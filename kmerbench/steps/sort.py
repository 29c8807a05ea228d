"""``sort``: ``Kmers.sort()``, its rounds timed in a traced run."""


def run(s, step):
    s.km.sort(on_round=s.on_round)
