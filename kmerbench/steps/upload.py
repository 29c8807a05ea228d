"""``upload``: the SBA bytes onto the card (``device_cache("forward").sba``)."""


def run(s, step):
    s.sc.device_cache("forward").sba
