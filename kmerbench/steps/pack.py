"""``pack``: the packed words the sort reads (``packed2``, else ``packed``)."""


def run(s, step):
    dc = s.sc.device_cache("forward")
    if dc.packed2 is None:
        dc.packed
