"""The sort's share of its bound: each row's k-mer key and position read
once and written once (kmerbench/roofline.py), at the card's memory rate,
over the device busy time inside the sort spans, summed over the jobs."""

from kmerbench.record import spans_of
from kmerbench.roofline import share_of_bandwidth, sort_bytes


def read(run):
    spans = spans_of(run, "sort", "job")
    if not spans or run.device is None:
        return None
    k = run.index_step["max"]
    if k is None or not run.rows_per_job:
        return None
    busy_s = sum(run.device.busy_us(s.start, s.end) for s in spans) / 1e6
    if busy_s <= 0:
        return None
    return share_of_bandwidth(sort_bytes(run.rows_per_job, k, run.two_bit) * len(spans),
                              busy_s)
