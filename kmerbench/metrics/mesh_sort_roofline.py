"""The mesh sample sort's share of its bound: the local sort and the merge
each read and write every row of a shard once (``roofline.sort_bytes`` of
the job's rows over the cell's cards, 24 B a row at k = 31 on 2-bit keys),
at the card's memory rate, over the slowest card's device time of the
``gk:mesh.local_sort`` and ``gk:mesh.merge`` spans, summed over the jobs
(program span)."""

from kmerbench import catalog
from kmerbench.program_spans import phases
from kmerbench.roofline import share_of_bandwidth, sort_bytes

SPANS = ("gk:mesh.local_sort", "gk:mesh.merge")


def read(run):
    k = run.index_step["max"]
    if run.unit != "job" or not run.rows_per_job or k is None:
        return None
    ph = phases(run)
    if not ph:
        return None
    timed = [p for p in ph if p.name in SPANS and p.device_ms is not None]
    if not timed:
        return None
    cards = catalog.cell(catalog.load_benchmark(), run.cell)["chips"]
    nbytes = sort_bytes(run.rows_per_job // cards, k, run.two_bit) * len(timed)
    return share_of_bandwidth(nbytes, sum(p.device_ms for p in timed) / 1e3)
