"""The mesh exchange's share of the link: the least bytes a card sends
(``link_roofline.exchange_bytes``: three quarters of its rows on four
cards, each row its key words and position, 12 B at k = 31 on 2-bit keys)
at the link's peak of one direction, over the slowest card's device time
of the ``gk:mesh.exchange`` span, summed over the jobs (program span)."""

from kmerbench import catalog
from kmerbench.link_roofline import exchange_bytes, share_of_link
from kmerbench.program_spans import phases
from kmerbench.roofline import sort_bytes


def read(run):
    k = run.index_step["max"]
    if run.unit != "job" or not run.rows_per_job or k is None:
        return None
    ph = phases(run)
    if not ph:
        return None
    timed = [p for p in ph if p.name == "gk:mesh.exchange" and p.device_ms is not None]
    if not timed:
        return None
    cards = catalog.cell(catalog.load_benchmark(), run.cell)["chips"]
    row_bytes = sort_bytes(1, k, run.two_bit) // 2  # read once: the row's bytes
    nbytes = exchange_bytes(run.rows_per_job, row_bytes, cards) * len(timed)
    return share_of_link(nbytes, sum(p.device_ms for p in timed) / 1e3)
