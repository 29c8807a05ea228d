"""Median ms of the session's unfiltered ``get_kmer_group_counts`` calls."""

from kmerbench.record import median, spans_of


def read(run):
    ms = median([s.seconds for s in spans_of(run, "group_counts", "call", filtered=False)])
    return None if ms is None else ms * 1e3
