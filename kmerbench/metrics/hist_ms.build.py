"""Median ms of a job's ``get_kmer_group_counts`` call, host clock after a
synchronise."""

from kmerbench.record import median, spans_of


def read(run):
    ms = median([s.seconds for s in spans_of(run, "group_counts", "job", filtered=False)])
    return None if ms is None else ms * 1e3
