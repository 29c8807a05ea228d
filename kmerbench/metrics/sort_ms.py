"""Median ms of ``Kmers.sort()`` a job, host clock after a synchronise."""

from kmerbench.record import median, spans_of


def read(run):
    ms = median([s.seconds for s in spans_of(run, "sort", "job")])
    return None if ms is None else ms * 1e3
