"""Refinement rounds a sort: calls of the public ``on_round`` hook."""

from kmerbench.record import median, spans_of


def read(run):
    return median([len(s.rounds) for s in spans_of(run, "sort", "job") if s.rounds])
