"""The 90th percentile (nearest rank) of all calls of the window, ms."""

from kmerbench.record import nearest_rank


def read(run):
    if run.unit != "call" or not run.unit_seconds:
        return None
    return nearest_rank(run.unit_seconds, 0.9) * 1e3
