"""Median device ms of the ``gk:filters.flags`` span over the session's
filtered calls: the lanes flags (A13)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:filters.flags", "call")
