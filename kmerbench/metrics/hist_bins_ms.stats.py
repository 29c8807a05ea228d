"""Median device ms of the ``gk:groups.histogram`` span over the session's
unfiltered calls (those with no ``gk:filters.flags`` span)."""

from kmerbench.program_spans import median_device_ms, unfiltered_calls


def read(run):
    return median_device_ms(run, "gk:groups.histogram", "call", calls=unfiltered_calls)
