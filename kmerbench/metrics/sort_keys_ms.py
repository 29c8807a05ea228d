"""Median device ms of a job's ``gk:sort.keys`` span: the key lanes built
from the pack (program span, two CUDA events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:sort.keys", "job")
