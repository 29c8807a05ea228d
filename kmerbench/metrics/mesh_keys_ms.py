"""Median device ms of a job's ``gk:mesh.keys`` span: every shard's key
lanes built from its slice of the pack (program span, the slowest card's
CUDA events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:mesh.keys", "job")
