"""Median device ms of a job's ``gk:mesh.exchange`` span: each bucket
moved to its shard (program span, the slowest card's CUDA events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:mesh.exchange", "job")
