"""Median device ms of a job's ``gk:mesh.pack`` span: the pack's slices
sent to the shards (program span, the slowest card's CUDA events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:mesh.pack", "job")
