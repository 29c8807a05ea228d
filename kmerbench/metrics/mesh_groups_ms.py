"""Median device ms of a job's ``gk:mesh.groups`` span: group boundaries
and sizes, stitched across shard edges (program span, the slowest card's
CUDA events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:mesh.groups", "job")
