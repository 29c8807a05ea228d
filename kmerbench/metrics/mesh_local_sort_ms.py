"""Median device ms of a job's ``gk:mesh.local_sort`` span: each shard's
rows sorted before the splitters (program span, the slowest card's CUDA
events)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:mesh.local_sort", "job")
