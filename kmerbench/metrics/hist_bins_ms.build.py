"""Median device ms of a job's ``gk:groups.histogram`` span: the clamp, the
qualifying select and the ``torch.bincount`` (A4)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:groups.histogram", "job")
