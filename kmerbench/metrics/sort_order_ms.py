"""Median device ms of a job's ``gk:sort.order`` span: the ordering passes
(``torch.sort`` on 2-bit keys, the lane sort on 4-bit keys)."""

from kmerbench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "gk:sort.order", "job")
