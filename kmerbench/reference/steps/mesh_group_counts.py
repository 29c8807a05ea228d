"""The reference side of ``mesh_group_counts``: (histogram, total) over the
verified order, in blocks (``reference/blocked.py``)."""

import numpy as np

from kmerbench.reference import blocked


def expected(ix, step):
    return ix.group_counts(step["k"])


def control(ix, step, bits):
    return blocked.control_group_counts(ix, step["k"], bits)


def matches(got, want) -> bool:
    hist, total = want
    got_hist, got_total = got
    return int(got_total) == total and np.array_equal(np.asarray(got_hist), hist)
