"""The reference side of ``group_counts``: (histogram, total) over the
verified order."""

import numpy as np

from kmerbench.reference import kmers_ref as ref


def expected(ix, step):
    return ref.group_counts(ix, step["k"], step.get("filter"))


def control(ix, step, bits):
    return ref.control_group_counts(ix, step["k"], step.get("filter"), bits)


def matches(got, want) -> bool:
    hist, total = want
    got_hist, got_total = got
    return int(got_total) == total and np.array_equal(np.asarray(got_hist), hist)
