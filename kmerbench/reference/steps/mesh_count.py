"""The reference side of ``mesh_count``: the total of ``mesh_group_counts``."""

from kmerbench.reference import blocked


def expected(ix, step):
    return ix.group_counts(step["k"])[1]


def control(ix, step, bits):
    return blocked.control_group_counts(ix, step["k"], bits)[1]


def matches(got, want) -> bool:
    return int(got) == want
