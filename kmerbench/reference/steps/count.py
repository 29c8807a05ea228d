"""The reference side of ``count``: the total of ``group_counts``."""

from kmerbench.reference import kmers_ref as ref


def expected(ix, step):
    return ref.group_counts(ix, step["k"], step.get("filter"))[1]


def control(ix, step, bits):
    return ref.control_group_counts(ix, step["k"], step.get("filter"), bits)[1]


def matches(got, want) -> bool:
    return int(got) == want
