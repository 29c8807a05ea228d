"""Shared helpers of the benchmark's tests."""

import copy


def tiny_config(config: dict) -> dict:
    """A configuration's shape at a size a test holds: a few records of a
    few kbp, a few families, N runs where it has them."""
    c = copy.deepcopy(config)
    if c["n_runs"]["fixed"]:
        c["records"] = [["chr1", 20000]]
        c["n_runs"] = {"fixed": [[0, 100], [9000, 1500], [19900, 100]], "placed": [300, 300, 41]}
    else:
        c["records"] = [["I", 6000], ["II", 4000], ["MtDNA", 500]]
    c["repeat_families"].update(families=4, copies_max=30)
    return c
