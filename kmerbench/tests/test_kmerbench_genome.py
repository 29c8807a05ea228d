"""The generator: the same genome from the same seed, at the configuration's
published sizes."""

import numpy as np
import pytest
from kmerbench_helpers import tiny_config

from kmerbench import catalog, genome


@pytest.fixture(scope="module")
def bench():
    return catalog.load_benchmark()


@pytest.mark.parametrize("name", ["celegans-wbcel235", "grch38-chr1"])
def test_same_seed_same_genome(bench, name):
    config = tiny_config(catalog.config(bench, name))
    a = genome.make_records(config, 2**33 + 5)
    b = genome.make_records(config, 2**33 + 5)
    c = genome.make_records(config, 2**33 + 6)
    assert [n for n, _ in a] == [n for n, _ in config["records"]]
    assert [len(x) for _, x in a] == [ln for _, ln in config["records"]]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert not all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, c))
    want_n = sum(ln for _, ln in config["n_runs"]["fixed"]) + sum(config["n_runs"]["placed"])
    assert sum(int((x == ord("N")).sum()) for _, x in a) == want_n


@pytest.mark.parametrize("name,total,n_bases", [
    ("celegans-wbcel235", 100286401, 0),
    ("grch38-chr1", 248956422, 18475410),
])
def test_published_sizes(bench, name, total, n_bases):
    config = catalog.config(bench, name)
    assert sum(ln for _, ln in config["records"]) == total == config["total_bp"]
    runs = genome._n_runs(config, np.random.default_rng(7), total)
    assert sum(ln for _, ln in runs) == n_bases
    ordered = sorted(runs)
    assert all(s >= 0 and s + ln <= total for s, ln in ordered)
    assert all(a[0] + a[1] < b[0] for a, b in zip(ordered, ordered[1:]))


def test_gc_share_and_copy_numbers():
    rng = np.random.default_rng(3)
    ranks = genome.draw_ranks(rng, 400000, 0.354)
    gc = np.isin(ranks, [1, 2]).mean()
    assert abs(gc - 0.354) < 0.005
    copies = genome.family_copies(87, 2, 5000)
    assert copies == genome.family_copies(87, 2, 5000)
    assert min(copies) >= 2 and max(copies) <= 5000 and copies == sorted(copies)

