"""The port's entry points outside the package, on the CPU:
``tools/torch_run_soak.py``, ``tools/torch_run_applications.py`` and
``tools/torch_run_e2e_validation.py`` against the JAX package's scripts and
calls on the same inputs. Their copied generators draw what the JAX side
draws; the applications' rows and the end-to-end counts equal the JAX
package's; a few cases of each soak sweep pass on the CPU; each script
raises without CUDA unless given ``--device cpu``, and the soak exits
non-zero on a failing case. Tolerance: exact equality.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
from genome_kmers_tpu.ops.filters import LengthFilter as JaxLengthFilter
from test_fuzz import random_case as jax_random_case

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load(name: str):
    """A script of ``tools/`` (not a package) as a module, loaded once."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


soak = _load("torch_run_soak")
apps = _load("torch_run_applications")
e2e = _load("torch_run_e2e_validation")


def _jax_rows(seq, ks, per_k_sort):
    """tools/run_applications.py's unique_vs_k rows on the JAX package, the
    seconds column left out."""
    sc = gj.SequenceCollection(sequence_list=[("chr1", seq)], strands_to_load="forward")
    rows = []
    if per_k_sort:
        for k in ks:
            km = gj.Kmers(sc, min_kmer_len=k, max_kmer_len=k)
            km.sort()
            rows.append((k, *km.get_kmer_group_counts(k, max_counts_bin=100)))
    else:
        km = gj.Kmers(sc, min_kmer_len=min(ks), max_kmer_len=max(ks))
        km.sort()
        for k in sorted(ks):
            rows.append((k, *km.get_kmer_group_counts(
                k, kmer_filter_func=JaxLengthFilter(k), max_counts_bin=100)))
    return [(k, total, int(hist.sum()), int(hist[1]), round(int(hist[1]) / total, 6))
            for k, hist, total in rows]


# --------------------------------------------------------------------------- #
# the copied generators
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("first_seed, n_cases", [
    (soak.ORACLE_SEED, 150), (soak.MESH_SEED, 40), (soak.FILTER_SEED, 60)])
def test_random_case_matches_test_fuzz(first_seed, n_cases):
    for seed in range(first_seed, first_seed + n_cases):
        assert soak.random_case(seed) == jax_random_case(seed), seed


@pytest.mark.parametrize("seed", [50_000, 7])
def test_make_repeat_genome_matches_jax_script(seed):
    jax_apps = _load("run_applications")
    args = (50_000, 5, 50, 300, 0.02, seed)
    assert apps.make_repeat_genome(*args) == jax_apps.make_repeat_genome(*args)


def test_uniform_genome_is_the_jax_scripts_draw():
    rng = np.random.default_rng(20_000)
    assert apps.uniform_genome(20_000) == "".join(rng.choice(list("ACGT"), size=20_000))


def test_synthetic_genome_is_the_jax_scripts_draw():
    rng = np.random.default_rng(12_345)
    want = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=12_345)
    assert np.array_equal(e2e.synthetic_genome(12_345), want)


# --------------------------------------------------------------------------- #
# the applications and the end-to-end validation against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("per_k_sort", [False, True])
def test_unique_vs_k_matches_jax(per_k_sort):
    ks = [8, 12, 16, 21]
    seq = apps.uniform_genome(20_000)
    rows, t_sort = apps.unique_vs_k(seq, ks, "cpu", per_k_sort=per_k_sort)
    assert [r[:5] for r in rows] == _jax_rows(seq, ks, per_k_sort)
    assert (t_sort is None) == per_k_sort


def test_unique_vs_k_sort_once_equals_per_k():
    seq = apps.uniform_genome(5_000)
    once, _ = apps.unique_vs_k(seq, [3, 5, 9, 13], "cpu")
    per_k, _ = apps.unique_vs_k(seq, [3, 5, 9, 13], "cpu", per_k_sort=True)
    assert [r[:5] for r in once] == [r[:5] for r in per_k]


def test_group_size_dist_matches_jax(tmp_path):
    seq, planted = apps.make_repeat_genome(50_000, 5, 50, 300, 0.02, seed=50_000)
    out = apps.group_size_dist(seq, 31, 100_000, "cpu")
    sc = gj.SequenceCollection(sequence_list=[("chr1", seq)], strands_to_load="forward")
    km = gj.Kmers(sc, min_kmer_len=31, max_kmer_len=31)
    km.sort()
    hist, total = km.get_kmer_group_counts(31, max_counts_bin=100_000)
    hist = np.asarray(hist)
    assert np.array_equal(out["hist"], hist) and out["total"] == total
    assert out["rows"] == [(int(s), int(hist[s])) for s in np.flatnonzero(hist) if s > 0]
    assert max(s for s, _ in out["rows"]) > 1  # the planted repeats make a tail
    path = tmp_path / "gsd.csv"
    apps.write_csv(str(path), apps.GROUP_SIZE_COLUMNS, out["rows"])
    lines = path.read_text().splitlines()
    assert lines[0] == "group_size,num_groups" and len(lines) == len(out["rows"]) + 1


def test_e2e_matches_jax(tmp_path):
    n_bp, k = 100_000, 31
    out = e2e.run_e2e(n_bp, k, "cpu")
    seq_arr = e2e.synthetic_genome(n_bp)
    fasta = tmp_path / "synthetic.fasta"
    e2e.write_fasta(str(fasta), seq_arr)
    km = gj.Kmers(gj.SequenceCollection(fasta_file_path=str(fasta)), min_kmer_len=k, max_kmer_len=k)
    km.sort()
    hist, total = km.get_kmer_group_counts(k, max_counts_bin=100)
    counts = km.count_queries([bytes(seq_arr[1000 : 1000 + k]).decode(), "A" * k])
    assert (out["total"], out["distinct"], out["unique"]) == (total, int(hist.sum()), int(hist[1]))
    assert out["query_counts"] == [int(c) for c in counts] == out["expected_counts"]
    assert out["n_kmers"] == total == n_bp - k + 1


def test_count_windows_counts_repeats():
    seq = np.frombuffer(b"ACGACGACGTTTT", dtype=np.uint8)
    assert [e2e.count_windows(seq, q) for q in ["ACG", "CGA", "TT", "TTTTT", "G"]] == [3, 2, 3, 0, 3]


# --------------------------------------------------------------------------- #
# the soak's sweeps on the CPU, and the scripts' device rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sweep, kwargs", [
    ("oracle_soak", {}), ("mesh_soak", {"max_shards": 4}), ("filtered_soak", {})])
def test_soak_sweep_passes_on_cpu(sweep, kwargs):
    assert getattr(soak, sweep)(12, "cpu", **kwargs) == []


def test_soak_exits_nonzero_on_a_failing_case(monkeypatch, capsys):
    def wrong(seq_list, min_k, max_k):
        unsorted_idx, unsorted, sorted_kmers, sorted_idx = soak_expected(seq_list, min_k, max_k)
        return unsorted_idx, unsorted, sorted_kmers, sorted_idx[::-1]

    soak_expected = soak.expected_kmers
    monkeypatch.setattr(soak, "expected_kmers", wrong)
    assert soak.main(["2", "0", "0", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL 224" in out and "oracle soak: 0/2 ok" in out and "filtered soak: 0/0 ok" in out
    monkeypatch.undo()
    assert soak.main(["2", "1", "1", "--device", "cpu"]) == 0


@pytest.mark.parametrize("module, argv", [
    (soak, ["1", "1", "1"]),
    (apps, ["--bp", "1000", "--ks", "5"]),
    (e2e, ["--scale", "custom", "--bp", "2000"]),
])
def test_script_raises_without_cuda_unless_given_cpu(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv + ["--device", "cuda"])
    assert not module.main(argv + ["--device", "cpu"])
