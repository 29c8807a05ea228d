"""The port's profiling sweeps (genome_kmers_tpu_torch/profiling.py) against
the JAX package's, on the CPU at a tiny size: the same DataFrame columns,
the same row keys and, for the sort sweep, the same k-mer counts; the
generators give the same sequences from the same seed; the large sweep
(``LargeKmers``) gives the JAX package's k-mer counts. Times are not
compared (CPU times of two engines)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genome_kmers_tpu import profiling as jprof
from genome_kmers_tpu_torch import profiling as tprof

REPO = Path(__file__).resolve().parents[1]
KEYS = ["seq_len", "strands_to_load", "num_chromosomes", "num_lookups", "strand_to_test",
        "kmer_len", "num_kmers", "num_iterations"]


def _same_frames(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in KEYS:
        if col in want.columns:
            assert got[col].tolist() == want[col].tolist() or (
                got[col].isna().tolist() == want[col].isna().tolist()
            ), col
    assert (got["avg_run_time"] > 0).all() and (got["min_run_time"] <= got["avg_run_time"]).all()


@pytest.mark.parametrize(
    "sweep",
    ["seq_list_init", "fasta_init", "get_segment_num", "kmers_sort"],
)
def test_sweep_columns_match_jax(sweep):
    calls = {
        "seq_list_init": lambda m, **kw: m.profile_seq_list_init([500, 900], num_iterations=1,
                                                                 **kw),
        "fasta_init": lambda m, **kw: m.profile_fasta_init([600], num_chromosomes=3,
                                                           num_iterations=1, **kw),
        "get_segment_num": lambda m, **kw: m.profile_get_segment_num_from_sba_index(
            800, [1, 4], num_lookups=20, num_iterations=1, strand_to_load="both", **kw),
        "kmers_sort": lambda m, **kw: m.profile_kmers_sort([700], [5, None], num_iterations=1,
                                                           **kw),
    }
    _same_frames(calls[sweep](tprof, device="cpu"), calls[sweep](jprof))


def test_generators_match_jax():
    assert tprof.get_random_seq(300, seed=7) == jprof.get_random_seq(300, seed=7)
    assert tprof.get_random_seq_list(1000, 3, seed=2) == jprof.get_random_seq_list(1000, 3, seed=2)
    sc_t = tprof.SequenceCollection(sequence_list=tprof.get_random_seq_list(900, 4),
                                    strands_to_load="both", device="cpu")
    sc_j = jprof.SequenceCollection(sequence_list=jprof.get_random_seq_list(900, 4),
                                    strands_to_load="both")
    for strand in ("forward", "reverse_complement"):
        assert np.array_equal(
            tprof.get_sba_indices_to_test(sc_t, 30, strand, seed=1),
            jprof.get_sba_indices_to_test(sc_j, 30, strand, seed=1),
        )


def test_large_sort_raises_naming_a12():
    """Once a NotImplementedError naming A12; the sweep is ported: on one
    and on two CPU shards, suffix mode included, the JAX package's frame."""
    want = jprof.profile_large_sort([300], [5, None], num_iterations=1)
    for n in (None, 2):
        got = tprof.profile_large_sort([300], [5, None], num_iterations=1, n_devices=n,
                                       device="cpu")
        _same_frames(got, want)


def test_profiling_cli_large_sort_on_the_cpu(tmp_path):
    out = tmp_path / "prof"
    proc = subprocess.run(
        [sys.executable, "tools/torch_run_profiling.py", "-c", "large_sort", "-n", "1",
         "--device", "cpu", "--n-devices", "2", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rows = (tmp_path / "prof-large_sort.csv").read_text().splitlines()
    assert rows[0].startswith("seq_len,kmer_len,num_kmers") and len(rows) == 2
    assert rows[1].startswith("1000000,31,999970,")


def test_profiling_cli_on_the_cpu(tmp_path):
    out = tmp_path / "prof"
    proc = subprocess.run(
        [sys.executable, "tools/torch_run_profiling.py", "-c", "get_segment_num", "-n", "1",
         "--device", "cpu", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    header = (tmp_path / "prof-get_segment_num.csv").read_text().splitlines()[0]
    assert header.startswith("seq_len,num_chromosomes,num_lookups")
    assert "jax" not in proc.stderr.lower()
