"""The hybrid 2-bit/4-bit split sort and ``_DeviceCache.packed2_any``, the
port against the JAX package, on the CPU.

On the genomes of the JAX package's tests/test_hybrid.py (random ACGT with
a few N runs; several records with short caps; N at the record edges; all
N; more than a quarter of the windows ambiguous), made from a seed with
NumPy: ``packed2_any`` equals the JAX package's word for word, and
``hybrid_sort_positions`` equals the JAX package's (int64 positions
against its uint32 ones), the split, all-2-bit and all-4-bit branches
included, or, where a case adds no new JAX compile path, the JAX
package's 4-bit ``sort_positions``, the truth of its own hybrid tests. An
unbounded or beyond-64 ``max_kmer_len`` raises the same error. Tolerance:
exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import hybrid as jh
from genome_kmers_tpu.ops import keys as jk
from genome_kmers_tpu.ops import sort as js
from genome_kmers_tpu_torch.ops import hybrid as th
from genome_kmers_tpu_torch.ops.keys import cap_lengths, compute_valid_len


def sparse_n_genome(n, seed, n_runs=3, run_len=5):
    """Random ACGT genome with a few N runs (the JAX package's test genome)."""
    rng = np.random.default_rng(seed)
    s = list("".join(rng.choice(list("ACGT"), size=n)))
    for _ in range(n_runs):
        start = int(rng.integers(0, n - run_len))
        s[start : start + run_len] = "N" * run_len
    return "".join(s)


def _both(seq_list, min_k, max_k):
    """(JAX device cache, JAX positions, port device cache, port positions)."""
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load="forward", device="cpu")
    jkm = gj.Kmers(jsc, min_kmer_len=min_k, max_kmer_len=max_k)
    tkm = gt.Kmers(tsc, min_kmer_len=min_k, max_kmer_len=max_k)
    assert np.array_equal(np.asarray(jkm.kmer_sba_start_indices),
                          np.asarray(tkm.kmer_sba_start_indices))
    return (jsc.device_cache("forward"), jnp.asarray(jkm.kmer_sba_start_indices),
            tsc.device_cache("forward"), torch.as_tensor(tkm.kmer_sba_start_indices, dtype=torch.int64))


def _hybrid_pair(seq_list, min_k, max_k, uniform=False, clean_only=False, truth=False):
    """(JAX output, port output, ambiguous windows, positions); with
    ``clean_only`` both sort only the positions whose windows are free of
    non-ACGT bases. The JAX output is its hybrid sort's, or with ``truth``
    its 4-bit ``sort_positions`` of all the positions, which its own hybrid
    tests hold the hybrid sort to (a fraction of the hybrid sort's compile
    time)."""
    jdc, jpos, tdc, tpos = _both(seq_list, min_k, max_k)
    if clean_only:
        cap = cap_lengths(compute_valid_len(tpos, tdc.seg_starts, tdc.seg_ends), max_k)
        tpos = tpos[~th.ambiguity_mask(tdc.next_amb, tpos, cap)]
        jpos = jnp.asarray(tpos.numpy().astype(np.uint32))
    if truth:
        jcap = jk.cap_lengths(jk.compute_valid_len(jpos, jdc.seg_starts, jdc.seg_ends), max_k)
        want = np.asarray(js.sort_positions(jdc.packed, jpos, jcap, max_k))
    else:
        want = np.asarray(jh.hybrid_sort_positions(
            jdc.packed, jdc.packed2_any, jpos, jdc.seg_starts, jdc.seg_ends, max_k, jdc.next_amb,
            uniform_cap=uniform))
    got = th.hybrid_sort_positions(tdc.packed, tdc.packed2_any, tpos, tdc.seg_starts, tdc.seg_ends,
                                   max_k, tdc.next_amb, uniform_cap=uniform)
    assert got.dtype == torch.int64
    cap = cap_lengths(compute_valid_len(tpos, tdc.seg_starts, tdc.seg_ends), max_k)
    n_amb = int(th.ambiguity_mask(tdc.next_amb, tpos, cap).sum())
    return want.astype(np.int64), got.numpy(), n_amb, len(tpos)


CASES = {
    "edges": ([("chr1", "N" * 4 + sparse_n_genome(400, 5, n_runs=1) + "N" * 4)], 3, 6),
    "multi-record short caps": (
        [("a", sparse_n_genome(300, 1)), ("b", "ACGT"), ("c", "ACNTA"), ("d", sparse_n_genome(90, 2))],
        2, 8),
    "all ambiguous": ([("chr1", "N" * 50)], 2, 4),
    "over a quarter ambiguous": ([("chr1", sparse_n_genome(1200, 7, n_runs=12, run_len=6))], 31, 31),
    # the positions whose windows avoid the N runs
    "no ambiguous window": ([("chr1", sparse_n_genome(1200, 31))], 31, 31),
}


@pytest.mark.parametrize("k", [4, 31, 33, 55])
def test_sparse_n_matches_jax(k):
    """Sparse N, uniform caps, the split branch: both streams non-empty. At
    31 against the JAX package's hybrid sort, at 4, 33 and 55 (where the
    4-bit stream refines) its 4-bit sort."""
    want, got, n_amb, n = _hybrid_pair([("chr1", sparse_n_genome(1200, seed=k))], k, k, uniform=True,
                                       truth=k != 31)
    assert 0 < 4 * n_amb <= n
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_branches_match_jax(case):
    seq_list, min_k, max_k = CASES[case]
    want, got, n_amb, n = _hybrid_pair(seq_list, min_k, max_k, uniform=min_k == max_k,
                                       clean_only=case == "no ambiguous window",
                                       truth=case in ("edges", "multi-record short caps"))
    branch = ("none" if n_amb == 0 else "dense" if 4 * n_amb > n else "split")
    expected_branch = {"all ambiguous": "dense", "over a quarter ambiguous": "dense",
                       "no ambiguous window": "none"}.get(case, "split")
    assert branch == expected_branch
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seq", ["ACGTACGGTCA", "ACGTNNRYACGGTCA$ACGT"])
def test_packed2_any_matches_jax(seq):
    """The words of every byte, ACGT genome (``packed2``) or not (other
    bytes ranked 0), equal the JAX package's."""
    records = [(f"r{i}", part) for i, part in enumerate(seq.split("$"))]
    jdc = gj.SequenceCollection(sequence_list=records, strands_to_load="forward").device_cache("forward")
    tdc = gt.SequenceCollection(sequence_list=records, strands_to_load="forward",
                                device="cpu").device_cache("forward")
    got = tdc.packed2_any
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jdc.packed2_any))
    assert tdc.packed2_any is got  # built once
    if tdc.is_acgt_only:
        assert got is tdc.packed2


@pytest.mark.parametrize("max_k", [None, 65])
def test_unbounded_raises_like_jax(max_k):
    jdc, jpos, tdc, tpos = _both([("chr1", sparse_n_genome(80, 3))], 2, max_k)
    with pytest.raises(NotImplementedError) as want:
        jh.hybrid_sort_positions(jdc.packed, jdc.packed2_any, jpos, jdc.seg_starts, jdc.seg_ends,
                                 max_k, jdc.next_amb)
    with pytest.raises(NotImplementedError) as got:
        th.hybrid_sort_positions(tdc.packed, tdc.packed2_any, tpos, tdc.seg_starts, tdc.seg_ends,
                                 max_k, tdc.next_amb)
    assert str(got.value) == str(want.value)


def test_one_position_is_returned_as_is():
    _, _, tdc, tpos = _both([("chr1", "ACGTN")], 5, 5)
    assert len(tpos) == 1
    got = th.hybrid_sort_positions(tdc.packed, tdc.packed2_any, tpos, tdc.seg_starts, tdc.seg_ends,
                                   5, tdc.next_amb)
    assert got is tpos
