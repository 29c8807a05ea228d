"""Group statistics of the port over the JAX package's own sorted lanes.

A JAX ``Kmers`` is built and sorted on the CPU; its host state (the SBA,
segment starts, record names, sorted positions and retained lanes) is
carried into the port with ``interop.from_numpy_state``. The port's
``boundaries_from_sorted_lanes`` (at every kmer_len up to the built
length), group sizes, histograms and totals must then equal the JAX
package's exactly, on a random genome and a tiled repeat with heavy ties,
and on an IUPAC genome's 4-bit lanes. ``group_geometry`` and
``selection_masks`` are held against the JAX functions on seeded masks.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import jax.numpy as jnp

from genome_kmers_tpu.ops.groups import group_geometry as jax_group_geometry
from genome_kmers_tpu.ops.groups import group_sizes_at_boundaries as jax_group_sizes
from genome_kmers_tpu.ops.groups import selection_masks as jax_selection_masks
from genome_kmers_tpu.ops.sort import boundaries_from_sorted_lanes as jax_boundaries
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.ops.groups import (
    group_geometry,
    group_sizes_at_boundaries,
    lanes_group_total,
    selection_masks,
)
from genome_kmers_tpu_torch.ops.sort import boundaries_from_sorted_lanes

CONFIGS = [(3, 3), (31, 31), (4, 20), (20, 48)]
MAX_COUNTS_BINS = [1, 30, 256, 257, 1000, 10**6]


def _seq_list(kind: str, min_len: int):
    """Seeded records, one of them only ``min_len + 2`` bases long."""
    rng = np.random.default_rng(5 if kind == "random" else 6)
    short = ("s", "".join(rng.choice(list("ACGT"), size=min_len + 2)))
    if kind == "iupac":
        probs = [0.22] * 4 + [0.04] * 3
        return [("i0", "".join(rng.choice(list("ACGTNRY"), p=probs, size=300))),
                ("i1", "ACGT" + "N" * 80 + "ACGTT" + "N" * 45), ("i2", "Y" * 60), short]
    if kind == "random":
        lens = (400, 60, 150)
        records = [(f"r{i}", "".join(rng.choice(list("ACGT"), size=n))) for i, n in enumerate(lens)]
        return records + [short]
    unit = "".join(rng.choice(list("ACGT"), size=29))
    return [("t0", (unit * 20)[:500]), ("t1", (unit * 4)[:100]), ("t2", "ACG" * 12),
            ("t3", "T" * 70), short]


def _pair(kind, mn, mx):
    """The sorted JAX Kmers and the port's Kmers holding its state."""
    seq_list = _seq_list(kind, mn)
    sc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    km = gj.Kmers(sc, mn, mx)
    km.sort()
    lanes = km._lanes_cache
    _, tkm = from_numpy_state(
        sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, mn, mx,
        positions=km.kmer_sba_start_indices,
        words=[np.asarray(w) for w in lanes["words"]],
        cap=None if lanes["cap"] is None else np.asarray(lanes["cap"]),
        two_bit=lanes["two_bit"], device="cpu",
    )
    return km, tkm


@pytest.mark.parametrize("kind", ["random", "tiled"])
@pytest.mark.parametrize("mn,mx", CONFIGS)
def test_boundaries_and_sizes_at_every_kmer_len(kind, mn, mx):
    km, tkm = _pair(kind, mn, mx)
    j_lanes, t_lanes = km._lanes_cache, tkm._lanes_cache
    for kmer_len in range(1, mx + 1):
        want = jax_boundaries(j_lanes["words"], j_lanes["cap"], kmer_len, True)
        got = boundaries_from_sorted_lanes(t_lanes["words"], t_lanes["cap"], kmer_len, True)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(want)), kmer_len
        sizes = group_sizes_at_boundaries(got)
        assert np.array_equal(sizes.numpy(), np.asarray(jax_group_sizes(want)).astype(np.int64))
        assert lanes_group_total(t_lanes["words"], t_lanes["cap"], 1, None, kmer_len,
                                 True) == len(km)
        j_total = int(km.get_kmer_count(kmer_len, min_group_size=2))
        assert lanes_group_total(t_lanes["words"], t_lanes["cap"], 2, None, kmer_len,
                                 True) == j_total


@pytest.mark.parametrize("mn,mx", [(3, 3), (31, 31), (4, 20), (12, 32)])
def test_4bit_boundaries_and_sizes_at_every_kmer_len(mn, mx):
    km, tkm = _pair("iupac", mn, mx)
    j_lanes, t_lanes = km._lanes_cache, tkm._lanes_cache
    assert t_lanes["two_bit"] is j_lanes["two_bit"] is False and t_lanes["cap"] is None
    for kmer_len in range(1, mx + 1):
        want = jax_boundaries(j_lanes["words"], None, kmer_len, False)
        got = boundaries_from_sorted_lanes(t_lanes["words"], None, kmer_len, two_bit=False)
        assert np.array_equal(got.numpy(), np.asarray(want)), kmer_len
        for mgs in (1, 2):
            total = lanes_group_total(t_lanes["words"], None, mgs, None, kmer_len, two_bit=False)
            assert total == int(km.get_kmer_count(kmer_len, min_group_size=mgs))
    for mcb in MAX_COUNTS_BINS:
        want, want_total = km.get_kmer_group_counts(mx, max_counts_bin=mcb)
        got, got_total = tkm.get_kmer_group_counts(mx, max_counts_bin=mcb)
        assert np.array_equal(got, want) and got_total == want_total


@pytest.mark.parametrize("seed", range(6))
def test_group_geometry_and_selection_masks_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    mask = rng.random(n) < (0.15, 0.5, 0.9)[seed % 3]
    mask[0] = True
    got = group_geometry(torch.from_numpy(mask))
    want = jax_group_geometry(jnp.asarray(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    _, _, size, rank = got
    _, _, j_size, j_rank = want
    none = jnp.uint32(0xFFFFFFF0)  # how the JAX package passes "unbounded"
    for mgs, xgs, yfn in [(1, None, None), (2, None, None), (1, 3, None), (2, 5, 1), (1, None, 2)]:
        yielded, gsy = selection_masks(torch.from_numpy(mask), size, rank, mgs, xgs, yfn)
        j_yielded, j_gsy = jax_selection_masks(
            jnp.asarray(mask), j_size, j_rank, jnp.uint32(mgs),
            none if xgs is None else jnp.uint32(xgs), none if yfn is None else jnp.uint32(yfn),
        )
        assert np.array_equal(yielded.numpy(), np.asarray(j_yielded))
        assert np.array_equal(gsy.numpy(), np.asarray(j_gsy).astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "tiled"])
@pytest.mark.parametrize("mn,mx", CONFIGS)
def test_histograms_and_totals_match_jax(kind, mn, mx):
    km, tkm = _pair(kind, mn, mx)
    for kmer_len in sorted({1, mn, (mn + mx) // 2, mx}):
        for mcb in MAX_COUNTS_BINS:
            want, want_total = km.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            got, got_total = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            assert got.dtype == np.int64 and got.shape == (mcb + 1,)
            assert np.array_equal(got, want), (kmer_len, mcb)
            assert got_total == want_total and isinstance(got_total, int)


@pytest.mark.parametrize("kind", ["random", "tiled"])
@pytest.mark.parametrize("mgs,xgs", [(1, None), (2, None), (1, 1), (2, 3), (3, None), (5, 40)])
def test_group_size_bounds_match_jax(kind, mgs, xgs):
    km, tkm = _pair(kind, 4, 20)
    for kmer_len in (2, 4, 9, 20):
        want = km.get_kmer_group_counts(kmer_len, min_group_size=mgs, max_group_size=xgs,
                                        max_counts_bin=30)
        got = tkm.get_kmer_group_counts(kmer_len, min_group_size=mgs, max_group_size=xgs,
                                        max_counts_bin=30)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1], kmer_len
        assert tkm.get_kmer_count(kmer_len, min_group_size=mgs, max_group_size=xgs) == int(
            km.get_kmer_count(kmer_len, min_group_size=mgs, max_group_size=xgs)
        )


def test_from_numpy_state_unsorted_and_checks():
    seq_list = _seq_list("random", 3)
    sc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    tsc, tkm = from_numpy_state(
        sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, 3, 9, device="cpu"
    )
    assert tsc == sc and not tkm._is_sorted
    assert np.array_equal(tkm.kmer_sba_start_indices, gj.Kmers(sc, 3, 9).kmer_sba_start_indices)
    pos = tkm.kmer_sba_start_indices
    with pytest.raises(ValueError, match="words"):
        from_numpy_state(sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names,
                         3, 9, positions=pos, device="cpu")
    with pytest.raises(ValueError, match="cap"):
        from_numpy_state(sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names,
                         3, 9, positions=pos, words=[pos], device="cpu")
