"""Key build and dense sort of the port against the JAX package, on the CPU.

Same seeded genomes through ``genome_kmers_tpu.ops`` and
``genome_kmers_tpu_torch.ops``: ``valid_len_all``, ``build_key2_words_dense``
and ``sort_positions_dense`` (sorted positions and every retained lane).
The genomes have several records, records shorter than max_kmer_len (for
min < max), a tiled repeat with heavy ties, and an all-'T' record, whose
k-mers have all-ones keys and must still sort ahead of the invalid rows.
Tolerance: exact equality (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu.ops import keys as jkeys
from genome_kmers_tpu.ops.sort import sort_positions_dense as jax_sort_positions_dense
from genome_kmers_tpu_torch.ops import keys as tkeys
from genome_kmers_tpu_torch.ops.sort import sort_positions_dense

UNIFORM = [(k, k) for k in (1, 5, 15, 16, 17, 31, 32, 33, 48, 64)]
RANGES = [(1, 5), (3, 15), (5, 16), (2, 17), (10, 31), (11, 32), (20, 33), (20, 48), (1, 64), (33, 64)]


def _genome(kind: str, min_len: int):
    """(sba uint8, seg_starts uint32) of a seeded genome whose records are
    all at least ``min_len`` long."""
    rng = np.random.default_rng(17 if kind == "random" else 23)
    if kind == "random":
        records = ["".join(rng.choice(list("ACGT"), size=n)) for n in (300, 90, 129)]
        records += ["".join(rng.choice(list("ACGT"), size=min_len + d)) for d in (0, 3)]
    else:  # tiled repeat: heavy ties
        unit = "".join(rng.choice(list("ACGT"), size=37))
        records = [(unit * 12)[:400], (unit * 5)[:150], unit[:5] * 30]
    records.append("T" * 80)
    text = "$".join(records)
    starts = np.concatenate([[0], np.cumsum([len(r) + 1 for r in records[:-1]])])
    return np.frombuffer(text.encode(), dtype=np.uint8).copy(), starts.astype(np.uint32)


def _jax_geometry(sba, seg_starts):
    starts = jnp.asarray(seg_starts)
    return starts, jkeys.compute_seg_ends(starts, len(sba))


def _torch_geometry(sba, seg_starts):
    starts = torch.from_numpy(seg_starts.astype(np.int64))
    return starts, tkeys.compute_seg_ends(starts, len(sba))


def _u32(lane: torch.Tensor) -> np.ndarray:
    values = lane.numpy()
    assert lane.dtype == torch.int64 and values.min() >= 0 and values.max() < 2**32
    return values.astype(np.uint32)


@pytest.mark.parametrize("kind", ["random", "tiled"])
def test_valid_len_all_and_seg_ends_match_jax(kind):
    sba, seg_starts = _genome(kind, 7)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    assert np.array_equal(t_ends.numpy(), np.asarray(j_ends).astype(np.int64))
    iota = jnp.arange(len(sba), dtype=jnp.uint32)
    want = np.asarray(jkeys.valid_len_all(j_starts, j_ends, iota))
    got = tkeys.valid_len_all(t_starts, t_ends, len(sba))
    assert np.array_equal(_u32(got), want)
    positions = np.flatnonzero(want)  # every non-separator position
    vl = tkeys.compute_valid_len(torch.from_numpy(positions), t_starts, t_ends)
    assert np.array_equal(vl.numpy(), want[positions].astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "tiled"])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 33, 64])
def test_build_key2_words_dense_matches_jax(kind, k):
    sba, seg_starts = _genome(kind, 1)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    n_words = -(-k // 16)
    j_cap = jnp.minimum(
        jkeys.valid_len_all(j_starts, j_ends, jnp.arange(len(sba), dtype=jnp.uint32)),
        jnp.uint32(k),
    )
    want = jkeys.build_key2_words_dense(jkeys.pack_rank2_words(jnp.asarray(sba)), j_cap, n_words)
    t_cap = torch.clamp_max(tkeys.valid_len_all(t_starts, t_ends, len(sba)), k)
    got = tkeys.build_key2_words_dense(
        tkeys.pack_rank2_words(torch.from_numpy(sba)), t_cap, n_words
    )
    assert len(got) == len(want) == n_words
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("kind", ["random", "tiled"])
@pytest.mark.parametrize("mn,mx", UNIFORM + RANGES)
def test_sort_positions_dense_matches_jax(kind, mn, mx):
    sba, seg_starts = _genome(kind, mn)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    n = int(sum(int(e) - int(s) + 1 - mn + 1 for s, e in zip(seg_starts, np.asarray(j_ends))))
    uniform = mn == mx
    j_pos, j_lanes = jax_sort_positions_dense(
        jkeys.pack_rank2_words(jnp.asarray(sba)), j_starts, j_ends, n, mn, mx,
        two_bit=True, uniform_cap=uniform, return_lanes=True,
    )
    t_pos, t_lanes = sort_positions_dense(
        tkeys.pack_rank2_words(torch.from_numpy(sba)), t_starts, t_ends, n, mn, mx
    )
    assert t_pos.dtype == torch.int64
    assert np.array_equal(_u32(t_pos), np.asarray(j_pos))
    assert t_lanes["two_bit"] is j_lanes["two_bit"] is True
    assert t_lanes["built_k"] == j_lanes["built_k"] == mx
    assert len(t_lanes["words"]) == len(j_lanes["words"])
    for g, w in zip(t_lanes["words"], j_lanes["words"]):
        assert np.array_equal(_u32(g), np.asarray(w))
    assert (t_lanes["cap"] is None) == (j_lanes["cap"] is None) == uniform
    if not uniform:
        assert np.array_equal(_u32(t_lanes["cap"]), np.asarray(j_lanes["cap"]))


def test_all_t_kmers_sort_ahead_of_invalid_rows():
    """k = 31 packs to 62 bits; an all-'T' 31-mer has all of them set and
    must stay a real row, ahead of the separator and tail rows."""
    sba, seg_starts = _genome("tiled", 31)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    n = int(sum(int(e) - int(s) + 1 - 31 + 1 for s, e in zip(seg_starts, t_ends.numpy())))
    pos, lanes = sort_positions_dense(
        tkeys.pack_rank2_words(torch.from_numpy(sba)), t_starts, t_ends, n, 31, 31
    )
    t_rec = int(seg_starts[-1])
    assert pos[-50:].tolist() == list(range(t_rec, t_rec + 50))
    assert lanes["words"][0][-1].item() == 0xFFFFFFFF
    assert lanes["words"][1][-1].item() == 0xFFFFFFFC
