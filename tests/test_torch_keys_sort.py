"""Key builds and sorts of the port against the JAX package, on the CPU.

Same seeded genomes through ``genome_kmers_tpu.ops`` and
``genome_kmers_tpu_torch.ops``: ``valid_len_all``, the dense and the
gathered key words of both encodings, ``sort_positions_dense`` (2-bit and
4-bit) and ``sort_positions`` (both encodings, from ascending, descending
and shuffled subset input) with the sorted positions and every retained
lane, and ``adjacent_boundaries``. The genomes have several records,
records shorter than max_kmer_len (for min < max), a tiled repeat with
heavy ties, and an all-'T' record, whose k-mers have all-ones 2-bit keys
and must still sort ahead of the invalid rows; the IUPAC genomes add N
runs, sparse codes and an all-'Y' record (all-ones 4-bit words).
Tolerance: exact equality (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu.ops import keys as jkeys
from genome_kmers_tpu.ops.sort import adjacent_boundaries as jax_adjacent_boundaries
from genome_kmers_tpu.ops.sort import sort_positions as jax_sort_positions
from genome_kmers_tpu.ops.sort import sort_positions_dense as jax_sort_positions_dense
from genome_kmers_tpu_torch.ops import keys as tkeys
from genome_kmers_tpu_torch.ops.sort import adjacent_boundaries, sort_positions, sort_positions_dense

UNIFORM = [(k, k) for k in (1, 5, 15, 16, 17, 31, 32, 33, 48, 64)]
RANGES = [(1, 5), (3, 15), (5, 16), (2, 17), (10, 31), (11, 32), (20, 33), (20, 48), (1, 64), (33, 64)]


def _genome(kind: str, min_len: int):
    """(sba uint8, seg_starts uint32) of a seeded genome whose records are
    all at least ``min_len`` long."""
    rng = np.random.default_rng(17 if kind == "random" else 23)
    if kind == "random":
        records = ["".join(rng.choice(list("ACGT"), size=n)) for n in (300, 90, 129)]
        records += ["".join(rng.choice(list("ACGT"), size=min_len + d)) for d in (0, 3)]
    elif kind == "iupac":  # N runs, sparse codes, all-ones 4-bit words
        rng = np.random.default_rng(29)
        probs = [0.23] * 4 + [0.02] * 4
        records = ["".join(rng.choice(list("ACGTNRYK"), p=probs, size=n)) for n in (300, 129)]
        records += ["ACGT" + "N" * 70 + "ACGTT" + "N" * 50, "Y" * 45]
        records += ["".join(rng.choice(list("ACGTN"), size=min_len + d)) for d in (0, 3)]
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
        tkeys.pack_rank2_words(torch.from_numpy(sba)), t_starts, t_ends, n, mn, mx,
        two_bit=True, uniform_cap=uniform, return_lanes=True,
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
        tkeys.pack_rank2_words(torch.from_numpy(sba)), t_starts, t_ends, n, 31, 31,
        two_bit=True, uniform_cap=True, return_lanes=True,
    )
    t_rec = int(seg_starts[-1])
    assert pos[-50:].tolist() == list(range(t_rec, t_rec + 50))
    assert lanes["words"][0][-1].item() == 0xFFFFFFFF
    assert lanes["words"][1][-1].item() == 0xFFFFFFFC


# --------------------------------------------------------------------------- #
# 4-bit keys and the gather path
# --------------------------------------------------------------------------- #

UNIFORM4 = [(k, k) for k in (1, 7, 8, 9, 24, 31, 32)]
RANGES4 = [(1, 5), (3, 8), (2, 17), (10, 31), (12, 32)]


def _bits(lane: torch.Tensor) -> np.ndarray:
    assert lane.dtype == torch.int32
    return lane.numpy().view(np.uint32)


def _count(seg_starts, seg_ends, mn):
    return int(sum(int(e) - int(s) + 1 - mn + 1 for s, e in zip(seg_starts, seg_ends)))


@pytest.mark.parametrize("k", [1, 8, 9, 31, 32])
def test_build_key_words_dense_matches_jax(k):
    sba, seg_starts = _genome("iupac", 1)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    n_words = -(-k // 8)
    j_cap = jnp.minimum(
        jkeys.valid_len_all(j_starts, j_ends, jnp.arange(len(sba), dtype=jnp.uint32)),
        jnp.uint32(k),
    )
    want = jkeys.build_key_words_dense(jkeys.pack_rank_words(jnp.asarray(sba)), j_cap, n_words)
    t_cap = torch.clamp_max(tkeys.valid_len_all(t_starts, t_ends, len(sba)), k)
    packed = tkeys.pack_rank_words(torch.from_numpy(sba))
    got = tkeys.build_key_words_dense(packed, t_cap, n_words)
    assert len(got) == len(want) == n_words
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), np.asarray(w))
    # the dense build equals the gathered build over every position
    iota = torch.arange(len(sba), dtype=torch.int64)
    for g, w in zip(got, tkeys.build_key_words(packed, iota, t_cap, n_words)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("two_bit", [True, False])
@pytest.mark.parametrize("k,offset", [(5, 0), (16, 0), (31, 0), (32, 0), (20, 8), (12, 32)])
def test_gathered_key_words_match_jax(two_bit, k, offset):
    """Any positions in any order, a window starting ``offset`` bases in."""
    sba, seg_starts = _genome("random" if two_bit else "iupac", 1)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    rng = np.random.default_rng(k + offset)
    positions = rng.permutation(np.flatnonzero(sba != ord("$")))[:200]
    j_pos = jnp.asarray(positions.astype(np.uint32))
    t_pos = torch.from_numpy(positions.astype(np.int64))
    j_cap = jkeys.cap_lengths(jkeys.compute_valid_len(j_pos, j_starts, j_ends), k + offset)
    t_cap = tkeys.cap_lengths(tkeys.compute_valid_len(t_pos, t_starts, t_ends), k + offset)
    assert np.array_equal(t_cap.numpy(), np.asarray(j_cap).astype(np.int64))
    assert np.array_equal(
        tkeys.segment_ids_for_positions(t_pos, t_starts).numpy(),
        np.asarray(jkeys.segment_ids_for_positions(j_pos, j_starts)).astype(np.int64),
    )
    n_words = -(-k // (16 if two_bit else 8))
    if two_bit:
        want = jkeys.build_key2_words(
            jkeys.pack_rank2_words(jnp.asarray(sba)), j_pos, j_cap, n_words, jnp.uint32(offset)
        )
        got = tkeys.build_key2_words(
            tkeys.pack_rank2_words(torch.from_numpy(sba)), t_pos, t_cap, n_words, offset
        )
    else:
        want = jkeys.build_key_words(
            jkeys.pack_rank_words(jnp.asarray(sba)), j_pos, j_cap, n_words, jnp.uint32(offset)
        )
        got = tkeys.build_key_words(
            tkeys.pack_rank_words(torch.from_numpy(sba)), t_pos, t_cap, n_words, offset
        )
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), np.asarray(w))


@pytest.mark.parametrize("mn,mx", UNIFORM4 + RANGES4)
def test_sort_positions_dense_4bit_matches_jax(mn, mx):
    sba, seg_starts = _genome("iupac", mn)
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    n = _count(seg_starts, np.asarray(j_ends), mn)
    j_pos, j_lanes = jax_sort_positions_dense(
        jkeys.pack_rank_words(jnp.asarray(sba)), j_starts, j_ends, n, mn, mx,
        two_bit=False, uniform_cap=mn == mx, return_lanes=True,
    )
    t_pos, t_lanes = sort_positions_dense(
        tkeys.pack_rank_words(torch.from_numpy(sba)), t_starts, t_ends, n, mn, mx, two_bit=False,
        uniform_cap=mn == mx, return_lanes=True,
    )
    assert t_pos.dtype == torch.int64 and t_pos.shape == (n,)
    assert np.array_equal(_u32(t_pos), np.asarray(j_pos))
    assert t_lanes["two_bit"] is j_lanes["two_bit"] is False
    assert t_lanes["built_k"] == j_lanes["built_k"] == mx
    assert t_lanes["cap"] is None and j_lanes["cap"] is None
    assert len(t_lanes["words"]) == len(j_lanes["words"]) == -(-mx // 8)
    for g, w in zip(t_lanes["words"], j_lanes["words"]):
        assert g.shape == (n,) and np.array_equal(_bits(g), np.asarray(w))


def _input_order(kind: str, positions: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(len(positions))
    if kind == "descending":
        return positions[::-1].copy()
    if kind == "shuffled subset":
        return rng.permutation(positions)[: len(positions) // 2]
    return positions


@pytest.mark.parametrize("order", ["ascending", "descending", "shuffled subset"])
@pytest.mark.parametrize(
    "genome,mn,mx",
    [("random", 5, 5), ("random", 31, 31), ("tiled", 64, 64), ("tiled", 3, 17),
     ("random", 20, 48), ("iupac", 9, 9), ("iupac", 31, 31), ("iupac", 32, 32),
     ("iupac", 3, 17), ("iupac", 12, 32)],
)
def test_sort_positions_matches_jax(genome, mn, mx, order):
    """The gather sort: the position is a key, so any input order gives the
    order of the JAX package, and of the dense sort on the full set."""
    sba, seg_starts = _genome(genome, mn)
    two_bit = genome != "iupac"
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    full = np.concatenate([
        np.arange(int(s), int(e) - mn + 2) for s, e in zip(seg_starts, np.asarray(j_ends))
    ])
    positions = _input_order(order, full)
    j_pos = jnp.asarray(positions.astype(np.uint32))
    t_pos = torch.from_numpy(positions.astype(np.int64))
    j_cap = jkeys.cap_lengths(jkeys.compute_valid_len(j_pos, j_starts, j_ends), mx)
    t_cap = tkeys.cap_lengths(tkeys.compute_valid_len(t_pos, t_starts, t_ends), mx)
    if two_bit:
        j_packs = {"packed": None, "packed2": jkeys.pack_rank2_words(jnp.asarray(sba))}
        t_packs = {"packed": None, "packed2": tkeys.pack_rank2_words(torch.from_numpy(sba))}
    else:
        j_packs = {"packed": jkeys.pack_rank_words(jnp.asarray(sba)), "packed2": None}
        t_packs = {"packed": tkeys.pack_rank_words(torch.from_numpy(sba)), "packed2": None}
    want_pos, want = jax_sort_positions(
        j_packs["packed"], j_pos, j_cap, mx, packed2=j_packs["packed2"],
        uniform_cap=mn == mx, return_lanes=True,
    )
    got_pos, got = sort_positions(
        t_packs["packed"], t_pos, t_cap, mx, packed2=t_packs["packed2"], uniform_cap=mn == mx,
        return_lanes=True,
    )
    assert got_pos.dtype == torch.int64
    assert np.array_equal(_u32(got_pos), np.asarray(want_pos))
    assert got["two_bit"] is want["two_bit"] is two_bit and got["built_k"] == want["built_k"] == mx
    assert len(got["words"]) == len(want["words"])
    for g, w in zip(got["words"], want["words"]):
        assert np.array_equal(_bits(g), np.asarray(w))
    assert (got["cap"] is None) == (want["cap"] is None) == (mn == mx or not two_bit)
    if got["cap"] is not None:
        assert np.array_equal(_u32(got["cap"]), np.asarray(want["cap"]))
    if order != "shuffled subset":
        dense_pos = sort_positions_dense(
            t_packs["packed2"] if two_bit else t_packs["packed"], t_starts, t_ends, len(full),
            mn, mx, two_bit=two_bit, uniform_cap=mn == mx,
        )
        assert torch.equal(got_pos, dense_pos)
    # group boundaries from gathered keys, at and around the sorted length
    for kmer_len in sorted({1, mn, mx, min(mx + 5, 64 if two_bit else 32)}):
        j_c = jkeys.cap_lengths(jkeys.compute_valid_len(want_pos, j_starts, j_ends), kmer_len)
        t_c = tkeys.cap_lengths(tkeys.compute_valid_len(got_pos, t_starts, t_ends), kmer_len)
        want_b = jax_adjacent_boundaries(
            j_packs["packed"], want_pos, j_c, kmer_len, packed2=j_packs["packed2"],
            uniform_cap=mn >= kmer_len,
        )
        got_b = adjacent_boundaries(
            t_packs["packed"], got_pos, t_c, kmer_len, packed2=t_packs["packed2"],
            uniform_cap=mn >= kmer_len,
        )
        assert got_b.dtype == torch.bool
        assert np.array_equal(got_b.numpy(), np.asarray(want_b)), kmer_len


def test_sort_positions_of_at_most_one_row_and_beyond_the_window():
    sba, seg_starts = _genome("iupac", 1)
    t_starts, t_ends = _torch_geometry(sba, seg_starts)
    packed = tkeys.pack_rank_words(torch.from_numpy(sba))
    one = torch.tensor([3], dtype=torch.int64)
    cap = tkeys.cap_lengths(tkeys.compute_valid_len(one, t_starts, t_ends), 9)
    pos, lanes = sort_positions(packed, one, cap, 9, return_lanes=True)
    assert torch.equal(pos, one) and lanes is None
    assert torch.equal(sort_positions(packed, one, cap, 9), one)
    # beyond the window the rounds of 32 bases take over: no lanes are kept
    two = torch.tensor([3, 1], dtype=torch.int64)
    j_two = jnp.asarray([3, 1], dtype=jnp.uint32)
    j_packed = jkeys.pack_rank_words(jnp.asarray(sba))
    j_starts, j_ends = _jax_geometry(sba, seg_starts)
    for max_kmer_len in (33, None):
        cap = tkeys.cap_lengths(tkeys.compute_valid_len(two, t_starts, t_ends), max_kmer_len)
        j_cap = jkeys.cap_lengths(jkeys.compute_valid_len(j_two, j_starts, j_ends), max_kmer_len)
        pos, lanes = sort_positions(packed, two, cap, max_kmer_len, return_lanes=True)
        want = jax_sort_positions(j_packed, j_two, j_cap, max_kmer_len)
        assert lanes is None and np.array_equal(_u32(pos), np.asarray(want))
        assert torch.equal(sort_positions(packed, two, cap, max_kmer_len), pos)
        got_b = adjacent_boundaries(packed, two, cap, max_kmer_len)
        want_b = jax_adjacent_boundaries(j_packed, j_two, j_cap, max_kmer_len)
        assert np.array_equal(got_b.numpy(), np.asarray(want_b))
