"""The JAX package's call contracts on the port, against the JAX package on
the CPU.

* ``ops.sort.sort_positions_dense`` and ``ops.sort.sort_positions``: int64
  positions alone by default, a ``(positions, lanes)`` pair with
  ``return_lanes``, at ``two_bit`` and ``uniform_cap`` both ways, by the
  JAX defaults (``two_bit=False``: a 4-bit pack) where no keyword is given;
* ``parallel.distributed_group_size_histogram_ragged(return_digest=True)``:
  ``(counts, total, hi)`` on meshes of 1, 2, 3 and 4 CPU shards over a
  sorted index cut into shards with pads at their tails, with
  ``max_counts_bin`` below and above the largest group, group-size bounds,
  a survivor mask, ``strand_split`` (at the sort's own length, where the
  JAX package's strand cut agrees with the port's (string, strand) groups)
  and ``ext_gid``; ``return_sizes`` keeps its precedence and gives the
  JAX digest ``[total, largest size, speculative counts]``;
* ``ops.groups.fold_err_conditions(valid=...)`` and ``sizes_digest`` with
  the sizes given;
* ``FilterContext``'s positional order and ``KmerFilter.batchable``.

Seeded with NumPy. Tolerance: exact equality (integer outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu import parallel as jp
from genome_kmers_tpu.ops import groups as jg
from genome_kmers_tpu.ops import keys as jkeys
from genome_kmers_tpu.ops import sort as jsort
from genome_kmers_tpu_torch import Kmers, SequenceCollection
from genome_kmers_tpu_torch import parallel as tp
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.ops import groups as tg
from genome_kmers_tpu_torch.ops import keys as tkeys
from genome_kmers_tpu_torch.ops import sort as tsort


def _genome(iupac: bool, seed: int = 3):
    """(sba, seg_starts uint32) of four seeded records with copied
    segments, ACGT or with N runs and IUPAC codes."""
    rng = np.random.default_rng(seed)
    records = []
    for n in (260, 75, 140, 40):
        s = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].copy()
        src = int(rng.integers(0, n - 25))
        for dst in rng.integers(0, n - 25, 2):
            s[dst : dst + 25] = s[src : src + 25]
        if iupac:
            s[rng.integers(0, n, n // 15)] = np.frombuffer(b"NRYK", dtype=np.uint8)[
                rng.integers(0, 4, n // 15)]
        records.append(s.tobytes())
    text = b"$".join(records)
    starts = np.concatenate([[0], np.cumsum([len(r) + 1 for r in records[:-1]])])
    return np.frombuffer(text, dtype=np.uint8).copy(), starts.astype(np.uint32)


def _geometry(sba, seg_starts):
    j_starts = jnp.asarray(seg_starts)
    t_starts = torch.from_numpy(seg_starts.astype(np.int64))
    return ((j_starts, jkeys.compute_seg_ends(j_starts, len(sba))),
            (t_starts, tkeys.compute_seg_ends(t_starts, len(sba))))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).astype(np.uint32) if t.dtype == torch.int64 \
        else t.numpy().view(np.uint32)


def _same_lanes(got: dict, want: dict) -> bool:
    if got["two_bit"] != want["two_bit"] or got["built_k"] != want["built_k"]:
        return False
    if (got["cap"] is None) != (want["cap"] is None) or len(got["words"]) != len(want["words"]):
        return False
    pairs = list(zip(got["words"], want["words"]))
    if got["cap"] is not None:
        pairs.append((got["cap"], want["cap"]))
    return all(np.array_equal(_u32(g), np.asarray(w)) for g, w in pairs)


# --------------------------------------------------------------------------- #
# the sorts' return contracts
# --------------------------------------------------------------------------- #

SORT_CASES = [(two_bit, mn, mx, uniform) for two_bit in (True, False)
              for mn, mx in ((13, 13), (9, 20)) for uniform in (False, True) if uniform <= (mn == mx)]


@pytest.mark.parametrize("two_bit,mn,mx,uniform", SORT_CASES)
def test_sort_positions_dense_contract_matches_jax(two_bit, mn, mx, uniform):
    sba, seg_starts = _genome(iupac=not two_bit)
    (j_starts, j_ends), (t_starts, t_ends) = _geometry(sba, seg_starts)
    ends = np.asarray(j_ends)
    n = int(sum(max(int(e) - int(s) + 1 - mn + 1, 0) for s, e in zip(seg_starts, ends)))
    j_pack = (jkeys.pack_rank2_words if two_bit else jkeys.pack_rank_words)(jnp.asarray(sba))
    t_pack = (tkeys.pack_rank2_words if two_bit else tkeys.pack_rank_words)(torch.from_numpy(sba))
    j_pos, j_lanes = jsort.sort_positions_dense(
        j_pack, j_starts, j_ends, n, mn, mx, two_bit=two_bit, uniform_cap=uniform,
        return_lanes=True)
    alone = tsort.sort_positions_dense(t_pack, t_starts, t_ends, n, mn, mx, two_bit=two_bit,
                                       uniform_cap=uniform)
    t_pos, t_lanes = tsort.sort_positions_dense(t_pack, t_starts, t_ends, n, mn, mx,
                                                two_bit=two_bit, uniform_cap=uniform,
                                                return_lanes=True)
    assert isinstance(alone, torch.Tensor) and alone.dtype == torch.int64
    assert torch.equal(alone, t_pos)
    assert np.array_equal(_u32(t_pos), np.asarray(j_pos))
    assert _same_lanes(t_lanes, j_lanes)
    if not two_bit:
        # the JAX defaults read the 4-bit pack
        by_default = tsort.sort_positions_dense(t_pack, t_starts, t_ends, n, mn, mx)
        want = jsort.sort_positions_dense(j_pack, j_starts, j_ends, n, mn, mx)
        assert np.array_equal(_u32(by_default), np.asarray(want))


@pytest.mark.parametrize("two_bit,mn,mx,uniform", SORT_CASES)
def test_sort_positions_contract_matches_jax(two_bit, mn, mx, uniform):
    sba, seg_starts = _genome(iupac=not two_bit, seed=5)
    (j_starts, j_ends), (t_starts, t_ends) = _geometry(sba, seg_starts)
    ends = np.asarray(j_ends)
    full = np.concatenate([np.arange(int(s), int(e) - mn + 2) for s, e in zip(seg_starts, ends)])
    positions = np.random.default_rng(mn).permutation(full)[: 2 * len(full) // 3]
    j_in = jnp.asarray(positions.astype(np.uint32))
    t_in = torch.from_numpy(positions.astype(np.int64))
    j_cap = jkeys.cap_lengths(jkeys.compute_valid_len(j_in, j_starts, j_ends), mx)
    t_cap = tkeys.cap_lengths(tkeys.compute_valid_len(t_in, t_starts, t_ends), mx)
    packs = {}
    for side, keys, array in (("j", jkeys, jnp.asarray), ("t", tkeys, torch.from_numpy)):
        packs[side] = ((None, keys.pack_rank2_words(array(sba))) if two_bit
                       else (keys.pack_rank_words(array(sba)), None))
    j_pos, j_lanes = jsort.sort_positions(packs["j"][0], j_in, j_cap, mx, packed2=packs["j"][1],
                                          uniform_cap=uniform, return_lanes=True)
    j_alone = jsort.sort_positions(packs["j"][0], j_in, j_cap, mx, packed2=packs["j"][1],
                                   uniform_cap=uniform)
    alone = tsort.sort_positions(packs["t"][0], t_in, t_cap, mx, packed2=packs["t"][1],
                                 uniform_cap=uniform)
    t_pos, t_lanes = tsort.sort_positions(packs["t"][0], t_in, t_cap, mx, packed2=packs["t"][1],
                                          uniform_cap=uniform, return_lanes=True)
    assert isinstance(alone, torch.Tensor) and torch.equal(alone, t_pos)
    assert np.array_equal(_u32(alone), np.asarray(j_alone))
    assert np.array_equal(_u32(t_pos), np.asarray(j_pos))
    assert _same_lanes(t_lanes, j_lanes)


def test_kmers_sort_keeps_its_lanes():
    """``Kmers.sort`` asks for the lanes: the fresh and the gather sort keep
    the same lanes as the sorts called with ``return_lanes=True``."""
    for iupac in (False, True):
        sba, seg_starts = _genome(iupac)
        records = [(f"r{i}", r.decode()) for i, r in enumerate(sba.tobytes().split(b"$"))]
        sc = SequenceCollection(sequence_list=records, device="cpu")
        km = Kmers(sc, 13, 13)
        km.sort()
        dc = sc.device_cache("forward")
        two_bit = dc.packed2 is not None
        pos, lanes = tsort.sort_positions_dense(
            dc.packed2 if two_bit else dc.packed, dc.seg_starts, dc.seg_ends, len(km), 13, 13,
            two_bit=two_bit, uniform_cap=True, return_lanes=True)
        assert two_bit != iupac and torch.equal(km._pos_dev, pos)
        for a, b in zip(km._lanes_cache["words"], lanes["words"]):
            assert torch.equal(a, b)
        assert km._lanes_cache["cap"] is None and lanes["cap"] is None
        km.sort()  # a re-sort: the gather path
        assert torch.equal(km._pos_dev, pos) and km._lanes_cache["two_bit"] == two_bit
        assert all(np.array_equal(_u32(a), _u32(b))
                   for a, b in zip(km._lanes_cache["words"], lanes["words"]))


# --------------------------------------------------------------------------- #
# the mesh histogram's digest
# --------------------------------------------------------------------------- #


def _layout(sorted_pos: np.ndarray, p: int, seed: int):
    """The sorted rows cut into p shards of uneven length, each padded at
    its tail to one width: (positions (p, m) uint32, pads (p, m) bool)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, len(sorted_pos) + 1, p - 1))
    parts = np.split(sorted_pos, cuts)
    m = max(len(x) for x in parts) + 2
    pos = np.full((p, m), 0xFFFFFFF0, dtype=np.uint32)
    pad = np.ones((p, m), dtype=bool)
    for s, rows in enumerate(parts):
        pos[s, : len(rows)] = rows
        pad[s, : len(rows)] = False
    return pos, pad


def _sharded(jm, x):
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(jp.AXIS))
    return jax.device_put(jnp.asarray(x.ravel()), sharding)


DIGEST_CASES = [
    # (iupac, shards, min, max group size, max_counts_bin, extra)
    (False, 1, 1, None, 1000, None),
    (False, 2, 1, None, 2, None),
    (True, 3, 2, 6, 1000, None),
    (False, 4, 1, None, 3, "mask"),
    (True, 4, 1, 4, 1000, "mask"),
    (False, 2, 1, None, 1000, "strand_split"),
    (True, 3, 1, None, 2, "strand_split"),
    (False, 4, 1, None, 1000, "ext_gid"),
    (True, 2, 2, None, 3, "ext_gid"),
]


@pytest.mark.parametrize("iupac,p,min_gs,max_gs,max_bin,extra", DIGEST_CASES)
def test_histogram_digest_matches_jax(iupac, p, min_gs, max_gs, max_bin, extra):
    k = 9
    sba, seg_starts = _genome(iupac, seed=11 + p)
    records = [(f"r{i}", r.decode()) for i, r in enumerate(sba.tobytes().split(b"$"))]
    sc = SequenceCollection(sequence_list=records, device="cpu")
    km = Kmers(sc, k, k)
    km.sort()
    sorted_pos = km.kmer_sba_start_indices.astype(np.uint32)
    pos, pad = _layout(sorted_pos, p, seed=p)
    jm, tm = jp.make_mesh(p), tp.make_mesh(devices=["cpu"] * p)
    (j_starts, j_ends), _ = _geometry(sba, seg_starts)
    dc = sc.device_cache("forward")
    j_packs = ((None, jkeys.pack_rank2_words(jnp.asarray(sba))) if not iupac
               else (jkeys.pack_rank_words(jnp.asarray(sba)), None))
    t_packs = (None, dc.packed2) if not iupac else (dc.packed, None)
    j_kw, t_kw = {}, {}
    rng = np.random.default_rng(p + 7)
    if extra == "mask":
        mask = rng.random(pos.shape) < 0.6
        j_kw["mask"], t_kw["mask"] = _sharded(jm, mask), list(torch.from_numpy(mask))
    elif extra == "strand_split":
        split = int(sorted_pos[len(sorted_pos) // 2])
        j_kw["strand_split"] = t_kw["strand_split"] = split
    elif extra == "ext_gid":
        strings = [sba[q : q + k].tobytes() for q in sorted_pos]
        gid = np.cumsum([True] + [a != b for a, b in zip(strings[1:], strings[:-1])])
        gids = np.zeros(pos.shape, dtype=np.uint32)
        gids[~pad] = gid  # the shards hold the sorted rows in order
        j_kw["ext_gid"] = _sharded(jm, gids)
        t_kw["ext_gid"] = list(torch.from_numpy(gids.astype(np.int64)))
    kmer_len = None if extra == "ext_gid" else k
    common = dict(min_group_size=min_gs, max_group_size=max_gs, max_counts_bin=max_bin)
    j_counts, j_total, j_hi = jp.distributed_group_size_histogram_ragged(
        j_packs[0], _sharded(jm, pos), _sharded(jm, pad.astype(np.uint32)), j_starts, j_ends,
        kmer_len, jm, packed2=j_packs[1], return_digest=True, **common, **j_kw)
    t_args = (t_packs[0], list(torch.from_numpy(pos.astype(np.int64))), list(torch.from_numpy(pad)),
              dc.seg_starts, dc.seg_ends, kmer_len, tm)
    counts, total, hi = tp.distributed_group_size_histogram_ragged(
        *t_args, packed2=t_packs[1], return_digest=True, **common, **t_kw)
    assert np.array_equal(counts.numpy(), np.asarray(j_counts).astype(np.int64))
    assert total == int(j_total)
    assert hi.dtype == torch.int64 and hi.shape == () and hi.device == tm.devices[0]
    assert int(hi) == int(j_hi)
    nonzero = np.flatnonzero(counts.numpy())
    assert int(hi) == (int(nonzero[-1]) if len(nonzero) else 0)
    # without the digest: the same counts and total; return_sizes first
    plain = tp.distributed_group_size_histogram_ragged(
        *t_args, packed2=t_packs[1], **common, **t_kw)
    assert len(plain) == 2 and torch.equal(plain[0], counts) and plain[1] == total
    # return_sizes: the JAX digest [total, unclipped largest size, speculative counts]
    j_digest = jp.distributed_group_size_histogram_ragged(
        j_packs[0], _sharded(jm, pos), _sharded(jm, pad.astype(np.uint32)), j_starts, j_ends,
        kmer_len, jm, packed2=j_packs[1], return_digest=True, return_sizes=True, **common,
        **j_kw)[2]
    sizes = tp.distributed_group_size_histogram_ragged(
        *t_args, packed2=t_packs[1], return_digest=True, return_sizes=True, **common, **t_kw)
    assert len(sizes) == 3 and len(sizes[0]) == p
    digest = sizes[2]
    assert digest.dtype == torch.int64 and digest.device == tm.devices[0]
    assert np.array_equal(digest.numpy(), np.asarray(j_digest).astype(np.int64))
    assert int(digest[0]) == total


def test_histogram_digest_without_a_qualifying_group():
    sba, seg_starts = _genome(False)
    records = [(f"r{i}", r.decode()) for i, r in enumerate(sba.tobytes().split(b"$"))]
    sc = SequenceCollection(sequence_list=records, device="cpu")
    km = Kmers(sc, 9, 9)
    km.sort()
    pos, pad = _layout(km.kmer_sba_start_indices.astype(np.uint32), 2, seed=0)
    dc = sc.device_cache("forward")
    counts, total, hi = tp.distributed_group_size_histogram_ragged(
        None, list(torch.from_numpy(pos.astype(np.int64))), list(torch.from_numpy(pad)),
        dc.seg_starts, dc.seg_ends, 9, tp.make_mesh(devices=["cpu"] * 2), min_group_size=10**6,
        packed2=dc.packed2, return_digest=True)
    assert int(counts.sum()) == total == int(hi) == 0


# --------------------------------------------------------------------------- #
# ops.groups and ops.filters
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_fold_err_conditions_with_valid_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    positions = rng.permutation(1000)[:n].astype(np.int64)
    errs = [rng.random(n) < rate for rate in (0.05, 0.1, 0.0)]
    for valid in (rng.random(n) < 0.5, np.zeros(n, dtype=bool), np.ones(n, dtype=bool)):
        want = [int(x) for x in jg.fold_err_conditions(
            [jnp.asarray(e) for e in errs], jnp.asarray(positions.astype(np.uint32)),
            valid=jnp.asarray(valid))]
        got = tg.fold_err_conditions([torch.from_numpy(e) for e in errs],
                                     torch.from_numpy(positions), valid=torch.from_numpy(valid))
        assert got.tolist() == want
        masked = tg.fold_err_conditions([torch.from_numpy(e & valid) for e in errs],
                                        torch.from_numpy(positions))
        assert torch.equal(got, masked)


def test_sizes_digest_uses_the_given_sizes():
    boundary = torch.tensor([True, False, True, True, False, False])
    size = tg.group_sizes_at_boundaries(boundary)
    got = tg.sizes_digest(boundary, size, 2, None)
    assert torch.equal(got[0], size) and got[1].tolist() == [True, False, False, True, False,
                                                              False] and got[2] == 5
    doubled = tg.sizes_digest(boundary, size * 2, 2, 4)
    assert doubled[1].tolist() == [True, False, True, False, False, False] and doubled[2] == 6


def test_filter_context_order_and_batchable():
    sba = np.frombuffer(b"ACGTACGT", dtype=np.uint8)
    pos = torch.arange(3)
    rows = torch.tensor([True, False, True])
    ctx = tf.FilterContext(sba, pos, torch.full((3,), 5), None, rows)
    assert ctx.valid_rows is rows and ctx._scans is None
    library = [tf.KeepAllFilter, tf.LengthFilter, tf.HomopolymerFilter, tf.GcContentFilter,
               tf.NoAmbiguousBasesFilter, tf.CrisprNggPamFilter, tf.VectorizedFilter]
    assert tf.KmerFilter.batchable is True
    assert all(issubclass(c, tf.KmerFilter) and c.batchable is True for c in library)
