"""The port's 64-bit regime, function by function, against the JAX package.

``ops/large.py``: the strided packs (native, plain and JAX), the
funnel-shift key words at several offsets (a Python int and a 0-dim
tensor), the two decodes, the dense positions and ``compute_valid_len64``
past 2^32; ``parallel/sample_sort.py``: the one-window large sample sort's
layout, lanes included, the canonical one, the refinement sort's rows and
run ids, ``distributed_adjacent_gids_large``; ``parallel/large.py``: the
statistics over each layout, with a survivor mask and a strand split. Then
a genome past 2^32 bases, the tiled design of
``tests/test_large.py::_tiled_past_2p32`` (a strided pack of 257 copies of
a 16 Mbp block, never an SBA), checked against a host oracle: the sort,
group statistics, a filter, queries, strings, canonical counts and a
checkpoint round trip.

Inputs are made from a seed with NumPy; meshes are CPU shards. Tolerance:
exact equality (integer outputs).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import large as jlarge
from genome_kmers_tpu.parallel import make_mesh as j_make_mesh
from genome_kmers_tpu.parallel import large as jplarge
from genome_kmers_tpu.parallel import sample_sort as jss
from genome_kmers_tpu_torch.ops import large as tlarge
from genome_kmers_tpu_torch.ops.encoding import RANK2_TABLE, RANK_TABLE
from genome_kmers_tpu_torch.parallel import large as tplarge
from genome_kmers_tpu_torch.parallel import make_mesh
from genome_kmers_tpu_torch.parallel import sample_sort as tss


def _genome(seed: int, n: int, cut: int, two_bit: bool):
    """An SBA of two segments split by '$' at ``cut``, with a repeated
    stretch so that groups of several k-mers and long ties exist."""
    rng = np.random.default_rng(seed)
    alpha = b"ACGT" if two_bit else b"ACGTNRY"
    sba = rng.choice(np.frombuffer(alpha, dtype=np.uint8), size=n)
    sba[n - 150 : n - 80] = sba[100:170]
    sba[cut] = ord("$")
    return (sba, np.array([0, cut + 1], dtype=np.uint64),
            np.array([cut - 1, n - 1], dtype=np.uint64))


def _pack(sba, two_bit):
    return tlarge.pack_rank2_strided_np(sba) if two_bit else tlarge.pack_rank_strided_np(sba)


def _tmesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread while these tests run: the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shards(x, n):
    return np.asarray(x).reshape(n, -1)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


# --------------------------------------------------------------------------- #
# ops/large.py
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 17, 5000])
@pytest.mark.parametrize("two_bit", [True, False])
def test_strided_packs_native_plain_and_jax(two_bit, n):
    """The native pack, its plain version and the JAX package's pack give
    the same words, the zero tail included (ACGT, IUPAC codes and '$')."""
    rng = np.random.default_rng(n)
    sba = rng.choice(np.frombuffer(b"ACGTNRYS$", dtype=np.uint8), size=n)
    if two_bit:
        got, want = tlarge.pack_rank2_strided_np(sba), jlarge.pack_rank2_strided_np(sba)
        plain = tlarge.pack_strided_plain(sba, 16, 2, RANK2_TABLE, 8)
    else:
        got, want = tlarge.pack_rank_strided_np(sba, 3), jlarge.pack_rank_strided_np(sba, 3)
        plain = tlarge.pack_strided_plain(sba, 8, 4, RANK_TABLE, 3)
    assert got.dtype == np.uint32 and np.array_equal(got, want) and np.array_equal(plain, want)


@pytest.mark.parametrize("offset", [0, 5, 64, "tensor"])
@pytest.mark.parametrize("two_bit", [True, False])
def test_funnel_words_match_jax(two_bit, offset):
    """Key words of every in-word phase, caps of every length (zero too),
    at a window offset given as an int or as a 0-dim tensor."""
    sba, starts, ends = _genome(3, 3000, 1200, two_bit)
    packed = _pack(sba, two_bit)
    pos = np.arange(0, 2900, dtype=np.uint64)
    cap = np.random.default_rng(1).integers(0, 70, size=pos.shape[0]).astype(np.uint32)
    k_off = 37 if offset == "tensor" else offset
    t_off = torch.tensor(37) if offset == "tensor" else offset
    n_words = 4 if two_bit else 5
    jfn = jlarge.build_key2_words_strided if two_bit else jlarge.build_key_words_strided
    tfn = tlarge.build_key2_words_strided if two_bit else tlarge.build_key_words_strided
    hi, lo = jlarge.split64_np(pos)
    want = jfn(jnp.asarray(packed), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cap), n_words,
               jnp.uint32(k_off))
    got = tfn(tss.words_tensor(packed), torch.from_numpy(pos.view(np.int64)),
              torch.from_numpy(cap.astype(np.int64)), n_words, t_off)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("two_bit", [True, False])
def test_decodes_match_jax(two_bit):
    sba, starts, ends = _genome(5, 2000, 900, two_bit)
    packed = _pack(sba, two_bit)
    pos = np.random.default_rng(2).integers(0, 1950, size=300).astype(np.uint64)
    assert np.array_equal(tlarge.decode_strided_np(packed, pos, 33, two_bit),
                          jlarge.decode_strided_np(packed, pos, 33, two_bit))
    lens = np.random.default_rng(3).integers(0, 50, size=300)
    got, want = (tlarge.decode_strided_var_np(packed, pos, lens, two_bit),
                 jlarge.decode_strided_var_np(packed, pos, lens, two_bit))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # the decode is the SBA itself
    assert tlarge.decode_strided_np(packed, pos[:5], 20, two_bit).tobytes() == b"".join(
        sba[int(p) : int(p) + 20].tobytes() for p in pos[:5])


@pytest.mark.parametrize("min_len", [1, 31, 200])
def test_dense_positions_and_valid_len64_match_jax(min_len):
    """Segments whose starts lie past 2^32: the dense start set (JAX (hi,
    lo) pairs fused) and the valid lengths, saturated as the JAX package's;
    a segment shorter than ``min_kmer_len`` raises its error."""
    starts = np.array([5, (1 << 32) - 100, (1 << 33) + 7], dtype=np.uint64)
    ends = starts + np.array([300, 260, 198], dtype=np.uint64)
    if min_len == 200:
        with pytest.raises(ValueError, match="at least one k-mer") as e:
            jlarge.build_dense_positions_pairs(starts, ends, min_len)
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            tlarge.build_dense_positions(starts, ends, min_len, device="cpu")
        ends[2] += 1
    (hi, lo), n = jlarge.build_dense_positions_pairs(starts, ends, min_len)
    got, n_t = tlarge.build_dense_positions(starts, ends, min_len, device="cpu")
    assert n_t == n and np.array_equal(_u64(got), jlarge.fuse64_np(np.asarray(hi), np.asarray(lo)))
    sh, sl = jlarge.split64_np(starts)
    eh, el = jlarge.split64_np(ends)
    want = jlarge.compute_valid_len64(hi, lo, *map(jnp.asarray, (sh, sl, eh, el)))
    vl = tlarge.compute_valid_len64(got, tss.int64_tensor(starts), tss.int64_tensor(ends))
    assert np.array_equal(vl.numpy(), np.asarray(want).astype(np.int64))
    # a segment longer than 2^32 saturates at NO_CAP, as the JAX package's
    big_end = np.array([(1 << 34)], dtype=np.uint64)
    vl = tlarge.compute_valid_len64(torch.tensor([3]), torch.tensor([0]), tss.int64_tensor(big_end))
    assert int(vl[0]) == tlarge.NO_CAP == 0xFFFFFFF0


# --------------------------------------------------------------------------- #
# the large sample sorts and statistics
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _sort_case(two_bit: bool, seed: int = 7):
    sba, starts, ends = _genome(seed, 2400, 1000, two_bit)
    rng = np.random.default_rng(seed)
    pos = rng.permutation(np.concatenate([np.arange(0, 1000), np.arange(1001, 2400)]))
    return _pack(sba, two_bit), starts, ends, pos.astype(np.uint64)


J_DEV = 2  # the JAX mesh of the references; the port runs on 1, 2 and 4 shards


def _stats_kwargs(variant, lanes, k, mask):
    if variant == "lanes":
        return {"sorted_words": lanes, "built_k": k}
    if variant == "mask":
        return {"mask": mask}
    return {}


@functools.lru_cache(maxsize=None)
def _jax_one_window(k: int, two_bit: bool):
    """The JAX package's one-window sort on ``J_DEV`` shards: per-shard
    positions (fused), pad flags and lanes, and its statistics at k - 5
    from the gathered words, from the lanes and under a survivor mask."""
    packed, starts, ends, pos = _sort_case(two_bit)
    jm = j_make_mesh(J_DEV)
    (hi, lo), pad, lanes = jss.sample_sort_positions_large_ragged(
        jnp.asarray(packed), pos, starts, ends, k, jm, two_bit=two_bit, return_lanes=True)
    fused = jlarge.fuse64_np(np.asarray(hi), np.asarray(lo))
    mask = jnp.asarray(fused % 3 != 0)
    stats = {}
    for variant in ("words", "lanes", "mask"):
        stats[variant] = jplarge.distributed_group_size_histogram_large_ragged(
            jnp.asarray(packed), hi, lo, pad, starts, ends, k - 5, jm, max_counts_bin=7,
            two_bit=two_bit, **_stats_kwargs(variant, lanes, k, mask))
    return (_shards(fused, J_DEV), _shards(pad, J_DEV) != 0,
            [_shards(w, J_DEV) for w in lanes], stats)


@pytest.mark.parametrize("k,two_bit", [(31, True), (55, True), (12, False)])
def test_large_sample_sort_layout_matches_jax(k, two_bit):
    """The one-window sort of shuffled positions: on the JAX package's mesh
    size each shard's positions, pad flags and key lanes (words, cap)
    equal its byte for byte, on every mesh the sorted rows do; the
    statistics over the layout, from the gathered words, from the lanes
    and with a survivor mask, equal the JAX package's."""
    packed, starts, ends, pos = _sort_case(two_bit)
    jpos, jpad, jlanes, jstats = _jax_one_window(k, two_bit)
    for n_dev in (1, 2, 4):
        tm = _tmesh(n_dev)
        tpos, tpad, tlanes = tss.sample_sort_positions_large_ragged(
            packed, pos, starts, ends, k, tm, two_bit=two_bit, return_lanes=True)
        assert np.array_equal(tss.large_rows(tpos, tpad), jpos[~jpad])
        if n_dev == J_DEV:
            for p in range(n_dev):
                assert np.array_equal(_u64(tpos[p]), jpos[p])
                assert np.array_equal(tpad[p].numpy(), jpad[p])
                assert len(tlanes[p]) == len(jlanes)
                for t, j in zip(tlanes[p], jlanes):
                    assert np.array_equal(_u32(t), j[p])
        mask = [torch.from_numpy(_u64(x) % 3 != 0) for x in tpos]
        for variant, want in jstats.items():
            got = tplarge.distributed_group_size_histogram_large_ragged(
                packed, tpos, tpad, starts, ends, k - 5, tm, max_counts_bin=7, two_bit=two_bit,
                **_stats_kwargs(variant, tlanes, k, mask))
            assert got[0].dtype == np.uint64 and np.array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("n_dev", [1, 3])
@pytest.mark.parametrize("two_bit", [True, False])
def test_canonical_large_sort_matches_jax(two_bit, n_dev):
    packed, starts, ends, pos = _sort_case(two_bit)
    k = 21 if two_bit else 11
    jm, tm = j_make_mesh(n_dev), _tmesh(n_dev)
    (hi, lo), jpad, jl = jss.sample_sort_canonical_large_ragged(
        jnp.asarray(packed), pos, starts, ends, k, jm, two_bit=two_bit)
    tpos, tpad, tl = tss.sample_sort_canonical_large_ragged(
        packed, pos, starts, ends, k, tm, two_bit=two_bit)
    jpos = _shards(jlarge.fuse64_np(np.asarray(hi), np.asarray(lo)), n_dev)
    for p in range(n_dev):
        assert np.array_equal(_u64(tpos[p]), jpos[p])
        for t, j in zip(tl[p], jl):
            assert np.array_equal(_u32(t), _shards(j, n_dev)[p])


@functools.lru_cache(maxsize=None)
def _jax_refinement(max_k, two_bit: bool):
    """The JAX package's refinement sort on ``J_DEV`` shards: per-shard
    positions, pad flags and run ids (fused), its row count a shard, and
    for kmer_len 70 and None the run ids of
    ``distributed_adjacent_gids_large`` and the statistics over them with a
    strand split."""
    packed, starts, ends, pos = _sort_case(two_bit)
    jm = j_make_mesh(J_DEV)
    g = jnp.asarray(packed)
    (hi, lo), pad, (ghi, glo) = jss.sample_sort_positions_large_unbounded(
        g, pos, starts, ends, jm, two_bit=two_bit, max_kmer_len=max_k)
    by_len = {}
    for kl in (70, None):
        gids = jss.distributed_adjacent_gids_large(g, hi, lo, pad, starts, ends, kl, jm,
                                                   two_bit=two_bit)
        stats = jplarge.distributed_group_size_histogram_large_ragged(
            g, hi, lo, pad, starts, ends, None, jm, max_counts_bin=9, two_bit=two_bit,
            ext_gid=gids, strand_split=1500)
        by_len[kl] = (_shards(jlarge.fuse64_np(*map(np.asarray, gids)), J_DEV), stats)
    fused = _shards(jlarge.fuse64_np(np.asarray(hi), np.asarray(lo)), J_DEV)
    return (fused, _shards(pad, J_DEV) != 0,
            _shards(jlarge.fuse64_np(np.asarray(ghi), np.asarray(glo)), J_DEV), by_len)


@pytest.mark.parametrize("max_k,two_bit", [(None, True), (45, False)])
def test_large_refinement_sort_matches_jax(max_k, two_bit):
    """Suffix mode and bounds beyond one window: the real rows and converged
    run ids equal the JAX package's in global order; each shard holds its
    real rows and one pad, round 0's rows by shard are the JAX package's
    large sample sort's at the first window, and every refinement round
    leaves each shard at most twice the mean rows (the port balances the
    rounds where the JAX package gathers them on shard 0, ROADMAP.md §C5);
    ``distributed_adjacent_gids_large`` over the layout gives the sort's
    run ids back at the sort's identity, and the JAX package's at 70 and
    None, and the statistics over them with a strand split equal its."""
    packed, starts, ends, pos = _sort_case(two_bit)
    jpos, jpad, jgid, by_len = _jax_refinement(max_k, two_bit)
    for n_dev in (1, 2, 4):
        tm = _tmesh(n_dev)
        info = {}
        tpos, tpad, tgid = tss.sample_sort_positions_large_unbounded(
            packed, pos, starts, ends, tm, two_bit=two_bit, max_kmer_len=max_k, info=info)
        assert info["rounds"] > 1
        assert all(x.shape[0] == int((~pad).sum()) + 1 and bool(pad[-1]) for x, pad in zip(tpos, tpad))
        assert np.array_equal(tss.large_rows(tpos, tpad), jpos[~jpad])
        assert np.array_equal(tss.large_rows(tgid, tpad), jgid[~jpad])
        assert all(max(rows) <= 2 * -(-len(pos) // n_dev) for rows in info["round_rows"][1:])
        if n_dev == J_DEV:
            (_, _), j0_pad = jss.sample_sort_positions_large_ragged(
                jnp.asarray(packed), pos, starts, ends, 64 if two_bit else 32, j_make_mesh(J_DEV),
                two_bit=two_bit)
            assert info["round_rows"][0] == [int((x == 0).sum()) for x in _shards(j0_pad, J_DEV)]
        again = tss.distributed_adjacent_gids_large(packed, tpos, tpad, starts, ends, max_k, tm,
                                                    two_bit=two_bit)
        assert all(torch.equal(a[:-1], g[:-1]) for a, g in zip(again, tgid))
        for kl, (want_g, want) in by_len.items():
            got_g = tss.distributed_adjacent_gids_large(packed, tpos, tpad, starts, ends, kl, tm,
                                                        two_bit=two_bit)
            assert np.array_equal(tss.large_rows(got_g, tpad), want_g[~jpad])
            got = tplarge.distributed_group_size_histogram_large_ragged(
                packed, tpos, tpad, starts, ends, None, tm, max_counts_bin=9, two_bit=two_bit,
                ext_gid=got_g, strand_split=1500)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_large_sort_rejects_what_jax_rejects():
    packed, starts, ends, pos = _sort_case(True)
    for args, kw in (((65,), {}), ((31,), {"canonical_k": 31})):
        with pytest.raises(Exception) as je:
            jss.sample_sort_positions_large_ragged(jnp.asarray(packed), pos, starts, ends,
                                                   *args, j_make_mesh(1), **kw)
        with pytest.raises(type(je.value), match=re.escape(str(je.value))):
            tss.sample_sort_positions_large_ragged(packed, pos, starts, ends, *args, _tmesh(1),
                                                   **kw)


# --------------------------------------------------------------------------- #
# past 2^32 bases: the tiled genome against a host oracle
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def big():
    """The design of tests/test_large.py::_tiled_past_2p32: a 16 Mbp ACGT
    block tiled 257 times (L = 4,311,744,512 > 2^32) as a strided pack,
    40,000 block offsets planted in 1-8 random tiles each (groups spanning
    2^32), shuffled, and the host oracle's 62-bit keys of k = 31."""
    rng = np.random.default_rng(11)
    block_len, tiles, k = 1 << 24, (1 << 8) + 1, 31
    block = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=block_len)
    block_words = tlarge.pack_rank2_strided_np(block, extra_words=0)
    genome_words = np.zeros(tiles * block_words.shape[0] + 8, dtype=np.uint32)
    genome_words[: tiles * block_words.shape[0]].reshape(tiles, -1)[:] = block_words
    offs = rng.choice(block_len - k, size=40_000, replace=False).astype(np.uint64)
    reps = rng.integers(1, 9, size=offs.shape[0])
    pos = np.concatenate([
        offs[i] + np.uint64(block_len) * rng.choice(tiles, size=r, replace=False).astype(np.uint64)
        for i, r in enumerate(reps)
    ])
    rng.shuffle(pos)
    ranks = RANK2_TABLE[block].astype(np.uint64)
    key = np.zeros(len(pos), dtype=np.uint64)
    base = pos % np.uint64(block_len)
    for j in range(k):
        key = (key << np.uint64(2)) | ranks[(base + np.uint64(j)) % np.uint64(block_len)]
    L = block_len * tiles
    assert L > 1 << 32 and int(np.sum(pos >= (1 << 32))) > 0
    order = np.lexsort((pos, key))
    return dict(block_len=block_len, L=L, k=k, ranks=ranks, words=genome_words, pos=pos,
                key=key, order=order)


def _oracle_hist(sizes, mings, maxgs, bins):
    q = (sizes >= mings) & (sizes <= maxgs)
    return np.bincount(np.minimum(sizes[q], bins), minlength=bins + 1).astype(np.uint64), int(sizes[q].sum())


def _group_sizes(sorted_keys):
    bnd = np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]])
    return np.diff(np.concatenate([np.flatnonzero(bnd), [len(sorted_keys)]]))


def test_sort_and_stats_past_2p32(big):
    """The large sample sort on 2 shards, then the statistics over its
    layout, against the host oracle (``np.lexsort`` of the keys and the
    positions)."""
    k, L, pos, key, order = big["k"], big["L"], big["pos"], big["key"], big["order"]
    starts, ends = np.array([0], dtype=np.uint64), np.array([L - 1], dtype=np.uint64)
    mesh = _tmesh(2)
    tpos, tpad = tss.sample_sort_positions_large_ragged(big["words"], pos, starts, ends, k, mesh)
    assert np.array_equal(tss.large_rows(tpos, tpad), pos[order])
    counts, total = tplarge.distributed_group_size_histogram_large_ragged(
        big["words"], tpos, tpad, starts, ends, k, mesh, min_group_size=2, max_group_size=100,
        max_counts_bin=10)
    want_counts, want_total = _oracle_hist(_group_sizes(key[order]), 2, 100, 10)
    assert np.array_equal(counts, want_counts) and total == want_total


def test_large_kmers_api_past_2p32(big, tmp_path):
    """Through ``LargeKmers`` on 2 shards: filtered statistics, queries of
    k-mers that lie past 2^32, their strings, canonical counts and a
    checkpoint restored onto one shard, each against the host oracle."""
    from genome_kmers_tpu_torch.ops.filters import gen_kmer_gc_content_filter_func

    k, L, B = big["k"], big["L"], big["block_len"]
    pos, key, ranks, order = big["pos"], big["key"], big["ranks"], big["order"]
    starts, ends = np.array([0], dtype=np.uint64), np.array([L - 1], dtype=np.uint64)
    lk = gt.LargeKmers(big["words"], starts, ends, k, k)
    lk.sort(_tmesh(2), positions=pos)
    assert np.array_equal(lk.sorted_positions(), pos[order])

    mn, mx = 10, 21  # GC counts in [10, 21] of k = 31
    base = pos % np.uint64(B)
    cs = np.concatenate([[0], np.cumsum(np.isin(ranks, (1, 2)).astype(np.int64))])
    gc = cs[(base + np.uint64(k)).astype(np.int64)] - cs[base.astype(np.int64)]
    surv_s = ((gc >= mn) & (gc <= mx))[order]
    ks = key[order]
    gid = np.cumsum(np.concatenate([[True], ks[1:] != ks[:-1]])) - 1
    want = _oracle_hist(np.bincount(gid, weights=surv_s).astype(np.int64), 1, 1 << 62, 10)
    f = gen_kmer_gc_content_filter_func((mn - 0.5) / k, (mx + 0.5) / k, k)
    counts, total = lk.get_kmer_group_counts(k, kmer_filter_func=f, max_counts_bin=10)
    assert np.array_equal(counts, want[0]) and total == want[1]

    hi_rows = np.flatnonzero(pos >= (1 << 32))[:3]
    inv = np.empty(len(pos), dtype=np.int64)
    inv[order] = np.arange(len(pos))
    strs = lk.get_kmer_strs(inv[hi_rows], k)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for row, s in zip(hi_rows, strs):
        b = int(pos[row] % np.uint64(B))
        assert s == lut[ranks[b : b + k].astype(np.int64)].tobytes().decode()
    assert lk.count_queries(strs, k).tolist() == [int(np.sum(key == key[r])) for r in hi_rows]

    rc_key, tmp = np.zeros(len(pos), dtype=np.uint64), key.copy()
    for _ in range(k):
        rc_key = (rc_key << np.uint64(2)) | ((tmp & np.uint64(3)) ^ np.uint64(3))
        tmp >>= np.uint64(2)
    sizes = np.unique(np.minimum(key, rc_key), return_counts=True)[1]
    cc, ct = lk.get_canonical_kmer_group_counts(k, max_counts_bin=10, positions=pos)
    want_c = _oracle_hist(sizes.astype(np.int64), 1, 1 << 62, 10)
    assert np.array_equal(cc, want_c[0]) and ct == want_c[1]

    lk.save_checkpoint(tmp_path / "big")
    lk2 = gt.LargeKmers(big["words"], starts, ends, k, k)
    lk2.load_checkpoint(tmp_path / "big", _tmesh(1))
    assert np.array_equal(lk2.sorted_positions(), pos[order])
    c2, t2 = lk2.get_kmer_group_counts(k, kmer_filter_func=f, max_counts_bin=10)
    assert np.array_equal(c2, counts) and t2 == total
