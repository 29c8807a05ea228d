"""Canonical k-mer keys and statistics of the port against the JAX package,
on the CPU.

``revcomp_key_words`` (2-bit) and ``revcomp_key_words4`` (4-bit) at every
word-boundary case of k, ``canonical_key_words``, ``canonical_sort`` and
``canonical_boundaries``, the gather digests, and
``Kmers.get_canonical_kmer_group_counts`` on the dense route (the fresh
index) and the gather route (sorted, assigned and reverse-complement
indexes), 2-bit keys up to k = 64 and 4-bit keys up to k = 32, with the
JAX package's errors. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import canonical as jcan
from genome_kmers_tpu.ops.keys import pack_rank2_words as jax_pack2
from genome_kmers_tpu_torch.ops import canonical as tcan
from genome_kmers_tpu_torch.ops.keys import pack_rank2_words, widen_u32

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"ABCDGHKMNRSTVWY", dtype=np.uint8)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _genome(rng, n, iupac):
    g = ACGT[rng.integers(0, 4, size=n)]
    for _ in range(4):  # copies and reverse-complement copies: canonical groups
        length = int(rng.integers(10, min(80, n // 2)))
        src = int(rng.integers(0, n - length))
        seg = g[src : src + length].copy()
        for j, dst in enumerate(rng.integers(0, n - length, size=3)):
            g[dst : dst + length] = seg if j % 2 else gt.ops.encoding.COMPLEMENT_TABLE[seg[::-1]]
    if iupac:
        g[rng.integers(0, n, size=n // 40)] = IUPAC[rng.integers(0, len(IUPAC), size=n // 40)]
        g[n // 3 : n // 3 + 40] = ord("N")
    return g.tobytes().decode()


def _seq_list(seed, iupac):
    rng = np.random.default_rng(seed)
    return [("a", _genome(rng, 1500, iupac)), ("b", _genome(rng, 70, iupac)),
            ("c", _genome(rng, 600, iupac))]


# --------------------------------------------------------------------------- #
# reverse complement of key words
# --------------------------------------------------------------------------- #


def _random_words(rng, k, per_word, n=300):
    """Left-justified words of k random fields, the rest zero."""
    n_words = -(-k // per_word)
    bits = 32 // per_word
    fields = rng.integers(0, 1 << bits, size=(n, n_words * per_word), dtype=np.uint64)
    if bits == 4:
        fields = np.where(fields == 0, 1, fields)  # rank 0 is '$', never inside a k-mer
    fields[:, k:] = 0
    shifts = np.arange(bits * (per_word - 1), -1, -bits, dtype=np.uint64)
    words = (fields.reshape(n, n_words, per_word) << shifts).sum(axis=2).astype(np.uint32)
    return tuple(np.ascontiguousarray(words[:, w]) for w in range(n_words))


def _as_torch(words):
    return tuple(widen_u32(torch.from_numpy(w.view(np.int32))) for w in words)


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32, 33, 63, 64])
def test_revcomp_key_words_matches_jax(k):
    words = _random_words(np.random.default_rng(k), k, 16)
    got = tcan.revcomp_key_words(_as_torch(words), k)
    want = jcan.revcomp_key_words(tuple(jnp.asarray(w) for w in words), k)
    assert all(g.dtype == torch.int64 for g in got)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
    # an involution on full-length keys
    twice = tcan.revcomp_key_words(got, k)
    assert all(torch.equal(a, b) for a, b in zip(twice, _as_torch(words)))


@pytest.mark.parametrize("k", [1, 7, 8, 9, 15, 16, 17, 31, 32])
def test_revcomp_key_words4_matches_jax(k):
    words = _random_words(np.random.default_rng(100 + k), k, 8)
    got = tcan.revcomp_key_words4(_as_torch(words), k)
    want = jcan.revcomp_key_words4(tuple(jnp.asarray(w) for w in words), k)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("k", [5, 31, 40])
def test_canonical_key_words_sort_and_boundaries_match_jax(k):
    seqs = _seq_list(7, iupac=False)
    sba = np.frombuffer("$".join(s for _, s in seqs).encode(), dtype=np.uint8).copy()
    starts = np.cumsum([0] + [len(s) + 1 for _, s in seqs[:-1]])
    pos = np.concatenate([np.arange(s, s + len(q) - k + 1) for s, (_, q) in zip(starts, seqs)])
    pos = np.random.default_rng(k).permutation(pos).astype(np.int64)
    tpacked, jpacked = pack_rank2_words(torch.from_numpy(sba)), jax_pack2(jnp.asarray(sba))
    got = tcan.canonical_key_words(tpacked, torch.from_numpy(pos), k)
    want = jcan.canonical_key_words(jpacked, jnp.asarray(pos.astype(np.uint32)), k)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
    t_pos, t_words = tcan.canonical_sort(tpacked, torch.from_numpy(pos), k)
    j_pos, j_words = jcan.canonical_sort(jpacked, jnp.asarray(pos.astype(np.uint32)), k)
    assert np.array_equal(t_pos.numpy(), np.asarray(j_pos))
    for g, w in zip(t_words, j_words):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))
    boundary = tcan.canonical_boundaries(t_words)
    assert np.array_equal(boundary.numpy(), np.asarray(jcan.canonical_boundaries(j_words)))
    assert 0 < int(boundary.sum()) < len(pos)


@pytest.mark.parametrize("iupac", [False, True])
def test_gather_digest_matches_jax(iupac):
    """Sizes, qualifying mask and total of the gather digest, over positions
    that include rows shorter than k."""
    from genome_kmers_tpu.ops.keys import pack_rank_words as jax_pack4

    k = 20
    seqs = _seq_list(9 + iupac, iupac)
    sba = np.frombuffer("$".join(s for _, s in seqs).encode(), dtype=np.uint8).copy()
    seg = np.cumsum([0] + [len(s) + 1 for _, s in seqs[:-1]])
    ends = np.concatenate([seg[1:] - 2, [len(sba) - 1]])
    pos = np.concatenate([np.arange(s, e + 1) for s, e in zip(seg, ends)]).astype(np.int64)
    vl = ends[np.searchsorted(seg, pos, side="right") - 1] - pos + 1
    if iupac:
        tpacked = gt.ops.keys.pack_rank_words(torch.from_numpy(sba))
        size, qualifies, total = tcan.canonical_sizes_digest4(
            tpacked, torch.from_numpy(pos), torch.from_numpy(vl), k)
        j = jcan.canonical_sizes_digest4(jax_pack4(jnp.asarray(sba)), jnp.asarray(pos.astype(np.uint32)),
                                         jnp.asarray(vl.astype(np.uint32)), k)
    else:
        tpacked = pack_rank2_words(torch.from_numpy(sba))
        size, qualifies, total = tcan.canonical_sizes_digest(
            tpacked, torch.from_numpy(pos), torch.from_numpy(vl), k)
        j = jcan.canonical_sizes_digest(jax_pack2(jnp.asarray(sba)), jnp.asarray(pos.astype(np.uint32)),
                                        jnp.asarray(vl.astype(np.uint32)), k)
    assert np.array_equal(size.numpy(), np.asarray(j[0]).astype(np.int64))
    assert np.array_equal(qualifies.numpy(), np.asarray(j[1]))
    assert total == int(np.asarray(j[2])[0]) == int((vl >= k).sum())


# --------------------------------------------------------------------------- #
# Kmers.get_canonical_kmer_group_counts
# --------------------------------------------------------------------------- #


def _both(seqs, mn, mx, strands="forward"):
    jsc = gj.SequenceCollection(sequence_list=seqs, strands_to_load=strands)
    tsc = gt.SequenceCollection(sequence_list=seqs, strands_to_load=strands, device="cpu")
    if strands == "forward":
        return gj.Kmers(jsc, mn, mx), gt.Kmers(tsc, mn, mx)
    return (gj.Kmers.from_strand(jsc, mn, mx, source_strand=strands),
            gt.Kmers.from_strand(tsc, mn, mx, source_strand=strands))


def _same_counts(jk, tk, k, max_counts_bin=60):
    want = jk.get_canonical_kmer_group_counts(k, max_counts_bin=max_counts_bin)
    got = tk.get_canonical_kmer_group_counts(k, max_counts_bin=max_counts_bin)
    assert got[0].dtype == np.int64 and got[0].shape == (max_counts_bin + 1,)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] and isinstance(got[1], int)
    return got


@pytest.mark.parametrize(
    "iupac,mn,mx,ks",
    [
        (False, 1, None, (1, 16, 31, 33, 64)),
        (False, 20, 31, (20, 31, 40)),
        (True, 1, 32, (1, 8, 17, 31, 32)),
        (True, 12, None, (12, 31)),
    ],
)
def test_canonical_counts_dense_and_gather_routes_match_jax(iupac, mn, mx, ks):
    seqs = _seq_list(31 + iupac, iupac)
    jk, tk = _both(seqs, mn, mx)
    for k in ks:
        assert tk._init_geometry is not None  # the dense route
        dense = _same_counts(jk, tk, k)
        assert dense[0][2:].sum() > 0
    jk.sort()
    tk.sort()
    for k in ks:
        assert tk._init_geometry is None  # the gather route
        assert np.array_equal(_same_counts(jk, tk, k)[0], _same_counts(gj.Kmers(jk.seq_coll, mn, mx),
                                                                       tk, k)[0])
    assert _same_counts(jk, tk, ks[-1], max_counts_bin=1)[0].shape == (2,)


@pytest.mark.parametrize("strands", ["forward", "reverse_complement"])
def test_canonical_counts_on_assigned_and_strand_indexes_match_jax(strands):
    """An assigned descending subset (unsorted, gather route), and the
    reverse-complement index, whose canonical histogram is the forward one."""
    seqs = _seq_list(41, iupac=True)
    jk, tk = _both(seqs, 10, 20, strands)
    subset = jk.kmer_sba_start_indices[::2][::-1].copy()
    jk.kmer_sba_start_indices, tk.kmer_sba_start_indices = subset.copy(), subset.copy()
    _same_counts(jk, tk, 10)
    fwd = _both(seqs, 10, 20)[1]
    assert np.array_equal(_both(seqs, 10, 20, strands)[1].get_canonical_kmer_group_counts(10)[0],
                          fwd.get_canonical_kmer_group_counts(10)[0])


@pytest.mark.parametrize(
    "seqs,strands,call",
    [
        ([("a", "ACGTACGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(0)),
        ([("a", "ACGTACGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(65)),
        ([("a", "ACGTACGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(None)),
        ([("a", "ACGTNCGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(33)),
        ([("a", "ACGTNCGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(32)[1]),
        ([("a", "ACGTACGTTTGA")], "forward",
         lambda k: k.get_canonical_kmer_group_counts(3, max_counts_bin=0)),
        ([("a", "ACGTACGTTTGA")], "both", lambda k: k.get_canonical_kmer_group_counts(3)),
        ([("a", "ACGTACGTTTGA")], "forward", lambda k: k.get_canonical_kmer_group_counts(13)[1]),
    ],
)
def test_canonical_count_errors_match_jax(seqs, strands, call):
    jk, tk = _both(seqs, 3, 5, strands)
    assert _outcome(lambda: call(tk)) == _outcome(lambda: call(jk))


def test_canonical_counts_over_a_mesh_are_not_ported():
    """Once refused naming A11, canonical statistics on a mesh are ported:
    on the dense and the gather route, over a 1-D and a 2-D mesh of CPU
    shards, they equal the JAX package's single-device counts (more in
    tests/test_torch_mesh_unbounded.py)."""
    from genome_kmers_tpu_torch import parallel as tp

    seqs = [("a", "ACGTACGTTTGACGTACGT"), ("b", "TTGACGTANNACGTCAAC")]
    for mesh in (tp.make_mesh(devices=["cpu"] * 3), tp.make_mesh2(2, 2, devices=["cpu"] * 4)):
        jk, tk = _both(seqs, 3, 5)
        for _ in range(2):  # the fresh index (dense route), then the sorted one
            want = jk.get_canonical_kmer_group_counts(3)
            got = tk.get_canonical_kmer_group_counts(3, mesh=mesh)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]
            jk.sort()
            tk.sort()
