"""Count queries of the port against the JAX package, on the CPU.

The query encoders (4-bit and 2-bit words, and the first offending
query's message), the reverse complement of query strings, the module's
bound search on one packed genome, and ``Kmers.count_queries`` /
``count_queries_canonical`` on ACGT and IUPAC genomes, at a prefix
``kmer_len``, in suffix mode, on ``from_strand`` indexes (reverse
complement and both strands) and for every error, each against the JAX
package's ``Kmers`` on the same seeded genomes. Tolerance: exact equality,
dtypes included.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import encoding as jenc
from genome_kmers_tpu.ops import query as jq
from genome_kmers_tpu_torch.ops import encoding as tenc
from genome_kmers_tpu_torch.ops import query as tq

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"ABCDGHKMNRSTVWY", dtype=np.uint8)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _genome(rng, n, iupac):
    g = ACGT[rng.integers(0, 4, size=n)]
    for _ in range(4):  # repeats, so that queries have counts above 1
        length = int(rng.integers(10, min(80, n // 2)))
        src = int(rng.integers(0, n - length))
        for dst in rng.integers(0, n - length, size=3):
            g[dst : dst + length] = g[src : src + length]
    if iupac:
        g[rng.integers(0, n, size=n // 40)] = IUPAC[rng.integers(0, len(IUPAC), size=n // 40)]
        g[n // 3 : n // 3 + 40] = ord("N")
    return g.tobytes().decode()


def _seq_list(seed, iupac):
    rng = np.random.default_rng(seed)
    return [("a", _genome(rng, 1500, iupac)), ("b", _genome(rng, 60, iupac)),
            ("c", _genome(rng, 700, iupac))]


def _queries(seq_list, k, rng, n=150):
    """Strings of the genome (present) and random ones (mostly absent)."""
    sba = "$".join(s for _, s in seq_list)
    starts = rng.integers(0, len(sba) - k, size=n)
    out = [sba[p : p + k] for p in starts if "$" not in sba[p : p + k]]
    out += ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(20)]
    return out + ["N" * k, "A" * k]


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 17, 31, 33])
def test_encoders_match_jax(k):
    rng = np.random.default_rng(k)
    qs = ["".join(rng.choice(list("ACGT"), size=k)) for _ in range(40)]
    qs += ["".join(rng.choice(list("ABCDGHKMNRSTVWY"), size=k)) for _ in range(40)]
    got, want = tq.encode_query_words(qs, k), jq.encode_query_words(qs, k)
    assert len(got) == len(want) == -(-k // 8)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w)
    (got2, ok), (want2, ok_j) = tq.encode_query2_words(qs, k), jq.encode_query2_words(qs, k)
    assert np.array_equal(ok, ok_j) and ok.dtype == ok_j.dtype
    for g, w in zip(got2, want2):
        assert g.dtype == np.uint32 and np.array_equal(g, w)
    assert [len(w) for w in tq.encode_query_words([], k)] == [0] * -(-k // 8)


@pytest.mark.parametrize(
    "queries",
    [
        ["ACGT", "ACG", "AC$T"],  # a wrong length before a bad character
        ["ACGT", "AC$T", "ACG"],  # a bad character before a wrong length
        ["ACGT", "acgt"],  # lower case
        ["ACGT", "ACGé"],  # outside ASCII, as long as the others
        ["ACGT", "ACGéT"],
        ["ACGT", "NNNN", "ACGTA"],
        ["ACGT", "AXGT", "ACGU"],
    ],
)
def test_encoder_errors_name_the_first_offending_query(queries):
    for encode in ("encode_query_words", "encode_query2_words"):
        got = _outcome(lambda: getattr(tq, encode)(queries, 4))
        want = _outcome(lambda: getattr(jq, encode)(queries, 4))
        if isinstance(want, tuple) and isinstance(want[0], type):
            assert got == want
        else:
            assert all(np.array_equal(g, w) for g, w in zip(got[0], want[0]))
            assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("queries", [["ACGTRYKMBDHVNSW", "A"], ["AC$"], ["acg"], []])
def test_iupac_revcomp_strs_matches_jax(queries):
    assert _outcome(lambda: tenc.iupac_revcomp_strs(queries)) == _outcome(
        lambda: jenc.iupac_revcomp_strs(queries)
    )


# --------------------------------------------------------------------------- #
# the bound search
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("k", [3, 12, 40])
def test_module_count_queries_matches_jax(k):
    """The same packed genome, sorted positions and caps on both sides."""
    import jax.numpy as jnp

    from genome_kmers_tpu.ops.keys import pack_rank_words as jax_pack

    seqs = _seq_list(5, iupac=True)
    jsc = gj.SequenceCollection(sequence_list=seqs)
    jk = gj.Kmers(jsc, 1, None)
    jk.sort()
    pos = jk.kmer_sba_start_indices.astype(np.int64)
    sba = jsc.forward_sba
    starts = jsc._forward_sba_seg_starts.astype(np.int64)
    ends = np.concatenate([starts[1:] - 2, [len(sba) - 1]])
    cap = np.minimum(ends[np.searchsorted(starts, pos, side="right") - 1] - pos + 1, k)
    q_words = jq.encode_query_words(_queries(seqs, k, np.random.default_rng(k)), k)
    want = jq.count_queries(jax_pack(jnp.asarray(sba)), jnp.asarray(pos.astype(np.uint32)),
                            jnp.asarray(cap.astype(np.uint32)), q_words, k)
    packed = gt.ops.keys.pack_rank_words(torch.from_numpy(sba))
    got = tq.count_queries(packed, torch.from_numpy(pos), torch.from_numpy(cap), q_words, k)
    assert got.dtype == np.uint32 and np.array_equal(got, want) and want.max() > 1
    empty = tq.count_queries(packed, torch.zeros(0, dtype=torch.int64), torch.zeros(0), q_words, k)
    assert np.array_equal(empty, np.zeros(len(q_words[0]), dtype=np.uint32))


# --------------------------------------------------------------------------- #
# Kmers.count_queries / count_queries_canonical
# --------------------------------------------------------------------------- #


def _pair(seqs, mn, mx, strands="forward"):
    jsc = gj.SequenceCollection(sequence_list=seqs, strands_to_load=strands)
    tsc = gt.SequenceCollection(sequence_list=seqs, strands_to_load=strands, device="cpu")
    if strands == "forward":
        jk, tk = gj.Kmers(jsc, mn, mx), gt.Kmers(tsc, mn, mx)
    else:
        jk = gj.Kmers.from_strand(jsc, mn, mx, source_strand=strands)
        tk = gt.Kmers.from_strand(tsc, mn, mx, source_strand=strands)
    jk.sort()
    tk.sort()
    return jk, tk


@pytest.mark.parametrize(
    "iupac,mn,mx,ks",
    [
        (False, 31, 31, (31,)),
        (False, 12, 40, (12, 20, 40)),  # prefixes of the compare length
        (False, 1, None, (5, 31)),  # suffix mode
        (True, 31, 31, (31,)),
        (True, 5, 24, (5, 24)),
        (True, 1, None, (5, 31)),
    ],
)
def test_count_queries_match_jax(iupac, mn, mx, ks):
    seqs = _seq_list(11 + iupac, iupac)
    jk, tk = _pair(seqs, mn, mx)
    rng = np.random.default_rng(mn)
    for k in ks:
        qs = _queries(seqs, k, rng)
        got, want = tk.count_queries(qs, k), jk.count_queries(qs, k)
        assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)
        assert want.max() > 1
        got, want = tk.count_queries_canonical(qs, k), jk.count_queries_canonical(qs, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    qs = _queries(seqs, ks[0], rng, n=20)
    assert np.array_equal(tk.count_queries(qs), jk.count_queries(qs))  # kmer_len from the first


@pytest.mark.parametrize("strands", ["reverse_complement", "both"])
def test_count_queries_on_from_strand_indexes_match_jax(strands):
    seqs = _seq_list(3, iupac=True)
    jk, tk = _pair(seqs, 8, 8, strands)
    qs = _queries(seqs, 8, np.random.default_rng(8))
    assert np.array_equal(tk.count_queries(qs, 8), jk.count_queries(qs, 8))
    got = _outcome(lambda: tk.count_queries_canonical(qs, 8))
    want = _outcome(lambda: jk.count_queries_canonical(qs, 8))
    if strands == "both":
        assert got == want and want[0] is NotImplementedError
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "call",
    [
        lambda k: k.count_queries(["ACG"], 3),  # not sorted
        lambda k: (k.sort(), k.count_queries([], 3))[1].tolist(),
        lambda k: (k.sort(), k.count_queries(["AC"], 0)),
        lambda k: (k.sort(), k.count_queries(["ACG", "AC"], 3)),
        lambda k: (k.sort(), k.count_queries(["ACG", "AcG"], 3)),
        lambda k: (k.sort(), k.count_queries_canonical(["ACG", "AcG"], 3)),
        lambda k: (k.sort(), k.count_queries_canonical(["ACG", "A$G"], 3)),
        lambda k: k.count_queries_canonical(["ACG"], 3),  # not sorted
        lambda k: k.count_queries_canonical([], 3).tolist(),
    ],
)
def test_count_query_errors_match_jax(call):
    seqs = [("a", "ACGTACGTTTGA"), ("b", "CCGTANNA")]
    got = _outcome(lambda: call(gt.Kmers(gt.SequenceCollection(sequence_list=seqs, device="cpu"), 3, 5)))
    want = _outcome(lambda: call(gj.Kmers(gj.SequenceCollection(sequence_list=seqs), 3, 5)))
    assert got == want


def test_count_queries_over_a_mesh_are_not_ported():
    """Once refused naming A11, the mesh queries are ported: over a mesh of
    the CPU they count as the single device does (tests/test_torch_mesh.py
    holds them against the JAX package's)."""
    from genome_kmers_tpu_torch.parallel import make_mesh

    tk = gt.Kmers(gt.SequenceCollection(sequence_list=[("a", "ACGTACGTTTGA")], device="cpu"), 3, 3)
    tk.sort()
    mesh = make_mesh(devices=["cpu"] * 3)
    qs = ["ACG", "CGT", "TTG", "GGG"]
    assert np.array_equal(tk.count_queries(qs, mesh=mesh), tk.count_queries(qs))
    assert np.array_equal(tk.count_queries_canonical(qs, mesh=mesh), tk.count_queries_canonical(qs))


def test_count_queries_on_an_assigned_sorted_index_match_jax():
    """A subset index, assigned then sorted (the gather sort)."""
    seqs = _seq_list(21, iupac=False)
    jsc = gj.SequenceCollection(sequence_list=seqs)
    tsc = gt.SequenceCollection(sequence_list=seqs, device="cpu")
    jk, tk = gj.Kmers(jsc, 6, 10), gt.Kmers(tsc, 6, 10)
    subset = jk.kmer_sba_start_indices[::3][::-1].copy()
    jk.kmer_sba_start_indices, tk.kmer_sba_start_indices = subset.copy(), subset.copy()
    jk.sort()
    tk.sort()
    qs = _queries(seqs, 6, np.random.default_rng(6))
    assert np.array_equal(tk.count_queries(qs, 6), jk.count_queries(qs, 6))
    assert np.array_equal(tk.count_queries_canonical(qs, 6), jk.count_queries_canonical(qs, 6))
