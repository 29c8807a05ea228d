"""The port's filter module (``genome_kmers_tpu_torch/ops/filters.py``) and
the filtered group statistics of ``ops/groups.py`` against the JAX package,
function by function, on the CPU.

The SWAR popcount against ``np.bitwise_count``; each genome scan of the
device cache (``gc_cumsum``, ``run_len``, ``next_amb``, ``is_dollar``,
``valid_len_genome``) and of the byte SBA; each filter's flag plane; each
``*_lanes_flags{2,4}`` on the same sorted lanes (mask and raise conditions,
the lanes in both of the port's forms); the scalar ``__call__`` of every
filter at every position, including which ValueError fires first;
``VectorizedFilter`` with one mask written once in jnp and once in torch;
the survivor sizes and the error fold; the reference's host walk API. The
states are carried over with ``interop.from_numpy_state``. Tolerance:
exact equality, and the same exception type and message.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu.ops import groups as jg
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.ops import groups as tg
from genome_kmers_tpu_torch.ops.keys import u32_bits_as_int32

BIG = 0xFFFFFFF0  # the JAX package's next_amb sentinel


def _random_seq(rng, n, alphabet):
    return "".join(rng.choice(list(alphabet), n))


def _genomes():
    """The genomes of tests/test_lanes_filters.py (seed 11)."""
    rng = np.random.default_rng(11)
    yield "acgt-multi", [
        ("r1", _random_seq(rng, 220, "ACGT")),
        ("r2", _random_seq(rng, 41, "ACGT")),
        ("r3", _random_seq(rng, 64, "ACGT")),
    ]
    g = list(_random_seq(rng, 170, "ACGT"))
    g[50:61] = "N" * 11
    yield "n-runs", [("r1", "".join(g)), ("r2", _random_seq(rng, 33, "ACGTN"))]
    yield "iupac", [
        ("r1", _random_seq(rng, 130, "ACGTRYSWKMBDHVN")),
        ("r2", _random_seq(rng, 27, "ACGT")),
    ]
    yield "tiny-segments", [
        ("r1", "A"),
        ("r2", "GGGGGGGGGGGGGGGGGGGGGGGGGG"),
        ("r3", _random_seq(rng, 56, "ACGT")),
        ("r4", "C"),
    ]


GENOMES = dict(_genomes())


def _filters(m):
    """The filter list of tests/test_lanes_filters.py, built from module
    ``m`` (the JAX package's filters or the port's)."""
    yield "gc-mid", m.GcContentFilter(0.3, 0.7, 11), 11
    yield "gc-word-edge16", m.GcContentFilter(0.25, 0.75, 16), 16
    yield "gc-word-edge8", m.GcContentFilter(0.25, 0.75, 8), 8
    yield "gc-impossible", m.GcContentFilter(0.49, 0.50, 3), 3
    yield "gc-k1", m.GcContentFilter(0.0, 1.0, 1), 1
    yield "noamb", m.NoAmbiguousBasesFilter(9), 9
    yield "noamb-k16", m.NoAmbiguousBasesFilter(16), 16
    yield "len-small", m.LengthFilter(5), 5
    yield "len-big", m.LengthFilter(20), 20
    yield "crispr", m.CrisprNggPamFilter(), 23
    yield "homopoly-2", m.HomopolymerFilter(2, 12), 12
    yield "homopoly-1", m.HomopolymerFilter(1, 9), 9
    yield "homopoly-3", m.HomopolymerFilter(3, 16), 16
    yield "homopoly-short-circuit", m.HomopolymerFilter(30, 6), 6
    yield "homopoly-edge", m.HomopolymerFilter(7, 8), 8


FILTER_NAMES = [name for name, _, _ in _filters(tf)]


def _filter_pair(name):
    (j,) = [f for n, f, _ in _filters(jf) if n == name]
    (t,) = [f for n, f, _ in _filters(tf) if n == name]
    return j, t


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _collections(gname):
    """(JAX collection, the port's collection from its host state)."""
    jsc = gj.SequenceCollection(sequence_list=GENOMES[gname])
    tsc, _ = from_numpy_state(jsc.forward_sba, jsc._forward_sba_seg_starts,
                              jsc.forward_record_names, 1, None, device="cpu")
    return jsc, tsc


# --------------------------------------------------------------------------- #
# popcount
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popcount32_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0xAAAAAAAA]
    got = tf.popcount32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.bitwise_count(x).astype(np.int64))


# --------------------------------------------------------------------------- #
# genome scans and flag planes
# --------------------------------------------------------------------------- #

SCANS = ["gc_cumsum", "run_len", "next_amb", "is_dollar", "valid_len_genome"]


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("gname", list(GENOMES))
def test_device_cache_scans_match_jax(gname, scan):
    jsc, tsc = _collections(gname)
    want = np.asarray(getattr(jsc.device_cache("forward"), scan)).astype(np.int64)
    got = getattr(tsc.device_cache("forward"), scan).numpy().astype(np.int64)
    if scan == "next_amb":
        want = np.where(want == BIG, tf._NO_AMB, want)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("scan", ["_gc_cumsum", "_run_lengths", "_next_ambiguous"])
@pytest.mark.parametrize("gname", list(GENOMES))
def test_byte_scans_match_jax(gname, scan):
    jsc, _ = _collections(gname)
    sba = jsc.forward_sba
    want = np.asarray(getattr(jf, scan)(sba)).astype(np.int64)
    got = getattr(tf, scan)(torch.from_numpy(sba)).numpy().astype(np.int64)
    if scan == "_next_ambiguous":
        want = np.where(want == BIG, tf._NO_AMB, want)
    assert np.array_equal(got, want)


PLANE_FILTERS = ["gc-mid", "gc-word-edge16", "gc-k1", "noamb", "noamb-k16", "crispr",
                 "homopoly-2", "homopoly-1", "homopoly-edge"]


@pytest.mark.parametrize("fname", PLANE_FILTERS)
@pytest.mark.parametrize("gname", list(GENOMES))
def test_flag_planes_match_jax(gname, fname):
    jsc, tsc = _collections(gname)
    jfil, tfil = _filter_pair(fname)
    (jkey, jbuild), (tkey, tbuild) = jfil._plane_spec(), tfil._plane_spec()
    assert jkey == tkey
    want = np.asarray(jbuild(jsc.device_cache("forward")))
    got = tbuild(tsc.device_cache("forward"))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_short_circuit_homopolymer_has_no_plane():
    jfil, tfil = _filter_pair("homopoly-short-circuit")
    assert jfil._plane_spec() is None and tfil._plane_spec() is None


# --------------------------------------------------------------------------- #
# lanes flags
# --------------------------------------------------------------------------- #


def _port_lanes(jlanes, int32_words: bool):
    """The JAX lanes as the port holds them: int64 lanes of uint32 values
    (the 2-bit dense sort) or int32 bit patterns (every other lane)."""
    words = [torch.from_numpy(np.asarray(w).astype(np.int64)) for w in jlanes["words"]]
    if int32_words:
        words = [u32_bits_as_int32(w) for w in words]
    cap = None if jlanes["cap"] is None else torch.from_numpy(np.asarray(jlanes["cap"]).astype(np.int64))
    return {"two_bit": jlanes["two_bit"], "built_k": jlanes["built_k"], "words": tuple(words),
            "cap": cap}


LANES_CASES = [
    (gname, min_k, max_k)
    for gname, seq_list in GENOMES.items()
    for min_k, max_k in [(1, 31), (11, 11), (23, 32), (1, 16)]
    if min_k <= min(len(s) for _, s in seq_list)
]


def _homopoly_raise_oracle(sba: np.ndarray, positions: np.ndarray, k: int, max_h: int):
    """Where the reference's scalar homopolymer walk raises: the window
    runs past the array end, or it crosses a '$' before a run longer than
    ``max_h`` (the raise condition of the plane route)."""
    out = np.zeros(len(positions), dtype=bool)
    for r, p in enumerate(positions.tolist()):
        if p + k - 1 >= len(sba):
            out[r] = True
            continue
        run = 1
        for j in range(1, k):
            if sba[p + j] == ord("$"):
                out[r] = True
                break
            run = run + 1 if sba[p + j] == sba[p + j - 1] else 1
            if run > max_h:
                break
    return out


@pytest.mark.parametrize("gname,min_k,max_k", LANES_CASES)
def test_lanes_flags_match_jax(gname, min_k, max_k):
    """Each filter's lanes flags on the JAX package's sorted lanes: the
    mask and the raise conditions equal the JAX package's, but for one
    recorded difference (ROADMAP.md §C2): the raise condition of the 4-bit
    homopolymer flags equals the reference's scalar walk, where the JAX
    package's counts the nibbles past the filter's length into a row's cap
    and misses truncated rows on lanes built longer than it."""
    import jax.numpy as jnp

    seq_list = GENOMES[gname]
    jsc = gj.SequenceCollection(sequence_list=seq_list)
    jkm = gj.Kmers(jsc, min_k, max_k)
    jkm.sort()
    jlanes = jkm._lanes_cache
    jpos = jkm._device_positions()
    tpos = torch.from_numpy(np.asarray(jpos).astype(np.int64))
    sba_len = len(jsc.forward_sba)
    compared = 0
    for (name, jfil, _), (_, tfil, _) in zip(_filters(jf), _filters(tf)):
        jspec = jfil.lanes_spec(jlanes, sba_len, min_k)
        tspec = tfil.lanes_spec(_port_lanes(jlanes, False), sba_len, min_k)
        assert (jspec is None) == (tspec is None), name
        if jspec is None:
            continue
        assert tspec[0].__name__ == jspec[0].__name__ and list(tspec[1]) == jspec[1].tolist()
        assert len(tspec[2]) == len(jspec[2])
        assert [m(7) for m in tspec[2]] == [m(7) for m in jspec[2]]
        jmask, jerrs = jspec[0](jlanes["words"], jlanes["cap"], jpos, jnp.asarray(jspec[1]))
        jmask = np.asarray(jmask)
        if tspec[0].__name__ == "homopoly_lanes_flags4" and not tspec[1][3]:
            jerrs = [_homopoly_raise_oracle(np.asarray(jsc.forward_sba), np.asarray(jpos),
                                            tfil.kmer_len, tfil.max_homopolymer_size)]
        for int32_words in (False, True):
            lanes = _port_lanes(jlanes, int32_words)
            tmask, terrs = tspec[0](lanes["words"], lanes["cap"], tpos, tspec[1])
            assert np.array_equal(tmask.numpy(), jmask), (name, int32_words)
            assert len(terrs) == len(jerrs)
            for te, je in zip(terrs, jerrs):
                assert np.array_equal(te.numpy(), np.broadcast_to(np.asarray(je), jmask.shape)), name
        compared += 1
    assert compared > 0


@pytest.mark.parametrize("alpha", ["ACGT", "ACGTN"])
def test_homopolymer_lanes_mask_vs_scalar_oracle(alpha):
    """Planted runs of assorted lengths, one reaching the segment end: the
    lanes mask equals the scalar filter at every row it does not raise at,
    and the raise condition holds exactly where the scalar filter raises."""
    rng = np.random.default_rng(77)
    g = list("".join(rng.choice(list(alpha), 300)))
    for start, length, base in [(10, 2, "A"), (40, 3, "C"), (80, 5, "T"),
                                (120, 9, "G"), (200, 17, "A"), (260, 20, "C")]:
        g[start : start + length] = base * length
    g[-14:] = "A" * 14
    seq = "".join(g)
    sc = gt.SequenceCollection(sequence_list=[("r1", seq)], device="cpu")
    sba = np.frombuffer(seq.encode(), dtype=np.uint8)
    for min_k, max_k in [(1, 31), (12, 32), (1, 64)]:
        km = gt.Kmers(sc, min_k, max_k)
        km.sort()
        lanes = km._lanes_cache
        if lanes is None or (not lanes["two_bit"] and max_k > 32):
            continue
        pos = km._device_positions()
        for max_h, k in [(1, 12), (2, 12), (3, 20), (4, 31), (8, 31), (16, 31)]:
            if k > max_k:
                continue
            filt = tf.HomopolymerFilter(max_h, k)
            fn, params, _ = filt.lanes_spec(lanes, len(sba), min_k)
            mask, (raises,) = fn(lanes["words"], lanes["cap"], pos, params)
            for i, p in enumerate(pos.tolist()):
                got = _outcome(lambda: filt(sba, "forward", p))
                if got[0] is ValueError:
                    assert raises[i], (max_h, k, p)
                else:
                    assert not raises[i] and bool(mask[i]) == got[1], (max_h, k, p)


# --------------------------------------------------------------------------- #
# scalar filters
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fname", FILTER_NAMES)
def test_scalar_call_matches_jax_at_every_position(fname):
    jfil, tfil = _filter_pair(fname)
    for gname in ("n-runs", "tiny-segments"):
        sba = gj.SequenceCollection(sequence_list=GENOMES[gname]).forward_sba
        for p in range(len(sba)):
            assert _outcome(lambda: tfil(sba, "forward", p)) == _outcome(
                lambda: jfil(sba, "forward", p)
            ), (fname, gname, p)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.HomopolymerFilter(0, 5),
        lambda m: m.HomopolymerFilter(3, 0),
        lambda m: m.GcContentFilter(0.6, 0.5, 10),
        lambda m: m.GcContentFilter(-0.1, 0.5, 10),
        lambda m: m.GcContentFilter(0.1, 1.5, 10),
        lambda m: m.gen_kmer_gc_content_filter_func(0.4, 0.6, 10).max_allowed_gc_count,
        lambda m: m.gen_kmer_homopolymer_filter_func(3, 9).kmer_len,
        lambda m: m.gen_kmer_length_filter_func(4).min_kmer_len,
        lambda m: m.gen_no_ambiguous_bases_filter(7).kmer_len,
        lambda m: m.kmer_has_required_len(np.frombuffer(b"ACG$TTT", dtype=np.uint8), 1, 2),
        lambda m: m.kmer_has_required_len(np.frombuffer(b"ACG$TTT", dtype=np.uint8), 1, 3),
        lambda m: m.crispr_ngg_pam_filter(np.frombuffer(b"A" * 21 + b"GG", dtype=np.uint8), "forward", 0),
        lambda m: m.kmer_filter_keep_all(None, "forward", 0),
    ],
)
def test_filter_constructors_and_helpers_match_jax(make):
    want = _outcome(lambda: make(jf))
    assert _outcome(lambda: make(tf)) == want


# --------------------------------------------------------------------------- #
# VectorizedFilter
# --------------------------------------------------------------------------- #


def _starts_with_a_jnp(sba, positions, valid_len):
    import jax.numpy as jnp

    return (jnp.take(sba, positions.astype(jnp.int32)) == ord("A")) & (valid_len >= 4)


def _starts_with_a_torch(sba, positions, valid_len):
    return (sba[positions] == ord("A")) & (valid_len >= 4)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("gname", ["acgt-multi", "iupac"])
def test_vectorized_filter_matches_jax(gname, sort):
    jsc = gj.SequenceCollection(sequence_list=GENOMES[gname])
    tsc = gt.SequenceCollection(sequence_list=GENOMES[gname], device="cpu")
    jfil = gj.VectorizedFilter(_starts_with_a_jnp)
    tfil = gt.VectorizedFilter(_starts_with_a_torch)
    jkm, tkm = gj.Kmers(jsc, 2, 8), gt.Kmers(tsc, 2, 8)
    if sort:
        jkm.sort()
        tkm.sort()
        got = tkm.get_kmer_group_counts(3, kmer_filter_func=tfil, max_counts_bin=9)
        want = jkm.get_kmer_group_counts(3, kmer_filter_func=jfil, max_counts_bin=9)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert tkm.get_kmer_count(3, kmer_filter_func=tfil) == jkm.get_kmer_count(3, kmer_filter_func=jfil)
    got = tkm.get_kmers_arrays(3, kmer_filter_func=tfil)
    want = jkm.get_kmers_arrays(3, kmer_filter_func=jfil)
    assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(want[0]) > 0
    sba = jsc.forward_sba
    for p in range(len(sba)):
        assert tfil(sba, "forward", p) == jfil(sba, "forward", p)


def test_vectorized_filter_scalar_and_check_functions():
    sba = np.frombuffer(b"ACGTA$CCA", dtype=np.uint8)

    def check(ctx):
        raise ValueError(f"checked {int(ctx.positions.shape[0])} rows")

    for m, mask_fn in ((gj, _starts_with_a_jnp), (gt, _starts_with_a_torch)):
        f = m.VectorizedFilter(mask_fn, scalar_fn=lambda s, st, i: i == 3)
        assert [f(sba, "forward", p) for p in range(4)] == [False, False, False, True]
    tsc = gt.SequenceCollection(sequence_list=[("a", "ACGTA"), ("b", "CCA")], device="cpu")
    jsc = gj.SequenceCollection(sequence_list=[("a", "ACGTA"), ("b", "CCA")])
    got = _outcome(lambda: gt.Kmers(tsc, 1, 3).get_kmer_count(
        2, kmer_filter_func=gt.VectorizedFilter(_starts_with_a_torch, check_fn=check)))
    want = _outcome(lambda: gj.Kmers(jsc, 1, 3).get_kmer_count(
        2, kmer_filter_func=gj.VectorizedFilter(_starts_with_a_jnp, check_fn=check)))
    assert got == want and got[0] is ValueError


# --------------------------------------------------------------------------- #
# filtered group statistics
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_survivor_sizes_and_error_fold_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    boundary = rng.random(n) < 0.3
    boundary[0] = True
    mask = rng.random(n) < 0.5
    positions = rng.permutation(1000)[:n].astype(np.uint32)
    want = np.asarray(jg.survivor_sizes_at_boundaries(boundary, mask))
    got = tg.survivor_sizes_at_boundaries(torch.from_numpy(boundary), torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    conds = [rng.random(n) < p for p in (0.0, 0.01, 0.02)]
    if seed == 3:
        conds[2][:] = conds[1]  # ties at one row go to the earlier condition
    for errs in (conds[:1], conds[1:], conds, conds[::-1]):
        want = [int(x) for x in jg.fold_err_conditions(errs, positions)]
        got = tg.fold_err_conditions([torch.from_numpy(c) for c in errs],
                                     torch.from_numpy(positions.astype(np.int64)))
        if want[0] == 0:  # no offender: the other two terms carry nothing
            assert int(got[0]) == 0
        else:
            assert got.tolist() == want
    assert tg.fold_err_conditions([], torch.zeros(3, dtype=torch.int64)) is None


# --------------------------------------------------------------------------- #
# the reference's host walk API
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("max_kmer_len", [None, 1, 3, 8, 0])
def test_compare_sba_kmers_matches_jax(max_kmer_len):
    sba = gj.SequenceCollection(sequence_list=GENOMES["tiny-segments"]).forward_sba
    rng = np.random.default_rng(5)
    for a, b in rng.integers(0, len(sba), size=(300, 2)):
        got = _outcome(lambda: gt.compare_sba_kmers_lexicographically(sba, sba, a, b, max_kmer_len))
        want = _outcome(lambda: gj.compare_sba_kmers_lexicographically(sba, sba, a, b, max_kmer_len))
        assert got == want
    assert gt.compare_sba_kmers_always_less_than(sba, sba, 0, 1) == (-1, 0)


@pytest.mark.parametrize("fname", ["gc-mid", "len-small", "homopoly-short-circuit", "crispr"])
def test_host_group_walk_matches_jax(fname):
    jfil, tfil = _filter_pair(fname)
    jsc = gj.SequenceCollection(sequence_list=GENOMES["acgt-multi"])
    sba = jsc.forward_sba
    km = gj.Kmers(jsc, 25, 25)
    km.sort()
    idx = km.kmer_sba_start_indices
    for k in (3, 25):
        got = _outcome(lambda: gt.get_kmer_group_size_hist(
            sba, "forward", k, idx, gt.get_compare_sba_kmers_func(k), tfil, max_counts_bin=6))
        want = _outcome(lambda: gj.get_kmer_group_size_hist(
            sba, "forward", k, idx, gj.get_compare_sba_kmers_func(k), jfil, max_counts_bin=6))
        assert got[0] == want[0]
        if got[0] == "ok":
            assert np.array_equal(got[1][0], want[1][0]) and got[1][1] == want[1][1]
        else:
            assert got == want
        for info in (gt.get_kmer_info_minimal, gt.get_kmer_info_group_size_only):
            jinfo = getattr(gj, info.__name__)
            got = _outcome(lambda: list(gt.kmer_info_by_group_generator(
                sba, "forward", k, idx, gt.get_compare_sba_kmers_func(k), tfil, info,
                min_group_size=1, yield_first_n=2)))
            want = _outcome(lambda: list(gj.kmer_info_by_group_generator(
                sba, "forward", k, idx, gj.get_compare_sba_kmers_func(k), jfil, jinfo,
                min_group_size=1, yield_first_n=2)))
            assert got == want


def test_host_group_walk_argument_errors_match_jax():
    sba = np.frombuffer(b"ACGT", dtype=np.uint8)
    idx = np.arange(4, dtype=np.uint32)
    for kwargs in ({"min_group_size": 0}, {"min_group_size": 3, "max_group_size": 2},
                   {"yield_first_n": 0}):
        got = _outcome(lambda: list(gt.kmer_info_by_group_generator(
            sba, "forward", 2, idx, gt.compare_sba_kmers_always_less_than,
            gt.kmer_filter_keep_all, gt.get_kmer_info_minimal, **kwargs)))
        want = _outcome(lambda: list(gj.kmer_info_by_group_generator(
            sba, "forward", 2, idx, gj.compare_sba_kmers_always_less_than,
            gj.kmer_filter_keep_all, gj.get_kmer_info_minimal, **kwargs)))
        assert got == want and got[0] is ValueError
    got = _outcome(lambda: gt.get_kmer_group_size_hist(
        sba, "forward", 2, idx, gt.compare_sba_kmers_always_less_than,
        gt.kmer_filter_keep_all, max_counts_bin=0))
    want = _outcome(lambda: gj.get_kmer_group_size_hist(
        sba, "forward", 2, idx, gj.compare_sba_kmers_always_less_than,
        gj.kmer_filter_keep_all, max_counts_bin=0))
    assert got == want and got[0] is ValueError


def test_package_exports_match_jax():
    assert sorted(gt.__all__) == sorted(gj.__all__)
