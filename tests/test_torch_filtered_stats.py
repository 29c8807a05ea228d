"""Filtered statistics and yields of the port's ``Kmers`` against the JAX
package's, end to end on the CPU.

``get_kmer_count``, ``get_kmer_group_counts`` (with ``min_group_size``,
``max_group_size`` and ``max_counts_bin``), ``get_kmers`` (both
``kmer_info_to_yield`` modes) and ``get_kmers_arrays`` with every library
filter of ``tests/test_lanes_filters.py``, on an ACGT and an IUPAC genome
with copied segments (groups larger than one), over sorted (k, k),
(min, max) and suffix-mode indexes and an unsorted one, through each route
the JAX package has: the sorted lanes, the flag plane (the lanes rebuild
switched off) and the window gathers (no planes on the device cache), each
route asserted taken. Also ``track_strands_separately``, an assigned index
where the CRISPR lanes gate refuses, a filter that is a plain callable
(with its warning), the raise-parity cases of ``tests/test_lanes_filters.py``
and init-time filters of ``Kmers.from_strand`` in both methods on all three
strands. Tolerance: exact equality, and the same exception type and
message.
"""

import numpy as np
import pytest

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu_torch import kmers as tkmers
from genome_kmers_tpu_torch.ops import filters as tf


def _genomes():
    rng = np.random.default_rng(29)

    def rand(n, alphabet="ACGT", p=None):
        return "".join(rng.choice(list(alphabet), size=n, p=p))

    unit, motif = rand(45), rand(30)
    acgt = [("r1", rand(80) + unit + rand(25) + unit + "A" * 12 + motif),
            ("r2", unit + rand(40) + motif + motif[:20]),
            ("r3", "GGGGGGCCCCCC" + rand(30) + "TTTTTTTTTT"),
            ("r4", motif + rand(24))]
    probs = [0.22] * 4 + [0.04, 0.04, 0.02, 0.02]
    iupac = [("r1", rand(70, "ACGTNRYK", probs) + unit + "N" * 14 + unit + rand(30, "ACGTN")),
             ("r2", unit + rand(40, "ACGTSWBD") + motif),
             ("r3", "ACGT" + "N" * 25 + "GGGGGGGGGG")]
    return {"acgt": acgt, "iupac": iupac}


GENOMES = _genomes()


def _filters(m):
    """The filter list of tests/test_lanes_filters.py, from module ``m``."""
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


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _same(got, want) -> bool:
    """Outcomes equal: exceptions by type and message, results exactly."""
    if got[0] != want[0]:
        return False
    if got[0] != "ok":
        return got == want
    a, b = got[1], want[1]
    if isinstance(b, tuple):
        return len(a) == len(b) and all(_same(("ok", x), ("ok", y)) for x, y in zip(a, b))
    if isinstance(b, (np.ndarray, list)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _pair(kind, mn, mx, strand="forward", track=False):
    seq_list = GENOMES[kind]
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load=strand)
    tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load=strand, device="cpu")
    if strand == "forward":
        return gj.Kmers(jsc, mn, mx), gt.Kmers(tsc, mn, mx)
    kw = dict(source_strand=strand, track_strands_separately=track)
    return gj.Kmers.from_strand(jsc, mn, mx, **kw), gt.Kmers.from_strand(tsc, mn, mx, **kw)


def _route(km, route: str) -> None:
    """Force a route the way the JAX package's tests do: no lanes rebuild
    sends filtered queries to the plane, and a device cache that keeps no
    planes sends them to the window gathers."""
    if route != "lanes":
        km._lanes_cache = None
        km._lanes_rebuild = False
    if route == "window":
        km._dc().filter_flags = None


def _queries(k, sorted_index: bool, yields: bool = True):
    """The calls a filter is held to. The yields compact to the survivors,
    a new shape (and compile) of the JAX package's for every filter, so the
    caller may leave them out for some filters to keep the file fast."""
    calls = [("count", lambda km, f: km.get_kmer_count(k, kmer_filter_func=f))]
    if yields:
        calls += [
            ("arrays", lambda km, f: km.get_kmers_arrays(k, kmer_filter_func=f)),
            ("yields", lambda km, f: list(km.get_kmers(k, kmer_filter_func=f))),
        ]
    if sorted_index:
        calls += [
            ("hist", lambda km, f: km.get_kmer_group_counts(k, kmer_filter_func=f,
                                                            max_counts_bin=12)),
            ("count>=2", lambda km, f: km.get_kmer_count(k, kmer_filter_func=f,
                                                         min_group_size=2)),
            ("hist[2,3]", lambda km, f: km.get_kmer_group_counts(
                k, kmer_filter_func=f, min_group_size=2, max_group_size=3, max_counts_bin=2)),
        ]
    if sorted_index and yields:
        calls.append(("full, first 1", lambda km, f: list(km.get_kmers(
            k, kmer_filter_func=f, kmer_info_to_yield="full", yield_first_n=1,
            min_group_size=2))))
    return calls


CASES = [
    (kind, mn, mx, sort, route)
    for kind in ("acgt", "iupac")
    for mn, mx, sort, routes in [
        (24, 32, True, ("lanes", "plane", "window")),
        (12, 12, True, ("lanes", "plane", "window")),
        (1, 31, True, ("lanes", "plane", "window")),
        (1, None, True, ("plane", "window")),
        (24, 32, False, ("plane", "window")),
    ]
    for route in routes
]


@pytest.mark.parametrize("kind,mn,mx,sort,route", CASES)
def test_filtered_queries_match_jax(kind, mn, mx, sort, route):
    jkm, tkm = _pair(kind, mn, mx)
    if sort:
        jkm.sort()
        tkm.sort()
    _route(jkm, route)
    _route(tkm, route)
    tdc = tkm._dc()
    taken = {"lanes": 0, "plane": 0, "other": 0}
    # the yields for every third filter, a different third in each case
    third = CASES.index((kind, mn, mx, sort, route)) % 3
    pairs = zip(_filters(jf), _filters(tf))
    for i, ((name, jfil, k), (_, tfil, _)) in enumerate(pairs):
        lanes = sort and tkm._filtered_lanes_stats(k, tfil) is not None
        assert lanes == (sort and jkm._filtered_lanes_stats(k, jfil) is not None), name
        planes_before = None if tdc.filter_flags is None else len(tdc.filter_flags)
        for qname, call in _queries(k, sort, yields=i % 3 == third):
            got, want = _outcome(lambda: call(tkm, tfil)), _outcome(lambda: call(jkm, jfil))
            assert _same(got, want), (name, qname, got, want)
        if lanes:
            taken["lanes"] += 1
        elif planes_before is not None and len(tdc.filter_flags) > planes_before:
            taken["plane"] += 1
        else:
            taken["other"] += 1
    if route == "lanes":
        assert taken["lanes"] > 0
    elif route == "plane":
        assert taken["lanes"] == 0 and taken["plane"] > 0
    else:
        assert taken["lanes"] == taken["plane"] == 0 and tdc.filter_flags is None


@pytest.mark.parametrize("route", ["lanes", "plane"])
@pytest.mark.parametrize(
    "min_gs,max_gs,mcb", [(1, None, 1), (2, None, 3), (1, 1, 10), (2, 3, 1000000)]
)
def test_filtered_group_params_match_jax(min_gs, max_gs, mcb, route):
    jkm, tkm = _pair("acgt", 20, 24)
    for km in (jkm, tkm):
        km.sort()
        _route(km, route)
    for (name, jfil, k), (_, tfil, _) in zip(_filters(jf), _filters(tf)):
        kw = dict(min_group_size=min_gs, max_group_size=max_gs)
        got = _outcome(lambda: tkm.get_kmer_group_counts(k, kmer_filter_func=tfil,
                                                         max_counts_bin=mcb, **kw))
        want = _outcome(lambda: jkm.get_kmer_group_counts(k, kmer_filter_func=jfil,
                                                          max_counts_bin=mcb, **kw))
        assert _same(got, want), name
        got = _outcome(lambda: tkm.get_kmers_arrays(k, kmer_filter_func=tfil, yield_first_n=2, **kw))
        want = _outcome(lambda: jkm.get_kmers_arrays(k, kmer_filter_func=jfil, yield_first_n=2, **kw))
        assert _same(got, want), name


@pytest.mark.parametrize("route", ["lanes", "plane"])
@pytest.mark.parametrize("mn,mx", [(16, 16), (1, 16)])
def test_filtered_queries_strands_apart_match_jax(mn, mx, route):
    jkm, tkm = _pair("acgt", mn, mx, strand="both", track=True)
    for km in (jkm, tkm):
        km.sort()
        _route(km, route)
    for i, ((name, jfil, k), (_, tfil, _)) in enumerate(zip(_filters(jf), _filters(tf))):
        k = min(k, mx)
        for qname, call in _queries(k, True, yields=i % 4 == 0):
            assert _same(_outcome(lambda: call(tkm, tfil)), _outcome(lambda: call(jkm, jfil))), (
                name, qname)


@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_crispr_lanes_gate_refuses_an_assigned_index_short_of_23(kind):
    """A sorted index given positions with fewer than min_kmer_len bases
    left: the lanes are rebuilt, the cap check fails, and the CRISPR query
    takes the plane route, as in the JAX package."""
    short_j, _ = _pair(kind, 1, 32)
    short_j.sort()
    # rows with fewer than 23 bases left in their record, but none of the
    # last 22 of the SBA, which raise the overflow error on every route
    positions = short_j.kmer_sba_start_indices
    positions = positions[positions.astype(np.int64) + 23 <= len(short_j.seq_coll.forward_sba)]
    jkm, tkm = _pair(kind, 23, 32)
    for km in (jkm, tkm):
        km.sort()
        km.kmer_sba_start_indices = positions.copy()
    assert tkm._cap_cover_ok is None
    got = _outcome(lambda: tkm.get_kmer_group_counts(23, kmer_filter_func=tf.crispr_ngg_pam_filter))
    want = _outcome(lambda: jkm.get_kmer_group_counts(23, kmer_filter_func=jf.crispr_ngg_pam_filter))
    assert _same(got, want)
    assert tkm._lanes_cache is not None and tkm._cap_cover_ok is False
    assert tkm._filtered_lanes_stats(23, tf.crispr_ngg_pam_filter) is None
    assert ("crispr",) in tkm._dc().filter_flags
    got = tkm.get_kmer_count(23, kmer_filter_func=tf.crispr_ngg_pam_filter)
    assert got == jkm.get_kmer_count(23, kmer_filter_func=jf.crispr_ngg_pam_filter)
    # a fresh index keeps the cap coverage, and the gate lets the lanes in
    fresh = _pair(kind, 23, 32)[1]
    fresh.sort()
    assert fresh._filtered_lanes_stats(23, tf.crispr_ngg_pam_filter) is not None


def _odd(sba, strand, idx):
    return idx % 2 == 1


@pytest.mark.parametrize("sort", [False, True])
def test_callable_filter_matches_jax_and_warns(sort, monkeypatch):
    import genome_kmers_tpu.kmers as jkmers

    monkeypatch.setattr(jkmers, "_CALLABLE_WARN_THRESHOLD", 10)
    monkeypatch.setattr(tkmers, "_CALLABLE_WARN_THRESHOLD", 10)
    jkm, tkm = _pair("acgt", 5, 12)
    if sort:
        jkm.sort()
        tkm.sort()
    for qname, call in _queries(5, sort):
        with pytest.warns(RuntimeWarning, match="genome_kmers_tpu_torch.VectorizedFilter"):
            got = _outcome(lambda: call(tkm, _odd))
        with pytest.warns(RuntimeWarning, match="VectorizedFilter"):
            want = _outcome(lambda: call(jkm, _odd))
        assert _same(got, want), qname


class _MaskLess(tf.KmerFilter):
    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return kmer_sba_start_idx % 2 == 1


class _JaxMaskLess(jf.KmerFilter):
    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return kmer_sba_start_idx % 2 == 1


@pytest.mark.parametrize("sort", [False, True])
def test_kmer_filter_without_a_mask_raises_as_jax(sort):
    jkm, tkm = _pair("acgt", 3, 8)
    if sort:
        jkm.sort()
        tkm.sort()
    for _, call in _queries(3, sort):
        got, want = _outcome(lambda: call(tkm, _MaskLess())), _outcome(lambda: call(jkm, _JaxMaskLess()))
        assert got == want and got[0] is NotImplementedError


# --------------------------------------------------------------------------- #
# raise parity (tests/test_lanes_filters.py:195-211 and :362-412)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("route", ["lanes", "plane", "window"])
def test_raise_parity_truncation(route):
    seq_list = [("r1", "ACGTACGTAC"), ("r2", "GGGCC")]
    jsc = gj.SequenceCollection(sequence_list=seq_list)
    tsc = gt.SequenceCollection(sequence_list=seq_list, device="cpu")
    jkm, tkm = gj.Kmers(jsc, 1, 12), gt.Kmers(tsc, 1, 12)
    for km in (jkm, tkm):
        km.sort()
        _route(km, route)
    for m_j, m_t in ((jf.GcContentFilter(0.0, 1.0, 8), tf.GcContentFilter(0.0, 1.0, 8)),
                     (jf.NoAmbiguousBasesFilter(8), tf.NoAmbiguousBasesFilter(8)),
                     (jf.HomopolymerFilter(2, 8), tf.HomopolymerFilter(2, 8))):
        for call in (lambda km, f: km.get_kmer_group_counts(8, kmer_filter_func=f, max_counts_bin=10),
                     lambda km, f: km.get_kmer_count(8, kmer_filter_func=f)):
            got, want = _outcome(lambda: call(tkm, m_t)), _outcome(lambda: call(jkm, m_j))
            assert got == want and got[0] is ValueError


HP_SEQ1 = "ACGTCGTACGTACGGTCA" + "A" * 5  # a '$'-truncated tail run
HP_SEQ2 = "CGTACGTTGCATGCATGCAT"


@pytest.mark.parametrize("route", ["lanes", "plane", "window"])
def test_homopolymer_truncation_preempted_by_early_run(route):
    """A window that crosses '$' after its run exceeded max_h returns False;
    array-end overflow raises. A custom position set without the raising
    rows counts the scalar survivors; the dense index raises at the first
    offending row in sorted order, skipping the preempted rows."""
    k, max_h = 6, 1
    seq_list = [("r1", HP_SEQ1), ("r2", HP_SEQ2)]
    sba = np.frombuffer((HP_SEQ1 + "$" + HP_SEQ2).encode(), dtype=np.uint8)
    scalar = tf.HomopolymerFilter(max_h, k)
    positions, expected = [], 0
    for p in list(range(len(HP_SEQ1) - 2)) + [len(HP_SEQ1) + 1 + q for q in range(len(HP_SEQ2) - k + 1)]:
        out = _outcome(lambda: scalar(sba, "forward", p))
        if out[0] == "ok":
            positions.append(p)
            expected += int(out[1])
    jsc = gj.SequenceCollection(sequence_list=seq_list)
    tsc = gt.SequenceCollection(sequence_list=seq_list, device="cpu")
    for assigned in (True, False):
        jkm, tkm = gj.Kmers(jsc, 3, 8), gt.Kmers(tsc, 3, 8)
        for km in (jkm, tkm):
            if assigned:
                km.kmer_sba_start_indices = np.asarray(positions, dtype=np.uint32)
            km.sort()
            _route(km, route)
        for call in (lambda km, f: km.get_kmer_group_counts(k, kmer_filter_func=f, max_counts_bin=10),
                     lambda km, f: km.get_kmer_count(k, kmer_filter_func=f)):
            got = _outcome(lambda: call(tkm, tf.HomopolymerFilter(max_h, k)))
            want = _outcome(lambda: call(jkm, jf.HomopolymerFilter(max_h, k)))
            assert _same(got, want)
        if assigned:
            assert tkm.get_kmer_count(k, kmer_filter_func=scalar) == expected
        else:
            assert got[0] is ValueError


# --------------------------------------------------------------------------- #
# init-time filters of from_strand
# --------------------------------------------------------------------------- #


def _init_filters(m):
    return [m.NoAmbiguousBasesFilter(9), m.GcContentFilter(0.2, 0.8, 9), m.HomopolymerFilter(4, 9)]


@pytest.mark.parametrize("method", ["single_pass", "double_pass"])
@pytest.mark.parametrize("strand", ["forward", "reverse_complement", "both"])
@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_init_time_filters_match_jax(kind, strand, method):
    seq_list = GENOMES[kind]
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load=strand)
    tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load=strand, device="cpu")
    kw = dict(source_strand=strand, method=method)
    jkm = gj.Kmers.from_strand(jsc, 9, 24, kmer_filters=_init_filters(jf), **kw)
    tkm = gt.Kmers.from_strand(tsc, 9, 24, kmer_filters=_init_filters(tf), **kw)
    want = jkm.kmer_sba_start_indices
    assert 0 < len(want) < len(gj.Kmers.from_strand(jsc, 9, 24, **kw))
    assert np.array_equal(tkm.kmer_sba_start_indices, want) and len(tkm) == len(want)
    jkm.sort()
    tkm.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    got, want = tkm.get_kmer_group_counts(9, max_counts_bin=8), jkm.get_kmer_group_counts(9, max_counts_bin=8)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    # a filter that raises at init time raises the same error
    got = _outcome(lambda: gt.Kmers.from_strand(tsc, 1, 24, kmer_filters=[tf.GcContentFilter(0.2, 0.8, 9)], **kw))
    want = _outcome(lambda: gj.Kmers.from_strand(jsc, 1, 24, kmer_filters=[jf.GcContentFilter(0.2, 0.8, 9)], **kw))
    assert got[0] is ValueError and got == want


@pytest.mark.parametrize("method", ["single_pass", "double_pass"])
def test_init_time_callable_filter_matches_jax(method):
    jsc = gj.SequenceCollection(sequence_list=GENOMES["acgt"], strands_to_load="both")
    tsc = gt.SequenceCollection(sequence_list=GENOMES["acgt"], strands_to_load="both", device="cpu")
    seen = {"j": [], "t": []}

    def make(tag):
        def keep(sba, strand, idx):
            seen[tag].append((strand, idx))
            return sba[idx] == ord("G")
        return keep

    kw = dict(source_strand="both", method=method)
    jkm = gj.Kmers.from_strand(jsc, 4, 8, kmer_filters=[make("j"), jf.LengthFilter(6)], **kw)
    tkm = gt.Kmers.from_strand(tsc, 4, 8, kmer_filters=[make("t"), tf.LengthFilter(6)], **kw)
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    assert seen["t"] == seen["j"] and {s for s, _ in seen["t"]} == {"forward", "reverse_complement"}


def test_plain_constructor_still_refuses_init_filters():
    tsc = gt.SequenceCollection(sequence_list=GENOMES["acgt"], device="cpu")
    jsc = gj.SequenceCollection(sequence_list=GENOMES["acgt"])
    got = _outcome(lambda: gt.Kmers(tsc, 3, 8)._initialize(kmer_filters=[tf.LengthFilter(3)]))
    want = _outcome(lambda: gj.Kmers(jsc, 3, 8)._initialize(kmer_filters=[jf.LengthFilter(3)]))
    assert got == want and got[0] is NotImplementedError
