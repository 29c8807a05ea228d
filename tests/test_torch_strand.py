"""``Kmers.from_strand``: reverse-complement and both-strand indexes of the
port against the JAX package and the string oracle, on the CPU.

Seeded genomes of a few thousand bases (an exact repeat, a palindromic
stretch whose reverse complement is itself, an all-'T' record, which is all
'A' on the other strand, records as short as ``min_kmer_len``; the IUPAC
genome adds N runs and codes with their complements). For each strand mode,
with and without ``track_strands_separately``: the concatenated SBA, the
unsorted index, ``sort()``, histograms, counts, ``get_kmers_arrays``
columns, full ``get_kmers`` rows (strand, record, coordinate),
``get_kmer_str(s)``, a re-sort, an assigned index, ``double_pass`` and the
state carried over by ``interop.from_numpy_state``. The oracle sees a
reverse-complement index as the forward index of the reverse-complemented
records in reverse order, and a both-strand index as that of the forward
records followed by those. With the strands tracked apart, a group is
(string, strand): below the sort's own compare length the JAX package cuts
groups at strand changes instead (ROADMAP.md §C7), so there the port is
held to the oracle of ``tests/test_torch_strand_tracked.py`` and not to the
JAX package. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops.filters import GcContentFilter
from genome_kmers_tpu_torch.interop import from_numpy_state
from oracle import expected_groups, expected_hist, expected_kmers
from test_torch_strand_tracked import kmers_oracle, kmers_walk

COMPLEMENT = str.maketrans("ACGTRYSWKMBDHVN", "TGCAYRSWMKVHDBN")


def _revcomp(seq: str) -> str:
    return seq.translate(COMPLEMENT)[::-1]


def _records(kind: str, min_len: int = 1):
    rng = np.random.default_rng(211 if kind == "acgt" else 223)

    def rand(n, alphabet="ACGT", p=None):
        return "".join(rng.choice(list(alphabet), size=n, p=p))

    unit = rand(90)
    half = rand(40)
    if kind == "acgt":
        records = [rand(200) + unit + rand(30) + _revcomp(unit), half + _revcomp(half),
                   "T" * 50, rand(60)]
    else:
        probs = [0.23] * 4 + [0.02] * 4
        records = [rand(180, "ACGTNRYK", probs) + unit + "N" * 40 + _revcomp(unit)[:70],
                   "ACGT" + "N" * 45 + "BDHVSW", "Y" * 40, rand(50, "ACGTN")]
    records += [rand(min_len), rand(min_len + 2)]
    return [(f"r{i}", seq) for i, seq in enumerate(records)]


def _oracle_seq_list(seq_list, strand: str):
    """The records whose forward index is the index of ``strand``."""
    rc = [(name, _revcomp(seq)) for name, seq in reversed(seq_list)]
    if strand == "reverse_complement":
        return rc
    return list(seq_list) + [(name + "-", seq) for name, seq in rc]


def _collections(seq_list, strands):
    return (gj.SequenceCollection(sequence_list=seq_list, strands_to_load=strands),
            gt.SequenceCollection(sequence_list=seq_list, strands_to_load=strands, device="cpu"))


def _pair(kind, mn, mx, strand, track=False, method="single_pass"):
    seq_list = _records(kind, mn)
    jsc, tsc = _collections(seq_list, strand)
    kwargs = dict(source_strand=strand, track_strands_separately=track, method=method)
    return (seq_list, gj.Kmers.from_strand(jsc, mn, mx, **kwargs),
            gt.Kmers.from_strand(tsc, mn, mx, **kwargs))


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)
    return None


# --------------------------------------------------------------------------- #
# SequenceCollection
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_both_concat_arrays_match_jax(kind):
    seq_list = _records(kind)
    jsc, tsc = _collections(seq_list, "both")
    (j_sba, j_starts), (t_sba, t_starts) = jsc.both_concat_arrays(), tsc.both_concat_arrays()
    assert t_sba.dtype == np.uint8 and t_starts.dtype == np.uint32
    assert np.array_equal(t_sba, j_sba) and np.array_equal(t_starts, j_starts)
    text = "$".join(seq for _, seq in _oracle_seq_list(seq_list, "both"))
    assert t_sba.tobytes().decode() == text and len(t_starts) == 2 * len(seq_list)
    assert tsc.both_concat_arrays()[0] is t_sba  # cached
    dc = tsc.device_cache("both_concat")
    assert dc.sba.shape[0] == len(t_sba) and dc.is_acgt_only == (kind == "acgt")
    assert np.array_equal(dc.seg_starts.numpy(), t_starts.astype(np.int64))
    rc = tsc.device_cache("reverse_complement")
    assert np.array_equal(rc.sba.numpy(), jsc.revcomp_sba)


@pytest.mark.parametrize(
    "strands,call",
    [
        ("forward", lambda sc: sc.both_concat_arrays()),
        ("reverse_complement", lambda sc: sc.both_concat_arrays()),
        ("forward", lambda sc: sc.device_cache("reverse_complement")),
        ("forward", lambda sc: sc.device_cache("both_concat")),
        ("reverse_complement", lambda sc: sc.device_cache("forward")),
        ("both", lambda sc: sc.device_cache("sideways")),
    ],
)
def test_strand_cache_errors_match_jax(strands, call):
    jsc, tsc = _collections(_records("acgt"), strands)
    want = _outcome(lambda: call(jsc))
    assert want is not None and want[0] is ValueError
    assert _outcome(lambda: call(tsc)) == want


def test_reverse_complement_invalidates_the_strand_caches():
    _, tsc = _collections(_records("acgt"), "forward")
    fwd = tsc.device_cache("forward")
    tsc.reverse_complement()
    assert tsc._device == {} and tsc._both_concat is None
    rc = tsc.device_cache("reverse_complement")
    assert rc is not fwd and rc.sba.shape == fwd.sba.shape
    with pytest.raises(ValueError, match="forward strand is not loaded"):
        tsc.device_cache("forward")


# --------------------------------------------------------------------------- #
# from_strand end to end
# --------------------------------------------------------------------------- #

CONFIGS = [("acgt", 3, 3), ("acgt", 5, 20), ("acgt", 31, 31), ("acgt", 1, None), ("acgt", 5, 70),
           ("iupac", 3, 3), ("iupac", 12, 32), ("iupac", 1, None), ("iupac", 3, 40)]
MODES = [("reverse_complement", False), ("both", False), ("both", True)]
MODE_IDS = ["revcomp", "both", "both tracked apart"]


def _strand_of(tkm, positions):
    if tkm.kmer_source_strand == "reverse_complement":
        return np.ones(len(positions), dtype=bool)
    return np.asarray(positions) >= tkm._revcomp_offset()


def _oracle_sizes(sorted_kmers, is_rc, kmer_len, track):
    """Group sizes in sorted order; with ``track`` the strand is part of
    the identity: each run of equal strings counts its "+" rows and its "-"
    rows apart."""
    keys = [s if kmer_len is None else s[:kmer_len] for s in sorted_kmers]
    first = [i for i, key in enumerate(keys) if i == 0 or key != keys[i - 1]]
    if not track:
        return np.diff(first + [len(keys)])
    sizes = []
    for a, b in zip(first, first[1:] + [len(keys)]):
        n_rc = int(np.count_nonzero(is_rc[a:b]))
        sizes += [n for n in (b - a - n_rc, n_rc) if n]
    return np.array(sizes)


def _jax_groups(track, kmer_len, mx) -> bool:
    """Whether the JAX package's groups are the (string, strand) groups:
    untracked, or at the sort's own compare length, where each group's "+"
    rows already come first (ROADMAP.md §C7)."""
    return not track or kmer_len == mx


@pytest.mark.parametrize("strand,track", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kind,mn,mx", CONFIGS)
def test_from_strand_sort_and_statistics_match_jax_and_oracle(kind, mn, mx, strand, track):
    seq_list, jkm, tkm = _pair(kind, mn, mx, strand, track)
    oracle_list = _oracle_seq_list(seq_list, strand)
    unsorted, _, sorted_kmers, sorted_indices = expected_kmers(oracle_list, mn, mx)
    assert tkm.kmer_source_strand == strand and tkm.track_strands_separately is track
    assert len(tkm) == len(jkm) == len(unsorted)
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    assert np.array_equal(np.sort(tkm.kmer_sba_start_indices), unsorted)
    assert tkm.get_kmer_count(mn) == jkm.get_kmer_count(mn) == len(unsorted)
    jkm.sort()
    tkm.sort()
    got = tkm.kmer_sba_start_indices
    assert got.dtype == np.uint32 and list(got) == sorted_indices
    assert np.array_equal(got, jkm.kmer_sba_start_indices)
    is_rc = _strand_of(tkm, sorted_indices)
    for kmer_len in sorted({1, mn, 20 if mx is None else mx}) + ([None] if mx is None else []):
        for mcb in (5, 1000):
            counts, total = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            j_counts, j_total = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            sizes = _oracle_sizes(sorted_kmers, is_rc, kmer_len, track)
            assert total == j_total == len(unsorted)
            if _jax_groups(track, kmer_len, mx):
                assert np.array_equal(counts, j_counts)
            assert np.array_equal(counts, np.bincount(np.minimum(sizes, mcb), minlength=mcb + 1))
        for bounds in ({"min_group_size": 2}, {"min_group_size": 2, "max_group_size": 3}):
            got = tkm.get_kmer_count(kmer_len, **bounds)
            if _jax_groups(track, kmer_len, mx):
                assert got == jkm.get_kmer_count(kmer_len, **bounds)
            in_range = (sizes >= 2) & (sizes <= bounds.get("max_group_size", len(unsorted)))
            assert got == int(sizes[in_range].sum())
    if not track:
        counts, total = tkm.get_kmer_group_counts(mn, max_counts_bin=7)
        o_counts, o_total = expected_hist(sorted_kmers, mn, max_counts_bin=7)
        assert np.array_equal(counts, o_counts) and total == o_total


@pytest.mark.parametrize("strand,track", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kind,mn,mx", CONFIGS[::2])
def test_from_strand_yields_and_strings_match_jax_and_oracle(kind, mn, mx, strand, track):
    seq_list, jkm, tkm = _pair(kind, mn, mx, strand, track)
    assert list(tkm.get_kmers(mn)) == list(jkm.get_kmers(mn))  # unsorted
    jkm.sort()
    tkm.sort()
    sorted_kmers = expected_kmers(_oracle_seq_list(seq_list, strand), mn, mx)[2]
    nums = list(range(len(tkm)))
    assert tkm.get_kmer_strs(nums, None) == jkm.get_kmer_strs(nums, None) == sorted_kmers
    assert [tkm.get_kmer_str(i) for i in nums[::5]] == sorted_kmers[::5]
    assert [tkm.get_kmer_str(i, mn) for i in nums[::5]] == [s[:mn] for s in sorted_kmers[::5]]
    fits = [i for i in nums if len(sorted_kmers[i]) >= mn + 1]
    assert tkm.get_kmer_strs(fits, mn + 1) == [sorted_kmers[i][: mn + 1] for i in fits]
    for kmer_len in (mn, mx):
        for bounds in ({}, {"min_group_size": 2, "yield_first_n": 1}, {"max_group_size": 2}):
            arrays = tkm.get_kmers_arrays(kmer_len, **bounds)
            if _jax_groups(track, kmer_len, mx):
                for a, w in zip(arrays, jkm.get_kmers_arrays(kmer_len, **bounds)):
                    assert a.dtype == w.dtype and np.array_equal(a, w)
            rows = [(int(n), int(y), int(t)) for n, _, y, t in zip(*arrays)]
            assert list(tkm.get_kmers(kmer_len, **bounds)) == rows
            if not track:
                assert rows == expected_groups(sorted_kmers, kmer_len, **bounds)
            else:
                assert rows == kmers_walk(tkm, kmer_len, **bounds)
    # strand, record name and coordinate along the forward sequence
    for one_based in (False, True):
        full = list(tkm.get_kmers(mn, one_based_seq_index=one_based, kmer_info_to_yield="full"))
        j_full = list(jkm.get_kmers(mn, one_based_seq_index=one_based, kmer_info_to_yield="full"))
        if _jax_groups(track, mn, mx):
            assert full == j_full
        else:  # every row once: the JAX rows' record columns in the oracle's groups
            info = {row[0]: row[1:5] for row in j_full}
            assert full == [(n, *info[n], y, t) for n, y, t in kmers_walk(tkm, mn)]
    forward = dict(seq_list)
    for (num, strand_sign, name, start, length, _, _), kmer in zip(full[::3], sorted_kmers[::3]):
        seq = forward[name]
        if strand_sign == "+":
            assert seq[start - 1 : start - 1 + length] == kmer[:length]
        else:  # ``start`` is the 1-based forward coordinate of the k-mer's first base
            assert _revcomp(seq[start - length : start]) == kmer[:length]
    assert {row[1] for row in full} == ({"-"} if strand == "reverse_complement" else {"+", "-"})
    info = tkm._record_info_func(False)
    j_info = jkm._record_info_func(False)
    assert all(info(int(p)) == j_info(int(p)) for p in tkm.kmer_sba_start_indices[::11])


@pytest.mark.parametrize("kind,mn,mx", [("acgt", 5, 20), ("acgt", 31, 31), ("iupac", 12, 32),
                                        ("acgt", 1, None)])
def test_both_tracked_apart_is_the_sum_of_the_strands(kind, mn, mx):
    seq_list = _records(kind, mn)
    both = _pair(kind, mn, mx, "both", True)[2]
    rc = _pair(kind, mn, mx, "reverse_complement")[2]
    fwd = gt.Kmers(gt.SequenceCollection(sequence_list=seq_list, device="cpu"), mn, mx)
    for km in (both, rc, fwd):
        km.sort()
    # at the sort's own identity (below it a run of equal prefixes is not in
    # position order, so its strands interleave)
    hist = [km.get_kmer_group_counts(mx, max_counts_bin=50) for km in (both, rc, fwd)]
    assert np.array_equal(hist[0][0], hist[1][0] + hist[2][0])
    assert hist[0][1] == hist[1][1] + hist[2][1]
    # untracked, the strands share groups: fewer, larger groups
    joint = _pair(kind, mn, mx, "both", False)[2]
    joint.sort()
    assert np.array_equal(joint.kmer_sba_start_indices, both.kmer_sba_start_indices)
    assert joint.get_kmer_group_counts(mx)[0].sum() < both.get_kmer_group_counts(mx)[0].sum()


@pytest.mark.parametrize("strand,track", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("order", ["re-sort", "descending", "shuffled subset"])
@pytest.mark.parametrize("kind,mn,mx", [("acgt", 5, 20), ("iupac", 12, 32), ("acgt", 3, None)])
def test_from_strand_resort_and_assigned_index_match_jax(kind, mn, mx, order, strand, track):
    """The gather path on the other strands: a revcomp index lists its
    records in record order, which descends in revcomp-SBA coordinates."""
    _, jkm, tkm = _pair(kind, mn, mx, strand, track)
    if order == "re-sort":
        jkm.sort()
        tkm.sort()
    else:
        assigned = tkm.kmer_sba_start_indices[::-1].copy()
        if order == "shuffled subset":
            assigned = np.random.default_rng(9).permutation(assigned)[: len(assigned) // 2]
        jkm.kmer_sba_start_indices = assigned.copy()
        tkm.kmer_sba_start_indices = assigned.copy()
    jkm.sort()
    tkm.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    for kmer_len in (mn, 33, None):
        got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=20)
        arrays = tkm.get_kmers_arrays(kmer_len, min_group_size=2)
        if not _jax_groups(track, kmer_len, mx):
            assert np.array_equal(got[0], kmers_oracle(tkm, kmer_len, max_counts_bin=20)[0])
            rows = [(int(n), int(y), int(t)) for n, _, y, t in zip(*arrays)]
            assert rows == kmers_walk(tkm, kmer_len, min_group_size=2)
            continue
        want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=20)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        for a, w in zip(arrays, jkm.get_kmers_arrays(kmer_len, min_group_size=2)):
            assert np.array_equal(a, w)


def test_a_revcomp_index_starts_in_record_order():
    _, jkm, tkm = _pair("acgt", 5, 20, "reverse_complement")
    pos = tkm.kmer_sba_start_indices
    assert np.array_equal(pos, jkm.kmer_sba_start_indices)
    assert pos[0] > pos[-1] and not np.array_equal(pos, np.sort(pos))
    assert np.array_equal(tkm._device_positions().numpy(), pos.astype(np.int64))


@pytest.mark.parametrize("strand,track", MODES + [("forward", False)],
                         ids=MODE_IDS + ["forward"])
@pytest.mark.parametrize("kind,mn,mx", [("acgt", 5, 20), ("iupac", 3, 40)])
def test_double_pass_gives_the_single_pass_index(kind, mn, mx, strand, track):
    _, jkm, tkm = _pair(kind, mn, mx, strand, track, method="double_pass")
    single = _pair(kind, mn, mx, strand, track)[2]
    assert tkm._init_geometry is None  # an exactly sized host array
    assert np.array_equal(tkm.kmer_sba_start_indices, single.kmer_sba_start_indices)
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    for km in (jkm, tkm, single):
        km.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, single.kmer_sba_start_indices)
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    got = tkm.get_kmer_count(mn, min_group_size=2)
    assert got == single.get_kmer_count(mn, min_group_size=2)
    if _jax_groups(track, mn, mx):
        assert got == jkm.get_kmer_count(mn, min_group_size=2)
    else:
        assert got == kmers_oracle(tkm, mn, min_group_size=2)[1]


def test_from_strand_forward_is_the_plain_index():
    seq_list = _records("acgt", 5)
    _, tsc = _collections(seq_list, "forward")
    tkm, plain = gt.Kmers.from_strand(tsc, 5, 20), gt.Kmers(tsc, 5, 20)
    assert not tkm._strand_extension and tkm._strand_to_use() == "forward"
    tkm.sort()
    plain.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, plain.kmer_sba_start_indices)


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "loaded,kwargs",
    [
        ("forward", {"source_strand": "both"}),
        ("forward", {"source_strand": "reverse_complement"}),
        ("both", {"source_strand": "forward"}),
        ("both", {"source_strand": "reverse_complement"}),
        ("reverse_complement", {"source_strand": "both"}),
        ("reverse_complement", {"source_strand": "reverse_complement",
                                "track_strands_separately": True}),
        ("both", {"source_strand": "sideways"}),
        ("both", {"source_strand": "both", "method": "triple_pass"}),
        ("both", {"source_strand": "both", "min_kmer_len": 0}),
        ("both", {"source_strand": "both", "min_kmer_len": 500}),
        ("both", {"source_strand": "both", "min_kmer_len": 4, "max_kmer_len": 3}),
    ],
)
def test_from_strand_errors_match_jax(loaded, kwargs):
    jsc, tsc = _collections(_records("acgt"), loaded)
    want = _outcome(lambda: gj.Kmers.from_strand(jsc, **kwargs))
    assert want is not None
    assert _outcome(lambda: gt.Kmers.from_strand(tsc, **kwargs)) == want


@pytest.mark.parametrize("strand", ["forward", "reverse_complement", "both"])
def test_init_time_filters_are_not_ported(strand):
    """Once refused (ROADMAP.md A8), now ported: the port keeps the JAX
    package's positions, and its error for a filter that is not callable."""
    jsc, tsc = _collections(_records("acgt", 5), strand)
    want = gj.Kmers.from_strand(jsc, 5, 20, source_strand=strand,
                                kmer_filters=[GcContentFilter(0.4, 0.6, 5)])
    got = gt.Kmers.from_strand(tsc, 5, 20, source_strand=strand,
                               kmer_filters=[gt.gen_kmer_gc_content_filter_func(0.4, 0.6, 5)])
    assert 0 < len(want) and np.array_equal(got.kmer_sba_start_indices, want.kmer_sba_start_indices)
    not_callable = [_outcome(lambda: m.Kmers.from_strand(sc, 5, 20, source_strand=strand,
                                                         kmer_filters=[object()]))
                    for m, sc in ((gt, tsc), (gj, jsc))]
    assert not_callable[0] == not_callable[1] and not_callable[0][0] is TypeError
    assert len(gt.Kmers.from_strand(tsc, 5, 20, source_strand=strand, kmer_filters=[])) > 0


@pytest.mark.parametrize("strand", ["reverse_complement", "both"])
def test_the_plain_constructor_still_refuses_other_strands(strand):
    jsc, tsc = _collections(_records("acgt"), strand)
    want = _outcome(lambda: gj.Kmers(jsc, 3, 3, source_strand=strand))
    assert want is not None and want[0] is NotImplementedError
    assert _outcome(lambda: gt.Kmers(tsc, 3, 3, source_strand=strand)) == want
    # and a plain index bound to such a collection by hand refuses its calls
    tkm, jkm = gt.Kmers(), gj.Kmers()
    for km, sc in ((tkm, tsc), (jkm, jsc)):
        km.seq_coll, km.kmer_source_strand = sc, strand
    assert _outcome(tkm._check_forward_only) == _outcome(jkm._check_forward_only) is not None


# --------------------------------------------------------------------------- #
# state carried across
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("strand,track", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kind,mn,mx", [("acgt", 5, 20), ("iupac", 12, 32), ("acgt", 1, None)])
def test_interop_carries_a_strand_index(kind, mn, mx, strand, track):
    _, jkm, _ = _pair(kind, mn, mx, strand, track)
    sc = jkm.seq_coll
    if strand == "reverse_complement":
        state = (sc.revcomp_sba, sc._revcomp_sba_seg_starts, sc.revcomp_record_names, mn, mx)
    else:
        state = (sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, mn, mx)
    strands = dict(source_strand=strand, track_strands_separately=track, device="cpu")
    tsc, fresh = from_numpy_state(*state, **strands)
    assert tsc == sc and fresh._strand_extension and not fresh._is_sorted
    assert np.array_equal(fresh.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    jkm.sort()
    lanes = jkm._lanes_cache
    if lanes is None:
        carried = dict(suffix_gid=np.asarray(jkm._suffix_gid_cache[0]))
    else:
        carried = dict(words=[np.asarray(w) for w in lanes["words"]],
                       cap=None if lanes["cap"] is None else np.asarray(lanes["cap"]))
    _, tkm = from_numpy_state(*state, positions=jkm.kmer_sba_start_indices,
                              two_bit=kind == "acgt", **carried, **strands)
    assert tkm._is_sorted and tkm.track_strands_separately is track
    for kmer_len in (mn, mx, 33):
        got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=20)
        if _jax_groups(track, kmer_len, mx):
            want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=20)
        else:
            want = kmers_oracle(tkm, kmer_len, max_counts_bin=20)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    nums = list(range(0, len(tkm), 9))
    assert tkm.get_kmer_strs(nums, None) == jkm.get_kmer_strs(nums, None)
    fresh.sort()
    assert torch.equal(fresh._pos_dev, tkm._pos_dev)
