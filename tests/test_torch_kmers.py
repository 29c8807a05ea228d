"""The port's slices end to end against the JAX package's Kmers, on the CPU.

FASTA or sequence list -> SequenceCollection -> Kmers(min, max) -> sort()
-> get_kmer_group_counts / get_kmer_count, for ACGT genomes (2-bit keys)
and genomes with N runs and IUPAC codes (4-bit keys), on the
``tests/oracle.py`` sweeps, against both the JAX package and the
brute-force string oracle; the gather path (re-sorts, assigned indices,
unsorted counts, statistics beyond the sorted lanes, ``get_kmers``,
``get_kmers_arrays``, ``get_kmer_strs``); the constructors' error messages
verbatim; NotImplementedError, naming a ROADMAP.md item, for every call
outside the slices, and the JAX package's answer for the calls that earlier
slices refused (suffix mode, lengths beyond one window, ``from_strand``,
filters);
and the device rules. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.io.fasta import iter_fasta_records as jax_iter_fasta_records
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.io.fasta import iter_fasta_records
from genome_kmers_tpu_torch.ops.filters import KmerFilter
from oracle import expected_groups, expected_hist, expected_kmers, parameter_combinations

SEQ_LIST_1 = [("chr1", "ATCGAATTAG")]
SEQ_LIST_2 = [("chr1", "ATCGAATTAG"), ("chr2", "GGATCTTGCATT"), ("chr3", "GTGATTGACCCCT")]
SEQ_LIST_IUPAC = [("chr1", "ATCGNNTTAG"), ("chr2", "GGRYCTTGCNNT"), ("chr3", "GTGATNNNNNCCT")]
SEQ_LISTS = {"one": SEQ_LIST_1, "three": SEQ_LIST_2, "iupac": SEQ_LIST_IUPAC}

FASTA_TEXT = (
    ">chr1 first record\nACGTACGTAC\nGGTTAACC\n"
    ">chr2\r\nacgtTTTT\r\nGGGGCCCCAAAA\r\n"
    ">chr3 desc\nTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT\n"
)
FASTA_TEXT_IUPAC = (
    ">chr1 with a gap\nACGTACGTACNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN\nNNNNGGTTAACC\n"
    ">chr2\r\nacgtTTTTRYKM\r\nGGGGCCCCAAAAnnnnBDHVSW\r\n"
    ">chr3 desc\nYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYYY\n"
)


def _tsc(**kwargs):
    return gt.SequenceCollection(device="cpu", **kwargs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)
    return None


# --------------------------------------------------------------------------- #
# SequenceCollection
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("strands", ["forward", "reverse_complement", "both"])
def test_collection_from_sequence_list_matches_jax(strands):
    jsc = gj.SequenceCollection(sequence_list=SEQ_LIST_2, strands_to_load=strands)
    tsc = _tsc(sequence_list=SEQ_LIST_2, strands_to_load=strands)
    assert tsc == jsc and tsc.strands_loaded() == strands
    assert len(tsc) == len(jsc) and str(tsc) == str(jsc)
    assert tsc.sequence_length() == jsc.sequence_length()
    strand = "forward" if strands == "both" else strands
    assert list(tsc.iter_records(strand)) == list(jsc.iter_records(strand))
    sba = jsc.forward_sba if strand == "forward" else jsc.revcomp_sba
    for idx in range(len(sba)):
        if sba[idx] == ord("$"):
            continue
        assert tsc.get_record_loc_from_sba_index(idx, strand) == jsc.get_record_loc_from_sba_index(
            idx, strand
        )
        assert tsc.get_segment_num_from_sba_index(idx, strand) == jsc.get_segment_num_from_sba_index(
            idx, strand
        )


def test_collection_from_fasta_matches_jax(tmp_path):
    path = tmp_path / "genome.fa"
    path.write_bytes(FASTA_TEXT.encode())
    jsc = gj.SequenceCollection(fasta_file_path=path)
    tsc = _tsc(fasta_file_path=path)
    assert tsc == jsc
    assert tsc.forward_record_names == ["chr1", "chr2", "chr3"]
    assert list(iter_fasta_records(path)) == list(jax_iter_fasta_records(path))


@pytest.mark.parametrize(
    "text",
    [
        ">a\nACGT\n>b\n>c\nACGT\n",  # empty sequence
        ">a\nACGT\n>a\nACGT\n",  # repeated name
        ">a\nACGTX\n",  # non-allowed character
        "",  # empty file
    ],
)
def test_fasta_errors_match_jax(tmp_path, text):
    path = tmp_path / "bad.fa"
    path.write_bytes(text.encode())
    want = _outcome(lambda: gj.SequenceCollection(fasta_file_path=path))
    assert want is not None
    assert _outcome(lambda: _tsc(fasta_file_path=path)) == want


@pytest.mark.parametrize(
    "kwargs",
    [
        {"sequence_list": [("a", "ACGT"), ("b", "")]},
        {"sequence_list": [("a", "ACGT"), ("a", "ACGT")]},
        {"sequence_list": [("a", "ACGU")]},
        {"sequence_list": [("a", "acgt")]},
        {"sequence_list": [("a", "ACGT")], "fasta_file_path": "x.fa"},
        {"sequence_list": [("a", "ACGT")], "strands_to_load": "sideways"},
    ],
)
def test_collection_errors_match_jax(kwargs):
    want = _outcome(lambda: gj.SequenceCollection(**kwargs))
    assert want is not None
    assert _outcome(lambda: _tsc(**kwargs)) == want


# --------------------------------------------------------------------------- #
# Kmers end to end
# --------------------------------------------------------------------------- #


def _slice_combinations(seq_list, min_kmer_len):
    return [
        mx for sl, mn, mx in parameter_combinations([seq_list])
        if mn == min_kmer_len and mx is not None
    ]


@pytest.mark.parametrize("name", sorted(SEQ_LISTS))
@pytest.mark.parametrize("min_kmer_len", range(1, 10))
def test_oracle_sweep_matches_jax_and_oracle(name, min_kmer_len):
    seq_list = SEQ_LISTS[name]
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    tsc = _tsc(sequence_list=seq_list)
    for mx in _slice_combinations(seq_list, min_kmer_len):
        jkm, tkm = gj.Kmers(jsc, min_kmer_len, mx), gt.Kmers(tsc, min_kmer_len, mx)
        unsorted, _, sorted_kmers, sorted_indices = expected_kmers(seq_list, min_kmer_len, mx)
        assert np.array_equal(tkm.kmer_sba_start_indices, unsorted)
        assert len(tkm) == len(jkm)
        jkm.sort()
        tkm.sort()
        got = tkm.kmer_sba_start_indices
        assert got.dtype == np.uint32
        assert list(got) == sorted_indices
        assert np.array_equal(got, jkm.kmer_sba_start_indices)
        for kmer_len in range(1, mx + 1):
            counts, total = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=6)
            j_counts, j_total = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=6)
            o_counts, o_total = expected_hist(sorted_kmers, kmer_len, max_counts_bin=6)
            assert np.array_equal(counts, j_counts) and np.array_equal(counts, o_counts)
            assert total == j_total == o_total
            count = tkm.get_kmer_count(kmer_len, min_group_size=2)
            assert count == jkm.get_kmer_count(kmer_len, min_group_size=2)
            assert count == expected_hist(sorted_kmers, kmer_len, min_group_size=2)[1]


def test_fasta_to_statistics_matches_jax(tmp_path):
    path = tmp_path / "genome.fa"
    path.write_bytes(FASTA_TEXT.encode())
    jkm = gj.Kmers(gj.SequenceCollection(fasta_file_path=path), 5, 31)
    tkm = gt.Kmers(_tsc(fasta_file_path=path), 5, 31)
    assert tkm.device == torch.device("cpu")
    jkm.sort()
    tkm.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    for kmer_len in (5, 12, 31):
        for mcb in (3, 10**6):
            got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        assert tkm.get_kmer_count(kmer_len) == jkm.get_kmer_count(kmer_len)


def test_iupac_fasta_to_statistics_matches_jax(tmp_path):
    """N runs (all-N k-mers tie in one large group), IUPAC codes, and a
    run of 'Y', whose 4-bit words are all-ones."""
    path = tmp_path / "genome.fa"
    path.write_bytes(FASTA_TEXT_IUPAC.encode())
    for mn, mx in ((31, 31), (5, 31), (12, 32), (3, 7)):
        jkm = gj.Kmers(gj.SequenceCollection(fasta_file_path=path), mn, mx)
        tkm = gt.Kmers(_tsc(fasta_file_path=path), mn, mx)
        jkm.sort()
        tkm.sort()
        assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
        j_lanes, t_lanes = jkm._lanes_cache, tkm._lanes_cache
        assert t_lanes["two_bit"] is j_lanes["two_bit"] is False
        assert t_lanes["cap"] is None and j_lanes["cap"] is None
        for g, w in zip(t_lanes["words"], j_lanes["words"]):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
        for kmer_len in sorted({1, mn, (mn + mx) // 2, mx}):
            for mcb in (3, 10**6):
                got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
                want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
                assert np.array_equal(got[0], want[0]) and got[1] == want[1]
            for bounds in ({}, {"min_group_size": 2}, {"min_group_size": 2, "max_group_size": 5}):
                assert tkm.get_kmer_count(kmer_len, **bounds) == jkm.get_kmer_count(kmer_len, **bounds)


# --------------------------------------------------------------------------- #
# the gather path: indexes that are not the fresh one
# --------------------------------------------------------------------------- #


def _seeded_seq_list(kind: str):
    rng = np.random.default_rng(41)
    if kind == "acgt":
        unit = "".join(rng.choice(list("ACGT"), size=23))
        return [("a", "".join(rng.choice(list("ACGT"), size=160))), ("b", (unit * 6)[:120]),
                ("c", "T" * 70), ("d", "".join(rng.choice(list("ACGT"), size=66)))]
    probs = [0.22] * 4 + [0.04] * 3
    return [("a", "".join(rng.choice(list("ACGTNRY"), p=probs, size=160))),
            ("b", "ACGT" + "N" * 60 + "ACGTT" + "N" * 40), ("c", "Y" * 50),
            ("d", "".join(rng.choice(list("ACGTN"), size=40)))]


def _assigned(order: str, fresh: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(len(fresh))
    if order == "descending":
        return fresh[::-1].copy()
    if order == "shuffled subset":
        return rng.permutation(fresh)[: len(fresh) // 3]
    return np.concatenate([fresh[::2], fresh[::-3]])  # with repeated positions


GATHER_CONFIGS = [("acgt", 5, 5), ("acgt", 31, 31), ("acgt", 7, 20), ("acgt", 20, 48),
                  ("acgt", 64, 64), ("iupac", 5, 5), ("iupac", 31, 31), ("iupac", 7, 20),
                  ("iupac", 12, 32)]


def _pair(kind, mn, mx):
    seq_list = _seeded_seq_list(kind)
    return (gj.Kmers(gj.SequenceCollection(sequence_list=seq_list), mn, mx),
            gt.Kmers(_tsc(sequence_list=seq_list), mn, mx))


def _same_lanes(t_lanes, j_lanes):
    if t_lanes is None or j_lanes is None:
        return t_lanes is None and j_lanes is None
    same = t_lanes["two_bit"] is j_lanes["two_bit"] and t_lanes["built_k"] == j_lanes["built_k"]
    same = same and (t_lanes["cap"] is None) == (j_lanes["cap"] is None)
    pairs = list(zip(t_lanes["words"], j_lanes["words"]))
    if t_lanes["cap"] is not None:
        pairs.append((t_lanes["cap"], j_lanes["cap"]))
    for g, w in pairs:
        g = g.numpy().view(np.uint32) if g.dtype == torch.int32 else g.numpy().astype(np.uint32)
        same = same and np.array_equal(g, np.asarray(w))
    return same


def _same_statistics(tkm, jkm, kmer_lens):
    for kmer_len in kmer_lens:
        for mcb in (4, 1000):
            got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1], (kmer_len, mcb)
        for bounds in ({}, {"min_group_size": 2}, {"min_group_size": 2, "max_group_size": 3}):
            assert tkm.get_kmer_count(kmer_len, **bounds) == jkm.get_kmer_count(kmer_len, **bounds)


@pytest.mark.parametrize("kind,mn,mx", GATHER_CONFIGS)
def test_resort_matches_fresh_sort_and_jax(kind, mn, mx):
    jkm, tkm = _pair(kind, mn, mx)
    jkm.sort()
    tkm.sort()
    fresh = tkm.kmer_sba_start_indices.copy()
    jkm.sort()
    tkm.sort()  # no longer the fresh index: gathered keys, position as last key
    assert np.array_equal(tkm.kmer_sba_start_indices, fresh)
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    assert _same_lanes(tkm._lanes_cache, jkm._lanes_cache)
    _same_statistics(tkm, jkm, sorted({1, mn, mx}))


@pytest.mark.parametrize("order", ["descending", "shuffled subset", "repeats"])
@pytest.mark.parametrize("kind,mn,mx", GATHER_CONFIGS)
def test_assigned_index_matches_jax(kind, mn, mx, order):
    jkm, tkm = _pair(kind, mn, mx)
    assigned = _assigned(order, tkm.kmer_sba_start_indices)
    jkm.kmer_sba_start_indices = assigned.copy()
    tkm.kmer_sba_start_indices = assigned.copy()
    assert len(tkm) == len(jkm) == len(assigned)
    # unsorted: every k-mer is its own group, whatever kmer_len
    for kmer_len in (1, mx, None):
        assert tkm.get_kmer_count(kmer_len) == jkm.get_kmer_count(kmer_len) == len(assigned)
    for got, want in zip(tkm.get_kmers_arrays(mn), jkm.get_kmers_arrays(mn)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    jkm.sort()
    tkm.sort()
    assert tkm.kmer_sba_start_indices.dtype == np.uint32
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    assert _same_lanes(tkm._lanes_cache, jkm._lanes_cache)
    _same_statistics(tkm, jkm, sorted({1, mn, mx}))
    # a sorted index assigned by hand keeps no lanes: rebuilt once, by gathers
    sorted_pos = tkm.kmer_sba_start_indices.copy()
    jkm.kmer_sba_start_indices = sorted_pos.copy()
    tkm.kmer_sba_start_indices = sorted_pos.copy()
    assert tkm._lanes_cache is None
    _same_statistics(tkm, jkm, sorted({1, mn, mx}))
    assert _same_lanes(tkm._lanes_cache, jkm._lanes_cache)


@pytest.mark.parametrize(
    "kind,mn,mx,beyond",
    [("acgt", 5, 5, (6, 17, 64)), ("acgt", 7, 20, (21, 33, 48)), ("acgt", 31, 31, (32, 64)),
     ("iupac", 5, 5, (6, 9, 32)), ("iupac", 7, 20, (21, 32)), ("iupac", 31, 31, (32,))],
)
def test_statistics_beyond_the_sorted_lanes_match_jax(kind, mn, mx, beyond):
    """kmer_len above max_kmer_len: boundaries from gathered keys."""
    jkm, tkm = _pair(kind, mn, mx)
    jkm.sort()
    tkm.sort()
    _same_statistics(tkm, jkm, beyond)
    for kmer_len in beyond:
        for got, want in zip(tkm.get_kmers_arrays(kmer_len, min_group_size=2),
                             jkm.get_kmers_arrays(kmer_len, min_group_size=2)):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(SEQ_LISTS))
@pytest.mark.parametrize("min_kmer_len", [1, 2, 4])
def test_yielding_calls_match_jax_and_oracle(name, min_kmer_len):
    seq_list = SEQ_LISTS[name]
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    tsc = _tsc(sequence_list=seq_list)
    for mx in _slice_combinations(seq_list, min_kmer_len)[::2]:
        jkm, tkm = gj.Kmers(jsc, min_kmer_len, mx), gt.Kmers(tsc, min_kmer_len, mx)
        assert list(tkm.get_kmers(mx)) == list(jkm.get_kmers(mx))  # unsorted
        jkm.sort()
        tkm.sort()
        sorted_kmers = expected_kmers(seq_list, min_kmer_len, mx)[2]
        nums = list(range(len(tkm)))
        assert tkm.get_kmer_strs(nums, None) == jkm.get_kmer_strs(nums, None) == sorted_kmers
        assert [tkm.get_kmer_str(i) for i in nums] == sorted_kmers
        for kmer_len in sorted({1, min_kmer_len, mx}):
            for bounds in ({}, {"min_group_size": 2}, {"max_group_size": 2, "yield_first_n": 1},
                           {"min_group_size": 2, "yield_first_n": 2}):
                got = list(tkm.get_kmers(kmer_len, **bounds))
                assert got == list(jkm.get_kmers(kmer_len, **bounds))
                assert got == expected_groups(sorted_kmers, kmer_len, **bounds)
                arrays = tkm.get_kmers_arrays(kmer_len, **bounds)
                for a, w in zip(arrays, jkm.get_kmers_arrays(kmer_len, **bounds)):
                    assert a.dtype == w.dtype and np.array_equal(a, w)
                assert [(int(n), int(y), int(t)) for n, _, y, t in zip(*arrays)] == got
            if kmer_len >= min_kmer_len:
                assert _full_outcome(tkm, kmer_len) == _full_outcome(jkm, kmer_len)
                fits = [i for i in nums if len(sorted_kmers[i]) >= kmer_len]
                assert tkm.get_kmer_strs(fits, kmer_len) == jkm.get_kmer_strs(fits, kmer_len)
                assert tkm.get_kmer_strs(fits, kmer_len) == [sorted_kmers[i][:kmer_len] for i in fits]


def _full_outcome(km, kmer_len):
    """The full-info tuples, or the error of a k-mer that runs past its
    segment's end."""
    try:
        return list(km.get_kmers(kmer_len, one_based_seq_index=True, kmer_info_to_yield="full"))
    except ValueError as e:
        return str(e)


def test_string_and_yield_errors_match_jax():
    jkm, tkm = _pair("iupac", 3, 9)
    calls = [
        lambda km: km.get_kmer_str(-1),
        lambda km: km.get_kmer_str(len(km)),
        lambda km: km.get_kmer_str(0, 2),
        lambda km: km.get_kmer_str(0, 10),
        lambda km: km.get_kmer_str(len(km) - 1, 9),
        lambda km: km.get_kmer_strs([0, len(km)], 3),
        lambda km: km.get_kmer_strs([0], 0),
        lambda km: km.get_kmer_strs([len(km) - 1], 9),
        lambda km: list(km.get_kmers(0)),
        lambda km: list(km.get_kmers(3, kmer_info_to_yield="some")),
        lambda km: list(km.get_kmers(3, yield_first_n=1)),
        lambda km: km.get_kmers_arrays(3, min_group_size=2),
    ]
    for call in calls:
        assert _outcome(lambda: call(tkm)) == _outcome(lambda: call(jkm)) is not None
    assert tkm.get_kmer_strs([], 3) == jkm.get_kmer_strs([], 3) == []


def test_sort_checks_an_assigned_index_against_min_kmer_len():
    """A position with fewer than min_kmer_len bases left: the JAX package's
    AssertionError, verbatim."""
    jkm, tkm = _pair("acgt", 5, 9)
    bad = np.array([0, 158, 7], dtype=np.uint32)  # record "a" ends at 159
    jkm.kmer_sba_start_indices = bad.copy()
    tkm.kmer_sba_start_indices = bad.copy()
    want = _outcome(jkm.sort)
    assert want is not None and want[0] is AssertionError
    assert _outcome(tkm.sort) == want


@pytest.mark.parametrize("kind,mn,mx", [("acgt", 7, 20), ("iupac", 7, 20), ("iupac", 31, 31)])
def test_interop_carries_lanes_and_assigned_indexes(kind, mn, mx):
    seq_list = _seeded_seq_list(kind)
    sc = gj.SequenceCollection(sequence_list=seq_list)
    jkm = gj.Kmers(sc, mn, mx)
    jkm.sort()
    lanes = jkm._lanes_cache
    state = (sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, mn, mx)
    _, tkm = from_numpy_state(
        *state, positions=jkm.kmer_sba_start_indices,
        words=[np.asarray(w) for w in lanes["words"]],
        cap=None if lanes["cap"] is None else np.asarray(lanes["cap"]),
        two_bit=lanes["two_bit"], device="cpu",
    )
    assert tkm._is_sorted and tkm._lanes_cache["two_bit"] is (kind == "acgt")
    _same_statistics(tkm, jkm, sorted({1, mn, mx}))
    # an assigned, unsorted index: no lanes, sorted by the gather path
    descending = jkm.kmer_sba_start_indices[::-1].copy()
    _, tkm2 = from_numpy_state(*state, positions=descending, is_sorted=False, device="cpu")
    assert not tkm2._is_sorted and tkm2._lanes_cache is None
    assert np.array_equal(tkm2.kmer_sba_start_indices, descending)
    tkm2.sort()
    assert np.array_equal(tkm2.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    with pytest.raises(ValueError, match="no sorted key lanes"):
        from_numpy_state(*state, positions=descending, words=[descending], is_sorted=False,
                         device="cpu")
    if kind == "iupac":
        with pytest.raises(ValueError, match="no cap lane"):
            from_numpy_state(*state, positions=descending, words=[descending], cap=descending,
                             two_bit=False, device="cpu")


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "strands,kwargs",
    [
        ("forward", {"min_kmer_len": 0}),
        ("forward", {"max_kmer_len": 0}),
        ("forward", {"min_kmer_len": 4, "max_kmer_len": 3}),
        ("forward", {"min_kmer_len": 11}),
        ("forward", {"track_strands_separately": True}),
        ("forward", {"source_strand": "both"}),
        ("forward", {"source_strand": "sideways"}),
        ("forward", {"method": "double_pass"}),
        ("forward", {"method": "triple_pass"}),
        ("both", {}),
        ("reverse_complement", {}),
    ],
)
def test_kmers_constructor_errors_match_jax(strands, kwargs):
    jsc = gj.SequenceCollection(sequence_list=SEQ_LIST_2, strands_to_load=strands)
    tsc = _tsc(sequence_list=SEQ_LIST_2, strands_to_load=strands)
    want = _outcome(lambda: gj.Kmers(jsc, **kwargs))
    assert want is not None
    assert _outcome(lambda: gt.Kmers(tsc, **kwargs)) == want


def test_statistics_argument_errors_match_jax():
    jkm = gj.Kmers(gj.SequenceCollection(sequence_list=SEQ_LIST_2), 3, 3)
    tkm = gt.Kmers(_tsc(sequence_list=SEQ_LIST_2), 3, 3)
    unsorted_calls = [
        lambda km: km.get_kmer_group_counts(3),
        lambda km: km.get_kmer_count(3, min_group_size=2),
        lambda km: km.get_kmer_count(3, max_group_size=4),
        lambda km: km.get_kmer_count(0),
    ]
    sorted_calls = [
        lambda km: km.get_kmer_group_counts(3, max_counts_bin=0),
        lambda km: km.get_kmer_group_counts(0),
    ]
    for call in unsorted_calls:
        assert _outcome(lambda: call(tkm)) == _outcome(lambda: call(jkm)) is not None
    jkm.sort()
    tkm.sort()
    for call in sorted_calls:
        assert _outcome(lambda: call(tkm)) == _outcome(lambda: call(jkm)) is not None


class _OddFilter(KmerFilter):
    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return kmer_sba_start_idx % 2 == 1


class _JaxOddFilter(gj.kmers.KmerFilter):
    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return kmer_sba_start_idx % 2 == 1


@pytest.mark.parametrize(
    "call",
    [
        lambda g, sc, km, f: (km.sort(), list(km.get_kmers(3, kmer_filter_func=f))),
        lambda g, sc, km, f: g.Kmers.from_strand(sc, 3, 3, kmer_filters=[f]),
        lambda g, sc, km, f: km.get_kmer_count(3, kmer_filter_func=f),
        lambda g, sc, km, f: (km.sort(), km.get_kmer_count(3, kmer_filter_func=f)),
        lambda g, sc, km, f: (km.sort(), km.get_kmer_group_counts(3, kmer_filter_func=f)),
    ],
)
def test_filter_calls_once_out_of_slice_now_match_jax(call):
    """Filters, once refused: a KmerFilter with no mask raises the JAX
    package's NotImplementedError from its base ``mask_pure``."""
    tsc, jsc = _tsc(sequence_list=SEQ_LIST_2), gj.SequenceCollection(sequence_list=SEQ_LIST_2)
    got = _outcome(lambda: call(gt, tsc, gt.Kmers(tsc, 3, 8), _OddFilter()))
    want = _outcome(lambda: call(gj, jsc, gj.Kmers(jsc, 3, 8), _JaxOddFilter()))
    assert got == want and want[0] is NotImplementedError


def _large_sort_sweep(g, **kwargs):
    """The large sweep's k-mer counts (its times are not compared); the
    port's on CPU shards."""
    from genome_kmers_tpu import profiling as jprof
    from genome_kmers_tpu_torch import profiling as tprof

    if g is gt:
        df = tprof.profile_large_sort([100], device="cpu", **kwargs)
    else:
        df = jprof.profile_large_sort([100], **kwargs)
    return df[["seq_len", "kmer_len", "num_kmers", "num_iterations"]].values.tolist()


def _strided_pack():
    """A one-record genome in the arguments of the JAX package's
    ``LargeKmers(packed_words, seg_starts_u64, seg_ends_u64, ...)``."""
    return np.zeros(4, dtype=np.uint32), np.array([0], np.uint64), np.array([20], np.uint64)


def _large_state(lk):
    return (lk.num_kmers, lk._one_window, lk.two_bit, lk.min_kmer_len, lk.max_kmer_len)


# Persistence, export and the mesh calls were out of the slice once and are
# ported (tests/test_torch_persistence.py, test_torch_mesh.py,
# test_torch_mesh_unbounded.py, test_torch_hier.py; the mesh calls that
# stood here are cases of test_calls_once_out_of_slice_now_match_jax). The
# calls below, of the 64-bit regime, raised NotImplementedError naming
# ROADMAP.md A12 until it was ported (tests/test_torch_large*.py hold it
# further): each now gives the JAX package's answer or error.
@pytest.mark.parametrize(
    "call",
    [
        lambda g, sc, km: _large_state(g.LargeKmers(*_strided_pack(), 1, None)),
        lambda g, sc, km: g.LargeKmers(sc, 3, 3),
        lambda g, sc, km: _large_state(g.LargeKmers(*_strided_pack(), 3, 70)),
        lambda g, sc, km: _large_state(g.LargeKmers(*_strided_pack(), 3, 8, two_bit=False)),
        lambda g, sc, km: g.LargeKmers(),
        lambda g, sc, km: _large_sort_sweep(g),
        lambda g, sc, km: _large_sort_sweep(g, kmer_lens=[None]),
        lambda g, sc, km: _large_sort_sweep(g, n_devices=2),
        lambda g, sc, km: _large_sort_sweep(g, kmer_lens=[31, 70], num_iterations=1),
        lambda g, sc, km: (km.sort(), g.LargeKmers(sc, 3, 8)),
    ],
)
def test_out_of_slice_calls_raise_not_implemented(call):
    sc, scj = _tsc(sequence_list=SEQ_LIST_2), gj.SequenceCollection(sequence_list=SEQ_LIST_2)
    got = _outcome(lambda: call(gt, sc, gt.Kmers(sc, 3, 8)))
    want = _outcome(lambda: call(gj, scj, gj.Kmers(scj, 3, 8)))
    assert got == want
    assert not (isinstance(got, tuple) and got[0] is NotImplementedError)


def _mesh(g, n: int = 2):
    if g is gj:
        return gj.parallel.make_mesh(n)
    return gt.parallel.make_mesh(devices=["cpu"] * n)


def _mesh2(g):
    if g is gj:
        m = gj.parallel.make_mesh2(1, 2)
    else:
        m = gt.parallel.make_mesh2(1, 2, devices=["cpu"] * 2)
    return tuple(m.axis_names), dict(m.shape)


def _mesh_sorted(g, km, n: int = 2):
    km.sort(mesh=_mesh(g, n))
    return km


def _sorted(km):
    km.sort()
    return km


@pytest.mark.parametrize(
    "seq_list,strands,call",
    [
        # suffix mode and lengths beyond one compare window, once refused
        ([("a", "ACGTN" * 9)], "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 33)).kmer_sba_start_indices.tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, None)).kmer_sba_start_indices.tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 65)).kmer_sba_start_indices.tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 8)).get_kmer_group_counts(None)[0][:4].tolist()),
        (SEQ_LIST_2, "forward", lambda g, sc: _sorted(g.Kmers(sc, 3, 8)).get_kmer_count(65)),
        # from_strand, once refused
        (SEQ_LIST_2, "both",
         lambda g, sc: _sorted(g.Kmers.from_strand(sc, 3, 3, source_strand="both"))
         .kmer_sba_start_indices.tolist()),
        # queries and canonical statistics, once refused
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 8)).count_queries(["ATC", "TTG", "GGG"], 3).tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 8)).count_queries_canonical(["ATC", "CAA"], 3).tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: g.Kmers(sc, 3, 8).get_canonical_kmer_group_counts(3)[0][:4].tolist()),
        # the mesh beyond one compare window, canonical statistics on a mesh
        # and the 2-D mesh, once refused
        (SEQ_LIST_2, "forward",
         lambda g, sc: _mesh_sorted(g, g.Kmers(sc, 3, None)).kmer_sba_start_indices.tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _mesh_sorted(g, g.Kmers(sc, 3, 70)).kmer_sba_start_indices.tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _mesh_sorted(g, g.Kmers(sc, 3, 8)).get_kmer_count(None, mesh=_mesh(g))),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 8))
         .get_kmer_group_counts(None, mesh=_mesh(g))[0][:4].tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _sorted(g.Kmers(sc, 3, 8)).get_kmer_count(70, mesh=_mesh(g))),
        (SEQ_LIST_2, "forward", lambda g, sc: _mesh2(g)),
        (SEQ_LIST_2, "forward",
         lambda g, sc: g.Kmers(sc, 3, 8)
         .get_canonical_kmer_group_counts(3, mesh=_mesh(g))[0][:4].tolist()),
        (SEQ_LIST_2, "forward",
         lambda g, sc: _mesh_sorted(g, g.Kmers(sc, 3, 8))
         .get_canonical_kmer_group_counts(3, mesh=_mesh(g))[0][:4].tolist()),
    ],
)
def test_calls_once_out_of_slice_now_match_jax(seq_list, strands, call):
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load=strands)
    tsc = _tsc(sequence_list=seq_list, strands_to_load=strands)
    got, want = call(gt, tsc), call(gj, jsc)
    assert got == want and want not in ([], None)


# --------------------------------------------------------------------------- #
# devices
# --------------------------------------------------------------------------- #


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.SequenceCollection(sequence_list=SEQ_LIST_1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.SequenceCollection(sequence_list=SEQ_LIST_1, device="cuda:0")
    with pytest.raises(ValueError, match="must be a CUDA device or the CPU"):
        gt.SequenceCollection(sequence_list=SEQ_LIST_1, device="meta")


def test_index_and_lanes_live_on_the_collection_device():
    sc = _tsc(sequence_list=SEQ_LIST_2)
    km = gt.Kmers(sc, 4, 4)
    assert km.device == sc.device == torch.device("cpu")
    km.sort()
    dc = sc.device_cache("forward")
    assert dc.packed2.dtype == torch.int32 and dc.packed2.device == sc.device
    assert km._pos_dev.device == sc.device
    assert all(w.device == sc.device and w.dtype == torch.int64 for w in km._lanes_cache["words"])
    km.sort()  # the gather sort keeps its words as int32 bit patterns
    assert km._pos_dev.device == sc.device and km._pos_dev.dtype == torch.int64
    assert all(w.device == sc.device and w.dtype == torch.int32 for w in km._lanes_cache["words"])
