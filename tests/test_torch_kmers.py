"""The port's slice end to end against the JAX package's Kmers, on the CPU.

FASTA or sequence list -> SequenceCollection -> Kmers(min, max) -> sort()
-> get_kmer_group_counts / get_kmer_count, on the ``tests/oracle.py``
sweeps, against both the JAX package and the brute-force string oracle;
the constructors' error messages verbatim; NotImplementedError, naming a
ROADMAP.md item, for every call outside the slice; and the device rules.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.io.fasta import iter_fasta_records as jax_iter_fasta_records
from genome_kmers_tpu_torch.io.fasta import iter_fasta_records
from genome_kmers_tpu_torch.ops.filters import KmerFilter
from oracle import expected_hist, expected_kmers, parameter_combinations

SEQ_LIST_1 = [("chr1", "ATCGAATTAG")]
SEQ_LIST_2 = [("chr1", "ATCGAATTAG"), ("chr2", "GGATCTTGCATT"), ("chr3", "GTGATTGACCCCT")]
SEQ_LISTS = {"one": SEQ_LIST_1, "three": SEQ_LIST_2}

FASTA_TEXT = (
    ">chr1 first record\nACGTACGTAC\nGGTTAACC\n"
    ">chr2\r\nacgtTTTT\r\nGGGGCCCCAAAA\r\n"
    ">chr3 desc\nTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT\n"
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


@pytest.mark.parametrize(
    "call",
    [
        lambda sc, km: gt.Kmers(_tsc(sequence_list=[("a", "ACGTN" * 9)]), 3, 3).sort(),
        lambda sc, km: gt.Kmers(sc, 3, None).sort(),
        lambda sc, km: gt.Kmers(sc, 3, 65).sort(),
        lambda sc, km: km.sort(mesh=object()),
        lambda sc, km: (km.sort(), km.sort()),
        lambda sc, km: gt.Kmers.from_strand(sc, 3, 3, source_strand="both"),
        lambda sc, km: gt.LargeKmers(sc, 3, 3),
        lambda sc, km: sc.save("x.h5"),
        lambda sc, km: sc.load("x.h5"),
        lambda sc, km: km.save("x.h5"),
        lambda sc, km: km.load("x.h5"),
        lambda sc, km: km.count_queries(["ACG"], 3),
        lambda sc, km: km.count_queries_canonical(["ACG"], 3),
        lambda sc, km: km.get_canonical_kmer_group_counts(3),
        lambda sc, km: km.get_kmer_count(3),
        lambda sc, km: (km.sort(), km.get_kmer_count(3, kmer_filter_func=_OddFilter())),
        lambda sc, km: (km.sort(), km.get_kmer_group_counts(3, kmer_filter_func=_OddFilter())),
        lambda sc, km: (km.sort(), km.get_kmer_group_counts(None)),
        lambda sc, km: (km.sort(), km.get_kmer_count(9)),
        lambda sc, km: (km.sort(), km.get_kmer_group_counts(3, mesh=object())),
    ],
)
def test_out_of_slice_calls_raise_not_implemented(call):
    sc = _tsc(sequence_list=SEQ_LIST_2)
    km = gt.Kmers(sc, 3, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(sc, km)


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
