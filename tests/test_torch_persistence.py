"""Persistence and export of the port against the JAX package, on the CPU.

* ``SequenceCollection.save`` / ``load`` and ``Kmers.save`` / ``load`` in
  hdf5 and shelve, in three directions: port -> port, port -> JAX and
  JAX -> port, for collections of each strand and for indexes sorted and
  unsorted, forward, reverse-complement and both-strand, at
  ``max_kmer_len=None`` and on an IUPAC genome; a loaded sorted index
  serves statistics and queries without a sort;
* ``get_kmers_full_arrays`` across strands, ``one_based_seq_index``, a
  library filter and group bounds;
* ``to_csv``: the bytes of the JAX package's ``to_csv`` and of the port's
  own row loop, for each field set and at ``kmer_len=None``, also through
  the pandas writer;
* the raise messages, verbatim.

Tolerance: exact equality (integers, strings and bytes), dtypes included.
"""

import builtins

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu_torch import kmers as tk
from genome_kmers_tpu_torch.ops import filters as tf

SEQS = [
    ("chr1", "ACGTTGCAAGGCTTAACCGGTACGATCGAACGTTGCAAGGCTT" * 3),
    ("chr2", "GGGCCCAAATTTGGGCCCAAAT"),
    ("chr3", "ACGTAACGTATTGACGTAACGTAC" * 2),
]
SEQS_IUPAC = [
    ("chr1", "ACGTNNNACGTRYACGTTGCAAGGCTT" * 3),
    ("chr2", "GGGCCCAAATTTGGGKMCCAAAT"),
]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _pair(strand="forward", seqs=SEQS, mn=3, mx=8, sort=True, track=False):
    """The same index in both packages."""
    scj = gj.SequenceCollection(sequence_list=seqs, strands_to_load=strand)
    sct = gt.SequenceCollection(sequence_list=seqs, strands_to_load=strand, device="cpu")
    if strand == "forward":
        kj, kt = gj.Kmers(scj, mn, mx), gt.Kmers(sct, mn, mx)
    else:
        kj = gj.Kmers.from_strand(scj, mn, mx, source_strand=strand,
                                  track_strands_separately=track)
        kt = gt.Kmers.from_strand(sct, mn, mx, source_strand=strand,
                                  track_strands_separately=track)
    if sort:
        kj.sort()
        kt.sort()
    return kj, kt


# --------------------------------------------------------------------------- #
# collections
# --------------------------------------------------------------------------- #


def _collection_state(sc):
    return (
        sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names,
        sc.revcomp_sba, sc._revcomp_sba_seg_starts, sc.revcomp_record_names,
        sc._strands_loaded,
    )


def _same_state(a, b):
    for x, y in zip(_collection_state(a), _collection_state(b)):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None
            assert np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
        else:
            assert x == y


@pytest.mark.parametrize("fmt", ["hdf5", "shelve"])
@pytest.mark.parametrize("strand", ["forward", "reverse_complement", "both"])
@pytest.mark.parametrize("direction", ["port->port", "port->jax", "jax->port"])
def test_collection_round_trip(tmp_path, fmt, strand, direction):
    scj = gj.SequenceCollection(sequence_list=SEQS, strands_to_load=strand)
    sct = gt.SequenceCollection(sequence_list=SEQS, strands_to_load=strand, device="cpu")
    path = str(tmp_path / "coll")
    (scj if direction.startswith("jax") else sct).save(path, format=fmt)
    loaded = (gj if direction.endswith("jax") else gt).SequenceCollection(
        **({} if direction.endswith("jax") else {"device": "cpu"})
    )
    if not direction.endswith("jax"):
        sct.device_cache("forward" if strand != "reverse_complement" else strand).packed
        loaded._device = dict(sct._device)  # a cache that load must drop
    loaded.load(path, format=fmt)
    _same_state(loaded, sct)
    if not direction.endswith("jax"):
        assert loaded == sct and loaded._device == {} and loaded.device == torch.device("cpu")


def test_collection_unknown_format_raises_as_jax(tmp_path):
    sct = gt.SequenceCollection(sequence_list=SEQS, device="cpu")
    scj = gj.SequenceCollection(sequence_list=SEQS)
    for fn_t, fn_j in ((lambda: sct.save(str(tmp_path / "x"), format="csv"),
                        lambda: scj.save(str(tmp_path / "x"), format="csv")),
                       (lambda: sct.load(str(tmp_path / "x"), format="npz"),
                        lambda: scj.load(str(tmp_path / "x"), format="npz"))):
        assert _outcome(fn_t) == _outcome(fn_j)


# --------------------------------------------------------------------------- #
# indexes
# --------------------------------------------------------------------------- #

VARIANTS = {
    "forward-sorted": dict(),
    "forward-unsorted": dict(sort=False),
    "revcomp-sorted": dict(strand="reverse_complement"),
    "both-sorted-tracked": dict(strand="both", track=True, mn=4, mx=4),
    "suffix-sorted": dict(mn=1, mx=None),
    "iupac-sorted": dict(seqs=SEQS_IUPAC, mn=5, mx=12),
}


def _stats(km):
    k = km.max_kmer_len
    out = [km.get_kmer_count(k), km.get_kmers_arrays(k)[0].tolist()]
    if km._is_sorted:
        counts, total = km.get_kmer_group_counts(k, max_counts_bin=20)
        out += [counts.tolist(), total]
    return out


@pytest.mark.parametrize("fmt", ["hdf5", "shelve"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kmers_round_trip_three_directions(tmp_path, monkeypatch, fmt, variant):
    kj, kt = _pair(**VARIANTS[variant])
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    kj.save(pj, include_sequence_collection=True, format=fmt)
    kt.save(pt, include_sequence_collection=True, format=fmt)
    # port -> JAX
    j_loaded = gj.Kmers()
    j_loaded.load(pt, format=fmt)
    assert j_loaded == kj
    assert j_loaded.kmer_sba_start_indices.dtype == np.uint32
    # JAX -> port and port -> port, the collection from the file onto the CPU
    want = _stats(kt)
    for path in (pj, pt):
        loaded = gt.Kmers()
        loaded.load(path, format=fmt, device="cpu")
        assert loaded == kt and loaded.device == torch.device("cpu")
        assert loaded._strand_extension == (kt.kmer_source_strand != "forward")
        assert loaded.kmer_sba_start_indices.dtype == np.uint32
        # no sort runs for the statistics of a loaded index
        monkeypatch.setattr(gt.Kmers, "sort", lambda *a, **k: pytest.fail("sorted again"))
        assert _stats(loaded) == want
        if loaded._is_sorted and loaded.kmer_source_strand != "both":
            sba = kt._host_sba().tobytes().decode()
            qk = max(kt.min_kmer_len, 4)
            qs = [sba[i : i + qk] for i in range(0, len(sba) - qk, 5)]
            qs = [q for q in qs if "$" not in q]
            assert np.array_equal(loaded.count_queries(qs, qk), kt.count_queries(qs, qk))
        monkeypatch.undo()


def test_kmers_load_with_a_given_collection(tmp_path):
    kj, kt = _pair()
    path = str(tmp_path / "k.h5")
    kt.save(path)  # the index alone
    loaded = gt.Kmers()
    loaded.load(path, seq_coll=kt.seq_coll)
    assert loaded == kt and loaded.seq_coll is kt.seq_coll and loaded.device == kt.device
    j_loaded = gj.Kmers()
    j_loaded.load(path, seq_coll=kj.seq_coll)
    assert j_loaded == kj


def test_kmers_load_defaults_to_cuda(tmp_path, monkeypatch):
    _, kt = _pair()
    path = str(tmp_path / "k.h5")
    kt.save(path, include_sequence_collection=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt.Kmers().load(path)


def test_kmers_unknown_format_raises_as_jax(tmp_path):
    kj, kt = _pair()
    p = str(tmp_path / "x")
    assert _outcome(lambda: kt.save(p, format="zip")) == _outcome(lambda: kj.save(p, format="zip"))
    assert _outcome(lambda: gt.Kmers().load(p, format="zip", device="cpu")) == _outcome(
        lambda: gj.Kmers().load(p, format="zip"))


# --------------------------------------------------------------------------- #
# get_kmers_full_arrays
# --------------------------------------------------------------------------- #

FULL_CASES = [
    ("forward", 8, False, None, {}),
    ("forward", 8, True, None, {"min_group_size": 2, "yield_first_n": 1}),
    ("forward", None, True, None, {}),
    ("forward", 5, False, "gc", {"max_group_size": 3}),
    ("reverse_complement", 8, False, None, {}),
    ("reverse_complement", 6, True, "gc", {}),
    ("both", 8, True, None, {"min_group_size": 2}),
    ("both", None, False, None, {}),
]


@pytest.mark.parametrize("case", FULL_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_full_arrays_match_jax(case):
    strand, k, one_based, filt, bounds = case
    # every row holds k bases (k <= min_kmer_len), or k is None
    kj, kt = _pair(strand, mn=3 if k is None else 8, mx=8)
    fj = jf.kmer_filter_keep_all if filt is None else jf.gen_kmer_gc_content_filter_func(
        0.2, 0.8, 5)
    ft = tf.kmer_filter_keep_all if filt is None else tf.gen_kmer_gc_content_filter_func(
        0.2, 0.8, 5)
    want = kj.get_kmers_full_arrays(k, one_based, fj, **bounds)
    got = kt.get_kmers_full_arrays(k, one_based, ft, **bounds)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    # the generator's full-info rows, the same values
    rows = list(kt.get_kmers(k, one_based, ft, "full", **bounds))
    assert [r[0] for r in rows] == got["kmer_num"].tolist()
    assert [r[3] for r in rows] == got["seq_start_idx"].tolist()


def test_full_arrays_raises_as_jax():
    kj, kt = _pair(mn=3, mx=None)
    for k in (30, 0):
        want = _outcome(lambda: kj.get_kmers_full_arrays(k))
        assert want[0] is ValueError and _outcome(lambda: kt.get_kmers_full_arrays(k)) == want
    uj, ut = _pair(sort=False)
    assert _outcome(lambda: ut.get_kmers_full_arrays(5, min_group_size=2)) == _outcome(
        lambda: uj.get_kmers_full_arrays(5, min_group_size=2))


# --------------------------------------------------------------------------- #
# to_csv
# --------------------------------------------------------------------------- #

FIELD_SETS = [
    ["kmer"],
    ["kmer_num"],
    ["chrom", "start", "strand"],
    ["kmer", "group_size"],
    ["kmer_num", "kmer", "chrom", "start", "strand", "group_size"],
    ["kmer", "kmer_num", "kmer"],
]


def _csv_outcomes(kj, kt, kmer_len, fields, tmp_path):
    paths = [tmp_path / n for n in ("jax.csv", "port.csv", "loop.csv")]
    outs = [
        _outcome(lambda: kj.to_csv(kmer_len, str(paths[0]), fields)),
        _outcome(lambda: kt.to_csv(kmer_len, str(paths[1]), fields)),
        _outcome(lambda: kt._to_csv_row_loop(kmer_len, str(paths[2]), fields)),
    ]
    return outs, [p.read_bytes() if o is None else o for o, p in zip(outs, paths)]


@pytest.mark.parametrize("fields", FIELD_SETS, ids=lambda f: "+".join(f))
@pytest.mark.parametrize("index", ["forward-8", "forward-none", "revcomp-6", "both-5"])
def test_to_csv_bytes_match_jax_and_the_row_loop(tmp_path, fields, index):
    strand, k = {"forward-8": ("forward", 8), "forward-none": ("forward", None),
                 "revcomp-6": ("reverse_complement", 6), "both-5": ("both", 5)}[index]
    kj, kt = _pair(strand, mn=3, mx=8)
    outs, results = _csv_outcomes(kj, kt, k, fields, tmp_path)
    assert results[0] == results[1] == results[2]


def test_to_csv_raises_as_jax(tmp_path):
    kj, kt = _pair(mn=3, mx=None)
    # extends beyond the segment; kmer_len None past max_kmer_len on a bounded index
    for k, fields in ((30, ["kmer"]), (30, ["kmer", "group_size"]), (30, ["chrom"]),
                      (30, ["kmer_num"])):
        outs, results = _csv_outcomes(kj, kt, k, fields, tmp_path)
        assert results[0] == results[1] == results[2], (k, fields)
    bj, bt = _pair(mn=5, mx=8)
    for fields in (["kmer", "chrom"], ["kmer"]):
        outs, results = _csv_outcomes(bj, bt, None, fields, tmp_path)
        assert results[0] == results[1] == results[2], fields
    assert _outcome(lambda: kt.to_csv(5, str(tmp_path / "x.csv"), ["kmer", "gc"])) == _outcome(
        lambda: kj.to_csv(5, str(tmp_path / "x.csv"), ["kmer", "gc"]))


def test_to_csv_through_pandas(tmp_path, monkeypatch):
    """The writer's fallback when pyarrow does not import: the same bytes."""
    kj, kt = _pair("both", mn=6, mx=8)
    want = tmp_path / "want.csv"
    fields = ["kmer", "chrom", "start", "strand", "group_size"]
    kt.to_csv(6, str(want), fields)
    kt.to_csv(None, str(tmp_path / "want_var.csv"), ["kmer_num", "kmer"])
    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.startswith("pyarrow"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    kt.to_csv(6, str(tmp_path / "pandas.csv"), fields)
    kt.to_csv(None, str(tmp_path / "pandas_var.csv"), ["kmer_num", "kmer"])
    monkeypatch.undo()
    assert (tmp_path / "pandas.csv").read_bytes() == want.read_bytes()
    assert (tmp_path / "pandas_var.csv").read_bytes() == (tmp_path / "want_var.csv").read_bytes()


def test_to_csv_decodes_through_the_native_library(tmp_path, monkeypatch):
    _, kt = _pair(mn=5, mx=8)
    calls = []
    real_fixed, real_var = tk.decode_rows_native, tk.decode_rows_var_native
    monkeypatch.setattr(tk, "decode_rows_native",
                        lambda *a: calls.append("fixed") or real_fixed(*a))
    monkeypatch.setattr(tk, "decode_rows_var_native",
                        lambda *a: calls.append("var") or real_var(*a))
    kt.to_csv(5, str(tmp_path / "a.csv"))
    kt.to_csv(None, str(tmp_path / "b.csv"))
    assert calls == ["fixed", "var"]
