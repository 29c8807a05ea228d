"""The port's ``LargeKmers`` against the JAX package's, call by call.

Both packages build from the same records (made from a seed with NumPy):
an ACGT genome (2-bit keys) and one with N, R and Y codes (4-bit keys),
each with a repeated stretch and a short record. The JAX index is sorted
on one device (its outputs do not depend on the mesh; the interop test
carries a layout of 2 shards); the port's on 1, 2 and 4 CPU shards, and
every output must equal the JAX package's: sorted positions, group histograms
and totals (uint64) at bounded lengths, at None and beyond one window;
``both_strands`` with and without ``track_strands_separately``; a
``positions`` subset; the five library filters and their rejections;
canonical counts; both query calls; the extraction calls and ``to_csv``
bytes; every error message of the reference's limits. Then a checkpoint
round trip onto another shard count, the interop of a JAX layout, and
``from_fasta``.

Tolerance: exact equality (integer outputs and bytes).
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu.ops.large import fuse64_np
from genome_kmers_tpu.parallel import make_mesh as j_make_mesh
from genome_kmers_tpu_torch.interop import large_from_numpy_state
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.parallel import make_mesh

SHARDS = (1, 2, 4)
J_DEV = 1  # the JAX mesh of the references


def _records(two_bit: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    alpha = "ACGT" if two_bit else "ACGTNRY"
    seqs = ["".join(rng.choice(list(alpha), size=n)) for n in (900, 500, 60)]
    seqs[1] = seqs[1][:200] + seqs[0][100:140] + seqs[1][240:]
    seqs.append(seqs[0][300:340])
    return [(f"r{i}", s) for i, s in enumerate(seqs)]


def _tmesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread while these tests run: the test workers share the
    host's cores, and the port's work here is small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e).__name__, str(e)


def _pair(two_bit, mn, mx, both=False, track=False):
    """(JAX LargeKmers sorted on J_DEV devices, port LargeKmers unsorted)."""
    recs = _records(two_bit)
    j = gj.LargeKmers.from_records(recs, mn, mx, both_strands=both,
                                   track_strands_separately=track)
    j.sort(j_make_mesh(J_DEV))
    return j, gt.LargeKmers.from_records(recs, mn, mx, both_strands=both,
                                         track_strands_separately=track)


def _each_mesh(t, **sort_kwargs):
    for n in SHARDS:
        t.sort(_tmesh(n), **sort_kwargs)
        yield n


def _same_counts(got, want):
    assert got[0].dtype == np.uint64 and np.array_equal(got[0], want[0]) and got[1] == want[1]


def _equal(got, want) -> bool:
    """Outputs equal: arrays (and their dtypes) element for element,
    containers item for item, errors by type and message."""
    if isinstance(want, np.ndarray):
        return isinstance(got, np.ndarray) and got.dtype == want.dtype and np.array_equal(got, want)
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            _equal(got[k], want[k]) for k in want)
    if isinstance(want, (tuple, list)):
        return (isinstance(got, (tuple, list)) and len(got) == len(want)
                and all(_equal(g, w) for g, w in zip(got, want)))
    return got == want


def _substrings(two_bit, length, step=41):
    """Query strings: substrings of the records, which occur in the genome."""
    return [s[i : i + length] for _, s in _records(two_bit) for i in range(0, len(s) - length, step)]


GENOMES = [pytest.param(True, id="acgt"), pytest.param(False, id="iupac")]


# --------------------------------------------------------------------------- #
# sort and statistics
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mn,mx", [(5, 31), (1, None), (3, 80)])
@pytest.mark.parametrize("two_bit", GENOMES)
def test_sort_and_statistics_match_jax(two_bit, mn, mx):
    """Within one window (variable caps), suffix mode, and a bound beyond
    the window: sorted positions, group counts at None, at 10 and at the
    bound, with group-size bounds, and ``get_kmer_count``."""
    j, t = _pair(two_bit, mn, mx)
    assert np.array_equal(t.packed_words, j.packed_words) and t.two_bit == j.two_bit
    assert len(t) == len(j) and t._one_window == j._one_window
    calls = [
        lambda k: k.get_kmer_group_counts(None, max_counts_bin=20),
        lambda k: k.get_kmer_group_counts(10, min_group_size=2, max_group_size=5),
        lambda k: k.get_kmer_group_counts(mx, max_counts_bin=3),
        lambda k: k.get_kmer_count(10, min_group_size=2),
    ]
    want = [c(j) for c in calls]
    for _ in _each_mesh(t):
        assert np.array_equal(t.sorted_positions(), j.sorted_positions())
        for c, w in zip(calls, want):
            got = c(t)
            if isinstance(w, tuple):
                _same_counts(got, w)
            else:
                assert got == w


@pytest.mark.parametrize("track,mx", [(False, 31), (True, 31), (True, None)])
def test_both_strands_match_jax(track, mx):
    """A both-strand index, with and without strand-split groups: counts,
    full-info arrays (strand "-", forward coordinates) and yields."""
    j, t = _pair(True, 8 if mx else 1, mx, both=True, track=track)
    calls = [
        lambda k: k.get_kmer_group_counts(mx, max_counts_bin=9),
        lambda k: k.get_kmer_count(8),
        lambda k: k.get_kmers_full_arrays(None, one_based_seq_index=True),
        lambda k: list(k.get_kmers(None, kmer_info_to_yield="full", yield_first_n=1)),
        lambda k: k.get_kmers_full_arrays(8),
    ]
    want = [_outcome(lambda c=c: c(j)) for c in calls]
    for _ in _each_mesh(t):
        for c, w in zip(calls, want):
            assert _equal(_outcome(lambda: c(t)), w)


@pytest.mark.parametrize("two_bit", GENOMES)
def test_positions_subset_matches_jax(two_bit):
    """``sort(positions=)`` with a shuffled subset, truncated rows included:
    positions, counts, and the CRISPR filter, whose lanes route checks
    that the subset's caps cover min_kmer_len (they do not here, so both
    packages refuse it)."""
    recs = _records(two_bit)
    rng = np.random.default_rng(4)
    j = gj.LargeKmers.from_records(recs, 23, 31)
    pos = rng.permutation(j.build_positions())[:700]
    pos = np.concatenate([pos, np.array([899, 895], dtype=np.uint64)])
    j.sort(j_make_mesh(J_DEV), positions=pos)
    t = gt.LargeKmers.from_records(recs, 23, 31)
    assert np.array_equal(t.build_positions(), j.build_positions())
    want = j.get_kmer_group_counts(23, max_counts_bin=5)
    want_err = _outcome(lambda: j.get_kmer_count(23, jf.crispr_ngg_pam_filter))
    for _ in _each_mesh(t, positions=pos):
        assert t._custom_positions and np.array_equal(t.sorted_positions(), j.sorted_positions())
        _same_counts(t.get_kmer_group_counts(23, max_counts_bin=5), want)
        assert _outcome(lambda: t.get_kmer_count(23, tf.crispr_ngg_pam_filter)) == want_err


# --------------------------------------------------------------------------- #
# filters
# --------------------------------------------------------------------------- #


FILTERS = {
    "gc": lambda m: m.gen_kmer_gc_content_filter_func(0.3, 0.6, 12),
    "length": lambda m: m.gen_kmer_length_filter_func(20),
    "homopoly": lambda m: m.gen_kmer_homopolymer_filter_func(3, 12),
    "noamb": lambda m: m.gen_no_ambiguous_bases_filter(12),
    "crispr": lambda m: m.crispr_ngg_pam_filter,
}


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("two_bit", GENOMES)
def test_filters_match_jax(two_bit, name):
    """Each library filter on the sorted lanes: filtered counts (survivors
    in unfiltered groups), group bounds, yields; or the filter's own error
    at the first offending row where the rows are too short for it."""
    j, t = _pair(two_bit, 23, 31)
    calls = [
        lambda k, m: k.get_kmer_group_counts(12, kmer_filter_func=FILTERS[name](m)),
        lambda k, m: k.get_kmer_count(12, FILTERS[name](m), min_group_size=2),
        lambda k, m: k.get_kmers_arrays(12, FILTERS[name](m), yield_first_n=2),
    ]
    want = [_outcome(lambda c=c: c(j, jf)) for c in calls]
    for _ in _each_mesh(t):
        for c, w in zip(calls, want):
            assert _equal(_outcome(lambda: c(t, tf)), w)


@pytest.mark.parametrize("kind", ["callable", "vectorized"])
def test_filter_rejections_match_jax(kind):
    """A plain callable or a VectorizedFilter cannot run on the lanes: the
    JAX package's NotImplementedError and message."""
    j, t = _pair(True, 5, 31)
    t.sort(_tmesh(2))

    def make(m):
        if kind == "callable":
            return lambda sba, strand, i: True
        return m.VectorizedFilter(lambda *a: None)

    want = _outcome(lambda: j.get_kmer_group_counts(12, kmer_filter_func=make(jf)))
    assert want[0] == "NotImplementedError"
    assert _outcome(lambda: t.get_kmer_group_counts(12, kmer_filter_func=make(tf))) == want


# --------------------------------------------------------------------------- #
# canonical counts and queries
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("two_bit", GENOMES)
def test_canonical_counts_match_jax(two_bit):
    j, t = _pair(two_bit, 5, 31)
    limit = 31 if two_bit else 13
    want = [j.get_canonical_kmer_group_counts(k, max_counts_bin=30) for k in (7, limit)]
    for n in SHARDS:
        t.sort(_tmesh(n))
        for k, w in zip((7, limit), want):
            _same_counts(t.get_canonical_kmer_group_counts(k, max_counts_bin=30), w)
    fresh = gt.LargeKmers.from_records(_records(two_bit), 5, 31)
    _same_counts(fresh.get_canonical_kmer_group_counts(7, max_counts_bin=30, mesh=_tmesh(3)),
                 want[0])


@pytest.mark.parametrize("two_bit", GENOMES)
def test_queries_match_jax(two_bit):
    """``count_queries`` at the query length and at a shorter one, with
    k-mers of the index, random ones and (2-bit) ones with an N;
    ``count_queries_canonical``; the one-window cap's message."""
    j, t = _pair(two_bit, 5, 31)
    rng = np.random.default_rng(8)
    queries = _substrings(two_bit, 20)
    queries += ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(10)]
    queries += ["ACGTN" * 4, "A" * 20]
    want = [j.count_queries(queries), j.count_queries([q[:9] for q in queries], 9),
            j.count_queries_canonical(queries)]
    for _ in _each_mesh(t):
        got = [t.count_queries(queries), t.count_queries([q[:9] for q in queries], 9),
               t.count_queries_canonical(queries)]
        for g, w in zip(got, want):
            assert g.dtype == np.uint64 and np.array_equal(g, w)
    assert t.count_queries([]).dtype == np.uint64 and len(t.count_queries_canonical([])) == 0
    t80 = gt.LargeKmers.from_records(_records(two_bit), 5, 80)
    t80.sort(_tmesh(2))
    limit = 64 if two_bit else 32
    assert _outcome(lambda: t80.count_queries(["A" * 70])) == (
        "NotImplementedError",
        f"count_queries requires kmer_len <= {limit} (query keys are one-window; "
        "the sorted order itself supports any kmer_len)",
    )


# --------------------------------------------------------------------------- #
# extraction
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("two_bit,mn,mx", [(True, 5, 31), (False, 5, 31), (True, 1, None)])
def test_extraction_matches_jax(two_bit, mn, mx, tmp_path):
    """``get_kmers`` (both kinds), the arrays, the full arrays, the strings
    (at a length and at None) and ``to_csv`` bytes, every field."""
    j, t = _pair(two_bit, mn, mx)
    nums = np.arange(0, len(j), 11)
    calls = [
        lambda k: list(k.get_kmers(5, min_group_size=2)),
        lambda k: list(k.get_kmers(None, kmer_info_to_yield="full", yield_first_n=1)),
        lambda k: k.get_kmers_arrays(5, min_group_size=2, max_group_size=4),
        lambda k: k.get_kmers_full_arrays(None, one_based_seq_index=True),
        lambda k: k.get_kmer_strs(nums, 5),
        lambda k: k.get_kmer_strs(nums[:40], None),
        lambda k: k.get_kmer_str(3, 4),
    ]
    want = [_outcome(lambda c=c: c(j)) for c in calls]
    fields = ["kmer", "kmer_num", "chrom", "start", "strand", "group_size"]
    csvs = ((5, fields), (None, ["kmer", "start"]), (5, ["kmer_num", "group_size"]))
    want_csv = [_outcome(lambda: j.to_csv(kl, tmp_path / "j.csv", fields=flds))
                or (tmp_path / "j.csv").read_bytes() for kl, flds in csvs]
    for n in _each_mesh(t):
        for c, w in zip(calls, want):
            assert _equal(_outcome(lambda: c(t)), w)
        for (kl, flds), w in zip(csvs, want_csv):
            out = tmp_path / f"t{n}.csv"
            assert (_outcome(lambda: t.to_csv(kl, out, fields=flds)) or out.read_bytes()) == w


# --------------------------------------------------------------------------- #
# the reference's limits and errors
# --------------------------------------------------------------------------- #


def _sorted_port(two_bit=True, mn=5, mx=31, both=False):
    t = gt.LargeKmers.from_records(_records(two_bit), mn, mx, both_strands=both)
    t.sort(_tmesh(2))
    return t


def _sorted_jax(two_bit=True, mn=5, mx=31, both=False):
    j = gj.LargeKmers.from_records(_records(two_bit), mn, mx, both_strands=both)
    j.sort(j_make_mesh(J_DEV))
    return j


ERRORS = {
    "min_above_max": (lambda g, m: g.LargeKmers.from_records(_records(True), 9, 8), None),
    "min_above_shortest": (lambda g, m: g.LargeKmers.from_records(_records(True), 70, 80), None),
    "unaligned_segments": (lambda g, m: g.LargeKmers(np.zeros(4, np.uint32), np.zeros(2, np.uint64),
                                                     np.zeros(1, np.uint64), 1, 2), None),
    "empty_record": (lambda g, m: g.LargeKmers.from_records([("a", "ACGT"), ("b", "")], 1, 2), None),
    "lowercase": (lambda g, m: g.LargeKmers.from_records([("a", "ACgT")], 1, 2), None),
    "iupac_on_2bit": (lambda g, m: g.LargeKmers.from_records([("a", "ACNT")], 1, 2, two_bit=True),
                      None),
    "track_without_both": (lambda g, m: g.LargeKmers.from_records(
        _records(True), 1, 2, track_strands_separately=True), None),
    "stats_unsorted": (lambda g, m: g.LargeKmers.from_records(_records(True), 5, 31)
                       .get_kmer_group_counts(5), None),
    "queries_unsorted": (lambda g, m: g.LargeKmers.from_records(_records(True), 5, 31)
                         .count_queries(["ACGTA"]), None),
    "strs_unsorted": (lambda g, m: g.LargeKmers.from_records(_records(True), 5, 31)
                      .get_kmer_strs([0], 5), None),
    "positions_unsorted": (lambda g, m: g.LargeKmers.from_records(_records(True), 5, 31)
                           .sorted_positions(), None),
    "canonical_no_mesh": (lambda g, m: g.LargeKmers.from_records(_records(True), 5, 31)
                          .get_canonical_kmer_group_counts(5), None),
    "kmer_len_above_max": (lambda g, k: k.get_kmer_group_counts(32), "sorted"),
    "kmer_len_zero": (lambda g, k: k.get_kmer_count(0), "sorted"),
    "max_counts_bin": (lambda g, k: k.get_kmer_group_counts(5, max_counts_bin=0), "sorted"),
    "canonical_limit": (lambda g, k: k.get_canonical_kmer_group_counts(65), "sorted"),
    "canonical_both_strands": (lambda g, k: k.get_canonical_kmer_group_counts(5), "both"),
    "canonical_queries_both": (lambda g, k: k.count_queries_canonical(["ACGTA"]), "both"),
    "query_length": (lambda g, k: k.count_queries(["ACGTA", "ACG"]), "sorted"),
    "kmer_num_bounds": (lambda g, k: k.get_kmer_strs([10**6], 5), "sorted"),
    "beyond_segment": (lambda g, k: k.get_kmer_strs(np.arange(len(k)), 31), "sorted"),
    "beyond_segment_full": (lambda g, k: k.get_kmers_full_arrays(31), "sorted"),
    "bad_info_kind": (lambda g, k: list(k.get_kmers(5, kmer_info_to_yield="all")), "sorted"),
    "bad_csv_field": (lambda g, k: k.to_csv(5, "/nonexistent/x.csv", fields=["kmer", "x"]),
                      "sorted"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    """Each limit of the reference and its exact error type and message."""
    call, needs = ERRORS[case]
    if needs is None:
        got, want = _outcome(lambda: call(gt, None)), _outcome(lambda: call(gj, None))
    else:
        both = needs == "both"
        got = _outcome(lambda: call(gt, _sorted_port(both=both)))
        want = _outcome(lambda: call(gj, _sorted_jax(both=both)))
    assert isinstance(want, tuple) and got == want


# --------------------------------------------------------------------------- #
# checkpoints, interop, FASTA
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mx,src,dst", [(31, 2, 1), (31, 1, 4), (None, 4, 2)])
def test_checkpoint_round_trip_onto_another_mesh(tmp_path, mx, src, dst):
    """A sorted index saved from ``src`` shards and restored onto ``dst``:
    the same sorted positions and the JAX package's statistics (lanes and
    run ids rebuilt); the metadata keys and values are the JAX package's;
    a mismatched index and an unsorted one are refused as the JAX
    package refuses them."""
    j = _sorted_jax(True, 5 if mx else 1, mx)
    t = gt.LargeKmers.from_records(_records(True), 5 if mx else 1, mx)
    t.sort(_tmesh(src))
    t.save_checkpoint(tmp_path / "ck")
    j.save_checkpoint(tmp_path / "jk")
    import json

    tm, jm = (json.loads((tmp_path / d / "gkt_meta.json").read_text()) for d in ("ck", "jk"))
    assert tm.keys() == jm.keys()
    assert all(tm[key] == jm[key] for key in jm if not key.startswith("__"))
    t2 = gt.LargeKmers.from_records(_records(True), 5 if mx else 1, mx)
    t2.load_checkpoint(tmp_path / "ck", _tmesh(dst))
    assert np.array_equal(t2.sorted_positions(), j.sorted_positions())
    _same_counts(t2.get_kmer_group_counts(None, max_counts_bin=9),
                 j.get_kmer_group_counts(None, max_counts_bin=9))
    f = (tf.gen_kmer_gc_content_filter_func(0.3, 0.6, 12), jf.gen_kmer_gc_content_filter_func(0.3, 0.6, 12))
    assert _outcome(lambda: t2.get_kmer_count(None, f[0])) == _outcome(
        lambda: j.get_kmer_count(None, f[1]))
    other = gt.LargeKmers.from_records(_records(True), 6, mx)
    jother = gj.LargeKmers.from_records(_records(True), 6, mx)
    assert _outcome(lambda: other.load_checkpoint(tmp_path / "ck", _tmesh(1)))[0] == "ValueError"
    assert (_outcome(lambda: other.load_checkpoint(tmp_path / "ck", _tmesh(1)))[1].split("(ckpt")[0]
            == _outcome(lambda: jother.load_checkpoint(tmp_path / "jk", j_make_mesh(1)))[1]
            .split("(ckpt")[0])
    assert _outcome(lambda: other.save_checkpoint(tmp_path / "x")) == _outcome(
        lambda: jother.save_checkpoint(tmp_path / "y"))


@pytest.mark.parametrize("mx,two_bit", [(31, True), (None, True)])
def test_interop_carries_a_jax_layout(mx, two_bit):
    """``large_from_numpy_state`` places the JAX index's sorted layout on a
    port mesh of its shard count, shard for shard: the same positions, and
    the JAX package's counts, filtered counts and queries over it."""
    mn, n_dev = 5 if mx else 1, 2
    j = gj.LargeKmers.from_records(_records(two_bit), mn, mx)
    j.sort(j_make_mesh(n_dev))
    (hi, lo), pad, _, _, _ = j._sorted
    fused = fuse64_np(np.asarray(hi), np.asarray(lo)).reshape(n_dev, -1)
    pads = np.asarray(pad).reshape(n_dev, -1)
    t = large_from_numpy_state(
        j.packed_words, j.seg_starts, j.seg_ends, mn, mx, two_bit=two_bit,
        record_names=j.record_names, mesh=_tmesh(n_dev), mesh_positions=list(fused),
        mesh_pad=list(pads),
    )
    for p in range(n_dev):
        assert np.array_equal(t._sorted[0][p].numpy().view(np.uint64), fused[p])
    assert np.array_equal(t.sorted_positions(), j.sorted_positions())
    _same_counts(t.get_kmer_group_counts(None), j.get_kmer_group_counts(None))
    _same_counts(t.get_kmer_group_counts(9, gt.gen_kmer_length_filter_func(12)),
                 j.get_kmer_group_counts(9, gj.gen_kmer_length_filter_func(12)))
    q = _substrings(two_bit, 10)
    assert np.array_equal(t.count_queries(q), j.count_queries(q))


@pytest.mark.parametrize("both", [False, True])
def test_from_fasta_matches_jax(tmp_path, both):
    """Records streamed out of a FASTA file (lowercase, wrapped lines, a
    trailing empty record) build the JAX package's pack and index."""
    recs = _records(False)
    path = tmp_path / "g.fa"
    path.write_text("".join(f">{n} desc\n{s[:50].lower()}\n{s[50:]}\n" for n, s in recs) + ">e\n")
    j = gj.LargeKmers.from_fasta(path, 5, 20, both_strands=both)
    t = gt.LargeKmers.from_fasta(path, 5, 20, both_strands=both)
    assert np.array_equal(t.packed_words, j.packed_words) and t.record_names == j.record_names
    assert np.array_equal(t.seg_starts, j.seg_starts) and np.array_equal(t.seg_ends, j.seg_ends)
    j.sort(j_make_mesh(J_DEV))
    t.sort(_tmesh(3))
    _same_counts(t.get_kmer_group_counts(20), j.get_kmer_group_counts(20))
    assert torch.is_tensor(t._sorted[0][0])


@pytest.mark.parametrize("mn,mx", [(4, 31), (1, None)])
def test_large_sort_on_a_2d_mesh(mn, mx, tmp_path):
    """``make_mesh2(2, 2)`` (the two-stage exchange): each shard's layout
    byte for byte the 1-D mesh's of 4 shards, the same counts; a layout
    sorted on it restores onto a 1-D mesh (the counterparts of
    tests/test_hier_integration.py's ``test_large_suffix`` and
    ``test_checkpoint_across_mesh_shapes``)."""
    from genome_kmers_tpu_torch.parallel import make_mesh2

    flat = gt.LargeKmers.from_records(_records(True), mn, mx)
    flat.sort(_tmesh(4))
    two_d = gt.LargeKmers.from_records(_records(True), mn, mx)
    two_d.sort(make_mesh2(2, 2, devices=["cpu"] * 4))
    for a, b in zip(flat._sorted[0], two_d._sorted[0]):
        assert torch.equal(a, b)
    want = flat.get_kmer_group_counts(None, max_counts_bin=30)
    _same_counts(two_d.get_kmer_group_counts(None, max_counts_bin=30), want)
    two_d.save_checkpoint(tmp_path / "ck2d")
    back = gt.LargeKmers.from_records(_records(True), mn, mx)
    back.load_checkpoint(tmp_path / "ck2d", _tmesh(4))
    _same_counts(back.get_kmer_group_counts(None, max_counts_bin=30), want)
