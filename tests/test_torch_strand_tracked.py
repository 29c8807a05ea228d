"""Statistics and yields of strand-tracked indexes against a string oracle,
on the CPU.

With ``track_strands_separately=True`` a group is a pair (the k-mer's
string at ``kmer_len``, its strand). The JAX package cuts a group wherever
the strand changes between neighbouring sorted rows, which is right only
where ``kmer_len`` covers the whole sorted key: below it, rows of
different full strings interleave the strands inside one group, and the
cut splits it into pieces (ROADMAP.md §C7). The port counts each string
group's "+" rows and "-" rows apart, and yields each group's "+" rows
before its "-" rows, on every route: the boundary route, the filtered
lanes, the flag plane and the window, a CPU mesh of 1-3 shards, and
``LargeKmers``.

The oracle takes the strings of the sorted rows from the SBA bytes, walks
the (surviving) rows in sorted order into runs of equal strings, and
splits each run by strand. Where the JAX package answers otherwise, the
test names its answer as the recorded difference. Tolerance: exact
equality.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.parallel import make_mesh

COMPLEMENT = str.maketrans("ACGTRYSWKMBDHVN", "TGCAYRSWMKVHDBN")


def _revcomp(seq: str) -> str:
    return seq.translate(COMPLEMENT)[::-1]


def both_sba(seq_list) -> bytes:
    """The SBA of a both-strand index: the records, then their reverse
    complements in reverse record order, '$' between any two."""
    seqs = [s for _, s in seq_list] + [_revcomp(s) for _, s in reversed(seq_list)]
    return "$".join(seqs).encode()


def tracked_walk(sba: bytes, positions, strand_split: int, kmer_len, keep=None,
                 min_group_size: int = 1, max_group_size=None, yield_first_n=None):
    """The yields of a strand-tracked sorted index: (row, group size
    yielded, group size total) in yield order. Rows are places in the sorted
    order; ``keep`` (a bool a row) marks the filter's survivors. The
    surviving rows run, in sorted order, into runs of equal strings at
    ``kmer_len`` (None: to the end of the record); each run yields its "+"
    rows, then its "-" rows, each half a group of its own."""
    text = sba.decode()
    runs, prev = [], None
    for row, p in enumerate(int(x) for x in positions):
        if keep is not None and not keep[row]:
            continue
        end = text.find("$", p)
        end = len(text) if end < 0 else end
        key = text[p:end] if kmer_len is None else text[p:min(end, p + kmer_len)]
        if prev is None or key != prev:
            runs.append([])
        runs[-1].append((row, p >= strand_split))
        prev = key
    out = []
    for run in runs:
        for rc in (False, True):
            half = [row for row, is_rc in run if is_rc == rc]
            total = len(half)
            if total == 0 or total < min_group_size:
                continue
            if max_group_size is not None and total > max_group_size:
                continue
            n = total if yield_first_n is None else min(total, yield_first_n)
            out += [(row, n, total) for row in half[:n]]
    return out


def tracked_hist(sba, positions, strand_split, kmer_len, keep=None, min_group_size=1,
                 max_group_size=None, max_counts_bin=1000000):
    """(histogram, total) of the oracle's groups."""
    counts = np.zeros(max_counts_bin + 1, dtype=np.int64)
    total = 0
    for _, _, size in tracked_walk(sba, positions, strand_split, kmer_len, keep,
                                   min_group_size, max_group_size, yield_first_n=1):
        counts[min(size, max_counts_bin)] += 1
        total += size
    return counts, total


def kmers_oracle(km, kmer_len, keep=None, **bounds):
    """``tracked_hist`` of a port ``Kmers`` index."""
    return tracked_hist(km._host_sba().tobytes(), km.kmer_sba_start_indices,
                        km._revcomp_offset(), kmer_len, keep, **bounds)


def kmers_walk(km, kmer_len, keep=None, **bounds):
    return tracked_walk(km._host_sba().tobytes(), km.kmer_sba_start_indices,
                        km._revcomp_offset(), kmer_len, keep, **bounds)


def jax_keep(seq_list, positions, strand_split, jfilter) -> np.ndarray:
    """The survivors of a JAX library filter, one scalar call a row, each
    row in its own strand's SBA (the reference's filter contract)."""
    fwd = np.frombuffer("$".join(s for _, s in seq_list).encode(), dtype=np.uint8)
    rc = np.frombuffer("$".join(_revcomp(s) for _, s in reversed(seq_list)).encode(),
                       dtype=np.uint8)
    return np.array([
        bool(jfilter(fwd, "forward", int(p)) if int(p) < strand_split
             else jfilter(rc, "reverse_complement", int(p) - strand_split))
        for p in positions
    ])


def _tracked(seq_list, mn, mx):
    sc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load="both", device="cpu")
    km = gt.Kmers.from_strand(sc, mn, mx, source_strand="both", track_strands_separately=True)
    km.sort()
    return km


def _tracked_jax(seq_list, mn, mx):
    sc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="both")
    km = gj.Kmers.from_strand(sc, mn, mx, source_strand="both", track_strands_separately=True)
    km.sort()
    return km


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _hist_equal(got, want) -> bool:
    return np.array_equal(np.asarray(got[0]), want[0]) and int(got[1]) == want[1]


# --------------------------------------------------------------------------- #
# the two reproductions of ROADMAP.md §C7
# --------------------------------------------------------------------------- #

ACTAT = [("r0", "ACTAT")]


@pytest.mark.parametrize("route", ["one device", "mesh 1", "mesh 2", "mesh 3",
                                   "large 1", "large 2"])
def test_actat_at_one_base(route):
    """ACTAT on both strands, sorted at (2, 2), statistics at 1: the "A"
    group reads + - + - in sorted order. The oracle's groups per (base,
    strand) are four of size 1 and two of size 2."""
    want = (np.array([0, 4, 2, 0, 0, 0]), 8)
    if route.startswith("large"):
        lk = gt.LargeKmers.from_records(ACTAT, 2, 2, both_strands=True,
                                        track_strands_separately=True)
        lk.sort(_mesh(int(route[-1])))
        assert _hist_equal(lk.get_kmer_group_counts(1, max_counts_bin=5), want)
        assert lk.get_kmer_count(1, min_group_size=2) == 4
        nums, pos, gsy, gst = lk.get_kmers_arrays(1)
        walk = tracked_walk(both_sba(ACTAT), lk.sorted_positions(), 6, 1)
        assert [tuple(r) for r in zip(nums, gsy, gst)] == walk
        assert np.array_equal(pos, lk.sorted_positions()[nums])
        return
    km = _tracked(ACTAT, 2, 2)
    assert km.kmer_sba_start_indices.tolist() == [0, 8, 3, 6, 1, 9, 2, 7]
    assert _hist_equal(kmers_oracle(km, 1, max_counts_bin=5), want)
    mesh = None if route == "one device" else _mesh(int(route[-1]))
    assert _hist_equal(km.get_kmer_group_counts(1, max_counts_bin=5, mesh=mesh), want)
    assert km.get_kmer_count(1, min_group_size=2, mesh=mesh) == 4
    if mesh is None:
        nums, pos, gsy, gst = km.get_kmers_arrays(1)
        assert [tuple(r) for r in zip(nums, gsy, gst)] == kmers_walk(km, 1)
        assert [row[0] for row in kmers_walk(km, 1)] == [0, 2, 1, 3, 4, 5, 6, 7]


def test_actat_jax_answer_is_the_recorded_difference():
    """The JAX package cuts the "A" group at each strand change: eight
    groups of size 1, none of size 2 (ROADMAP.md §C7)."""
    jkm = _tracked_jax(ACTAT, 2, 2)
    counts, total = jkm.get_kmer_group_counts(1, max_counts_bin=5)
    assert np.array_equal(counts, [0, 8, 0, 0, 0, 0]) and total == 8
    assert jkm.get_kmer_count(1, min_group_size=2) == 0
    tkm = _tracked(ACTAT, 2, 2)
    assert _hist_equal(tkm.get_kmer_group_counts(1, max_counts_bin=5), kmers_oracle(
        tkm, 1, max_counts_bin=5))


def probe_genome(seed: int):
    """A seeded ACGT genome of 1-4 records with copied segments."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    unit = "".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 80))))
    records = []
    for i in range(n):
        parts = []
        for _ in range(int(rng.integers(2, 5))):
            parts.append("".join(rng.choice(list("ACGT"), size=int(rng.integers(30, 120)))))
            if rng.random() < 0.6:
                parts.append(unit if rng.random() < 0.5 else _revcomp(unit))
        records.append((f"r{i}", "".join(parts)))
    return records


SEED7 = probe_genome(7)
# (index rows, the oracle's count, the JAX package's count): this generator's
# genome 7 (1603 bases in 4 records), not the 716-base genome of ROADMAP.md §C7
SEED7_RECORDED = (3206, 3126, 1547)


@pytest.mark.parametrize("route", ["one device", "mesh 1", "mesh 2", "mesh 3"])
def test_seed7_length_filter(route):
    """The seeded genome 7, (1, 70) on both strands, ``get_kmer_count(1,
    LengthFilter(11), 3)``: the filter keeps the rows with 11 bases left,
    the count is at one base of identity. One device and every mesh give
    the oracle's answer."""
    km = _tracked(SEED7, 1, 70)
    keep = jax_keep(SEED7, km.kmer_sba_start_indices, km._revcomp_offset(), jf.LengthFilter(11))
    want = kmers_oracle(km, 1, keep, min_group_size=3)[1]
    mesh = None if route == "one device" else _mesh(int(route[-1]))
    assert km.get_kmer_count(1, tf.LengthFilter(11), 3, mesh=mesh) == want
    assert _hist_equal(km.get_kmer_group_counts(1, tf.LengthFilter(11), 3, max_counts_bin=40,
                                                mesh=mesh),
                       kmers_oracle(km, 1, keep, min_group_size=3, max_counts_bin=40))


def test_seed7_jax_answer_is_the_recorded_difference():
    """The JAX package's single-device route cuts at strand changes among
    the survivors and gives fewer rows in groups of 3 or more than the
    oracle."""
    jkm = _tracked_jax(SEED7, 1, 70)
    tkm = _tracked(SEED7, 1, 70)
    keep = jax_keep(SEED7, tkm.kmer_sba_start_indices, tkm._revcomp_offset(), jf.LengthFilter(11))
    want = kmers_oracle(tkm, 1, keep, min_group_size=3)[1]
    got_jax = jkm.get_kmer_count(1, jf.LengthFilter(11), 3)
    assert (len(tkm), want, got_jax) == SEED7_RECORDED
    assert tkm.get_kmer_count(1, tf.LengthFilter(11), 3) == want


# --------------------------------------------------------------------------- #
# seeded genomes on every route, under every library filter
# --------------------------------------------------------------------------- #


def _genome(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    alphabet, p = (list("ACGT"), None) if kind == "acgt" else (
        list("ACGTNR"), [0.235] * 4 + [0.04, 0.02])

    def rand(n):
        return "".join(rng.choice(alphabet, size=n, p=p))

    unit = rand(40)
    return [("r0", rand(90) + unit + rand(20) + _revcomp(unit)),
            ("r1", unit + rand(50)), ("r2", "T" * 24 + rand(30))]


GENOMES = {f"{kind}-{seed}": _genome(kind, seed) for kind in ("acgt", "iupac") for seed in (3, 5)}


def _filters(m):
    yield "keep-all", None
    yield "gc", m.GcContentFilter(0.3, 0.7, 6)
    yield "homopoly", m.HomopolymerFilter(3, 8)
    yield "noamb", m.NoAmbiguousBasesFilter(7)
    yield "length", m.LengthFilter(9)
    yield "crispr", m.CrisprNggPamFilter()


def _route(km, route: str) -> None:
    """Force a route as the JAX package's tests do (tests/test_torch_filtered_stats.py)."""
    if route in ("plane", "window"):
        km._lanes_cache = None
        km._lanes_rebuild = False
    if route == "window":
        km._dc().filter_flags = None


CONFIGS = ((1, 24), (8, 8), (23, 30))


def _filter_fits(jfil, mn) -> bool:
    """A filter whose own window is longer than a row raises; those raises
    are held to the JAX package elsewhere (tests/test_torch_filtered_stats.py),
    so the filters run here on indexes whose rows all cover their window."""
    window = {"GcContentFilter": 6, "HomopolymerFilter": 8, "NoAmbiguousBasesFilter": 7,
              "LengthFilter": 1, "CrisprNggPamFilter": 23}
    return jfil is None or window[type(jfil).__name__] <= mn


@pytest.mark.parametrize("route", ["lanes", "plane", "window", "compacted"])
@pytest.mark.parametrize("genome", list(GENOMES))
def test_kmers_routes_match_the_oracle(genome, route):
    """Both-strand tracked indexes at kmer_len 1, 5 and the built length:
    histogram, count with group bounds and yields, on each filter route
    ("compacted": the filter as a plain callable, which compacts to the
    survivors before the boundary)."""
    seq_list = GENOMES[genome]
    for mn, mx in CONFIGS:
        km = _tracked(seq_list, mn, mx)
        _route(km, route)
        split = km._revcomp_offset()
        for (name, jfil), (_, tfil) in zip(_filters(jf), _filters(tf)):
            if not _filter_fits(jfil, mn):
                continue
            if route == "compacted" and tfil is not None:
                tfil = (lambda f: lambda sba, strand, idx: f(sba, strand, idx))(tfil)
            keep = None if jfil is None else jax_keep(seq_list, km.kmer_sba_start_indices,
                                                      split, jfil)
            kw = {} if tfil is None else {"kmer_filter_func": tfil}
            for k in sorted({1, 5, mx}):
                got = km.get_kmer_group_counts(k, max_counts_bin=6, **kw)
                assert _hist_equal(got, kmers_oracle(km, k, keep, max_counts_bin=6)), (name, k)
                bounds = dict(min_group_size=2, max_group_size=3)
                assert km.get_kmer_count(k, **kw, **bounds) == kmers_oracle(
                    km, k, keep, **bounds)[1], (name, k)
                nums, pos, gsy, gst = km.get_kmers_arrays(k, yield_first_n=2, **kw)
                want = kmers_walk(km, k, keep, yield_first_n=2)
                assert [tuple(int(x) for x in r) for r in zip(nums, gsy, gst)] == want, (name, k)
                assert np.array_equal(pos, km.kmer_sba_start_indices[nums])


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("genome", list(GENOMES))
def test_mesh_matches_the_oracle(genome, shards):
    """The mesh statistics of a tracked index (the kept layout, a fresh
    sample sort of the survivors, and run ids beyond one window), where a
    strand half may straddle a shard edge."""
    seq_list = GENOMES[genome]
    mesh = _mesh(shards)
    for mn, mx in CONFIGS:
        km = _tracked(seq_list, mn, mx)
        split = km._revcomp_offset()
        for name, jfil, tfil in [(n, f, t) for (n, f), (_, t) in zip(_filters(jf), _filters(tf))
                                 if n in ("keep-all", "gc", "length")]:
            if not _filter_fits(jfil, mn):
                continue
            keep = None if jfil is None else jax_keep(seq_list, km.kmer_sba_start_indices,
                                                      split, jfil)
            kw = {} if tfil is None else {"kmer_filter_func": tfil}
            for k in sorted({1, 5, mx}):
                got = km.get_kmer_group_counts(k, max_counts_bin=6, mesh=mesh, **kw)
                assert _hist_equal(got, kmers_oracle(km, k, keep, max_counts_bin=6)), (name, k)
        km.sort(mesh=mesh)
        for k in sorted({1, 5, mx}):
            got = km.get_kmer_group_counts(k, max_counts_bin=6, mesh=mesh)
            assert _hist_equal(got, kmers_oracle(km, k, max_counts_bin=6)), ("kept layout", k)


@pytest.mark.parametrize("genome", list(GENOMES))
def test_large_kmers_match_the_oracle(genome):
    """``LargeKmers.from_records(both_strands=True,
    track_strands_separately=True)`` at (8, 8), (1, 24) and suffix mode:
    histogram, counts and yields at 1, 5 and the built length, unfiltered
    and under the GC filter, on 1 and 2 shards."""
    seq_list = GENOMES[genome]
    sba = both_sba(seq_list)
    for mn, mx in ((8, 8), (1, 24), (1, None)):
        lk = gt.LargeKmers.from_records(seq_list, mn, mx, both_strands=True,
                                        track_strands_separately=True)
        split = lk._strand_split()
        for shards in (1, 2):
            lk.sort(_mesh(shards))
            pos = lk.sorted_positions()
            for name, jfil, tfil in ((None, None, None),
                                     ("gc", jf.GcContentFilter(0.3, 0.7, 6),
                                      tf.GcContentFilter(0.3, 0.7, 6))):
                if not _filter_fits(jfil, mn):
                    continue
                keep = None if jfil is None else jax_keep(seq_list, pos, split, jfil)
                for k in [1, 5, mx]:
                    got = lk.get_kmer_group_counts(k, tfil, max_counts_bin=6)
                    assert _hist_equal(got, tracked_hist(sba, pos, split, k, keep,
                                                         max_counts_bin=6)), (name, k, shards)
                    nums, got_pos, gsy, gst = lk.get_kmers_arrays(k, tfil, min_group_size=2,
                                                                  yield_first_n=1)
                    want = tracked_walk(sba, pos, split, k, keep, min_group_size=2,
                                        yield_first_n=1)
                    assert [tuple(int(x) for x in r) for r in zip(nums, gsy, gst)] == want
                    assert np.array_equal(got_pos, pos[nums])


def test_untracked_and_full_length_groups_are_unchanged():
    """At the sort's own compare length the "+" rows of a group already
    come first, so the re-order is the identity: the tracked statistics
    there, and every untracked index, equal the JAX package's."""
    seq_list = GENOMES["acgt-3"]
    for track in (True, False):
        tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load="both", device="cpu")
        jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="both")
        kw = dict(source_strand="both", track_strands_separately=track)
        tkm, jkm = gt.Kmers.from_strand(tsc, 8, 8, **kw), gj.Kmers.from_strand(jsc, 8, 8, **kw)
        tkm.sort()
        jkm.sort()
        for k in ((8,) if track else (1, 5, 8)):
            got, want = tkm.get_kmer_group_counts(k), jkm.get_kmer_group_counts(k)
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]
            for a, w in zip(tkm.get_kmers_arrays(k), jkm.get_kmers_arrays(k)):
                assert np.array_equal(a, w)
        if track:
            from genome_kmers_tpu_torch.ops.groups import strand_order
            from genome_kmers_tpu_torch.ops.sort import boundaries_from_sorted_lanes

            lanes = tkm._ensure_lanes()
            boundary = boundaries_from_sorted_lanes(lanes["words"], lanes["cap"], 8, True)
            pos = tkm._device_positions()
            order, _ = strand_order(boundary, pos >= tkm._revcomp_offset())
            assert torch.equal(order, torch.arange(len(pos)))


def test_full_length_tracked_groups_take_no_reorder(monkeypatch):
    """At the sort's own uniform length the single-device boundary route
    cuts at strand changes and does not call ``strand_order``; below it the
    re-order runs."""
    import genome_kmers_tpu_torch.kmers as tkmers

    seq_list = GENOMES["acgt-3"]
    tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load="both", device="cpu")
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="both")
    kw = dict(source_strand="both", track_strands_separately=True)
    tkm, jkm = gt.Kmers.from_strand(tsc, 8, 8, **kw), gj.Kmers.from_strand(jsc, 8, 8, **kw)
    tkm.sort()
    jkm.sort()

    def no_reorder(*args):
        raise AssertionError("strand_order ran at the sort's own length")

    monkeypatch.setattr(tkmers, "strand_order", no_reorder)
    for a, w in zip(tkm.get_kmers_arrays(8, min_group_size=2), jkm.get_kmers_arrays(8, min_group_size=2)):
        assert np.array_equal(a, w)
    with pytest.raises(AssertionError, match="strand_order ran"):
        tkm.get_kmers_arrays(5)


def test_large_rows_of_strand_halves_are_refused():
    """The layout's rows are those of string groups, so asking for them
    with the strand halves raises instead of misaligning."""
    from genome_kmers_tpu_torch.parallel.large import (
        distributed_group_size_histogram_large_ragged,
    )

    with pytest.raises(ValueError, match="pass no strand_split"):
        distributed_group_size_histogram_large_ragged(
            None, None, None, [], [], 8, _mesh(1), return_rows=True, strand_split=10)
