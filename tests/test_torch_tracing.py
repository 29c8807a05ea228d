"""The port's phase spans (``genome_kmers_tpu_torch.tracing``) on the CPU.

Off, a span records nothing. Under a ``torch.profiler`` session an index
build, a statistics session's calls and a suffix sort draw their ``gk:``
ranges in order, each a direct child of the caller's range around the
public call, none nested in another and none of user-annotation scope;
the records pair one to one with the ranges. The answers are the same bits
with the spans on and off. On every statistics route a count opens the
histogram call's spans but its histogram and readback. Small genomes: a few seconds in all.
"""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import genome_kmers_tpu_torch as gk
from genome_kmers_tpu_torch import tracing

CALLER = "caller:"
FUNCTION_SCOPE = torch._C._profiler.RecordScope.FUNCTION.value

SORT = ["gk:sort.keys", "gk:sort.order", "gk:sort.lanes"]
HIST = ["gk:groups.boundaries", "gk:groups.sizes", "gk:groups.histogram", "gk:groups.readback"]
COUNT = ["gk:groups.boundaries", "gk:groups.sizes"]
FILTERED = ["gk:filters.flags"] + HIST


def _genome(with_n: bool):
    rng = random.Random(7 if with_n else 5)
    unit = "".join(rng.choice("ACGT") for _ in range(400))
    seq = "".join(rng.choice("ACGT") for _ in range(2500)) + unit * 3  # repeats: groups > 1
    if with_n:
        seq = seq[:900] + "N" * 60 + seq[960:]
    return [("chr1", seq), ("chr2", seq[:700])]


def _collection(with_n: bool):
    return gk.SequenceCollection(sequence_list=_genome(with_n), strands_to_load="forward",
                                 device="cpu")


def _build_job(sc):
    km = gk.Kmers(sc, 31, 31)
    return [("sort", km.sort), ("group_counts", lambda: km.get_kmer_group_counts(31)),
            ("count", lambda: km.get_kmer_count(31))], km


def _stats_calls(km):
    filters = [gk.gen_kmer_gc_content_filter_func(0.3, 0.7, 31),
               gk.gen_kmer_homopolymer_filter_func(5, 31), gk.gen_no_ambiguous_bases_filter(31)]
    calls = [("group_counts", lambda k=k: km.get_kmer_group_counts(k)) for k in (31, 25, 21, 15)]
    calls += [("group_counts", lambda f=f: km.get_kmer_group_counts(31, kmer_filter_func=f))
              for f in filters]
    return calls + [("count", lambda: km.get_kmer_count(31))]


def _run(calls, traced: bool):
    """Each call inside a caller's range, traced or not. Returns (answers,
    profiler events or None)."""
    if not traced:
        return [fn() for _, fn in calls], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = []
        for op, fn in calls:
            with torch.profiler.record_function(CALLER + op):
                out.append(fn())
    return out, prof.events()


def _gk_ranges(events) -> list:
    ranges = sorted((e for e in events if e.name.startswith("gk:")),
                    key=lambda e: e.time_range.start)
    for e in ranges:
        assert e.cpu_parent is not None and e.cpu_parent.name.startswith(CALLER), e.name
        assert e.scope == FUNCTION_SCOPE, (e.name, e.scope)
        assert e.device_type == torch.autograd.DeviceType.CPU
    for a, b in zip(ranges, ranges[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)  # none nested
    return ranges


def _expect_records(ranges, expected_names, calls_of):
    recs = tracing.take()
    assert [e.name for e in ranges] == expected_names
    assert [r["name"] for r in recs] == expected_names
    # one number a public call, shared by its spans
    assert [r["call"] for r in recs] == [recs[0]["call"] + i for i in calls_of]
    for r in recs:
        assert r["rows"] > 0 and r["device_ms"] is None
    return recs


@pytest.fixture(autouse=True)
def _clear_records():
    tracing.take()
    yield
    tracing.take()


def test_off_records_nothing():
    calls, _ = _build_job(_collection(False))
    _run(calls, traced=False)
    assert tracing.records() == [] and tracing.take() == []
    assert tracing.span("gk:sort.keys") is tracing.span("gk:groups.sizes")
    with tracing.span("gk:sort.keys", torch.zeros(3)) as rec:
        assert rec is None
    tracing.new_call()
    assert tracing.records() == []


@pytest.mark.parametrize("with_n", [False, True], ids=["2bit", "4bit"])
def test_build_job_ranges_and_records(with_n):
    sc = _collection(with_n)
    calls, km = _build_job(sc)
    answers, events = _run(calls, traced=True)
    ranges = _gk_ranges(events)
    recs = _expect_records(ranges, SORT + HIST + COUNT, [0, 0, 0, 1, 1, 1, 1, 2, 2])
    assert recs[0]["rows"] == recs[1]["rows"] == recs[2]["rows"] == sc.device_cache(
        "forward").sba.shape[0]
    assert recs[3]["rows"] == len(km)
    assert recs[6]["rows"] == 1000001  # the histogram's bins come back
    # the lane sort's passes on 4-bit keys and the histogram kernel's (their
    # plain versions here: 0); the 2-bit keys take torch.sort and record none
    assert [r["passes"] for r in recs] == [None, 0 if with_n else None] + [None] * 3 + [0] + [None] * 3
    parents = [e.cpu_parent.name[len(CALLER):] for e in ranges]
    assert parents == ["sort"] * 3 + ["group_counts"] * 4 + ["count"] * 2


def test_stats_session_ranges_and_records():
    sc = _collection(True)
    km = gk.Kmers(sc, 31, 31)
    km.sort()
    _, events = _run(_stats_calls(km), traced=True)
    names = HIST * 4 + FILTERED * 3 + COUNT
    calls_of = [i for i in range(4) for _ in HIST] + [4 + i for i in range(3) for _ in FILTERED]
    recs = _expect_records(_gk_ranges(events), names, calls_of + [7, 7])
    # the histogram kernel's passes and the lanes-flags kernel's (their plain
    # versions here: 0); boundaries, sizes and readback run no counted kernel
    passes = [None, None, 0, None] * 4 + [0, None, None, 0, None] * 3 + [None, None]
    assert [r["passes"] for r in recs] == passes


@pytest.mark.parametrize("with_n", [False, True], ids=["2bit", "4bit"])
def test_suffix_sort_ranges_and_records(with_n):
    sc = _collection(with_n)
    km = gk.Kmers(sc)
    rounds = []
    calls = [("sort", lambda: km.sort(on_round=rounds.append)),
             ("group_counts", lambda: km.get_kmer_group_counts(31))]
    _, events = _run(calls, traced=True)
    # one span a round (``on_round`` hears of each, the last included); the
    # statistics at 31 gather their boundary (suffix mode keeps no lanes),
    # so they have no boundaries span
    assert len(rounds) >= 2
    names = ["gk:sort.round"] * len(rounds) + HIST[1:]
    _expect_records(_gk_ranges(events), names, [0] * len(rounds) + [1, 1, 1])


def test_answers_identical_on_and_off():
    for with_n in (False, True):
        sc = _collection(with_n)
        got = []
        for traced in (False, True):
            calls, km = _build_job(sc)
            answers, _ = _run(calls, traced)
            stats, _ = _run(_stats_calls(km), traced)
            suffix = gk.Kmers(sc)
            _run([("sort", suffix.sort)], traced)
            got.append((np.asarray(km.kmer_sba_start_indices).copy(), answers[1:], stats,
                        np.asarray(suffix.kmer_sba_start_indices).copy()))
        off, on = got
        assert np.array_equal(off[0], on[0]) and np.array_equal(off[3], on[3])
        for a, b in zip(off[1] + off[2], on[1] + on[2]):
            if isinstance(a, tuple):
                assert np.array_equal(a[0], b[0]) and a[0].dtype == b[0].dtype and a[1] == b[1]
            else:
                assert a == b


def test_kernel_passes_recorded_where_it_launched():
    """``kernel=``: the wrapper's passes where its launch count moved inside
    the span, 0 where it did not."""

    class Kernel:
        launches, passes = 3, 9

    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function(CALLER + "sort"):
            with tracing.span("gk:sort.order", torch.zeros(5), kernel=Kernel):
                Kernel.launches, Kernel.passes = 4, 17
            with tracing.span("gk:sort.order", torch.zeros(5), kernel=Kernel):
                pass
    assert [(r["passes"], r["rows"]) for r in tracing.take()] == [(17, 5), (0, 5)]


def _route_case(route):
    """(index, filter) of a case that takes ``route``: plane and window
    forced as tests/test_torch_filtered_stats.py's ``_route`` does."""
    sc = _collection(False)
    gc = gk.gen_kmer_gc_content_filter_func(0.3, 0.7, 31)
    if route == "suffix":
        km = gk.Kmers(sc)
    else:
        km = gk.Kmers(sc, 31, 31)
    if route != "unsorted":
        km.sort()
    if route in ("plane", "window"):
        km._lanes_cache = None
        km._lanes_rebuild = False
    if route == "window":
        km._dc().filter_flags = None
    keep = route in ("lanes", "suffix", "unsorted")
    return km, gk.kmer_filter_keep_all if keep else gc


ROUTES = [  # (case, the resolver's route, the count's spans)
    ("lanes", "lanes", COUNT),
    ("lanes_filtered", "lanes_filtered", ["gk:filters.flags"] + COUNT),
    ("plane", "plane", ["gk:groups.sizes"]),
    ("window", "plane", ["gk:groups.sizes"]),
    ("suffix", "boundary", ["gk:groups.sizes"]),
    ("unsorted", "boundary", ["gk:groups.sizes"]),
]


@pytest.mark.parametrize("case,route,count_spans", ROUTES, ids=[r[0] for r in ROUTES])
def test_count_and_histogram_share_each_route(case, route, count_spans):
    """On every route of ``Kmers._stats_route`` the count is the
    histogram's total and opens the histogram call's spans but its
    histogram and readback; canonical statistics open the histogram, then
    the readback. An unsorted index has no histogram: its count is one a
    k-mer."""
    km, f = _route_case(case)
    assert km._stats_route(31, f)[0] == route

    def traced(op, fn):
        answer, events = _run([(op, fn)], traced=True)
        names = [e.name for e in _gk_ranges(events)]
        assert [r["name"] for r in tracing.take()] == names
        return answer[0], names

    total, names = traced("count", lambda: km.get_kmer_count(31, kmer_filter_func=f))
    assert names == count_spans
    if case == "unsorted":
        assert total == len(km)
    else:
        (counts, hist_total), hist_names = traced(
            "group_counts", lambda: km.get_kmer_group_counts(31, kmer_filter_func=f))
        assert hist_total == total and counts.dtype == np.int64
        assert hist_names == names + HIST[2:]
    _, names = traced("canonical", lambda: km.get_canonical_kmer_group_counts(31))
    assert names == HIST[2:]
