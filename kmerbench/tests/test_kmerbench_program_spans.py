"""The readers of the program's phase spans (``program_spans.py`` and its
seven metrics) over synthetic runs on the CPU, and on the card each cell
traced for a second."""

import sys

import numpy as np
import pytest
from kmerbench_helpers import tiny_config

import genome_kmers_tpu_torch
from genome_kmers_tpu_torch import tracing
from kmerbench import catalog, program_spans, trace
from kmerbench.record import RunRecord
from kmerbench.run import run_cell

BENCH = catalog.load_benchmark()
NEW = ["sort_keys_ms", "sort_order_ms", "hist_bins_ms.build", "hist_bins_ms.stats",
       "filter_flags_ms", "span_idle_ms.build", "span_idle_ms.stats"]


def _read(name, run):
    return catalog.reader(name)(run)


def _trace(host, busy):
    """A device trace of a 1000 us window: ``host`` (op, name, start, end)
    direct children of the benchmark's spans, ``busy`` device intervals."""
    start = np.array([b[0] for b in busy], dtype=float)
    end = np.array([b[1] for b in busy], dtype=float)
    return trace.DeviceTrace(
        window=(0.0, 1000.0), start=start, end=end, name=["k"] * len(busy),
        kernel=np.ones(len(busy), dtype=bool), spans=[],
        host=(np.array([h[2] for h in host], dtype=float),
              np.array([h[3] for h in host], dtype=float), [f"{h[0]}/{h[1]}" for h in host]))


def _run(unit, host, busy, units=2):
    return RunRecord(cell="c", unit=unit, setup_s=1.0, window_s=1e-3,
                     unit_seconds=[5e-4] * units, index_step={"min": 31, "max": 31},
                     rows_per_job=10, memory_peak_bytes=0, two_bit=True,
                     device=_trace(host, busy))


def _records(monkeypatch, recs):
    """``tracing.records()`` gives ``recs`` (name, call, device_ms), and no
    earlier run has paired any."""
    out = [{"name": n, "call": c, "rows": 10, "passes": None, "device_ms": ms}
           for n, c, ms in recs]
    monkeypatch.setattr(tracing, "records", lambda: [dict(r) for r in out])
    monkeypatch.setattr(program_spans, "_paired", [0])


# two build jobs: sort (keys, order, lanes), group_counts (boundaries,
# sizes, histogram, readback), count (boundaries, sizes); 500 us each
GC = "group_counts"
JOB = [("sort", "gk:sort.keys", 0, 40), ("sort", "aten::sort", 45, 50),
       ("sort", "gk:sort.order", 50, 150), ("sort", "gk:sort.lanes", 150, 170),
       (GC, "gk:groups.boundaries", 200, 220), (GC, "gk:groups.sizes", 220, 260),
       (GC, "gk:groups.histogram", 260, 400), (GC, "gk:groups.readback", 400, 420),
       ("count", "gk:groups.boundaries", 440, 460), ("count", "gk:groups.sizes", 460, 480)]
JOBS = JOB + [(op, name, s + 500, e + 500) for op, name, s, e in JOB]
# device busy but for 10 us in each job's keys span, 30 us in its
# histogram span and 50 us outside every gk: range (170-200 and 480-500)
BUSY = [(b, b + 30) for b in (0, 500)] + [(b + 40, b + 170) for b in (0, 500)] + [
    (b + 200, b + 300) for b in (0, 500)] + [(b + 330, b + 480) for b in (0, 500)]


def _job_records(keys_ms=(1.0, 3.0), order_ms=(10.0, 20.0), hist_ms=(100.0, 50.0)):
    recs = []
    for j in range(2):
        c = 3 * j + 1
        recs += [("gk:sort.keys", c, keys_ms[j]), ("gk:sort.order", c, order_ms[j]),
                 ("gk:sort.lanes", c, 1.0), ("gk:groups.boundaries", c + 1, 1.0),
                 ("gk:groups.sizes", c + 1, 1.0), ("gk:groups.histogram", c + 1, hist_ms[j]),
                 ("gk:groups.readback", c + 1, 1.0), ("gk:groups.boundaries", c + 2, 1.0),
                 ("gk:groups.sizes", c + 2, 1.0)]
    return recs


def test_job_readers(monkeypatch):
    _records(monkeypatch, _job_records())
    run = _run("job", JOBS, BUSY)
    assert _read("sort_keys_ms", run) == 2.0
    assert _read("sort_order_ms", run) == 15.0
    assert _read("hist_bins_ms.build", run) == 75.0
    # idle inside the ranges: 10 us (keys) + 30 us (histogram) a job; the
    # gaps outside them and inside the non-gk op do not count
    assert _read("span_idle_ms.build", run) == pytest.approx(0.040)
    for name in ("hist_bins_ms.stats", "filter_flags_ms", "span_idle_ms.stats"):
        assert _read(name, run) is None


def test_call_readers(monkeypatch):
    # calls: an unfiltered histogram (60 ms), a filtered one (flags 300 ms,
    # histogram 10 ms), an unfiltered one (80 ms), a count
    plain = [("gk:groups.boundaries", 10), ("gk:groups.sizes", 10),
             ("gk:groups.histogram", 50), ("gk:groups.readback", 10)]
    host, recs, t = [], [], 0
    for call, (flags, hist_ms) in enumerate([(False, 60.0), (True, 10.0), (False, 80.0)], 1):
        phases = ([("gk:filters.flags", 100)] if flags else []) + plain
        for name, width in phases:
            host.append(("group_counts", name, t, t + width))
            ms = 300.0 if name == "gk:filters.flags" else hist_ms if "histogram" in name else 1.0
            recs.append((name, call, ms))
            t += width
    for name in ("gk:groups.boundaries", "gk:groups.sizes"):
        host.append(("count", name, t, t + 10))
        recs.append((name, 4, 1.0))
        t += 10
    _records(monkeypatch, recs)
    run = _run("call", host, [(0, t)], units=4)  # busy throughout: no idle
    assert _read("hist_bins_ms.stats", run) == 70.0  # the two unfiltered calls
    assert _read("filter_flags_ms", run) == 300.0
    assert _read("span_idle_ms.stats", run) == 0.0
    for name in ("sort_keys_ms", "sort_order_ms", "hist_bins_ms.build", "span_idle_ms.build"):
        assert _read(name, run) is None


def test_nothing_to_read_is_none(monkeypatch):
    _records(monkeypatch, _job_records())
    untraced = _run("job", JOBS, BUSY)
    untraced.device = None
    assert all(_read(name, untraced) is None for name in NEW)
    # on the CPU the records have no device time
    _records(monkeypatch, [(n, c, None) for n, c, _ in _job_records()])
    cpu = _run("job", JOBS, BUSY)
    assert all(_read(name, cpu) is None for name in NEW if name != "span_idle_ms.build")
    # a program without spans (the parent of this reader): no gk: range, no record
    _records(monkeypatch, [])
    bare = _run("job", [h for h in JOBS if not h[1].startswith("gk:")], BUSY)
    assert all(_read(name, bare) is None for name in NEW)
    # a program without the module
    monkeypatch.delattr(genome_kmers_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "genome_kmers_tpu_torch.tracing", None)
    assert all(_read(name, _run("job", JOBS, BUSY)) is None for name in NEW)


def test_records_pair_with_ranges_or_raise(monkeypatch):
    _records(monkeypatch, _job_records()[:-1])
    with pytest.raises(RuntimeError, match="17 program spans recorded, 18 traced"):
        program_spans.phases(_run("job", JOBS, BUSY))
    recs = _job_records()
    recs[4] = ("gk:groups.histogram",) + recs[4][1:]
    _records(monkeypatch, recs)
    with pytest.raises(RuntimeError, match="gk:groups.histogram traced as gk:groups.sizes"):
        program_spans.phases(_run("job", JOBS, BUSY))


def test_each_run_pairs_its_own_records(monkeypatch):
    """Runs in one process: the second pairs the records after the first's."""
    first = _job_records(keys_ms=(1.0, 1.0))
    _records(monkeypatch, first)
    run1 = _run("job", JOBS, BUSY)
    assert _read("sort_keys_ms", run1) == 1.0
    assert _read("sort_keys_ms", run1) == 1.0  # read once a run
    second = first + _job_records(keys_ms=(5.0, 7.0))
    monkeypatch.setattr(tracing, "records", lambda: [
        {"name": n, "call": c, "rows": 10, "passes": None, "device_ms": ms}
        for n, c, ms in second])
    assert _read("sort_keys_ms", _run("job", JOBS, BUSY)) == 6.0


def test_covered_us_against_a_walk():
    rng = np.random.default_rng(3)
    start = rng.uniform(0, 1000, 200)
    end = start + rng.uniform(0, 20, 200)
    a = rng.uniform(0, 1000, 50)
    b = a + rng.uniform(0, 100, 50)
    got = program_spans.covered_us(start, end, a, b)
    grid = np.arange(0, 1200, 0.01) + 0.005
    on = np.zeros(grid.size, dtype=bool)
    for s, e in zip(start, end):
        on[(grid >= s) & (grid < e)] = True
    want = [on[(grid >= x) & (grid < y)].sum() * 0.01 for x, y in zip(a, b)]
    np.testing.assert_allclose(got, want, atol=0.05)
    empty = program_spans.covered_us(np.array([]), np.array([]), a, b)
    assert np.all(empty == 0)


@pytest.mark.card
@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card_finds_the_span_metrics(cuda_device, cell_name):
    cell = catalog.cell(BENCH, cell_name)
    config = tiny_config(catalog.config(BENCH, cell["config"]))
    result, notes = run_cell(BENCH, cell, config, catalog.mix(cell["traffic"]), 2**31 + 29, 1.0,
                             True, [cuda_device])
    assert result["correct"] is True, notes["error"]
    want = {m["name"] for m in BENCH["per_layer"] if m["name"] in NEW
            and cell_name in m["workloads"]}
    got = {name for name in result["metrics"] if name in NEW}
    assert got == want
    assert all(result["metrics"][name]["value"] >= 0 for name in got)
