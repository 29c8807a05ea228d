"""The harness on the CPU at test sizes: the result line, the lookup by
name, the faults the comparison has to catch, and no JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from kmerbench_helpers import tiny_config

import genome_kmers_tpu_torch as gk
from kmerbench import catalog, roofline, trace
from kmerbench.run import ROOT, run_cell

BENCH = catalog.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


CPU = [torch.device("cpu")]


def _run(cell_name, seconds=0.3, devices=CPU, trace_on=False):
    cell = catalog.cell(BENCH, cell_name)
    config = tiny_config(catalog.config(BENCH, cell["config"]))
    return run_cell(BENCH, cell, config, catalog.mix(cell["traffic"]), 2**31 + 17, seconds,
                    trace_on, devices)


@pytest.mark.parametrize("cell_name", CELLS)
def test_result_line_has_the_contract_keys(cell_name):
    result, notes = _run(cell_name)
    assert list(result) == RESULT_KEYS  # "checks" last
    assert result["correct"] is True, (result, notes["error"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in catalog.metrics_for(BENCH, cell_name, False)} - {"peak_device_gib"}
    assert set(result["metrics"]) == want  # the CPU has no device peak
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] == 0 for c in result["checks"].values())
    json.dumps(result)


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        catalog.config(BENCH, w["config"])
        mix = catalog.mix(w["traffic"])
        assert mix["unit"] in ("job", "call") and mix["loop"]
        for step in mix["setup"] + mix["loop"]:
            assert callable(catalog.step(step["op"]).run)
            if step.get("filter"):
                assert callable(catalog.program_filter(step["filter"][0]).make)
                assert callable(catalog.reference_filter(step["filter"][0]).mask)
        answers = [st["op"] for st in mix["loop"] if st["op"] in ("group_counts", "count")]
        assert all(callable(catalog.reference_step(op).matches) for op in answers)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(catalog.reader(m["name"]))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


NEW_STEP = '''
def run(s, step):
    """The number of k-mers of length ``k`` that pass the filter."""
    return s.km.get_kmer_count(step["k"], kmer_filter_func=s.kmer_filter(step.get("filter")))
'''
NEW_REFERENCE_STEP = '''
from kmerbench.reference import kmers_ref as ref


def expected(ix, step):
    keep = ref.survivors(ix, step.get("filter"))
    return ix.n if keep is None else int(keep.sum())


def control(ix, step, bits):
    return expected(ix, step) + 1


def matches(got, want):
    return int(got) == want
'''
NEW_FILTER = '''
import genome_kmers_tpu_torch as gk


def make(k):
    return gk.gen_kmer_homopolymer_filter_func(3, k)
'''
NEW_REFERENCE_FILTER = '''
from kmerbench import catalog


def mask(ix, k):
    return catalog.reference_filter("homopolymer").mask(ix, 3, k)
'''


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A later change adds a configuration, a mix, a step with its
    reference, a filter on both sides and a metric as new files and
    BENCHMARK.json entries; nothing that is there is edited."""
    files = {
        "configs/new-genome.json": None,
        "mixes/new_mix.json": json.dumps(
            {"unit": "call", "setup": catalog.mix("stats_session")["setup"],
             "loop": [{"op": "survivors", "k": 21, "filter": ["short_runs", 21]},
                      {"op": "count", "k": 21, "filter": ["short_runs", 21]}]}),
        "steps/survivors.py": NEW_STEP,
        "reference/steps/survivors.py": NEW_REFERENCE_STEP,
        "steps/filters/short_runs.py": NEW_FILTER,
        "reference/filters/short_runs.py": NEW_REFERENCE_FILTER,
        "metrics/new.metric.py": "def read(run):\n    return len(run.unit_seconds) or None\n",
    }
    config = tiny_config(catalog.config(BENCH, "celegans-wbcel235"))
    config["name"] = "new-genome"
    files["configs/new-genome.json"] = json.dumps(config)
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(catalog, "ROOTS", [tmp_path] + catalog.ROOTS)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "new-genome", "file": "configs/new-genome.json"})
    bench["workloads"].append({"name": "new.cell", "config": "new-genome", "traffic": "new_mix",
                               "chips": 1})
    bench["end_to_end"].append({"name": "new.metric", "unit": "calls", "workloads": ["new.cell"]})
    assert catalog.config(bench, "new-genome", root=tmp_path)["name"] == "new-genome"
    assert [m["name"] for m in catalog.metrics_for(bench, "new.cell", False)] == [
        "peak_device_gib", "setup_s", "new.metric"]
    cell = catalog.cell(bench, "new.cell")
    result, notes = run_cell(bench, cell, config, catalog.mix("new_mix"), 5, 0.2, False, CPU)
    assert result["correct"] is True, (result, notes["error"])
    assert result["metrics"]["new.metric"]["value"] == result["attempted"]

    # the new step's answers are judged: an altered one is not correct
    monkeypatch.setattr(catalog.reference_step("survivors"), "matches", lambda got, want: False)
    result, _ = run_cell(bench, cell, config, catalog.mix("new_mix"), 5, 0.2, False, CPU)
    assert result["correct"] is False and result["checks"]["answers_bad"]["value"] > 0


# --------------------------------------------------------------------------- #
# faults planted in the timed path: each has to turn ``correct`` false. The
# cells run on one chip, so there is no exchange between chips to leave out.
# --------------------------------------------------------------------------- #


def _sort_unchanged(self, *args, **kwargs):
    """A step that returns its state unchanged: the index stays in genome order."""
    self._is_sorted = True


def _sort_half(original):
    def sort(self, *args, **kwargs):
        """Half of the rows left out of the sorted index."""
        original(self, *args, **kwargs)
        self._pos_dev = self._pos_dev[::2]
        self._pos_host = None
    return sort


def _altered_answer(original):
    def get_kmer_group_counts(self, *args, **kwargs):
        """An answer altered where it is produced: one histogram bin off by one."""
        hist, total = original(self, *args, **kwargs)
        hist = hist.copy()
        hist[1] += 1
        return hist, total
    return get_kmer_group_counts


FAULTS = {
    "state_unchanged": ("sort", lambda orig: _sort_unchanged),
    "half_left_out": ("sort", _sort_half),
    "answer_altered": ("get_kmer_group_counts", _altered_answer),
}


def _timed_ops(cell_name) -> set:
    return {s["op"] for s in catalog.mix(catalog.cell(BENCH, cell_name)["traffic"])["loop"]}


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in CELLS for f, (method, _) in FAULTS.items()
    if method.replace("get_kmer_", "") in _timed_ops(c)])
def test_planted_fault_is_not_correct(monkeypatch, cell_name, fault):
    """Each fault of the timed path that the cell can have."""
    method, make = FAULTS[fault]
    monkeypatch.setattr(gk.Kmers, method, make(getattr(gk.Kmers, method)))
    result, notes = _run(cell_name)
    assert result["correct"] is False, (fault, result["checks"], notes["error"])


def test_control_is_not_correct():
    """The control in each cell (the reference with one guarantee broken;
    an 8-bit fingerprint at this size, 32 bits at the cells' sizes)."""
    from kmerbench import genome, judge
    from kmerbench.reference import kmers_ref as ref

    for cell_name in CELLS:
        cell = catalog.cell(BENCH, cell_name)
        config = tiny_config(catalog.config(BENCH, cell["config"]))
        mix = catalog.mix(cell["traffic"])
        g = ref.Genome(genome.make_records(config, 99))
        index = next(s for s in mix["setup"] + mix["loop"] if s["op"] == "index")
        pos = np.flatnonzero(g.vl.numpy() >= index["min"])
        steps = [s for s in mix["loop"] if s["op"] in ("group_counts", "count")]
        # start from the true order, which the control for a suffix index needs
        ix = ref.Index(g, pos, index["max"])
        depth = index["max"] or 400
        keys = [ix.prefix_words(o, depth) for o in range(0, depth, g.B)]
        order = np.lexsort([pos] + [k.numpy() for k in reversed(keys)])
        truth = judge._answers(ref.Index(g, pos[order], index["max"]), steps, "expected")
        outputs = {"index": (pos[order], index),
                   "answers": [(s, truth[judge._key(s)]) for s in steps]}
        assert judge.passed(judge.judge(g, outputs)), cell_name
        control = judge.control_outputs(g, outputs, index in mix["loop"], bits=8)
        assert not judge.passed(judge.judge(g, control)), cell_name


# --------------------------------------------------------------------------- #
# the yardstick's arithmetic
# --------------------------------------------------------------------------- #


def test_roofline_bytes():
    assert roofline.sort_bytes(10, 31, True) == 240  # 8 B key + 4 B position, read and written
    assert roofline.sort_bytes(10, 31, False) == 400  # 16 B key + 4 B position
    assert roofline.sort_bytes(10, 64, True) == 10 * 2 * (16 + 4)
    assert roofline.share_of_bandwidth(3.35e12, 2.0) == pytest.approx(50.0)


def test_device_trace_arithmetic():
    t = trace.DeviceTrace(
        window=(0.0, 100.0), start=np.array([10.0, 15.0, 50.0, 90.0]),
        end=np.array([20.0, 30.0, 60.0, 100.0]), name=["a", "b", "a", "Memcpy HtoD"],
        kernel=np.array([True, True, True, False]), spans=[("sort", 5.0, 35.0), ("count", 45.0, 95.0)],
        host=(np.array([6.0, 46.0]), np.array([8.0, 70.0]), ["sort/aten::sort", "count/aten::sum"]))
    assert t.busy_us(0, 100) == 40.0
    assert t.busy_us(12, 55) == 23.0
    assert t.kernels_in(45, 95) == 1
    b = trace.breakdown(t)
    assert b["device_ops"] == [["a", 2e-05], ["b", 1.5e-05], ["Memcpy HtoD", 1e-05]]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # gaps, labelled at their middles: 0-10 in the sort span, 30-50 between the
    # spans, 60-90 in the count span after its op
    assert gaps == {"sort/python": pytest.approx(1e-05), "harness": pytest.approx(2e-05),
                    "count/python": pytest.approx(3e-05)}


def test_read_profile_counts_device_work_only():
    """Kernels, copies and fills are device work; the device-side image of a
    ``kmerbench:`` range is not. A trace without a kernel raises."""
    from types import SimpleNamespace as NS

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, start, end, parent=None):
        return NS(name=name, device_type=dev, time_range=NS(start=start, end=end),
                  cpu_parent=parent)

    window = ev(trace.WINDOW, cpu, 0.0, 100.0)
    span = ev("kmerbench:sort", cpu, 10.0, 60.0, window)
    events = [window, span, ev("aten::sort", cpu, 12.0, 20.0, span),
              ev("kmerbench:sort", cuda, 15.0, 55.0), ev("radix_sort_kernel", cuda, 15.0, 25.0),
              ev("Memcpy DtoH (Device -> Pageable)", cuda, 50.0, 55.0)]
    t = trace.read_profile(NS(events=lambda: events))
    assert t.name == ["radix_sort_kernel", "Memcpy DtoH (Device -> Pageable)"]
    assert t.busy_us(0, 100) == 15.0 and t.kernels_in(10, 60) == 1
    assert t.spans == [("sort", 10.0, 60.0)] and t.host[2] == ["sort/aten::sort"]
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        trace.read_profile(NS(events=lambda: events[:4]))


# --------------------------------------------------------------------------- #
# no JAX
# --------------------------------------------------------------------------- #


def test_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import kmerbench.run, kmerbench.driver, kmerbench.judge, kmerbench.trace,"
        " kmerbench.catalog as c, kmerbench.record, kmerbench.roofline, kmerbench.genome,"
        " kmerbench.timing, kmerbench.reference.kmers_ref, pathlib;"
        "h = c.HERE; [c._module(*p.relative_to(h).parts) for d in"
        " ('steps', 'reference/steps', 'reference/filters', 'metrics')"
        " for p in sorted((h / d).rglob('*.py'))];"
        "from kmerbench.run import forbidden_modules; print(forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
    import kmerbench.run as r

    sys.modules["genome_kmers_tpu.x"] = object()  # a forbidden top-level name, whole
    try:
        assert r.forbidden_modules() == ["genome_kmers_tpu"]
    finally:
        del sys.modules["genome_kmers_tpu.x"]
    assert "genome_kmers_tpu_torch" not in r.FORBIDDEN


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_cell_on_card_traced(cuda_device, cell_name):
    result, notes = _run(cell_name, seconds=1.0, devices=[cuda_device], trace_on=True)
    assert result["correct"] is True, notes["error"]
    assert result["device"]["busy_s"] > 0
    want = {m["name"] for m in catalog.metrics_for(BENCH, cell_name, True)}
    assert set(result["metrics"]) <= want and result["metrics"]
    assert list(result)[-1] == "checks"
