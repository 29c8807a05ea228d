"""Runs one cell of the benchmark of genome_kmers_tpu_torch.

    python3 kmerbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
makes the cell's genome from the seed, runs its mix's set-up and one warm
pass, then jobs or calls in a closed loop for ``--seconds``, and judges
what the window produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; traced, its
per-layer metrics), ``device`` and, traced, ``breakdown``, then
``checks``, each number compared beside its limit, which are also the last
lines of standard error. ``--control 1`` also judges the control (the
reference in the program's place with one guarantee broken), which has to
come out not correct; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's kernel caches live inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "kmerbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "kmerbench" / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "genome_kmers_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def run_cell(bench: dict, cell: dict, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, devices: list, control: bool = False, t_start: float = None) -> tuple:
    """One run of ``cell`` on ``devices`` (the collection on the first).
    Returns (the result object, notes for standard error: the reference's
    seconds, the window's error, the set-up's steps, the control's checks).
    The forbidden-module check is ``main``'s."""
    import torch

    from kmerbench import catalog, genome, judge
    from kmerbench.driver import Session, run_setup, run_window
    from kmerbench.record import RunRecord

    t_start = time.perf_counter() if t_start is None else t_start
    t_gen = time.perf_counter()
    records = genome.make_records(config, seed)
    gen_s = time.perf_counter() - t_gen
    s = Session(records, devices, seed)
    on_card = s.device.type == "cuda"
    prof = None
    try:
        run_setup(s, mix)
        setup_s = time.perf_counter() - t_start
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from kmerbench.trace import WINDOW

            s.trace = True
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(WINDOW):
                    w = run_window(s, mix, seconds)
        else:
            w = run_window(s, mix, seconds)
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
        # what the window produced, on the host: the index it ends with and
        # the answers of every job or call
        index_step = s.index_step
        outputs = {"index": (catalog.step(index_step["op"]).positions(s), index_step),
                   "answers": w.answers}
        spans, setup_steps = s.spans, s.setup_seconds
    finally:
        s.close()
    del s
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    index_side = catalog.reference_step(index_step["op"])
    g = index_side.genome(records)
    del records
    checks = judge.judge(g, outputs)
    judge_s = time.perf_counter() - t_judge
    control_checks = None
    if control:
        control_checks = judge.judge(
            g, judge.control_outputs(g, outputs, timed_index=index_step in mix["loop"]))
    del outputs

    run = RunRecord(
        cell=cell["name"], unit=mix["unit"], setup_s=setup_s, window_s=w.seconds,
        unit_seconds=[b - a for a, b in w.units], index_step=index_step,
        rows_per_job=index_side.rows(g, index_step) if mix["unit"] == "job" else 0,
        memory_peak_bytes=peak, two_bit=g.acgt_only, spans=spans,
    )
    del g
    result = {
        "correct": False, "attempted": w.attempted, "failed": w.failed, "metrics": {},
        "device": {"platform": "gpu" if on_card else devices[0].type,
                   "kind": torch.cuda.get_device_name(devices[0]) if on_card else devices[0].type,
                   "count": cell["chips"], "memory_peak_bytes": peak},
    }
    if trace:
        from kmerbench.trace import breakdown, read_profile

        run.device = read_profile(prof)
        if len(run.device.spans) != len(spans):
            raise RuntimeError(f"{len(spans)} spans timed, {len(run.device.spans)} traced")
        for span, (op, start, end) in zip(spans, run.device.spans):
            if op != span.op:
                raise RuntimeError(f"span {span.op} traced as {op}")
            span.start, span.end = start, end
        lo, hi = run.device.window
        result["device"]["busy_s"] = run.device.busy_us(lo, hi) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
    for m in catalog.metrics_for(bench, cell["name"], trace):
        value = catalog.reader(m["name"])(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        result["breakdown"] = breakdown(run.device)
    result["correct"] = bool(judge.passed(checks) and w.failed == 0 and w.units)
    result["checks"] = _checks_json(checks)
    notes = {"reference_s": judge_s, "error": w.error,
             "setup": [("import", t_gen - t_start), ("genome", gen_s)] + setup_steps}
    if control_checks is not None:
        notes["control"] = {"correct": judge.passed(control_checks),
                            "checks": _checks_json(control_checks)}
    return result, notes


def _checks_json(checks: dict) -> dict:
    return {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from kmerbench import catalog

    bench = catalog.load_benchmark()
    cell = catalog.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"kmerbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, notes = run_cell(bench, cell, catalog.config(bench, cell["config"]),
                             catalog.mix(cell["traffic"]), args.seed, args.seconds,
                             bool(args.trace),
                             [torch.device(f"cuda:{i}") for i in range(cell["chips"])],
                             control=bool(args.control), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"kmerbench: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    if notes["error"]:
        print(notes["error"], file=sys.stderr)
    print(f"setup_steps {json.dumps(notes['setup'])}", file=sys.stderr)
    print(f"reference_s {notes['reference_s']}", file=sys.stderr)
    if "control" in notes:
        print(f"control correct {notes['control']['correct']}", file=sys.stderr)
        for name, c in notes["control"]["checks"].items():
            print(f"control {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
