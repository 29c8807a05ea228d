"""Finds a cell's configuration, mix, steps, filters and metric readers by name.

Whatever belongs to one configuration, traffic mix, step, filter or metric
is a file of its own: ``configs/<config>.json`` (named by
``BENCHMARK.json``), ``mixes/<traffic>.json``, ``steps/<op>.py`` (the
program's call), ``reference/steps/<op>.py`` (the reference's answer to
it), ``steps/filters/<name>.py`` and ``reference/filters/<name>.py`` (a
k-mer filter on each side) and ``metrics/<metric>.py``. A new cell, mix,
step, filter or metric is new files and new ``BENCHMARK.json`` entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# directories searched for the files above, in order (the tests put a
# directory of new files before HERE)
ROOTS = [HERE]
_modules = {}


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _find(*parts: str) -> Path:
    for root in ROOTS:
        path = root.joinpath(*parts)
        if path.is_file():
            return path
    raise KeyError(f"no {'/'.join(parts)} in {', '.join(map(str, ROOTS))}")


def _module(*parts: str):
    """The module of the file ``parts`` under the first of ROOTS that holds
    it, loaded once."""
    key = (tuple(ROOTS), parts)
    if key not in _modules:
        path = _find(*parts)
        name = "kmerbench_" + "_".join(parts).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _modules[key] = module
    return _modules[key]


def mix(traffic: str) -> dict:
    return json.loads(_find("mixes", f"{traffic}.json").read_text())


def step(op: str):
    """``steps/<op>.py``: ``run(session, step)``, the program's call; it
    returns the answer to be judged, or None. A step that builds the index
    also has ``positions(session)``, the index on the host."""
    return _module("steps", f"{op}.py")


def reference_step(op: str):
    """``reference/steps/<op>.py``: for an answer, ``expected(ix, step)``,
    ``control(ix, step, bits)`` and ``matches(got, want)``; for an index,
    ``genome``, ``rows``, ``check`` and ``control``."""
    return _module("reference", "steps", f"{op}.py")


def program_filter(name: str):
    """``steps/filters/<name>.py``: ``make(*args)``, the program's filter."""
    return _module("steps", "filters", f"{name}.py")


def reference_filter(name: str):
    """``reference/filters/<name>.py``: ``mask(ix, *args)``, the rows it keeps."""
    return _module("reference", "filters", f"{name}.py")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", f"{metric}.py").read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): those that list the cell, or list no cells."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]
