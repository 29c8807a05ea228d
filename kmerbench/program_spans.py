"""The program's own phase spans in a traced run, for the metric readers.

The program records a span at each phase boundary of its sort, group
statistics and filters while a ``torch.profiler`` session records
(``genome_kmers_tpu_torch.tracing``): a ``gk:<layer>.<phase>`` range,
which the device trace lists among the ops a benchmark span calls directly
(``DeviceTrace.host``, labelled ``<op>/gk:...``), and a record with its
public call's number and its device time from two CUDA events.
The records are read, not cleared; the k-th of a run is paired with the
k-th ``gk:`` range of its trace, and a count or a name that differs
raises, as ``run.py`` does for its own spans. Where there is nothing to read
(untraced, a program without the module, a run without a span) the
readers get None.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kmerbench.record import median
from kmerbench.trace import merged

GK = "gk:"


@dataclass
class Phase:
    name: str  # gk:<layer>.<phase>
    call: int  # the program's public call
    device_ms: float  # None on the CPU
    start: float  # the profiler range, microseconds
    end: float


# records that the runs read before in this process paired: a process that
# runs several cells (the tests) keeps the records of each
_paired = [0]


def phases(run) -> list:
    """Every span of the window in order, or None (module doc). Read once a
    run."""
    if run.device is None:
        return None
    if hasattr(run, "_program_phases"):
        return run._program_phases
    try:
        from genome_kmers_tpu_torch import tracing
    except ImportError:
        return None
    hs, he, hl = run.device.host
    ranges = [(s, e, label.split("/", 1)[1]) for s, e, label in zip(hs, he, hl)
              if label.split("/", 1)[1].startswith(GK)]
    recs = tracing.records()
    if _paired[0] > len(recs):  # cleared since (``tracing.take``)
        _paired[0] = 0
    recs = recs[_paired[0]:]
    if len(recs) != len(ranges):
        raise RuntimeError(f"{len(recs)} program spans recorded, {len(ranges)} traced")
    out = []
    for r, (start, end, name) in zip(recs, ranges):
        if r["name"] != name:
            raise RuntimeError(f"program span {r['name']} traced as {name}")
        out.append(Phase(name, r["call"], r["device_ms"], float(start), float(end)))
    _paired[0] += len(recs)
    run._program_phases = out or None
    return run._program_phases


def median_device_ms(run, name: str, unit: str, calls=None):
    """Median device ms of the spans ``name`` in a run of ``unit`` ("job" or
    "call"), over the public calls ``calls(phases)`` picks, if given."""
    if run.unit != unit:
        return None
    ph = phases(run)
    if not ph:
        return None
    keep = None if calls is None else calls(ph)
    return median([p.device_ms for p in ph if p.name == name and p.device_ms is not None
                   and (keep is None or p.call in keep)])


def unfiltered_calls(ph) -> set:
    """The public calls with a histogram and no filter flags."""
    flagged = {p.call for p in ph if p.name == "gk:filters.flags"}
    return {p.call for p in ph if p.name == "gk:groups.histogram"} - flagged


def covered_us(start: np.ndarray, end: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each [a, b], the microseconds covered by the union of the
    intervals (start, end)."""
    s, e = merged(start, end)
    if s.size == 0:
        return np.zeros(np.shape(a))
    total = np.concatenate([[0.0], np.cumsum(e - s)])

    def upto(t):
        # intervals starting at or before t, less the overshoot of the last
        k = np.searchsorted(s, t, side="right")
        over = np.where(k > 0, np.maximum(e[np.maximum(k - 1, 0)] - t, 0.0), 0.0)
        return total[k] - over

    return upto(b) - upto(a)


def span_idle_ms(run, unit: str):
    """Device-idle ms a job or call while the host was inside a ``gk:`` range:
    the trace's idle time within the ranges, over the window's units."""
    if run.unit != unit or not run.unit_seconds:
        return None
    ph = phases(run)
    if not ph:
        return None
    a = np.array([p.start for p in ph])
    b = np.array([p.end for p in ph])
    idle = (b - a) - covered_us(run.device.start, run.device.end, a, b)
    return float(idle.sum()) / 1e3 / len(run.unit_seconds)
