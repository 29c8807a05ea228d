"""What one run recorded, as the metric readers (``metrics/<name>.py``)
see it. A reader is a module with ``read(run) -> float | None``; None
means it found nothing to read in this run, and the metric is left out."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field


@dataclass
class RunRecord:
    cell: str
    unit: str  # "job" or "call"
    setup_s: float
    window_s: float  # first unit's start to last unit's end, host clock
    unit_seconds: list  # host seconds of every job or call of the window
    index_step: dict  # the step that built the index (``min``, ``max``)
    rows_per_job: int  # index rows a job builds (from the configuration), 0 for calls
    memory_peak_bytes: int
    two_bit: bool  # the genome's alphabet is ACGT alone (the sort's 2-bit keys)
    spans: list = field(default_factory=list)  # traced: driver.Span with .start / .end
    device: object = None  # traced: trace.DeviceTrace


def spans_of(run: RunRecord, op: str, unit: str = None, filtered=None) -> list:
    """Traced spans of ``op`` (in ``unit`` mode; with ``filtered`` True or
    False, only those with or without a filter)."""
    out = []
    for s in run.spans:
        if s.op != op or (unit is not None and s.unit != unit):
            continue
        if filtered is not None and bool(s.step.get("filter")) != filtered:
            continue
        out.append(s)
    return out


def median(values):
    return statistics.median(values) if values else None


def nearest_rank(values, q: float):
    """The q-quantile by nearest rank: an observed value."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


def idle_pct(run: RunRecord):
    """Share of the traced window with no device activity, %."""
    if run.device is None:
        return None
    lo, hi = run.device.window
    return 100.0 * (1.0 - run.device.busy_us(lo, hi) / (hi - lo))
