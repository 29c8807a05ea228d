"""The device trace of a traced window, read from ``torch.profiler``.

Device activity is every CUDA event of the profile (kernels, copies,
fills) but the device-side images of the benchmark's ranges; the
benchmark's spans are its ``kmerbench:<op>`` ranges. The check
that the profiler saw the device is a frozen copy of the one in
``device_kernels``, ``chip_smoke.py:1725``: a trace with no kernel raises,
so a traced run fails rather than report a 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PREFIX = "kmerbench:"
WINDOW = PREFIX + "window"


@dataclass
class DeviceTrace:
    window: tuple  # (start, end) of the traced window, profiler microseconds
    start: np.ndarray  # device activities, microseconds
    end: np.ndarray
    name: list
    kernel: np.ndarray  # bool: a kernel, not a copy or a fill
    spans: list  # (op, start, end) of the benchmark's spans, in order
    host: tuple  # (start, end, label) arrays of the ops the spans call directly

    def busy_us(self, lo: float, hi: float) -> float:
        """Microseconds in [lo, hi] in which some device activity ran."""
        s, e = np.clip(self.start, lo, hi), np.clip(self.end, lo, hi)
        return float(union_length(s, e))

    def kernels_in(self, lo: float, hi: float) -> int:
        return int(np.count_nonzero(self.kernel & (self.start >= lo) & (self.start <= hi)))


def merged(start: np.ndarray, end: np.ndarray):
    """The union of intervals as sorted, disjoint (start, end) arrays."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], np.maximum.accumulate(end[order])
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


def union_length(start, end) -> float:
    s, e = merged(start, end)
    return float((e - s).sum())


def read_profile(prof) -> DeviceTrace:
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler also draws each range on the device's timeline: not device work
    dev = [e for e in events if e.device_type == cuda and not e.name.startswith(PREFIX)]
    kernel = np.array([not e.name.startswith(("Memcpy", "Memset")) for e in dev], dtype=bool)
    if not kernel.any():
        raise RuntimeError("torch.profiler saw no CUDA kernel in the traced window")
    windows = [e for e in events if e.name == WINDOW and e.device_type != cuda]
    if len(windows) != 1:
        raise RuntimeError(f"expected one traced window, found {len(windows)}")
    win = (windows[0].time_range.start, windows[0].time_range.end)
    spans = sorted(
        ((e.name[len(PREFIX):], e.time_range.start, e.time_range.end) for e in events
         if e.name.startswith(PREFIX) and e.name != WINDOW and e.device_type != cuda),
        key=lambda t: t[1],
    )
    span_ids = {id(e) for e in events if e.name.startswith(PREFIX) and e.name != WINDOW}
    children = sorted(
        ((e.time_range.start, e.time_range.end, f"{e.cpu_parent.name[len(PREFIX):]}/{e.name}")
         for e in events if e.device_type != cuda and e.cpu_parent is not None
         and id(e.cpu_parent) in span_ids),
        key=lambda t: t[0],
    )
    host = tuple(np.array([c[i] for c in children]) for i in range(2)) + (
        [c[2] for c in children],)
    start = np.array([e.time_range.start for e in dev], dtype=np.float64)
    end = np.array([e.time_range.end for e in dev], dtype=np.float64)
    inside = (end > win[0]) & (start < win[1])
    return DeviceTrace(win, np.clip(start[inside], *win), np.clip(end[inside], *win),
                       [n for n, i in zip((e.name for e in dev), inside) if i], kernel[inside],
                       spans, host)


def _label(t: DeviceTrace, at: np.ndarray) -> list:
    """What the host was doing at each time: the op a span called directly
    (``<span>/<op>``), ``<span>/python`` between them, ``harness`` outside
    every span."""
    hs, he, hl = t.host
    ss = np.array([s for _, s, _ in t.spans])
    se = np.array([e for _, _, e in t.spans])
    out = []
    j = np.searchsorted(hs, at, side="right") - 1 if len(hl) else np.full(at.shape, -1)
    k = np.searchsorted(ss, at, side="right") - 1 if ss.size else np.full(at.shape, -1)
    for m, jj, kk in zip(at, j, k):
        if jj >= 0 and he[jj] >= m:
            out.append(hl[jj])
        elif kk >= 0 and se[kk] >= m:
            out.append(f"{t.spans[kk][0]}/python")
        else:
            out.append("harness")
    return out


def _top(names, seconds, n: int = 10) -> list:
    totals = {}
    for name, sec in zip(names, seconds):
        totals[name] = totals.get(name, 0.0) + float(sec)
    return [[name[:200], sec] for name, sec in sorted(totals.items(), key=lambda t: -t[1])[:n]]


def breakdown(t: DeviceTrace) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing, each the 10 largest, in seconds."""
    device_ops = _top(t.name, (t.end - t.start) / 1e6)
    s, e = merged(t.start, t.end)
    gap_start = np.concatenate([[t.window[0]], e])
    gap_end = np.concatenate([s, [t.window[1]]])
    keep = gap_end > gap_start
    gap_start, gap_end = gap_start[keep], gap_end[keep]
    labels = _label(t, (gap_start + gap_end) / 2)
    return {"device_ops": device_ops, "idle_gaps": _top(labels, (gap_end - gap_start) / 1e6)}
