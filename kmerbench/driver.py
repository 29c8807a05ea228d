"""One general driver of the traffic mixes (``mixes/<mix>.json``).

A mix names its set-up steps and its loop of steps. With ``"unit": "job"``
one pass of the loop is one timed job; with ``"unit": "call"`` each step of
the loop is one timed call, taken in order, round and round. The loop is
closed: the next job or call starts when the last has returned, as a
pipeline script or an analyst works. A step is one call of the program's
public API, ``steps/<op>.py`` (found by ``catalog.step``); what it returns
is an answer, judged against ``reference/steps/<op>.py``.

Traced, each step is a span: a synchronise on each side, the host clock,
and a ``torch.profiler`` range named ``kmerbench:<op>``.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import torch

import genome_kmers_tpu_torch as gk

from . import catalog
from .timing import RoundLog, sync


@dataclass
class Span:
    op: str
    step: dict
    unit: str
    seconds: float
    rounds: list = field(default_factory=list)  # seconds of each refinement round
    start: float = None  # the span's profiler range, microseconds
    end: float = None


@dataclass
class Session:
    """What the steps build and what a run records."""

    records: list
    devices: list  # the cell's cards; the collection lives on the first
    seed: int
    trace: bool = False
    sc: object = None
    km: object = None
    index_step: dict = None  # the step that built ``km``
    on_round: object = None  # traced: the RoundLog of the running step
    spans: list = field(default_factory=list)
    setup_seconds: list = field(default_factory=list)  # (op, seconds) of the set-up steps
    _filters: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def sync(self) -> None:
        for d in self.devices:
            sync(d)

    def kmer_filter(self, spec):
        """The program's filter of ``spec`` = [name, *args], made once."""
        if not spec:
            return gk.kmer_filter_keep_all
        key = tuple(spec)
        if key not in self._filters:
            self._filters[key] = catalog.program_filter(spec[0]).make(*spec[1:])
        return self._filters[key]

    def close(self) -> None:
        self.sc = self.km = None


def run_step(s: Session, step: dict, unit: str):
    """One step; traced, as a span."""
    run = catalog.step(step["op"]).run
    if not s.trace:
        return run(s, step)
    s.on_round = RoundLog(s.device)
    s.sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"kmerbench:{step['op']}"):
        out = run(s, step)
        s.sync()
    seconds = time.perf_counter() - t0
    rounds = [t for _, t in s.on_round.rounds]
    s.on_round = None
    s.spans.append(Span(step["op"], step, unit, seconds, rounds))
    return out


@dataclass
class Window:
    units: list  # (start, end) host clock of every unit, in order
    answers: list  # (step, answer) of every step that answered
    attempted: int
    failed: int
    error: str = None

    @property
    def seconds(self) -> float:
        return self.units[-1][1] - self.units[0][0] if self.units else 0.0


def run_setup(s: Session, mix: dict) -> None:
    """The mix's set-up steps, then one pass of its loop (every shape the
    window uses), untraced."""
    for step in mix["setup"] + mix["loop"]:
        t0 = time.perf_counter()
        catalog.step(step["op"]).run(s, step)
        s.sync()
        s.setup_seconds.append((step["op"], time.perf_counter() - t0))


def run_window(s: Session, mix: dict, seconds: float) -> Window:
    """Jobs or calls, closed loop, started until ``seconds`` have passed
    since the first; the last one runs to its end."""
    loop, unit = mix["loop"], mix["unit"]
    w = Window([], [], 0, 0)
    deadline = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < deadline:
        steps = loop if unit == "job" else [loop[i % len(loop)]]
        i += 1
        w.attempted += 1
        t0 = time.perf_counter()
        try:
            for step in steps:
                out = run_step(s, step, unit)
                if out is not None:
                    w.answers.append((step, out))
            s.sync()
        except Exception:  # the run reports it and is not correct
            w.failed += 1
            w.error = traceback.format_exc()
            break
        w.units.append((t0, time.perf_counter()))
    return w
