"""Phase spans inside the sort, the group statistics and the filters.

The switch is a ``torch.profiler`` session: while none records, ``span``
returns one shared no-op context after a single check of the profiler's
flag (no allocation, no clock read, no CUDA call), so the library runs as
if it had no spans. While one records, each span is

* a function-scope range ``gk:<layer>.<phase>`` on the profiler's own
  clock, a sibling of the library's other ranges under whatever range the
  caller opened around the public call (the library opens none of its
  own, and its spans never nest). Unlike ``torch.profiler.record_function``
  it draws no image of itself on the device's timeline;
* a record, in the order the spans opened: ``name``; ``call``, a number
  shared by the spans of one public call (``Kmers.sort``,
  ``Kmers.get_kmer_group_counts``, ``Kmers.get_kmer_count``); ``rows``,
  the rows the phase works over; ``passes``, where the phase runs a
  kernel that counts them (the multi-lane sort, the group-size histogram),
  that kernel's passes over its rows (0 where its plain version ran), else
  None; ``device_ms``, the device time between two
  CUDA events recorded on the current stream as the span opens and
  closes, None for CPU tensors.

A mesh span (``mesh_span``) covers a phase that runs on every shard of a
mesh (``parallel/``): the same range, and a pair of CUDA events on the
current stream of each distinct card among the shards. Its record keeps
``card_ms``, each card's device ms in the order the shards name the
cards, and ``device_ms``, the slowest card's.

A span adds no synchronisation and reads nothing back; the device times
are read when the records are (``records``, ``take``). Host times are the
profiler's ranges. The records grow while sessions record and are kept
across them until ``take`` clears them.

    with torch.profiler.profile(activities=[...]) as prof:
        km.sort()
        hist, total = km.get_kmer_group_counts(31)
    phases = tracing.take()   # [{"name": "gk:sort.keys", "call": 1, ...}, ...]
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_Range = torch._C._profiler._RecordFunctionFast
_OFF = nullcontext()

_records = []
_call = 0


def new_call() -> None:
    """Start a public call: the spans until the next one share its number."""
    global _call
    if _profiler._is_profiler_enabled:
        _call += 1


class _Span:
    __slots__ = ("name", "call", "rows", "passes", "_range", "_streams", "_events",
                 "_kernel", "_launches", "_per_card")

    def __init__(self, name: str, rows, cards, kernel, per_card: bool):
        self.name, self.call, self.rows = name, _call, rows
        self.passes = None
        self._range = _Range(name)
        self._streams = [torch.cuda.current_stream(d) for d in dict.fromkeys(cards)
                         if d.type == "cuda"]
        self._events = []  # one a card as the span opens, then one a card as it closes
        self._kernel = kernel
        self._launches = None if kernel is None else kernel.launches
        self._per_card = per_card

    def _record(self) -> None:
        for stream in self._streams:
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            self._events.append(event)

    def __enter__(self):
        self._range.__enter__()
        _records.append(self)
        self._record()
        return self

    def __exit__(self, *exc):
        self._record()
        if self._kernel is not None:
            moved = self._kernel.launches != self._launches
            self.passes = self._kernel.passes if moved else 0
        self._range.__exit__(*exc)
        return False

    def as_dict(self) -> dict:
        n = len(self._streams)
        card_ms = []
        for start, end in zip(self._events[:n], self._events[n:]):
            end.synchronize()
            card_ms.append(start.elapsed_time(end))
        out = {"name": self.name, "call": self.call, "rows": self.rows,
               "passes": self.passes, "device_ms": max(card_ms) if card_ms else None}
        if self._per_card:
            out["card_ms"] = card_ms or None
        return out


def span(name: str, rows=None, kernel=None):
    """A context around one phase, ``name`` = ``gk:<layer>.<phase>``.
    ``rows``: a tensor whose first dimension is the rows the phase works
    over, and whose device decides whether the span is timed on the
    device. ``kernel``: a kernel wrapper with ``.launches`` and ``.passes``
    (``kernels/lane_sort.sort_lanes_cuda``,
    ``kernels/group_hist.group_size_hist_cuda``) whose passes the record
    keeps (the wrapper keeps those of its last launch)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if rows is None:
        return _Span(name, None, (), kernel, False)
    return _Span(name, int(rows.shape[0]), (rows.device,), kernel, False)


def mesh_span(name: str, shards, kernel=None, devices=None):
    """``span`` over a phase of every shard of a mesh: ``shards``, one
    tensor a local shard, whose first dimensions sum to the rows and
    whose cards are timed, each by its own pair of CUDA events (module
    doc); ``devices``, where given, are the cards timed instead (those a
    phase moves data to)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    cards = devices if devices is not None else [t.device for t in shards]
    return _Span(name, sum(int(t.shape[0]) for t in shards), cards, kernel, True)


def records() -> list:
    """Copies of the records, as dicts (module doc); their device times are
    read here, after waiting for the span's closing event."""
    return [r.as_dict() for r in _records]


def take() -> list:
    """``records()``, then clear them."""
    out = records()
    _records.clear()
    return out
