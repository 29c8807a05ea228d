"""Host-clock timing around work on the card.

Frozen copies, changed only by a benchmark change: ``RoundLog`` of
``chip_smoke.py:667``, which keeps the seconds of each round (the lane
sort's launch count is left out: no metric reads it); the spans of
``driver.run_step`` time a step as ``sync_time`` of ``chip_smoke.py:434``
does, a synchronise on each side.
"""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RoundLog:
    """Times the refinement rounds of a sort: pass it as ``on_round`` to
    ``Kmers.sort``, which calls it with the round's name when the round has
    finished on the card, so the host clock between two calls is one round
    (the first from the start of ``sort()``)."""

    def __init__(self, device):
        sync(device)
        self.rounds = []  # (function name, seconds)
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.rounds.append((name, now - self._t))
        self._t = now
