"""Genomes made from a seed, by a configuration's sizes.

Frozen here so that a later change to the program cannot move the
yardstick; only a benchmark change edits this file.

``plant_families`` is adapted from ``make_repeat_genome`` in
``tools/torch_run_applications.py:39`` (itself the generator of
``tools/run_applications.py``): repeat families of ``element_bp`` bases
whose copies carry independent point substitutions at ``mutation_rate``.
Three changes: the copy numbers are the log-uniform quantiles of
[copies_min, copies_max] instead of log-uniform draws, so that every seed
plants the same amount of repeat (the seed moves where and what, not how
much); the background and the elements are drawn at the configuration's
GC share; and one family's copies are planted in one vectorised step.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
N = ord("N")
_TABLE_BITS = 16


def _base_table(gc_share: float, symbols=np.arange(4, dtype=np.uint8)) -> np.ndarray:
    """uint16 draw -> base (rank A0 C1 G2 T3, or the ``symbols`` in that
    order) with P(C) = P(G) = gc_share / 2."""
    size = 1 << _TABLE_BITS
    at = int(round(size * (1.0 - gc_share) / 2))
    gc = size // 2 - at
    return np.repeat(symbols, [at, gc, gc, size - at - 2 * gc])


def draw_ranks(rng, n: int, gc_share: float, symbols=np.arange(4, dtype=np.uint8)) -> np.ndarray:
    return _base_table(gc_share, symbols)[rng.integers(0, 1 << _TABLE_BITS, n, dtype=np.uint16)]


def family_copies(families: int, copies_min: int, copies_max: int) -> list[int]:
    """The copy number of each family: log-uniform quantiles in [min, max]."""
    ratio = copies_max / copies_min
    return [int(round(copies_min * ratio ** ((i + 0.5) / families))) for i in range(families)]


def plant_families(bases, rng, families, element_bp, copies_min, copies_max,
                   mutation_rate, gc_share) -> int:
    """Plant repeat families into the ASCII ``bases`` in place; returns the
    copies."""
    n = bases.shape[0]
    offsets = np.arange(element_bp)
    planted = 0
    for copies in family_copies(families, copies_min, copies_max):
        elem = draw_ranks(rng, element_bp, gc_share)
        starts = rng.integers(0, n - element_bp, copies)
        block = np.broadcast_to(elem, (copies, element_bp)).copy()
        m = rng.random((copies, element_bp)) < mutation_rate
        block[m] = (block[m] + rng.integers(1, 4, int(m.sum()))) % 4
        bases[starts[:, None] + offsets] = BASES[block]
        planted += copies
    return planted


def _n_runs(config: dict, rng, total: int) -> list[tuple[int, int]]:
    """(start, length) of every N run: the configuration's fixed runs, then
    its other runs placed from the seed clear of every run before them."""
    spec = config.get("n_runs") or {}
    runs = [(int(s), int(ln)) for s, ln in spec.get("fixed", [])]
    for length in spec.get("placed", []):
        while True:
            start = int(rng.integers(0, total - length))
            if all(start + length < s or start > s + ln for s, ln in runs):
                runs.append((start, int(length)))
                break
    return runs


def make_records(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    """The configuration's records as (name, uint8 ASCII bases), from ``seed``:
    the background at the GC share, the repeat families over the whole
    genome, then the N runs."""
    rng = np.random.default_rng(seed)
    lengths = [int(ln) for _, ln in config["records"]]
    total = sum(lengths)
    gc = float(config["gc_share"])
    genome = draw_ranks(rng, total, gc, BASES)
    fam = config["repeat_families"]
    plant_families(genome, rng, fam["families"], fam["element_bp"], fam["copies_min"],
                   fam["copies_max"], fam["mutation_rate"], gc)
    for start, length in _n_runs(config, rng, total):
        genome[start:start + length] = N
    out, at = [], 0
    for (name, _), length in zip(config["records"], lengths):
        out.append((name, genome[at:at + length]))
        at += length
    return out

