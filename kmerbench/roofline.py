"""Peaks of the card and the least bytes of each kernel's work.

Frozen here with the benchmark: a later change to the program cannot move
them. The byte counts are those of PERF.md's kernel table (each input read
once, each output written once); they count the work, whatever implements
it.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM5 80 GB (data sheet): HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12


def sort_bytes(rows: int, kmer_len: int, two_bit: bool) -> int:
    """A sort of ``rows`` k-mers: each row's key (the k-mer at 2 or 4 bits
    a base, in whole 32-bit words) and its 32-bit position, read once and
    written once: 24 bytes a row at k = 31 on 2-bit keys, 40 on 4-bit."""
    key = math.ceil(kmer_len * (2 if two_bit else 4) / 32) * 4
    return 2 * rows * (key + 4)


def share_of_bandwidth(nbytes: float, seconds: float) -> float:
    """The least time for ``nbytes`` at HBM_BYTES_PER_S over ``seconds``, %."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
