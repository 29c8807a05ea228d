"""Segmented group statistics over a sorted k-mer index.

Counterpart of ``genome_kmers_tpu/ops/groups.py`` for the statistics over
retained sorted key lanes: boundary mask -> size at each group's first
row -> qualifying mask, total and histogram.

The histogram is one ``torch.bincount``, exact at any ``max_counts_bin``.
The JAX package's two-stage speculative digest was shaped by a link that
cost tens of milliseconds per transfer; nothing here needs it until a
measurement on the card asks for it.
"""

from __future__ import annotations

import torch

from .sort import boundaries_from_sorted_lanes


def group_geometry(boundary: torch.Tensor):
    """Per-element group geometry from a boundary mask (boundary[0] must be
    True). Returns int64 (start, end, size, rank): the index of the first
    element of i's group, one past its last, the group size, and i's
    0-based place within its group. Gathers from the boundary indices take
    the place of the JAX package's cummax / reverse cummin scans (see
    ``group_sizes_at_boundaries``)."""
    n = boundary.shape[0]
    starts = torch.nonzero(boundary).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    gid = torch.cumsum(boundary, dim=0) - 1
    start, end = starts[gid], ends[gid]
    rank = torch.arange(n, dtype=torch.int64, device=boundary.device) - start
    return start, end, end - start, rank


def group_sizes_at_boundaries(boundary: torch.Tensor) -> torch.Tensor:
    """size[i] = group size where boundary[i] is True, else 0.

    The JAX package takes the next boundary with a reverse ``lax.cummin``;
    on an H100 80GB HBM3 (700 W limit) ``torch.cummin`` over 2^27 int64
    rows took 390 ms, so the sizes come from the boundary indices instead
    (``nonzero``, a difference, one scatter)."""
    n = boundary.shape[0]
    starts = torch.nonzero(boundary).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    size = torch.zeros(n, dtype=torch.int64, device=boundary.device)
    size[starts] = ends - starts
    return size


def _qualifies(boundary, size, min_group_size: int, max_group_size):
    """Rows that start a group whose size is in [min, max] (max None = no
    upper bound)."""
    q = boundary & (size >= min_group_size)
    if max_group_size is not None:
        q &= size <= max_group_size
    return q


def _total(size, qualifies) -> int:
    return int(torch.where(qualifies, size, 0).sum())


def group_total_count(boundary, size, min_group_size: int, max_group_size) -> int:
    """Total k-mers in qualifying groups."""
    return _total(size, _qualifies(boundary, size, min_group_size, max_group_size))


def sizes_digest(boundary, min_group_size: int, max_group_size):
    """Sizes and the qualifying mask over a boundary mask. Returns (size,
    qualifies, total)."""
    size = group_sizes_at_boundaries(boundary)
    qualifies = _qualifies(boundary, size, min_group_size, max_group_size)
    return size, qualifies, _total(size, qualifies)


def lanes_sizes_digest(
    words, cap, kmer_len: int, min_group_size: int, max_group_size, two_bit: bool = True
):
    """``sizes_digest`` over the boundaries of retained sorted key lanes."""
    boundary = boundaries_from_sorted_lanes(words, cap, kmer_len, two_bit)
    return sizes_digest(boundary, min_group_size, max_group_size)


def hist_from_sizes(size, qualifies, max_counts_bin: int) -> torch.Tensor:
    """counts[s] = number of qualifying groups of size s, sizes above
    ``max_counts_bin`` folded into the top bin."""
    clipped = torch.clamp_max(size, max_counts_bin)[qualifies]
    return torch.bincount(clipped, minlength=max_counts_bin + 1)


def lanes_group_total(
    words, cap, min_group_size: int, max_group_size, kmer_len: int, two_bit: bool = True
) -> int:
    """Reduce-only sibling of ``lanes_sizes_digest`` for count queries."""
    boundary = boundaries_from_sorted_lanes(words, cap, kmer_len, two_bit)
    size = group_sizes_at_boundaries(boundary)
    return group_total_count(boundary, size, min_group_size, max_group_size)


def selection_masks(size, rank, min_group_size: int, max_group_size, yield_first_n):
    """Which elements a walk over the groups would yield, and per element
    the number of its group's members yielded: the first ``yield_first_n``
    members (in sorted order) of every group whose size is within
    [min_group_size, max_group_size]. None means unbounded. ``size`` and
    ``rank`` are per element (``group_geometry``)."""
    yielded = size >= min_group_size
    if max_group_size is not None:
        yielded &= size <= max_group_size
    if yield_first_n is None:
        return yielded, size
    return yielded & (rank < yield_first_n), torch.clamp_max(size, yield_first_n)
