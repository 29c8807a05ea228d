"""Segmented group statistics over a sorted k-mer index.

Counterpart of ``genome_kmers_tpu/ops/groups.py``: boundary mask -> size
(or, under a filter, survivor count) at each group's first row ->
qualifying mask, total and histogram, over retained sorted key lanes or a
boundary of gathered keys; and the fold of a filter's raise conditions.

The histogram is one launch of a hand-written kernel on the card
(``kernels/group_hist.py``; on the CPU its plain version), exact at any
``max_counts_bin``. The JAX package's
two-stage speculative digest was shaped by a link that cost tens of
milliseconds per transfer; nothing here needs it until a measurement on the
card asks for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.group_hist import group_size_hist_cuda
from ..kernels.lanes_flags import lanes_flags_cuda
from ..tracing import span
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


def strand_order(boundary: torch.Tensor, is_rc: torch.Tensor):
    """The (string, strand) groups of a both-strand index whose strands are
    tracked apart. ``boundary`` marks the groups at the query's length,
    ``is_rc`` the "-" rows. Returns ``(order, boundary)``: each group's rows
    stably re-ordered "+" rows first (``order[j]`` is the row that goes to
    place j; a group keeps its place), and the first row of every strand
    half in that order, empty halves dropped.

    Within a group of equal full sort keys the "+" rows already come first
    (ties go by position, and "+" positions are the smaller), so at the
    sort's own compare length ``order`` is the identity. Below it, rows of
    different full strings interleave the strands, which a cut at every
    strand change would split. A count and one scatter, no sort."""
    n = boundary.shape[0]
    dev = boundary.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), boundary
    plus = (~is_rc).to(torch.int64)
    plus_before = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(plus, dim=0, out=plus_before[1:])
    starts = torch.nonzero(boundary).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    n_plus = plus_before[ends] - plus_before[starts]
    gid = torch.cumsum(boundary, dim=0) - 1
    start = starts[gid]
    plus_rank = plus_before[:-1] - plus_before[start]
    rank = torch.arange(n, dtype=torch.int64, device=dev) - start
    dest = torch.where(is_rc, start + n_plus[gid] + rank - plus_rank, start + plus_rank)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[dest] = torch.arange(n, dtype=torch.int64, device=dev)
    out = boundary.clone()
    split = starts + n_plus
    out[split[(n_plus > 0) & (split < ends)]] = True
    return order, out


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


def sizes_digest(boundary, size, min_group_size: int, max_group_size):
    """The qualifying mask and total over a boundary mask and its sizes
    (``group_sizes_at_boundaries``). Returns (size, qualifies, total)."""
    qualifies = _qualifies(boundary, size, min_group_size, max_group_size)
    return size, qualifies, _total(size, qualifies)


def lanes_sizes_digest(
    words, cap, kmer_len: int, min_group_size: int, max_group_size, two_bit: bool
):
    """``sizes_digest`` over the boundaries of retained sorted key lanes."""
    with span("gk:groups.boundaries", words[0]):
        boundary = boundaries_from_sorted_lanes(words, cap, kmer_len, two_bit)
    with span("gk:groups.sizes", boundary):
        return sizes_digest(boundary, group_sizes_at_boundaries(boundary), min_group_size,
                            max_group_size)


def clipped_counts(qualifies, clipped, max_counts_bin: int) -> torch.Tensor:
    """counts[s] = number of rows with ``qualifies`` and size s, sizes above
    ``max_counts_bin`` counted in the top bin: one launch of the histogram
    kernel (``group_size_hist_cuda``), which clamps as it counts, where the
    JAX package picks a compare or a scatter-add by the bin count."""
    return group_size_hist_cuda(clipped, qualifies, max_counts_bin)


def hist_from_sizes(size, qualifies, max_counts_bin: int) -> torch.Tensor:
    """counts[s] = number of qualifying groups of size s, sizes above
    ``max_counts_bin`` folded into the top bin (``clipped_counts``, which
    needs no clamp first)."""
    return clipped_counts(qualifies, size, max_counts_bin)


def hist_to_host(counts: torch.Tensor, dtype=np.int64) -> np.ndarray:
    """A histogram's copy on the host, as ``dtype`` (``LargeKmers`` returns
    uint64): the one device-to-host copy of every statistics call's
    histogram."""
    return counts.cpu().numpy().astype(dtype)


def group_size_histogram(boundary, size, min_group_size: int, max_group_size,
                         max_counts_bin: int):
    """(histogram, total) over the groups with min_group_size <= size <=
    max_group_size (None: no upper bound): counts[s] = groups of size s,
    sizes above ``max_counts_bin`` in the top bin, and the k-mers of those
    groups."""
    qualifies = _qualifies(boundary, size, min_group_size, max_group_size)
    return hist_from_sizes(size, qualifies, max_counts_bin), _total(size, qualifies)


def lanes_group_total(
    words, cap, min_group_size: int, max_group_size, kmer_len: int, two_bit: bool
) -> int:
    """The total of ``lanes_sizes_digest``, for count queries."""
    return lanes_sizes_digest(words, cap, kmer_len, min_group_size, max_group_size, two_bit)[2]


# --------------------------------------------------------------------------- #
# filtered statistics: in a sorted index equal k-mers are contiguous, so the
# reference's "compare each survivor to the previous survivor" walk
# partitions the survivors as the groups of all rows do, and a group's
# survivor count is a difference of prefix counts over its extent. Groups
# with no survivor never existed for the walk: a qualifying group has at
# least one.
# --------------------------------------------------------------------------- #


def survivor_sizes_at_boundaries(boundary: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """surv[i] = number of filter survivors in i's group where boundary[i]
    is True, else 0. The JAX package carries the survivors-before count of
    each group's end back with a reverse ``lax.cummin``; here it is read at
    the next boundary index (``nonzero``), as ``group_sizes_at_boundaries``
    does."""
    n = boundary.shape[0]
    m = mask.to(torch.int64)
    before = torch.zeros(n + 1, dtype=torch.int64, device=boundary.device)
    torch.cumsum(m, dim=0, out=before[1:])  # survivors strictly before each row
    starts = torch.nonzero(boundary).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    surv = torch.zeros(n, dtype=torch.int64, device=boundary.device)
    surv[starts] = before[ends] - before[starts]
    return surv


def fold_err_conditions(errs, positions, valid=None):
    """Fold a filter's per-row raise conditions to ``[any, cond_id,
    first_bad_position]``, a 3-element int64 tensor naming the earliest
    offending row in index (sorted) order, the row the reference's walk
    raises at; ties at one row go to the earlier-listed condition, the
    scalar filter's check order. ``valid``, a bool mask beside the
    positions, leaves the other rows (ragged pads) out of every condition.
    No conditions fold to None."""
    if not errs:
        return None
    n = positions.shape[0]
    best_row = positions.new_tensor(n)
    best_cond = positions.new_tensor(0)
    any_err = torch.zeros((), dtype=torch.bool, device=positions.device)
    for idx, cond in enumerate(errs):
        if valid is not None:
            cond = cond & valid
        has = torch.any(cond)
        row = torch.where(has, torch.argmax(cond.to(torch.uint8)), n)
        take = row < best_row  # strict: the earlier condition wins ties
        best_cond = torch.where(take, idx, best_cond)
        best_row = torch.where(take, row, best_row)
        any_err |= has
    best_pos = torch.where(any_err, positions[torch.clamp_max(best_row, n - 1)], 0)
    return torch.stack([any_err.to(torch.int64), best_cond, best_pos])


def _lanes_filtered_core(words, cap, positions, params, flags_fn, kmer_len: int,
                         two_bit: bool, strand_split):
    """(boundary, survivor mask, error fold) of a filter evaluated on the
    retained sorted key lanes (ops/filters lanes flags: no genome read; on a
    card one launch of the lanes-flags kernel for the GC-content,
    homopolymer and no-ambiguous filters, whose passes the span keeps).
    ``strand_split`` is the first position of the reverse-complement half
    when the strands are tracked apart, else None: the groups are then
    (string, strand) (``strand_order``), and the boundary and mask are in
    that order."""
    with span("gk:filters.flags", positions, kernel=lanes_flags_cuda):
        mask, errs = flags_fn(words, cap, positions, params)
    with span("gk:groups.boundaries", positions):
        boundary = boundaries_from_sorted_lanes(words, cap, kmer_len, two_bit)
    if strand_split is not None:
        order, boundary = strand_order(boundary, positions >= strand_split)
        mask = mask[order]
    return boundary, mask, fold_err_conditions(errs, positions)


def _digest(total: torch.Tensor, err):
    """(total, [err_any, cond_id, first_bad_position] or []) in one read."""
    values = torch.stack([total] + ([] if err is None else list(err))).tolist()
    return values[0], values[1:]


def lanes_filtered_sizes_digest(words, cap, positions, params, kmer_len: int, min_group_size: int,
                                max_group_size, strand_split, two_bit: bool, flags_fn):
    """Survivor sizes, the qualifying mask, the total and the error triple
    of a filtered query over retained sorted key lanes: (surv, qualifies,
    total, err)."""
    boundary, mask, err = _lanes_filtered_core(
        words, cap, positions, params, flags_fn, kmer_len, two_bit, strand_split
    )
    with span("gk:groups.sizes", boundary):
        surv = survivor_sizes_at_boundaries(boundary, mask)
        qualifies = _qualifies(boundary, surv, max(min_group_size, 1), max_group_size)
        total, err = _digest(torch.where(qualifies, surv, 0).sum(), err)
    return surv, qualifies, total, err


def lanes_filtered_total(words, cap, positions, params, kmer_len: int, min_group_size: int,
                         max_group_size, strand_split, two_bit: bool, flags_fn):
    """(total, err) of ``lanes_filtered_sizes_digest``, for count queries."""
    return lanes_filtered_sizes_digest(
        words, cap, positions, params, kmer_len, min_group_size, max_group_size,
        strand_split, two_bit, flags_fn,
    )[2:]


def filtered_sizes_digest(boundary, mask, min_group_size: int, max_group_size):
    """Survivor sizes, the qualifying mask and the total of a filtered query
    over a boundary of all rows and a survivor mask (the plane and window
    routes): (surv, qualifies, total)."""
    with span("gk:groups.sizes", boundary):
        surv = survivor_sizes_at_boundaries(boundary, mask)
        qualifies = _qualifies(boundary, surv, max(min_group_size, 1), max_group_size)
        return surv, qualifies, _total(surv, qualifies)


def filtered_group_total(boundary, mask, min_group_size: int, max_group_size) -> int:
    """Total survivors in qualifying groups: the reduce-only sibling."""
    return filtered_sizes_digest(boundary, mask, min_group_size, max_group_size)[2]


def selection_masks(boundary, size, rank, min_group_size: int, max_group_size, yield_first_n):
    """Which elements a walk over the groups would yield, and per element
    the number of its group's members yielded: the first ``yield_first_n``
    members (in sorted order) of every group whose size is within
    [min_group_size, max_group_size]. None means unbounded. ``size`` and
    ``rank`` are per element (``group_geometry``); ``boundary`` is not
    read, as in the JAX package, whose signature it keeps."""
    yielded = size >= min_group_size
    if max_group_size is not None:
        yielded &= size <= max_group_size
    if yield_first_n is None:
        return yielded, size
    return yielded & (rank < yield_first_n), torch.clamp_max(size, yield_first_n)
