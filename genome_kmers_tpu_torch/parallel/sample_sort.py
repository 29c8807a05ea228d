"""Splitter-based sample sort of k-mer start positions over the mesh.

Counterpart of ``genome_kmers_tpu/parallel/sample_sort.py`` at a bounded
k-mer length (one compare window: k <= 64 on 2-bit keys, k <= 32 on 4-bit
keys). The pipeline of the JAX package, shard by shard:

  1. local sort of the key lanes (key words, the cap where caps differ, the
     position last, a key: input may come in any order);
  2. a regular-stride sample of ``s = min(256, m)`` rows of each shard's
     ``m`` (row ``(i * stride + stride // 2) % m``), gathered to every
     shard and sorted; the ``P - 1`` splitters are its rows at stride ``s``;
  3. each shard's rows split into ``P`` contiguous buckets at the splitters
     (bucket b: the rows with b splitters at or below them);
  4. the exchange: bucket b of every shard goes to shard b;
  5. each shard sorts what it received: shard b holds the b-th key range.

The result is globally sorted but ragged: shard b holds its ``n_b`` real
rows, then pads (``is_pad``, every lane all-ones) up to ``P * C`` rows,
where ``C = min(m, ceil(m / P * factor) + P)`` is the exchange capacity of
the JAX package: ``factor`` starts at 1.5 and doubles while a bucket is
larger than ``C``. Each shard's layout is the JAX package's at the same mesh
size.

What differs from the JAX package, for the card: the bucket bounds are
found on the host side (a lane-by-lane ``torch.searchsorted`` of each
splitter in each shard's sorted rows; the JAX package reads an overflow flag
once a try), so the capacity is chosen before anything moves and a retry
re-runs no sort; the
exchange moves each bucket's real rows and no padding; and no sort is given
rows that are identical in every lane, which the multi-lane sort kernel
(``kernels/lane_sort.py``) does not promise to order: the folded pad rows
that end the last shard of an evenly padded index are cut off before the
local sort and the splitter sort and put back behind the sorted rows, and
step 5 sorts only real rows, the pads added after it. Every multi-lane sort
here is ``sort_lanes_cuda``: the kernel on a CUDA tensor, its plain version
on the CPU.

Not ported yet (ROADMAP.md A11): the unbounded and beyond-window refinement
(``sample_sort_positions_unbounded``, ``distributed_adjacent_gids``), the
canonical sorts, the 64-bit (strided) positions and the 2-D mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.lane_sort import sort_lanes_cuda
from ..ops.keys import _mask_table, cap_lengths, compute_valid_len, u32_bits_as_int32, widen_u32
from .collectives import all_gather, all_to_all, put_sharded, replicate
from .distributed import _PAD_POS, _cdiv, _pad_to_multiple, _words_for, mesh_size

_ONES = -1  # 0xFFFFFFFF as an int32 bit pattern
_INT32_MIN = -(1 << 31)
N_SAMPLES = 256
CAPACITY_FACTOR = 1.5


def _searchsorted_rows(rows: tuple, queries: np.ndarray) -> list:
    """For each query (a column of ``queries``: one row a lane, int32 bit
    patterns on the host), the number of ``rows`` (sorted, lexicographic
    over the lanes, compared as unsigned) strictly below it:
    ``searchsorted(rows, query, side="left")`` over multi-lane rows. A lane
    at a time, ``torch.searchsorted`` of the query's value within the rows
    whose earlier lanes equal the query's (one sorted range, read to the
    host after each lane), so a query costs a few binary searches and no
    pass over the rows beyond the first lane's flip to signed order. The
    JAX package searches the other way round, every row among the
    splitters; with sorted rows the bucket bounds are the same."""
    out = []
    for q in queries.T:
        lo, hi = 0, rows[0].shape[0]
        for lane, value in zip(rows, q):
            seg = lane[lo:hi] ^ _INT32_MIN  # unsigned order as signed order
            v = seg.new_full((1,), int(np.int32(value) ^ np.int32(_INT32_MIN)))
            below = int(torch.searchsorted(seg, v))
            equal = int(torch.searchsorted(seg, v, right=True)) - below
            lo, hi = lo + below, lo + below + equal
            if equal == 0:
                break
        out.append(lo)
    return out


def _sort_unpadded(lanes: tuple, n_sort: int) -> tuple:
    """The rows sorted, where rows ``n_sort:`` are folded pads (all-ones in
    every lane, sorting last): only the first ``n_sort`` rows go through
    the sort, the pads stay behind them."""
    n = lanes[0].shape[0]
    if n_sort == n:
        return sort_lanes_cuda(lanes)
    head = sort_lanes_cuda(tuple(lane[:n_sort] for lane in lanes))
    return tuple(torch.cat([h, lane[n_sort:]]) for h, lane in zip(head, lanes))


def _sort_samples(samples: tuple) -> tuple:
    """The gathered samples sorted. Samples of folded pad rows (position
    lane all-ones: no real position is 0xFFFFFFFF) are identical rows; they
    sort last and are put there without going through the sort."""
    real = samples[-1] != _ONES
    if bool(real.all()):
        return sort_lanes_cuda(samples)
    head = sort_lanes_cuda(tuple(lane[real] for lane in samples))
    n_pad = int((~real).sum())
    return tuple(torch.cat([h, h.new_full((n_pad,), _ONES)]) for h in head)


def _capacity(m: int, n_dev: int, largest: int, capacity_factor: float):
    """(capacity, factor, retries) of the JAX package's retry loop: the
    first capacity of the doubling factors that holds the largest bucket."""
    factor, retries = capacity_factor, 0
    while True:
        capacity = min(m, int(np.ceil(m / n_dev * factor)) + n_dev)
        if largest <= capacity:
            return capacity, factor, retries
        if capacity >= m:
            raise AssertionError("sample sort overflow at full capacity (bug)")
        factor *= 2.0
        retries += 1


def _exchange_merge(lanes: list, n_sort: list, padm: list, mesh, n_samples: int,
                    capacity_factor: float, on_step=None):
    """Steps 1-5 over prepared per-shard lanes (key lanes, then the
    position, int32 bit patterns, ``m`` rows a shard; the list is
    consumed). Rows ``n_sort[p]:`` of shard p are folded pads (all-ones);
    ``padm[p]`` marks every row that is not to be exchanged (folded pads,
    and the invalid rows of the dense path, which sort behind the real rows
    by their leading lanes).

    Returns (positions, is_pad, key lanes) per shard, ``P * C`` rows each,
    and ``{"capacity_factor", "capacity", "retries", "rows"}``.
    ``on_step(name)`` is called after each step ("local sort", "splitters",
    "bucket bounds", "exchange", "merge") once its work is queued, so a
    caller that synchronises in it times the steps."""
    n_dev = mesh_size(mesh)
    m = lanes[0][0].shape[0]
    step = on_step if on_step is not None else (lambda name: None)

    # 1. local sort; ``lanes`` is emptied as it goes, so that each shard's
    # unsorted lanes are freed once sorted
    sorted_lanes = []
    for k in n_sort:
        sorted_lanes.append(_sort_unpadded(lanes.pop(0), k))
    lanes = sorted_lanes
    step("local sort")

    # 2. regular-stride samples -> all shards -> sorted -> splitters
    stride = max(m // n_samples, 1)
    samp_idx = (torch.arange(n_samples, dtype=torch.int64) * stride + stride // 2) % m
    local = [tuple(lane[samp_idx.to(lane.device)] for lane in shard) for shard in lanes]
    gathered = [all_gather([s[li] for s in local], mesh) for li in range(len(local[0]))]
    split_idx = (torch.arange(n_dev - 1, dtype=torch.int64) + 1) * n_samples
    splitters = []
    for p in range(n_dev):
        ranked = _sort_samples(tuple(g[p].reshape(-1) for g in gathered))
        splitters.append(tuple(lane[split_idx.to(lane.device)] for lane in ranked))
    step("splitters")

    # 3. bucket bounds: rows below each splitter, clamped to the real rows
    bounds = []
    for p in range(n_dev):
        n_real = m - int(padm[p].sum())
        split_host = np.stack([lane.cpu().numpy() for lane in splitters[p]])  # (lanes, P - 1)
        below = [min(b, n_real) for b in _searchsorted_rows(lanes[p], split_host)]
        bounds.append([0] + below + [n_real])
    bounds = np.asarray(bounds, dtype=np.int64)  # (P, P + 1)
    counts = np.diff(bounds, axis=1)
    capacity, factor, retries = _capacity(m, n_dev, int(counts.max()), capacity_factor)
    step("bucket bounds")

    # 4. exchange: bucket b of shard p -> shard b (its real rows only)
    recv = [
        all_to_all(
            [[shard[li][int(bounds[p][b]) : int(bounds[p][b + 1])] for b in range(n_dev)]
             for p, shard in enumerate(lanes)],
            mesh,
        )
        for li in range(len(lanes[0]))
    ]
    del lanes
    step("exchange")

    # 5. merge: sort the received real rows, then pad to P * C rows
    out_pos, out_pad, out_lanes = [], [], []
    rows = capacity * n_dev
    for b in range(n_dev):
        got = tuple(torch.cat(recv[li][b]) for li in range(len(recv)))
        n_b = got[0].shape[0]
        merged = sort_lanes_cuda(got)
        merged = tuple(torch.cat([w, w.new_full((rows - n_b,), _ONES)]) for w in merged)
        out_pos.append(widen_u32(merged[-1]))
        out_pad.append(torch.arange(rows, device=merged[0].device) >= n_b)
        out_lanes.append(merged[:-1])
    step("merge")
    info = {"capacity_factor": factor, "capacity": capacity, "retries": retries,
            "rows": [int(c) for c in counts.sum(axis=0)]}
    return out_pos, out_pad, out_lanes, info


def sample_sort_positions_ragged(
    packed,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    max_kmer_len: int,
    mesh,
    packed2=None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
    return_lanes: bool = False,
    on_step=None,
    info: dict | None = None,
):
    """Globally sort k-mer start positions (int64, any order, on any
    device) over the mesh: (positions, is_pad) per shard, int64 positions
    (pads 0xFFFFFFFF) and bool pad flags, ``P * C`` rows a shard. With
    ``return_lanes`` also the sorted key words per shard (int32 bit
    patterns, pads all-ones) for the statistics. ``packed2`` (2-bit pack,
    k <= 64) or ``packed`` (4-bit pack, k <= 32); ``uniform_cap`` drops the
    cap lane when every position has ``max_kmer_len`` bases. ``info``, a
    dict, receives the capacity factor used, the capacity, the retries and
    the real rows of each shard; ``on_step`` see ``_exchange_merge``."""
    limit = 64 if packed2 is not None else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(f"sample sort requires max_kmer_len <= {limit} bases")
    cap_len = cap_lengths(compute_valid_len(positions, seg_starts, seg_ends), max_kmer_len)
    two_bit = packed2 is not None
    n = positions.shape[0]
    n_dev = mesh_size(mesh)
    n_words = _cdiv(max_kmer_len, 16 if two_bit else 8)
    pos_p = _pad_to_multiple(positions, n_dev, _PAD_POS)
    cap_p = _pad_to_multiple(cap_len, n_dev, 0)
    m = pos_p.shape[0] // n_dev
    pos_s, cap_s = put_sharded(pos_p, mesh), put_sharded(cap_p, mesh)
    del pos_p, cap_p, cap_len
    genome = replicate(packed2 if two_bit else packed, mesh)
    lanes, n_sort, padm = [], [], []
    for p in range(n_dev):
        n_real = min(max(n - p * m, 0), m)
        pad = torch.arange(m, device=pos_s[p].device) >= n_real
        words = _words_for(genome[p], pos_s[p], cap_s[p], n_words, two_bit)
        words = tuple(torch.where(pad, _ONES, w) for w in words)  # pads sort last
        caps = () if uniform_cap else (torch.where(pad, _ONES, cap_s[p].to(torch.int32)),)
        pos_k = torch.where(pad, _ONES, u32_bits_as_int32(pos_s[p]))
        lanes.append(words + caps + (pos_k,))
        n_sort.append(n_real)
        padm.append(pad)
    del pos_s, cap_s
    out_pos, out_pad, out_lanes, got = _exchange_merge(
        lanes, n_sort, padm, mesh, min(n_samples, m), capacity_factor, on_step
    )
    if info is not None:
        info.update(got)
    if return_lanes:
        return out_pos, out_pad, [w[:n_words] for w in out_lanes]
    return out_pos, out_pad


def sample_sort_positions(
    packed,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    max_kmer_len: int,
    mesh,
    packed2=None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
) -> torch.Tensor:
    """The globally sorted positions, compacted on the host and returned on
    the input's device; see ``sample_sort_positions_ragged``."""
    limit = 64 if packed2 is not None else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(
            "sample sort beyond one compare window (max_kmer_len None or above "
            f"{limit}) is not ported yet (ROADMAP.md A11)"
        )
    out_pos, out_pad = sample_sort_positions_ragged(
        packed, positions, seg_starts, seg_ends, max_kmer_len, mesh, packed2=packed2,
        n_samples=n_samples, capacity_factor=capacity_factor, uniform_cap=uniform_cap,
    )
    host = torch.cat([pos[~pad].cpu() for pos, pad in zip(out_pos, out_pad)])
    return host.to(positions.device)


# --------------------------------------------------------------------------- #
# dense fresh path: the key lanes of every SBA position, built shard by
# shard from slices of the replicated pack (no per-row gather). Valid only
# while the index is the canonical dense start set (a fresh Kmers sort).
# --------------------------------------------------------------------------- #


def _dense_key_lanes(packed, seg_starts, seg_ends, lo: int, hi: int, min_len: int,
                     n_words: int, k: int, two_bit: bool, uniform_cap: bool):
    """(key lanes, positions, invalid) of positions ``lo..hi-1``, int32 bit
    patterns. Word w of a position p is the pack at ``p + per_word * w``
    (zero past its end), masked to the cap. Rows that are not k-mer starts
    (separators, tails shorter than ``min_len``, positions past the SBA)
    are invalid and fold as the JAX package folds them: all-ones words
    (and cap, when the cap lane is kept) on 2-bit keys, a leading invalid
    lane on 4-bit keys, where a real word can be all-ones."""
    dev = packed.device
    per_word = 16 if two_bit else 8
    iota = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    cap = torch.clamp_max(compute_valid_len(iota, seg_starts, seg_ends), k)
    invalid = cap < min_len
    masks = _mask_table(per_word, dev)
    length = packed.shape[0]
    words = []
    for w in range(n_words):
        off = per_word * w
        word = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
        a, b = min(lo + off, length), min(hi + off, length)
        word[: b - a] = packed[a:b]
        word &= masks[torch.clamp(cap - off, 0, per_word)]
        words.append(word)
    if two_bit:
        key = tuple(torch.where(invalid, _ONES, w) for w in words)
        if not (uniform_cap and k % 16 != 0):
            # a real last word keeps < 16 bases when k % 16 != 0, so its low
            # bits are zero and it never equals all-ones: then no cap lane
            key += (torch.where(invalid, _ONES, cap.to(torch.int32)),)
    else:
        key = (invalid.to(torch.int32),) + tuple(words)
    return key, u32_bits_as_int32(iota), invalid


def sample_sort_positions_dense_ragged(
    packed,
    seg_starts,
    seg_ends,
    n: int,
    min_kmer_len: int,
    max_kmer_len: int,
    mesh,
    two_bit: bool = False,
    uniform_cap: bool = False,
    return_lanes: bool = False,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    on_step=None,
    info: dict | None = None,
):
    """Sample sort of the canonical k-mer start set (every position with
    valid_len >= min_kmer_len) from the genome's pack (2-bit when
    ``two_bit``, else 4-bit) over the mesh, with no position array and no
    key gather: shard p builds the lanes of SBA positions ``p*m ..
    (p+1)*m - 1`` (the SBA padded to a multiple of the shard count) from
    slices of the pack. Output as ``sample_sort_positions_ragged`` over the
    canonical start set (same keys, same position tie-break); ``n`` is the
    canonical start count, checked against the real rows."""
    limit = 64 if two_bit else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(f"dense sample sort requires max_kmer_len <= {limit} bases")
    n_dev = mesh_size(mesh)
    n_words = _cdiv(max_kmer_len, 16 if two_bit else 8)
    m = _cdiv(max(packed.shape[0], 1), n_dev)
    genome = replicate(packed, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    lanes, padm = [], []
    for p in range(n_dev):
        key, iota, invalid = _dense_key_lanes(
            genome[p], ss[p], se[p], p * m, (p + 1) * m, min_kmer_len, n_words,
            max_kmer_len, two_bit, uniform_cap,
        )
        lanes.append(key + (iota,))
        padm.append(invalid)
    out_pos, out_pad, out_lanes, got = _exchange_merge(
        lanes, [m] * n_dev, padm, mesh, min(n_samples, m), capacity_factor, on_step
    )
    if sum(got["rows"]) != n:
        raise AssertionError(f"dense sample sort kept {sum(got['rows'])} rows, expected {n}")
    if info is not None:
        info.update(got)
    if return_lanes:
        words = out_lanes if two_bit else [w[1:] for w in out_lanes]
        return out_pos, out_pad, [w[:n_words] for w in words]
    return out_pos, out_pad


def ragged_rows(positions: list, is_pad: list) -> np.ndarray:
    """The real rows of a ragged layout in global order, as a host uint32
    array (the counterpart of the JAX package's ``pos[pad == 0]``)."""
    if not positions:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate(
        [pos[~pad].cpu().numpy().astype(np.uint32) for pos, pad in zip(positions, is_pad)]
    )
