"""Splitter-based sample sort of k-mer start positions over the mesh.

Counterpart of ``genome_kmers_tpu/parallel/sample_sort.py``. The pipeline of
the JAX package, shard by shard:

  1. local sort of the key lanes (key words, the cap where caps differ, the
     position last, a key: input may come in any order);
  2. a regular-stride sample of ``s = min(256, m)`` rows of each shard's
     ``m`` (row ``(i * stride + stride // 2) % m``), gathered to every
     shard and sorted; the ``P - 1`` splitters are its rows at stride ``s``;
  3. each shard's rows split into ``P`` contiguous buckets at the splitters
     (bucket b: the rows with b splitters at or below them);
  4. the exchange: bucket b of every shard goes to shard b
     (``collectives.all_to_all``: one hop on a 1-D mesh, the two stages of
     ``hier.py`` on a 2-D one);
  5. each shard sorts what it received: shard b holds the b-th key range.

The result is globally sorted but ragged: shard b holds its ``n_b`` real
rows, then pads (``is_pad``, every lane all-ones) up to ``P * C`` rows,
where ``C = min(m, ceil(m / P * factor) + P)`` is the exchange capacity of
the JAX package: ``factor`` starts at 1.5 and doubles while a bucket is
larger than ``C``. Each shard's layout is the JAX package's at the same mesh
size.

Beyond one compare window (``max_kmer_len`` None, or above 64 bases on
2-bit keys / 32 on 4-bit keys) the sort refines, as the JAX package's
``sample_sort_positions_unbounded``: round 0 is the sample sort capped at
the first 32-base window; after each round the run structure (a run id a
row, stitched across shard edges, and the count of tied rows that still
extend past the window) is computed over the new layout, and while rows are
unresolved the next round sample-sorts by (run id, the next 32 bases, cap,
position). ``distributed_adjacent_gids`` runs the run structure alone over
a layout that is already sorted. The canonical sorts order rows by
min(key, reverse complement).

What differs from the JAX package, for the card:

* a shard holds its real rows only, and its row count ``m`` in the JAX
  layout as a number: the pads that sort behind the real rows in the JAX
  package's local sort (the padding of an uneven index, the rows a
  canonical sort leaves out) are not built, and a sample that falls on one
  of them is an all-ones row. So no sort is given rows that are identical
  in every lane, which the multi-lane sort kernel (``kernels/lane_sort.py``)
  does not promise to order. The bounded sorts and round 0 return the JAX
  layout byte for byte, pads included.
* the refinement rounds are balanced. The JAX package sizes each round's
  exchange from the previous layout's rows, pads included, and samples at
  a regular stride over all of them; its capacity series grows that layout
  1.5x a round, so the samples fall on pads more and more and from about
  round 4 every real row sits on shard 0. Here a round sizes its exchange
  from the real rows (``m`` = the largest shard's real rows after the
  previous round) and draws each shard's samples at a regular stride over
  its real rows, as many as its share of all rows (``P * n_samples``
  samples in all); the splitters are the quantiles of the real samples.
  Each shard then ends a round with about ``1 / P`` of the rows (the tests
  hold at most twice the mean), so the rows of a round keep the global
  order and run ids of the JAX package but not its per-shard split. They
  return each shard's real rows and one pad row.
* the bucket bounds are found on the host side (a lane-by-lane
  ``torch.searchsorted`` of each splitter in each shard's sorted rows; the
  JAX package reads an overflow flag once a try), so the capacity is chosen
  before anything moves and a retry re-runs no sort; the exchange moves
  each bucket's real rows and no padding.

The ``*_large*`` sorts are the same pipeline over a strided pack
(``ops/large.py``, the index of ``LargeKmers``): int64 positions of any
size, which enter the lane sort as two int32 lanes (hi, then lo), key words
by a funnel shift, and refinement windows of 64 bases on 2-bit keys and 32
on 4-bit keys (4 words each), as the JAX package's. A key source
(``_FlatKeys``, ``_StridedKeys``) tells the shared code how rows are keyed;
the round driver, the run structure and the exchange are one copy.

Every multi-lane sort here is ``sort_lanes_cuda``: the kernel on a CUDA
tensor, its plain version on the CPU.

On a process mesh (``distributed.make_mesh`` under ``torch.distributed``)
every per-shard loop runs over this rank's shards only; sample counts,
bucket counts and run counts that need every shard are all-gathered
(``collectives.gather_host``), and rows move between ranks only through
``collectives.all_to_all``. Host views of a layout (``ragged_rows``,
``large_rows`` with ``mesh``) all-gather it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.lane_sort import MAX_LANES, sort_lanes_cuda
from ..ops.canonical import canonical_words
from ..ops.keys import _mask_table, cap_lengths, compute_valid_len, u32_bits_as_int32, widen_u32
from ..ops.large import (
    NO_CAP,
    build_key2_words_strided,
    build_key_words_strided,
    compute_valid_len64,
    fuse64,
    split64,
)
from ..ops.sort import WINDOW_BASES, _round_done
from ..tracing import mesh_span
from .collectives import (
    all_gather,
    all_gather_shards,
    all_to_all,
    gather_host,
    psum,
    replicate,
    to_device,
)
from .distributed import (
    _cdiv,
    _halo_adjacent_eq,
    _halo_prev_flag,
    _words_for,
    mesh_size,
)

_ONES = -1  # 0xFFFFFFFF as an int32 bit pattern
_PAD_U32 = 0xFFFFFFFF  # a pad row's position and run id, as int64 values
_INT32_MIN = -(1 << 31)
N_SAMPLES = 256
CAPACITY_FACTOR = 1.5
# positions past a shard's last row whose pack words its dense key lanes
# read: n_words - 1 words of 16 bases (2-bit, k <= 64) or 8 (4-bit, k <= 32)
DENSE_HALO = 64


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


def _sort_samples(samples: tuple) -> tuple:
    """The gathered samples sorted. Samples of pad rows (all-ones in every
    lane: no real row is, its position lanes never are) are identical rows;
    they sort last and are put there without going through the sort."""
    real = torch.stack([lane != _ONES for lane in samples]).any(dim=0)
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


def _samples(lanes: list, rows: int, n_samples: int, mesh, balanced: bool):
    """Step 2's samples of each local shard's sorted lanes, one width on
    every shard (a missing sample is an all-ones pad row), and the index in
    the sorted gathered samples of each of the ``P - 1`` splitters.

    The JAX package's (``balanced`` False): ``n_samples`` rows of each
    shard's ``rows`` at a regular stride, a row past its built rows a pad;
    the splitters at stride ``n_samples``. Balanced (the refinement
    rounds): ``P * n_samples`` samples in all, each shard's share of them
    by its share of the rows, at the midpoints of equal parts of its real
    rows; the splitters the quantiles of the real samples."""
    n_dev = mesh_size(mesh)
    if not balanced:
        stride = max(rows // n_samples, 1)
        take = [[(i * stride + stride // 2) % rows for i in range(n_samples)]] * len(lanes)
        width = n_samples
        split_idx = [(b + 1) * n_samples for b in range(n_dev - 1)]
    else:
        n_rows = gather_host([shard[0].shape[0] for shard in lanes], mesh)
        total = int(n_rows.sum())
        share = [min(int(n), -(-n_dev * n_samples * int(n) // total)) if total else 0
                 for n in n_rows]
        take = [[(2 * i + 1) * int(n_rows[p]) // (2 * share[p]) for i in range(share[p])]
                for p in mesh.shard_ids]
        width = max(max(share), 1)
        split_idx = [(b + 1) * sum(share) // n_dev for b in range(n_dev - 1)]
    local = []
    for shard, idx in zip(lanes, take):
        built = [i for i in idx if i < shard[0].shape[0]]
        at = torch.tensor(built, dtype=torch.int64, device=shard[0].device)
        n_pad = width - len(built)
        local.append(tuple(torch.cat([lane[at], lane.new_full((n_pad,), _ONES)]) for lane in shard))
    return local, torch.tensor(split_idx, dtype=torch.int64)


def _exchange_merge(lanes: list, padm, rows: int, mesh, capacity_factor: float,
                    n_samples: int = N_SAMPLES, on_step=None, balanced: bool = False):
    """Steps 1-5 over prepared per-shard lanes (key lanes, then the
    position, int32 bit patterns; the list is consumed). Shard p holds the
    first ``lanes[p][0].shape[0]`` of its ``rows`` rows in the JAX layout;
    the rest are pads, all-ones in every lane, which are not built.
    ``padm[p]`` (or None: none) marks the rows built but not exchanged: the
    invalid rows of the dense sorts, which sort behind the real rows by
    their leading lanes. ``balanced`` (the refinement rounds: every built
    row is real, ``rows`` the largest shard's) samples each shard's real
    rows by its share (``_samples``).

    Returns (lanes, info): each shard's received rows sorted (its real rows
    in the JAX layout), every lane, and ``{"capacity_factor", "capacity",
    "retries", "rows", "shard_rows"}``: ``rows`` the real rows of each
    shard (all shards, on every rank), ``shard_rows`` (``P * C``) the rows
    of each shard in a layout padded to the exchange capacity ``C``: the
    JAX layout, except after a balanced round. ``on_step(name)`` is called
    after each step ("local sort", "splitters", "bucket bounds",
    "exchange", "merge") once its work is queued, so a caller that
    synchronises in it times the steps."""
    n_dev = mesh_size(mesh)
    n_samples = min(n_samples, rows)
    step = on_step if on_step is not None else (lambda name: None)

    # 1. local sort; ``lanes`` is emptied as it goes, so that each shard's
    # unsorted lanes are freed once sorted
    with mesh_span("gk:mesh.local_sort", [shard[0] for shard in lanes], kernel=sort_lanes_cuda):
        sorted_lanes = []
        while lanes:
            sorted_lanes.append(sort_lanes_cuda(lanes.pop(0)))
        lanes = sorted_lanes
    step("local sort")

    # 2. samples -> all shards -> sorted -> splitters; a sample past a
    # shard's built rows is a pad row
    with mesh_span("gk:mesh.splitters", [shard[0] for shard in lanes]):
        local, split_idx = _samples(lanes, rows, n_samples, mesh, balanced)
        gathered = [all_gather([s[li] for s in local], mesh) for li in range(len(local[0]))]
        del local
        splitters = []
        for i in range(len(lanes)):
            ranked = _sort_samples(tuple(g[i].reshape(-1) for g in gathered))
            splitters.append(tuple(lane[split_idx.to(lane.device)] for lane in ranked))
    step("splitters")

    # 3. bucket bounds: rows below each splitter, clamped to the real rows;
    # every shard's bucket sizes on every rank
    with mesh_span("gk:mesh.bounds", [shard[0] for shard in lanes]):
        bounds = []
        for i, shard in enumerate(lanes):
            n_real = shard[0].shape[0] - (0 if padm is None else int(padm[i].sum()))
            split_host = np.stack([lane.cpu().numpy() for lane in splitters[i]])  # (lanes, P - 1)
            below = [min(b, n_real) for b in _searchsorted_rows(shard, split_host)]
            bounds.append([0] + below + [n_real])
        bounds = np.asarray(bounds, dtype=np.int64)  # (local shards, P + 1)
        counts = gather_host(list(np.diff(bounds, axis=1)), mesh)  # (P, P)
        capacity, factor, retries = _capacity(rows, n_dev, int(counts.max()), capacity_factor)
    step("bucket bounds")

    # 4. exchange: bucket b of shard p -> shard b (its real rows only)
    with mesh_span("gk:mesh.exchange", [shard[0] for shard in lanes]):
        recv = [
            all_to_all(
                [[shard[li][int(bounds[i][b]) : int(bounds[i][b + 1])] for b in range(n_dev)]
                 for i, shard in enumerate(lanes)],
                mesh,
            )
            for li in range(len(lanes[0]))
        ]
        del lanes
    step("exchange")

    # 5. merge: sort the received real rows; each shard's received blocks
    # are freed once joined
    with mesh_span("gk:mesh.merge", [b for blocks in recv[0] for b in blocks],
                   kernel=sort_lanes_cuda):
        merged = []
        for i in range(len(recv[0])):
            joined = tuple(torch.cat(recv[li][i]) for li in range(len(recv)))
            for lane in recv:
                lane[i] = None
            merged.append(sort_lanes_cuda(joined))
            del joined
    step("merge")
    info = {"capacity_factor": factor, "capacity": capacity, "retries": retries,
            "rows": [int(c) for c in counts.sum(axis=0)], "shard_rows": capacity * n_dev}
    return merged, info


def _pad_tail(lane: torch.Tensor, rows: int, fill) -> torch.Tensor:
    return torch.cat([lane, lane.new_full((rows - lane.shape[0],), fill)])


def _padded(merged: list, rows: int, keys=None):
    """The JAX layout of per-shard real rows (``_exchange_merge``'s lanes):
    (positions, is_pad, key lanes) per shard, ``rows`` rows each, int64
    positions (pads all-ones: 0xFFFFFFFF, or -1 from a strided sort's two
    lanes), bool pad flags and int32 key lanes (pads all-ones). ``keys``
    (default flat) says how many lanes the position takes."""
    n_pos = 1 if keys is None else keys.n_pos
    out_pos, out_pad, out_lanes = [], [], []
    with mesh_span("gk:mesh.layout", [shard[0] for shard in merged]):
        for shard in merged:
            n_b = shard[0].shape[0]
            padded = [_pad_tail(w, rows, _ONES) for w in shard]
            out_pos.append(_lanes_position(padded, n_pos))
            out_pad.append(torch.arange(rows, device=shard[0].device) >= n_b)
            out_lanes.append(tuple(padded[:-n_pos]))
    return out_pos, out_pad, out_lanes


def _lanes_position(lanes, n_pos: int) -> torch.Tensor:
    """The int64 position of a row's last ``n_pos`` lanes."""
    return widen_u32(lanes[-1]) if n_pos == 1 else fuse64(lanes[-2], lanes[-1])


class _FlatKeys:
    """Rows keyed on a per-position pack (``ops/keys.py``): the 2-bit pack
    (16 bases a word) or the 4-bit one (8), positions below 2^32 in one
    int32 lane, refinement windows of 32 bases. Each local shard ``i``
    reads its replicated copy of the pack and segment tables."""

    n_pos = 1
    pad = _PAD_U32  # a pad row's position and run id

    def __init__(self, genome, seg_starts, seg_ends, two_bit: bool, mesh):
        self.genome = replicate(genome, mesh)
        self.ss, self.se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
        self.two_bit = two_bit
        self.per_word = 16 if two_bit else 8
        self.window = WINDOW_BASES

    def caps(self, i: int, pos, max_cap):
        """min(valid_len, max_cap) of local shard i's positions (None: no bound)."""
        return cap_lengths(compute_valid_len(pos, self.ss[i], self.se[i]), max_cap)

    def words(self, i: int, pos, cap, n_words: int, offset=0) -> tuple:
        return _words_for(self.genome[i], pos, cap, n_words, self.two_bit, offset)

    def pos_lanes(self, pos) -> tuple:
        return (u32_bits_as_int32(pos),)


class _StridedKeys(_FlatKeys):
    """Rows keyed on a strided pack (``ops/large.py``), the index of
    ``LargeKmers``: int64 positions of any size in two int32 lanes (hi,
    lo), valid lengths saturated at ``NO_CAP`` as the JAX package's uint32
    caps are, and refinement windows of 64 bases on 2-bit keys and 32 on
    4-bit keys."""

    n_pos = 2
    pad = -1  # all-ones, the JAX package's (hi, lo) pad pair

    def __init__(self, genome, seg_starts, seg_ends, two_bit: bool, mesh):
        super().__init__(genome, seg_starts, seg_ends, two_bit, mesh)
        self.window = 64 if two_bit else 32

    def caps(self, i: int, pos, max_cap):
        cap = NO_CAP if max_cap is None else min(int(max_cap), NO_CAP)
        return torch.clamp_max(compute_valid_len64(pos, self.ss[i], self.se[i]), cap)

    def words(self, i: int, pos, cap, n_words: int, offset=0) -> tuple:
        build = build_key2_words_strided if self.two_bit else build_key_words_strided
        return build(self.genome[i], pos, cap, n_words, offset)

    def pos_lanes(self, pos) -> tuple:
        return split64(pos)


def _shard_slices(positions: torch.Tensor, mesh):
    """(rows, slices): the index cut into equal shards of ``rows`` rows
    (the JAX layout pads it to a multiple of the shard count), each local
    shard's real positions on its device (every rank holds the whole
    index)."""
    n = positions.shape[0]
    m = _cdiv(max(n, 1), mesh_size(mesh))
    return m, [to_device(positions[min(p * m, n) : min((p + 1) * m, n)], dev)
               for p, dev in zip(mesh.shard_ids, mesh.devices)]


def _flat_keys(packed, packed2, seg_starts, seg_ends, mesh) -> _FlatKeys:
    two_bit = packed2 is not None
    return _FlatKeys(packed2 if two_bit else packed, seg_starts, seg_ends, two_bit, mesh)


def _gather_sort(keys, positions, max_kmer_len, mesh, n_samples, capacity_factor,
                 uniform_cap, on_step, canonical_k=None):
    """The gather sample sort at a bounded length: (per-shard sorted real
    rows, every lane, and ``_exchange_merge``'s info). Lanes: the key words
    (canonical ones, of the rows with ``canonical_k`` bases or more, where
    it is given), the cap unless ``uniform_cap``, the position."""
    n_words = _cdiv(max_kmer_len, keys.per_word)
    m, pos_s = _shard_slices(positions, mesh)
    lanes = []
    with mesh_span("gk:mesh.keys", pos_s):
        for i, pos in enumerate(pos_s):
            cap = keys.caps(i, pos, max_kmer_len)
            if canonical_k is not None:
                # a truncated k-mer has no canonical form: it is a pad
                full = cap >= canonical_k
                pos, cap = pos[full], cap[full]
            words = keys.words(i, pos, cap, n_words)
            if canonical_k is not None:
                words = _canonical(words, canonical_k, keys.two_bit)
            caps = () if uniform_cap else (cap.to(torch.int32),)
            lanes.append(words + caps + keys.pos_lanes(pos))
        del pos_s
    return _exchange_merge(lanes, None, m, mesh, capacity_factor, n_samples, on_step)


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
    merged, got = _gather_sort(
        _flat_keys(packed, packed2, seg_starts, seg_ends, mesh), positions, max_kmer_len,
        mesh, n_samples, capacity_factor, uniform_cap, on_step,
    )
    out_pos, out_pad, out_lanes = _padded(merged, got["shard_rows"])
    if info is not None:
        info.update(got)
    if return_lanes:
        n_words = _cdiv(max_kmer_len, 16 if packed2 is not None else 8)
        return out_pos, out_pad, [w[:n_words] for w in out_lanes]
    return out_pos, out_pad


def sample_sort_positions(
    packed,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    max_kmer_len,
    mesh,
    packed2=None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
) -> torch.Tensor:
    """The globally sorted positions, compacted on the host and returned on
    the input's device; see ``sample_sort_positions_ragged``. A
    ``max_kmer_len`` of None or beyond one compare window takes the
    refinement rounds (``sample_sort_positions_unbounded``)."""
    limit = 64 if packed2 is not None else 32
    if max_kmer_len is None or max_kmer_len > limit:
        return sample_sort_positions_unbounded(
            packed, positions, seg_starts, seg_ends, mesh, packed2=packed2,
            n_samples=n_samples, capacity_factor=capacity_factor, max_kmer_len=max_kmer_len,
        )
    out_pos, out_pad = sample_sort_positions_ragged(
        packed, positions, seg_starts, seg_ends, max_kmer_len, mesh, packed2=packed2,
        n_samples=n_samples, capacity_factor=capacity_factor, uniform_cap=uniform_cap,
    )
    return torch.from_numpy(np.concatenate(_real_rows(out_pos, out_pad, mesh))).to(positions.device)


# --------------------------------------------------------------------------- #
# refinement rounds: compare lengths beyond one window
# --------------------------------------------------------------------------- #


def _run_structure(keys, positions, valid, gid, offset: int, max_cap, mesh):
    """The global run structure of a sorted layout after the window of
    ``keys.window`` bases at ``offset``: (run ids, unresolved). Rows are
    equal when their previous run ids (``gid``; None on the first window)
    and the window's key words agree and, on 2-bit keys, their caps clamped
    to the window end (rows that both extend past it stay in one run); row
    0 of a shard compares with the last valid row of the nearest earlier
    shard that has one. Run ids (int64) count the runs of all shards before
    a row, from 0; pads get ``keys.pad``. ``unresolved`` (a 0-dim tensor)
    counts the valid rows equal to their predecessor where either extends
    past the window. ``max_cap`` None compares to the end of the record."""
    n_words = keys.window // keys.per_word
    end = offset + keys.window
    lanes, beyond = [], []
    for i, pos in enumerate(positions):
        cap = torch.where(valid[i], keys.caps(i, pos, max_cap), 0)
        shard = keys.words(i, pos, cap, n_words, offset)
        if keys.two_bit:
            shard += (torch.clamp_max(cap, end),)
        if gid is not None:
            shard = (gid[i],) + shard
        lanes.append(shard)
        beyond.append(cap > end)
    eqs = _halo_adjacent_eq(lanes, valid, mesh)
    del lanes
    prev_beyond = _halo_prev_flag(beyond, valid, mesh)
    boundary = [~eq & v for eq, v in zip(eqs, valid)]
    unresolved = psum(
        [(eq & v & (b | pb)).sum() for eq, v, b, pb in zip(eqs, valid, beyond, prev_beyond)], mesh
    )[0]
    counts = all_gather([b.sum() for b in boundary], mesh)
    new_gid = [
        torch.where(valid[i], counts[i][:p].sum() + torch.cumsum(b, dim=0) - 1, keys.pad)
        for (i, b), p in zip(enumerate(boundary), mesh.shard_ids)
    ]
    return new_gid, unresolved


def _refine_lanes(keys, i: int, pos, gid, offset: int, max_cap, gid_lanes: int):
    """Local shard i's lanes of a refinement round: (run id, the window at
    ``offset``, cap, position), the JAX package's ``gid=`` lane layout. The
    run id takes one int32 lane while every id is below 2^32 (its high
    lane, zero on every row, orders nothing), else two."""
    n_words = keys.window // keys.per_word
    cap = keys.caps(i, pos, max_cap)
    words = keys.words(i, pos, cap, n_words, offset)
    gid_l = (u32_bits_as_int32(gid),) if gid_lanes == 1 else split64(gid)
    return gid_l + words + (u32_bits_as_int32(cap),) + keys.pos_lanes(pos)


def _refinement_rounds(keys, merged, got, mesh, max_kmer_len, n_samples, capacity_factor,
                       first_name, on_round, on_step):
    """The rounds after round 0 (``merged``, ``got``: its sorted real rows
    and info): run structure, then while rows are unresolved one balanced
    sample sort keyed by (run id, next window, cap, position), sized from
    the largest shard's real rows, and the run structure of the new
    layout. Returns (positions, run ids, the info of every round), each
    shard's real rows in global order."""
    step = on_step if on_step is not None else (lambda name: None)
    rounds = [got]
    pos = [_lanes_position(shard, keys.n_pos) for shard in merged]
    del merged
    valid = [torch.ones(x.shape[0], dtype=torch.bool, device=x.device) for x in pos]
    gid, unresolved = _run_structure(keys, pos, valid, None, 0, max_kmer_len, mesh)
    step("run structure")
    offset, name = 0, first_name
    while _round_done(unresolved, name, on_round):
        offset += keys.window
        name = "_refine_round"
        gid_lanes = 1
        if keys.n_pos == 2:  # a flat index has fewer than 2^32 rows
            # ids rise in shard order: the runs are the largest id + 1
            n_runs = int(gather_host([int(g[-1]) + 1 if g.shape[0] else 0 for g in gid], mesh).max())
            gid_lanes = 1 if n_runs <= 1 << 32 else 2
        n_lanes = gid_lanes + keys.window // keys.per_word + 1 + keys.n_pos
        if n_lanes > MAX_LANES:
            raise NotImplementedError(
                f"a refinement round of {n_runs} runs needs {n_lanes} sort lanes; "
                f"the lane sort takes at most {MAX_LANES}"
            )
        lanes = [
            _refine_lanes(keys, i, pos[i], gid[i], offset, max_kmer_len, gid_lanes)
            for i in range(len(pos))
        ]
        del pos, gid
        step("round lanes")
        merged, got = _exchange_merge(
            lanes, None, max(rounds[-1]["rows"]), mesh, capacity_factor, n_samples, on_step,
            balanced=True,
        )
        rounds.append(got)
        pos = [_lanes_position(shard, keys.n_pos) for shard in merged]
        old_gid = [
            widen_u32(shard[0]) if gid_lanes == 1 else fuse64(shard[0], shard[1])
            for shard in merged
        ]
        del merged
        valid = [torch.ones(x.shape[0], dtype=torch.bool, device=x.device) for x in pos]
        gid, unresolved = _run_structure(keys, pos, valid, old_gid, offset, max_kmer_len, mesh)
        del old_gid
        step("run structure")
    return pos, gid, rounds


def _compact_layout(pos: list, gid: list, pad_value):
    """Each shard's real rows and one pad row: (positions, is_pad, run ids)."""
    pads = [torch.arange(x.shape[0] + 1, device=x.device) == x.shape[0] for x in pos]
    return ([_pad_tail(x, x.shape[0] + 1, pad_value) for x in pos], pads,
            [_pad_tail(g, g.shape[0] + 1, pad_value) for g in gid])


def _rounds_info(info, rounds) -> None:
    """``info`` of a refinement sort: "rounds", "retries",
    "capacity_factors" and "round_rows" (the real rows of every shard after
    each round), "rows" and "shard_rows" of the last layout."""
    if info is not None:
        info.update(
            rounds=len(rounds), retries=sum(r["retries"] for r in rounds),
            capacity_factors=[r["capacity_factor"] for r in rounds],
            round_rows=[r["rows"] for r in rounds],
            rows=rounds[-1]["rows"], shard_rows=rounds[-1]["shard_rows"],
        )


def sample_sort_positions_unbounded(
    packed,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    mesh,
    packed2=None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    max_kmer_len: int | None = None,
    return_ragged: bool = False,
    on_round=None,
    on_step=None,
    info: dict | None = None,
):
    """Sort k-mer start positions over the mesh by refinement rounds: the
    mesh counterpart of the single-device refinement (ops/sort.py), for
    ``max_kmer_len`` None (suffix mode: compare to each record's end) and
    any bounded length beyond one compare window. Returns the sorted
    positions (int64, on the input's device), or with ``return_ragged``
    the layout ``(positions, is_pad, run ids)`` per shard: each shard's
    real rows and one pad row, int64 positions and run ids (pads
    0xFFFFFFFF), bool pad flags. Rows share a run id iff their k-mers are
    equal under the sort's full comparison: the group identity of the
    statistics at ``kmer_len = max_kmer_len``.

    Round 0's layout is the JAX package's; the refinement rounds balance
    the rows over the shards (the module doc), so after them the global
    order and the run ids are the JAX package's and each shard holds about
    ``1 / P`` of the rows. ``on_round(name)`` is called once a round's
    unresolved count has been read (round 0:
    "sample_sort_positions_ragged", then "_refine_round"); ``on_step`` see
    ``_exchange_merge``, and also hears "round lanes" (a round's key lanes
    built) and "run structure"; ``info`` see ``_rounds_info``."""
    keys = _flat_keys(packed, packed2, seg_starts, seg_ends, mesh)
    # round 0: the sample sort capped at the first window
    merged, got = _gather_sort(
        keys, positions, keys.window, mesh, n_samples, capacity_factor, False, on_step
    )
    pos, gid, rounds = _refinement_rounds(
        keys, merged, got, mesh, max_kmer_len, n_samples, capacity_factor,
        "sample_sort_positions_ragged", on_round, on_step,
    )
    _rounds_info(info, rounds)
    if return_ragged:
        return _compact_layout(pos, gid, keys.pad)
    return torch.from_numpy(np.concatenate(_real_rows(pos, None, mesh))).to(positions.device)


def _adjacent_gids(keys, rag_pos: list, rag_pad: list, kmer_len, mesh) -> list:
    """The run structure window by window over a sorted layout, no
    re-sort, until no tied pair can extend: the run ids."""
    valid = [~pad for pad in rag_pad]
    gid, unresolved = _run_structure(keys, rag_pos, valid, None, 0, kmer_len, mesh)
    offset = 0
    while bool(unresolved):
        offset += keys.window
        gid, unresolved = _run_structure(keys, rag_pos, valid, gid, offset, kmer_len, mesh)
    return gid


def distributed_adjacent_gids(
    packed,
    rag_pos: list,
    rag_pad: list,
    seg_starts,
    seg_ends,
    kmer_len: int | None,
    mesh,
    packed2=None,
) -> list:
    """Run ids at ``kmer_len``-base identity (None: to each record's end)
    over a layout that is already globally sorted (ragged, valid rows a
    prefix of each shard): the run structure window by window, no re-sort,
    until no tied pair can extend. Rows share an id iff their k-mers are
    equal at ``kmer_len`` (int64 per shard, pads 0xFFFFFFFF)."""
    keys = _flat_keys(packed, packed2, seg_starts, seg_ends, mesh)
    return _adjacent_gids(keys, rag_pos, rag_pad, kmer_len, mesh)


# --------------------------------------------------------------------------- #
# dense fresh path: the key lanes of every SBA position, built shard by
# shard from the shard's own slice of the pack and its halo, sent to each
# card alone (``_dense_shards``; no per-row gather, no card holds the whole
# pack but the one it lives on). Valid only while the index is the
# canonical dense start set (a fresh Kmers sort).
# --------------------------------------------------------------------------- #


def _dense_words(packed, lo: int, hi: int, cap: torch.Tensor, n_words: int, per_word: int,
                 base: int):
    """Key words (int32 bit patterns) of positions ``lo..hi-1``: word w of
    position p is the pack at ``p + per_word * w`` (zero past its end),
    masked to the cap. ``packed`` holds the pack from position ``base`` on
    (a shard's slice, ``_dense_shards``)."""
    masks = _mask_table(per_word, packed.device)
    length = packed.shape[0]
    words = []
    for w in range(n_words):
        off = per_word * w - base
        word = torch.zeros(hi - lo, dtype=torch.int32, device=packed.device)
        a, b = min(lo + off, length), min(hi + off, length)
        word[: b - a] = packed[a:b]
        word &= masks[torch.clamp(cap - per_word * w, 0, per_word)]
        words.append(word)
    return tuple(words)


def _dense_key_lanes(packed, seg_starts, seg_ends, lo: int, hi: int, min_len: int,
                     n_words: int, k: int, two_bit: bool, uniform_cap: bool, base: int):
    """(key lanes, positions, invalid) of positions ``lo..hi-1``, int32 bit
    patterns, from the pack held from position ``base`` on. Rows that are
    not k-mer starts (separators, tails shorter than ``min_len``, positions
    past the SBA) are invalid and fold as the JAX package folds them:
    all-ones words (and cap, when the cap lane is kept) on 2-bit keys, a
    leading invalid lane on 4-bit keys, where a real word can be all-ones."""
    iota = torch.arange(lo, hi, dtype=torch.int64, device=packed.device)
    cap = torch.clamp_max(compute_valid_len(iota, seg_starts, seg_ends), k)
    invalid = cap < min_len
    words = _dense_words(packed, lo, hi, cap, n_words, 16 if two_bit else 8, base)
    if two_bit:
        key = tuple(torch.where(invalid, _ONES, w) for w in words)
        if not (uniform_cap and k % 16 != 0):
            # a real last word keeps < 16 bases when k % 16 != 0, so its low
            # bits are zero and it never equals all-ones: then no cap lane
            key += (torch.where(invalid, _ONES, cap.to(torch.int32)),)
    else:
        key = (invalid.to(torch.int32),) + tuple(words)
    return key, u32_bits_as_int32(iota), invalid


def _dense_shards(packed, mesh):
    """(rows a shard, each local shard's slice of the pack, the position
    each slice starts at): the SBA padded to a multiple of the shard count,
    shard p holding positions ``p * rows ..``, so its key words read the
    pack from ``p * rows`` to ``DENSE_HALO`` positions past its last row.
    A shard on the pack's card reads it in place; any other receives its
    slice alone, never the whole pack."""
    n = packed.shape[0]
    m = _cdiv(max(n, 1), mesh_size(mesh))
    bases = [min(p * m, n) for p in mesh.shard_ids]
    with mesh_span("gk:mesh.pack", [packed[b : min(b + m, n)] for b in bases],
                   devices=mesh.devices):
        slices = [to_device(packed[b : min(b + m + DENSE_HALO, n)], dev)
                  for b, dev in zip(bases, mesh.devices)]
    return m, slices, bases


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
    n_words = _cdiv(max_kmer_len, 16 if two_bit else 8)
    m, genome, bases = _dense_shards(packed, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    lanes, padm = [], []
    with mesh_span("gk:mesh.keys", genome):
        for i, p in enumerate(mesh.shard_ids):
            key, iota, invalid = _dense_key_lanes(
                genome[i], ss[i], se[i], p * m, (p + 1) * m, min_kmer_len, n_words,
                max_kmer_len, two_bit, uniform_cap, bases[i],
            )
            lanes.append(key + (iota,))
            padm.append(invalid)
        del genome, key, iota, invalid
    merged, got = _exchange_merge(lanes, padm, m, mesh, capacity_factor, n_samples, on_step)
    if sum(got["rows"]) != n:
        raise AssertionError(f"dense sample sort kept {sum(got['rows'])} rows, expected {n}")
    if info is not None:
        info.update(got)
    out_pos, out_pad, out_lanes = _padded(merged, got["shard_rows"])
    if return_lanes:
        words = out_lanes if two_bit else [w[1:] for w in out_lanes]
        return out_pos, out_pad, [w[:n_words] for w in words]
    return out_pos, out_pad


# --------------------------------------------------------------------------- #
# canonical (strand-collapsed) sorts: rows ordered by min(key, revcomp(key)),
# full-length k-mers only
# --------------------------------------------------------------------------- #


def _canonical(words: tuple, k: int, two_bit: bool) -> tuple:
    """Canonical words of full-length rows, int32 bit patterns in and out."""
    fwd = tuple(widen_u32(w) for w in words)
    return tuple(u32_bits_as_int32(w) for w in canonical_words(fwd, k, two_bit))


def sample_sort_canonical_dense_ragged(
    packed_e,
    seg_starts,
    seg_ends,
    min_kmer_len: int,
    k: int,
    mesh,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    two_bit: bool = True,
    on_step=None,
):
    """Sample sort of the fresh index's full-length k-mer starts by
    canonical key over the mesh, gather-free as the dense sort: the forward
    words of SBA positions ``p*m ..`` are slices of the pack (``packed_e``:
    2-bit when ``two_bit``, else 4-bit), the reverse complement is bit
    arithmetic on them (ops/canonical.py). Rows that are not full-length
    starts of the index (valid_len < max(k, min_kmer_len)) carry a leading
    invalid lane and are not exchanged. Returns (positions, is_pad,
    canonical word lanes) per shard, the lanes the group identity of
    ``distributed_group_size_histogram_ragged(sorted_words=...)``."""
    limit = 64 if two_bit else 32
    if k > limit:
        raise NotImplementedError(f"canonical keys require k <= {limit}")
    n_words = _cdiv(k, 16 if two_bit else 8)
    m, genome, bases = _dense_shards(packed_e, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    lanes, padm = [], []
    with mesh_span("gk:mesh.keys", genome):
        for i, p in enumerate(mesh.shard_ids):
            iota = torch.arange(p * m, (p + 1) * m, dtype=torch.int64, device=genome[i].device)
            valid = compute_valid_len(iota, ss[i], se[i]) >= max(k, min_kmer_len)
            cap = torch.where(valid, k, 0)
            words = _canonical(_dense_words(genome[i], p * m, (p + 1) * m, cap, n_words,
                                            16 if two_bit else 8, bases[i]), k, two_bit)
            lanes.append(((~valid).to(torch.int32),) + words + (u32_bits_as_int32(iota),))
            padm.append(~valid)
        del genome, iota, valid, cap, words
    merged, got = _exchange_merge(lanes, padm, m, mesh, capacity_factor, n_samples, on_step)
    out_pos, out_pad, out_lanes = _padded(merged, got["shard_rows"])
    return out_pos, out_pad, [w[1 : 1 + n_words] for w in out_lanes]


def sample_sort_canonical_ragged(
    packed_e,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    kmer_len: int,
    mesh,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    two_bit: bool = True,
    on_step=None,
):
    """Canonical sample sort of any position set (int64, any order): rows
    ordered by min(key, revcomp(key)), the position the tie-break; rows
    with fewer than ``kmer_len`` bases left have no canonical form and are
    pads. Returns ``(positions, is_pad, canonical word lanes)`` per shard,
    as ``sample_sort_canonical_dense_ragged``."""
    limit = 64 if two_bit else 32
    if kmer_len is None or kmer_len < 1 or kmer_len > limit:
        raise ValueError(f"kmer_len ({kmer_len}) must be in [1, {limit}]")
    n_words = _cdiv(kmer_len, 16 if two_bit else 8)
    m, pos_s = _shard_slices(positions, mesh)
    genome = replicate(packed_e, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    lanes = []
    for i, pos in enumerate(pos_s):
        pos = pos[compute_valid_len(pos, ss[i], se[i]) >= kmer_len]
        cap = torch.full_like(pos, kmer_len)
        words = _canonical(_words_for(genome[i], pos, cap, n_words, two_bit), kmer_len, two_bit)
        lanes.append(words + (u32_bits_as_int32(pos),))
    del pos_s
    merged, got = _exchange_merge(lanes, None, m, mesh, capacity_factor, n_samples, on_step)
    out_pos, out_pad, out_lanes = _padded(merged, got["shard_rows"])
    return out_pos, out_pad, out_lanes


# --------------------------------------------------------------------------- #
# the large regime: a strided pack and int64 positions (LargeKmers)
# --------------------------------------------------------------------------- #


def words_tensor(packed_words) -> torch.Tensor:
    """A strided pack as an int32 tensor of uint32 bit patterns (a NumPy
    uint32 array is viewed, not copied)."""
    if isinstance(packed_words, torch.Tensor):
        return packed_words
    return torch.from_numpy(np.ascontiguousarray(packed_words, dtype=np.uint32).view(np.int32))


def int64_tensor(values) -> torch.Tensor:
    """Positions or segment bounds (uint64 values below 2^63) as an int64
    tensor (a NumPy array is viewed, not copied)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values, dtype=np.uint64).view(np.int64))


def strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit: bool, mesh) -> _StridedKeys:
    """The key source of a strided pack, replicated over the mesh."""
    return _StridedKeys(words_tensor(packed_strided), int64_tensor(seg_starts_u64),
                        int64_tensor(seg_ends_u64), two_bit, mesh)


def sample_sort_positions_large_ragged(
    packed_strided,
    positions_u64,
    seg_starts_u64,
    seg_ends_u64,
    max_kmer_len: int,
    mesh,
    two_bit: bool = True,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
    return_lanes: bool = False,
    canonical_k: int | None = None,
    on_step=None,
    info: dict | None = None,
):
    """Sample sort of k-mer start positions over a strided pack (16 bases a
    word when ``two_bit``, else 8), for genomes past the uint32 ceiling:
    the pipeline of ``sample_sort_positions_ragged`` with each position in
    two int32 sort lanes (hi, lo), so every comparison (local sort,
    splitters, bucket bounds, merge) is the exact 64-bit one. Positions
    (uint64 array or int64 tensor, any order) may lie past 2^32.

    Returns ``(positions, is_pad)`` per shard, ``P * C`` rows each, int64
    positions (pads -1, the JAX all-ones pair) and bool pad flags; with
    ``return_lanes`` also the sorted key lanes (words, and the cap lane
    unless ``uniform_cap``; pads all-ones). ``canonical_k`` sorts by
    min(key, reverse complement); rows with fewer bases have no canonical
    form and are pads. ``on_step`` and ``info`` as
    ``sample_sort_positions_ragged``."""
    limit = 64 if two_bit else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(f"large sample sort requires max_kmer_len <= {limit} bases")
    if canonical_k is not None and not uniform_cap:
        raise ValueError("canonical_k requires uniform_cap=True")
    keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
    merged, got = _gather_sort(
        keys, int64_tensor(positions_u64), max_kmer_len, mesh, n_samples, capacity_factor,
        uniform_cap, on_step, canonical_k,
    )
    if info is not None:
        info.update(got)
    out_pos, out_pad, out_lanes = _padded(merged, got["shard_rows"], keys)
    if return_lanes:
        return out_pos, out_pad, out_lanes
    return out_pos, out_pad


def sample_sort_positions_large(
    packed_strided,
    positions_u64,
    seg_starts_u64,
    seg_ends_u64,
    max_kmer_len: int,
    mesh,
    two_bit: bool = True,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
) -> np.ndarray:
    """The globally sorted positions of
    ``sample_sort_positions_large_ragged`` as a host uint64 array."""
    out_pos, out_pad = sample_sort_positions_large_ragged(
        packed_strided, positions_u64, seg_starts_u64, seg_ends_u64, max_kmer_len, mesh,
        two_bit=two_bit, n_samples=n_samples, capacity_factor=capacity_factor,
        uniform_cap=uniform_cap,
    )
    return large_rows(out_pos, out_pad)


def sample_sort_positions_large_unbounded(
    packed_strided,
    positions_u64,
    seg_starts_u64,
    seg_ends_u64,
    mesh,
    two_bit: bool = True,
    max_kmer_len: int | None = None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    on_round=None,
    on_step=None,
    info: dict | None = None,
):
    """Refinement sort over a strided pack with int64 positions: suffix
    mode (``max_kmer_len`` None) or any bound beyond one window (64 bases
    on 2-bit keys, 32 on 4-bit keys). Round 0 is the large sample sort
    capped at the first window; then the rounds of
    ``sample_sort_positions_unbounded`` with windows of 4 words, int64 run
    ids (one sort lane below 2^32 runs, else two) and the position in two
    lanes.

    Returns ``(positions, is_pad, run ids)`` per shard: each shard's real
    rows (round 0's the JAX package's; the refinement rounds balance them
    over the shards) and one pad row, int64 positions and run ids (pads
    -1), bool pad flags. Rows share a run id iff their k-mers are
    equal under the sort's full comparison. ``on_round`` (round 0 is named
    "sample_sort_positions_large_ragged"), ``on_step`` and ``info`` as
    ``sample_sort_positions_unbounded``."""
    keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
    merged, got = _gather_sort(
        keys, int64_tensor(positions_u64), keys.window, mesh, n_samples, capacity_factor,
        False, on_step,
    )
    pos, gid, rounds = _refinement_rounds(
        keys, merged, got, mesh, max_kmer_len, n_samples, capacity_factor,
        "sample_sort_positions_large_ragged", on_round, on_step,
    )
    _rounds_info(info, rounds)
    return _compact_layout(pos, gid, keys.pad)


def distributed_adjacent_gids_large(
    packed_strided,
    positions: list,
    is_pad: list,
    seg_starts_u64,
    seg_ends_u64,
    kmer_len: int | None,
    mesh,
    two_bit: bool = True,
) -> list:
    """Run ids at ``kmer_len``-base identity (None: to each segment's end)
    over a sorted large layout, by windows of 64 (2-bit) or 32 (4-bit)
    bases and no re-sort (int64 per shard, pads -1)."""
    keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
    return _adjacent_gids(keys, positions, is_pad, kmer_len, mesh)


def sample_sort_canonical_large_ragged(
    packed_strided,
    positions_u64,
    seg_starts_u64,
    seg_ends_u64,
    kmer_len: int,
    mesh,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    two_bit: bool = True,
    on_step=None,
):
    """Canonical large sample sort: rows ordered by min(key, reverse
    complement), the position the tie-break; truncated rows are pads.
    Returns ``(positions, is_pad, canonical word lanes)`` per shard."""
    limit = 64 if two_bit else 32
    if kmer_len is None or kmer_len < 1 or kmer_len > limit:
        raise ValueError(f"kmer_len ({kmer_len}) must be in [1, {limit}]")
    return sample_sort_positions_large_ragged(
        packed_strided, positions_u64, seg_starts_u64, seg_ends_u64, kmer_len, mesh,
        two_bit=two_bit, n_samples=n_samples, capacity_factor=capacity_factor,
        uniform_cap=True, return_lanes=True, canonical_k=kmer_len, on_step=on_step,
    )


def _real_rows(positions: list, is_pad, mesh) -> list:
    """Each shard's real rows (all of them where ``is_pad`` is None) on the
    host, every rank's shards where ``mesh`` is a process mesh (the JAX
    package's ``process_allgather``)."""
    rows = positions if is_pad is None else [pos[~pad] for pos, pad in zip(positions, is_pad)]
    if mesh is not None:
        rows = all_gather_shards(rows, mesh)
    return [x.cpu().numpy() for x in rows]


def large_rows(positions: list, is_pad: list, mesh=None) -> np.ndarray:
    """The real rows of a large layout in global order, host uint64; pass
    the layout's ``mesh`` where it spans processes."""
    if not positions:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate([x.view(np.uint64) for x in _real_rows(positions, is_pad, mesh)])


def ragged_rows(positions: list, is_pad: list, mesh=None) -> np.ndarray:
    """The real rows of a ragged layout in global order, as a host uint32
    array (the counterpart of the JAX package's ``pos[pad == 0]``); pass
    the layout's ``mesh`` where it spans processes."""
    if not positions:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate([x.astype(np.uint32) for x in _real_rows(positions, is_pad, mesh)])
