"""The mesh, and group statistics over a sharded sorted index.

Counterpart of ``genome_kmers_tpu/parallel/distributed.py``. The JAX package
runs one controller over a ``jax.sharding.Mesh`` of ``shard_map`` bodies,
within one process or over the processes of ``jax.distributed``. The port's
mesh is an ordered list of ``torch.device``s, one a shard (``make_mesh``),
a sharded array is a list of per-shard tensors, and the collectives are
the functions of ``collectives.py``. On the CPU ``make_mesh(8,
devices=["cpu"] * 8)`` stands where the JAX tests put XLA's 8 virtual CPU
devices; on one card ``make_mesh(4, devices=["cuda:0"] * 4)`` runs the
sharded code, exchange included, on that card; on a host with more cards
one shard goes to each.

Where ``torch.distributed`` is initialised, ``make_mesh`` builds a process
mesh: each rank names its own devices (its local shards), the mesh spans
every rank's shards in rank order (the process-major order of the JAX
package's ``jax.devices()``), each rank holds and computes its own shards
only, and the collectives move data between ranks over the process group
(NCCL for card tensors, one rank a card; Gloo through the host).

Group statistics stitch across shard edges as the JAX package does: each
shard compares its first row with the last valid row of the nearest
previous shard that has one (the halo), and counts a group's size in
counted-row coordinates (the rows of all shards before it), so the ragged
layout of the sample sort, with pads at the tail of every shard, needs no
compaction. The next-boundary search that the JAX package does with a
reverse ``cummin`` is the boundary indices (``nonzero``) read in order, as
``ops/groups.group_sizes_at_boundaries`` does.

A mesh may also have two axes, ``("node", "local")`` (``hier.make_mesh2``):
its shards are taken in row-major order, so everything here is the same on
both shapes; only the exchange of the sample sort differs
(``collectives.all_to_all``).

``distributed_sort_positions`` is the JAX package's odd-even merge sort
(1-D meshes only): a local sort of each shard's block, then as many
odd-even phases as shards, each a pairwise exchange of whole blocks and a
lane sort of the 2m rows of a pair. The sample sort (``sample_sort.py``)
is the route of ``Kmers.sort(mesh=...)``; this one is opt-in.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..kernels.lane_sort import sort_lanes_cuda
from ..ops.groups import fold_err_conditions, hist_from_sizes
from ..ops.keys import (
    build_key2_words,
    build_key_words,
    cap_lengths,
    compute_valid_len,
    u32_bits_as_int32,
    widen_u32,
)
from ..ops.sort import _masked
from ..sequence_collection import resolve_device
from .collectives import (  # noqa: F401 - hier_shape: the JAX package's home of it
    all_gather,
    all_gather_shards,
    all_to_all,
    gather_host,
    hier_shape,
    pmax,
    psum,
    put_sharded,
    replicate,
)

AXIS = "kmers"  # mesh axis name: position-sharded data parallelism
_PAD_POS = 0xFFFFFFF0  # padding position of an evenly sharded index (JAX ops/sort._PAD_POS)
_BIG = 1 << 62  # "no boundary here": above every counted-row index
_SPEC_HIST_BINS = 256  # speculative bins of the return_sizes digest (JAX ops/groups)


class Mesh:
    """A mesh of shards: ``devices[i]`` holds this process's local shard
    ``i``, global shard ``first + i`` (several shards may share one
    device). Within one process (``group`` None) every shard is local. With
    ``group``, a ``torch.distributed`` process group whose every rank holds
    as many shards, the mesh spans ``n_ranks * len(devices)`` shards in rank
    order and this rank's are ``shard_ids``. One axis by default;
    ``axis_names`` and ``axis_sizes`` name more, the shards then in
    row-major order over them (``hier.make_mesh2``: ``("node", "local")``).
    Two meshes are equal when they list the same devices in the same order
    over the same axes and group."""

    def __init__(self, devices, axis_names=(AXIS,), axis_sizes=None, group=None):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.n_ranks = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.n_shards = len(self.devices) * self.n_ranks
        self.first = self.rank * len(self.devices)
        self.shard_ids = range(self.first, self.first + len(self.devices))
        # where a collective's tensors travel: the card under NCCL, the
        # host under Gloo
        self.comm_device = None
        if group is not None:
            on_card = dist.get_backend(group) == "nccl"
            self.comm_device = self.devices[0] if on_card else torch.device("cpu")
        self.axis_names = tuple(axis_names)
        sizes = (self.n_shards,) if axis_sizes is None else tuple(int(a) for a in axis_sizes)
        if len(sizes) != len(self.axis_names) or math.prod(sizes) != self.n_shards:
            raise ValueError(
                f"axes {self.axis_names} of sizes {sizes} do not hold {self.n_shards} shards"
            )
        self.shape = dict(zip(self.axis_names, sizes))

    def __eq__(self, other):
        return (
            isinstance(other, Mesh)
            and self.devices == other.devices
            and self.shape == other.shape
            and self.group is other.group
        )

    def __hash__(self):
        return hash((self.devices, self.axis_names))

    def __repr__(self):
        ranks = "" if self.group is None else f", rank {self.rank} of {self.n_ranks}"
        return f"Mesh({[str(d) for d in self.devices]}, {self.shape}{ranks})"


def visible_cards(n: int | None, caller: str) -> list:
    """The first ``n`` visible CUDA cards (all where ``n`` is None); raises
    without CUDA or with fewer cards: the CPU is used only when the caller
    names it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: CUDA is not available; pass devices=['cpu'] * n for a mesh on the CPU"
        )
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is not None:
        if n > len(devices):
            raise ValueError(f"{caller}: {n} devices asked for, {len(devices)} visible")
        devices = devices[:n]
    return devices


def process_group():
    """The default ``torch.distributed`` group where it is initialised (a
    mesh built now spans its processes), else None."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank_card(caller: str) -> list:
    """This rank's card, ``cuda:<local rank>`` (``LOCAL_RANK`` where the
    launcher sets it, else the rank modulo the visible cards); raises
    without CUDA."""
    cards = visible_cards(None, caller)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % len(cards)))
    return [cards[local]]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the position-sharding axis. ``devices`` (any
    ``torch.device`` specs, repeats allowed) are taken as given; without
    them the mesh takes the visible CUDA cards, the first ``n_devices`` of
    them where it is given, and raises without CUDA.

    Where ``torch.distributed`` is initialised the mesh spans its processes:
    ``devices`` are this rank's own (every rank names as many), by default
    its card ``cuda:<local rank>``, and ``n_devices``, where given, must be
    the mesh's shard count over all ranks."""
    group = process_group()
    if group is None:
        if devices is None:
            devices = visible_cards(n_devices, "make_mesh")
        return Mesh(devices)
    mesh = Mesh(rank_card("make_mesh") if devices is None else devices, group=group)
    if n_devices is not None and n_devices != mesh.n_shards:
        raise ValueError(f"make_mesh: {n_devices} shards asked for, the process mesh has "
                         f"{mesh.n_shards} ({mesh.n_ranks} ranks of {len(mesh.devices)})")
    return mesh


def mesh_size(mesh: Mesh) -> int:
    """Number of shards, over all ranks of a process mesh."""
    return mesh.n_shards


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_to_multiple(arr: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    n = arr.shape[0]
    n_pad = _cdiv(max(n, 1), multiple) * multiple
    if n_pad == n:
        return arr
    return torch.cat([arr, arr.new_full((n_pad - n,), fill)])


def shard_evenly(positions: torch.Tensor, mesh: Mesh):
    """(positions, is_pad) of an index cut into equal shards: padded to a
    multiple of the shard count with ``_PAD_POS`` rows flagged as pads."""
    n = positions.shape[0]
    n_dev = mesh_size(mesh)
    pos_p = _pad_to_multiple(positions, n_dev, _PAD_POS)
    pad = torch.arange(pos_p.shape[0], device=positions.device) >= n
    return put_sharded(pos_p, mesh), put_sharded(pad, mesh)


def compact_ragged(positions: list, is_pad: list, mesh: Mesh):
    """Stable per-shard compaction: pad rows move to each shard's tail and
    the valid rows keep their relative order (key order, not position
    order). The statistics assume every shard's valid rows form a prefix,
    which a filter mask applied to a sorted ragged index breaks. A stable
    partition by the pad flag (two ``nonzero``), not a sort."""
    out_pos, out_pad = [], []
    for pos, pad in zip(positions, is_pad):
        order = torch.cat([torch.nonzero(~pad).flatten(), torch.nonzero(pad).flatten()])
        out_pos.append(pos[order])
        out_pad.append(pad[order])
    return out_pos, out_pad


def _words_for(packed, positions, cap_len, n_words, two_bit, offset: int = 0):
    """Key words from ``offset`` bases on (int32 bit patterns): 2-bit (16
    bases a word, the cap an extra identity lane) or 4-bit (8 a word,
    truncation in the words)."""
    if two_bit:
        return build_key2_words(packed, positions, cap_len, n_words, offset)
    return build_key_words(packed, positions, cap_len, n_words, offset)


def _oddeven_phase(ops: list, mesh: Mesh, phase: int) -> list:
    """One phase of the block odd-even transposition. Even phases pair the
    shards (0, 1), (2, 3), ...; odd phases (1, 2), (3, 4), .... Each pair
    exchanges whole blocks (``all_to_all``: the block to the partner, an
    empty block to every other shard), merges the 2m rows with one lane
    sort, and the lower shard of the pair keeps the lower half. Shards left
    unpaired (the ends of the chain) keep their rows. After as many phases
    as shards the blocks are in global order."""
    n_dev = mesh.n_shards
    pairs = []
    for g in mesh.shard_ids:
        if phase % 2 == 0:
            partner, is_low = g ^ 1, g % 2 == 0
        else:
            partner, is_low = (g + 1, True) if g % 2 == 1 else (g - 1, False)
        pairs.append((partner if 0 <= partner < n_dev else None, is_low))
    blocks = []
    for lanes, (partner, _) in zip(ops, pairs):
        empty = lanes[0].new_empty((0, len(lanes)))
        row = [empty] * n_dev
        if partner is not None:
            row[partner] = torch.stack(lanes, dim=1)
        blocks.append(row)
    received = all_to_all(blocks, mesh)
    del blocks
    out = []
    for lanes, (partner, is_low), got in zip(ops, pairs, received):
        if partner is None:
            out.append(lanes)
            continue
        m = lanes[0].shape[0]
        other = got[partner]
        merged = sort_lanes_cuda(tuple(torch.cat([a, other[:, j]]) for j, a in enumerate(lanes)))
        # a copy of the half kept, so that the merge's buffer is freed
        out.append(tuple((x[:m] if is_low else x[m:]).clone() for x in merged))
    return out


def _dist_sort_local(genome, positions, cap_len, is_pad, n_words, two_bit) -> tuple:
    """A shard's local sort. Lanes, all of them keys: (is_pad, words...,
    cap, position). The cap makes a shorter equal prefix smaller on 2-bit
    keys and changes nothing on 4-bit keys (equal words imply equal caps).
    Pad rows hold distinct positions, so every row differs from every
    other, as the lane sort kernel needs."""
    words = _words_for(genome, positions, cap_len, n_words, two_bit)
    return sort_lanes_cuda(
        (is_pad.to(torch.int32),) + words
        + (cap_len.to(torch.int32), u32_bits_as_int32(positions))
    )


def distributed_sort_positions(
    packed,
    positions: torch.Tensor,
    seg_starts,
    seg_ends,
    max_kmer_len: int,
    mesh: Mesh,
    packed2=None,
) -> torch.Tensor:
    """Globally sort k-mer start positions (int64, any order) over the mesh
    by the odd-even merge sort: each shard sorts its block of the evenly
    sharded index, then as many odd-even phases as shards
    (``_oddeven_phase``). The counterpart of the JAX package's
    ``shard_map`` sort, whose pairwise ``ppermute`` is here an
    ``all_to_all`` with one non-empty block a shard, so the same code runs
    within one process and over a ``torch.distributed`` group.

    Caps come from the segment extents. Requires a bounded
    ``max_kmer_len``: <= 32 bases on 4-bit keys (``packed``), <= 64 with
    ``packed2`` (the 2-bit pack of an ACGT genome). A 1-D mesh only. Returns
    the sorted int64 positions, pads removed, compacted on the input's
    device (as ``sample_sort.sample_sort_positions`` gives them)."""
    limit = 64 if packed2 is not None else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(
            f"distributed sort requires max_kmer_len <= {limit} bases"
            " (64 with the 2-bit ACGT fast path)"
        )
    if len(mesh.axis_names) != 1:
        raise NotImplementedError(
            "the odd-even merge sort is 1-D-mesh only (its ppermute ring "
            "has no hierarchical form); use the sample sort for 2-D meshes"
        )
    two_bit = packed2 is not None
    n = positions.shape[0]
    n_dev = mesh_size(mesh)
    n_words = _cdiv(max_kmer_len, 16 if two_bit else 8)
    cap_len = cap_lengths(compute_valid_len(positions, seg_starts, seg_ends), max_kmer_len)
    # pads: flagged, cap 0, and positions that differ from each other
    n_all = _cdiv(max(n, 1), n_dev) * n_dev
    pad_pos = _PAD_POS - torch.arange(n_all - n, dtype=torch.int64, device=positions.device)
    pos_s = put_sharded(torch.cat([positions, pad_pos]), mesh)
    cap_s = put_sharded(_pad_to_multiple(cap_len, n_dev, 0), mesh)
    pad_s = put_sharded(torch.arange(n_all, device=positions.device) >= n, mesh)
    del cap_len
    genome = replicate(packed2 if two_bit else packed, mesh)
    ops = [_dist_sort_local(g, p, c, d, n_words, two_bit)
           for g, p, c, d in zip(genome, pos_s, cap_s, pad_s)]
    del pos_s, cap_s, pad_s
    for phase in range(n_dev):
        ops = _oddeven_phase(ops, mesh, phase)
    # pads sort after every real row, so the real rows in shard order are
    # the sorted positions
    rows = all_gather_shards([widen_u32(lanes[-1])[lanes[0] == 0] for lanes in ops], mesh)
    return torch.cat([r.to(positions.device) for r in rows])


def _last_rows(shard: tuple, n_valid: torch.Tensor) -> torch.Tensor:
    """The shard's last valid row as one int64 value a lane (row 0 where
    it has none; zeros for a shard of no rows)."""
    if shard[0].shape[0] == 0:
        return torch.zeros(len(shard), dtype=torch.int64, device=shard[0].device)
    return torch.stack([lane[torch.clamp_min(n_valid - 1, 0)].to(torch.int64) for lane in shard])


def _halo_preds(valid: list, mesh: Mesh) -> list:
    """For each local shard (global shard p), the nearest q < p whose shard
    has a valid row, as a 0-dim tensor on the shard's device (-1 if
    none)."""
    all_n_valid = all_gather([v.sum() for v in valid], mesh)
    preds = []
    for i, p in enumerate(mesh.shard_ids):
        dev = all_n_valid[i].device
        cand = torch.where(all_n_valid[i][:p] > 0, torch.arange(p, device=dev), -1)
        preds.append(cand.max() if p else torch.tensor(-1, device=dev))
    return preds


def _halo_adjacent_eq(lanes: list, valid: list, mesh: Mesh) -> list:
    """Adjacent equality of sharded rows, stitched across shard edges: row
    i of a shard equals row i - 1 in every lane (valid rows form each
    shard's prefix, so row i - 1 of a valid row is its true predecessor),
    and row 0 compares with the last valid row of the nearest previous
    shard that has one (False where there is none). ``lanes[i]`` is local
    shard i's tuple of lanes, any integer or bool dtypes; a shard may have no
    rows."""
    n_valid = [v.sum() for v in valid]
    all_last = all_gather([_last_rows(shard, nv) for shard, nv in zip(lanes, n_valid)], mesh)
    preds = _halo_preds(valid, mesh)
    out = []
    for i, shard in enumerate(lanes):
        eq = torch.ones(shard[0].shape[0], dtype=torch.bool, device=shard[0].device)
        for lane in shard:
            eq[1:] &= lane[1:] == lane[:-1]
        if eq.shape[0]:
            pred = preds[i]
            first = torch.stack([lane[0].to(torch.int64) for lane in shard])
            eq[:1] = (first == all_last[i][torch.clamp_min(pred, 0)]).all() & (pred >= 0)
        out.append(eq)
    return out


def _halo_prev_flag(flag: list, valid: list, mesh: Mesh) -> list:
    """The previous row's value of a sharded bool flag under the same halo
    stitch: row 0 reads the last valid row of the nearest previous shard
    that has one (False where there is none)."""
    n_valid = [v.sum() for v in valid]
    all_last = all_gather([_last_rows((f,), nv)[0] for f, nv in zip(flag, n_valid)], mesh)
    preds = _halo_preds(valid, mesh)
    out = []
    for i, f in enumerate(flag):
        prev = torch.zeros_like(f)
        prev[1:] = f[:-1]
        if f.shape[0]:
            pred = preds[i]
            prev[:1] = (all_last[i][torch.clamp_min(pred, 0)] != 0) & (pred >= 0)
        out.append(prev)
    return out


def _dist_sizes_digest(words_fn, positions, cap_len, is_pad, min_gs, max_gs, strand_split,
                       sorted_words, mask, ext_gid, n_words, two_bit, keep_bits, mesh):
    """Group sizes over sharded sorted rows: (size, qualifies, total,
    boundary).

    ``size[p][i]`` is, at the first valid row of a group, the number of its
    counted rows (valid rows, or the filter survivors of ``mask``: then the
    group identity stays that of all valid rows, the reference's
    previous-survivor walk), else 0; ``qualifies`` marks sizes in [max(min,
    1), max]; ``total`` sums the qualifying sizes over all shards;
    ``boundary`` marks the first valid row of every group, those with no
    counted row too. Identity lanes: the run ids ``ext_gid`` where given
    (they encode the ends of the k-mers too), else the key words
    (``words_fn(i, positions, caps, n_words)`` of local shard i, or the retained
    ``sorted_words`` masked to ``keep_bits`` bits of the last word) and the
    cap on 2-bit keys.

    Where ``strand_split`` is given (rows at or past it are "-" k-mers) a
    group is (string, strand): its "+" and its "-" counted rows are counted
    apart over the same boundaries and halo arithmetic, so a strand half
    may straddle a shard edge. ``size`` and ``qualifies`` of a shard are
    then its "+" halves followed by its "-" halves (twice its rows, each
    half at its group's first row); empty halves never qualify."""
    valid = [~pad for pad in is_pad]
    counted = valid if mask is None else [m & v for m, v in zip(mask, valid)]
    lanes = []
    for i in range(len(valid)):
        if ext_gid is not None:
            shard = (ext_gid[i],)
        else:
            cap = torch.where(valid[i], cap_len[i], 0)
            if sorted_words is None:
                words = words_fn(i, positions[i], cap, n_words)
            else:
                words = list(sorted_words[i][:n_words])
                if keep_bits < 32:
                    words[-1] = _masked(words[-1], (0xFFFFFFFF << (32 - keep_bits)) & 0xFFFFFFFF)
            shard = tuple(words) + ((cap,) if two_bit else ())
        lanes.append(shard)
    eqs = _halo_adjacent_eq(lanes, valid, mesh)
    del lanes
    boundaries = [~eq & v for eq, v in zip(eqs, valid)]
    if strand_split is None:
        size, qualifies, totals = _counted_sizes(boundaries, counted, positions, min_gs, max_gs,
                                                 mesh)
    else:
        is_rc = [pos >= strand_split for pos in positions]
        halves = [
            _counted_sizes(boundaries, [c & (r == rc) for c, r in zip(counted, is_rc)],
                           positions, min_gs, max_gs, mesh)
            for rc in (False, True)
        ]
        size = [torch.cat(pair) for pair in zip(halves[0][0], halves[1][0])]
        qualifies = [torch.cat(pair) for pair in zip(halves[0][1], halves[1][1])]
        totals = [a + b for a, b in zip(halves[0][2], halves[1][2])]
    return size, qualifies, int(psum(totals, mesh)[0]), boundaries


def _counted_sizes(boundaries, counted, positions, min_gs, max_gs, mesh):
    """(size, qualifies, per-shard totals) of ``_dist_sizes_digest`` for
    one set of counted rows: a group's size is its counted rows, read in
    counted-row coordinates (the rows of all shards before it), so a group
    may straddle shard edges."""
    n_dev = mesh_size(mesh)
    all_counted = all_gather([c.sum() for c in counted], mesh)
    starts, vbs, firsts = [], [], []
    for i, p in enumerate(mesh.shard_ids):
        c = counted[i].to(torch.int64)
        offset = all_counted[i][:p].sum()
        vidx = offset + torch.cumsum(c, dim=0) - c  # counted rows before each row, all shards
        b_idx = torch.nonzero(boundaries[i]).flatten()
        vb = vidx[b_idx]
        starts.append(b_idx)
        vbs.append(vb)
        firsts.append(torch.cat([vb, vb.new_full((1,), _BIG)])[0])
    all_firsts = all_gather(firsts, mesh)
    sizes, qualifies, totals = [], [], []
    for i, p in enumerate(mesh.shard_ids):
        dev = positions[i].device
        total_counted = all_counted[i].sum()
        # first boundary of a later shard, or none (the end of the index)
        after = all_firsts[i][p + 1 :].min() if p + 1 < n_dev else torch.tensor(_BIG, device=dev)
        next_v = torch.cat([vbs[i][1:], after.view(1)])
        size = torch.zeros(positions[i].shape[0], dtype=torch.int64, device=dev)
        size[starts[i]] = torch.minimum(next_v, total_counted) - vbs[i]
        q = torch.zeros_like(boundaries[i])
        q[starts[i]] = True
        q &= size >= max(min_gs, 1)  # groups with no counted row never existed for the walk
        if max_gs is not None:
            q &= size <= max_gs
        sizes.append(size)
        qualifies.append(q)
        totals.append(torch.where(q, size, 0).sum())
    return sizes, qualifies, totals


def distributed_hist_from_sizes(size: list, qualifies: list, max_counts_bin: int, mesh: Mesh):
    """Histogram of the sharded qualifying group sizes (sizes above
    ``max_counts_bin`` in the top bin): ``hist_from_sizes`` a shard (one
    launch of the histogram kernel) and a ``psum``; an int64 tensor on
    shard 0's device."""
    counts = [hist_from_sizes(s, q, max_counts_bin) for s, q in zip(size, qualifies)]
    return psum(counts, mesh)[0]


def mesh_lanes_filter_flags(words: list, positions: list, is_pad: list, params, flags_fn,
                            seg_starts, seg_ends, built_k: int, mesh: Mesh):
    """A library filter evaluated on the retained sharded sorted lanes (the
    lanes flags of ops/filters.py): (survivor mask per shard, the error
    triple ``[any, cond_id, first_bad_position]`` as a list, empty when the
    filter raises nothing). The per-row caps are recomputed from the
    segment table (the ragged sort keeps no cap lane). Pad rows are neither
    survivors nor offenders: their positions read as 0 here, and their
    flags are masked out. The first offending row in shard order is the
    first in global sorted order, the row the reference's walk raises at."""
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    masks, digests = [], []
    for i, pad in enumerate(is_pad):
        valid = ~pad
        pos = torch.where(valid, positions[i], 0)
        cap = cap_lengths(compute_valid_len(pos, ss[i], se[i]), built_k)
        mask, errs = flags_fn(words[i], cap, pos, params)
        masks.append(mask & valid)
        digests.append(fold_err_conditions(errs, pos, valid=valid))
    if digests[0] is None:
        return masks, []
    for values in gather_host([d.cpu().numpy() for d in digests], mesh).tolist():
        if values[0]:
            return masks, values
    return masks, [0, 0, 0]


def distributed_group_size_histogram_ragged(
    packed,
    sorted_positions: list,
    is_pad: list,
    seg_starts,
    seg_ends,
    kmer_len: int,
    mesh: Mesh,
    min_group_size: int = 1,
    max_group_size: int | None = None,
    max_counts_bin: int = 1000000,
    packed2=None,
    strand_split: int | None = None,
    sorted_words=None,
    mask=None,
    return_digest: bool = False,
    return_sizes: bool = False,
    ext_gid=None,
):
    """Group-size histogram and total over the ragged per-shard-padded
    layout of ``sample_sort_positions_ragged`` (or an evenly padded one):
    ``(counts, total)``; with ``return_digest`` ``(counts, total, hi)``,
    ``hi`` the largest clipped bin any qualifying group lands in
    (min(largest qualifying size, ``max_counts_bin``), 0 without one), a
    0-dim int64 tensor on the mesh's first device, so that a caller can
    read ``counts[:hi + 1]`` alone; or, before either, with
    ``return_sizes`` the sharded ``(size, qualifies, digest)``, ``digest``
    the JAX package's int64 tensor ``[total, largest qualifying size,
    counts of the sizes clipped at _SPEC_HIST_BINS]`` on the mesh's first
    device. ``packed`` /
    ``packed2`` are the genome's 4-bit or 2-bit pack (one tensor,
    replicated here); ``sorted_words``, the lanes a sample sort retained on
    the same encoding, skip the key gathers (``kmer_len`` at most their
    built length); ``mask``, a sharded survivor mask, makes the sizes count
    survivors in unfiltered group identity; ``strand_split`` keeps the two
    strands of a both-strand index apart (positions at or past it are "-"
    k-mers): a group is then (string, strand), and a shard's sizes are its
    "+" halves followed by its "-" halves (``_dist_sizes_digest``).
    ``ext_gid``, sharded run ids (``sample_sort.distributed_adjacent_gids``
    or the converged ids of ``sample_sort_positions_unbounded``), are the
    group identity alone: then ``kmer_len`` may be None or beyond one
    compare window and the genome is not read."""
    limit = 64 if packed2 is not None else 32
    if ext_gid is None and (kmer_len is None or kmer_len > limit):
        raise NotImplementedError(
            f"distributed stats require kmer_len <= {limit} "
            "(pass ext_gid for unbounded/beyond-window group identity)"
        )
    two_bit = packed2 is not None
    if ext_gid is not None:
        size, qualifies, total, _ = _dist_sizes_digest(
            None, sorted_positions, None, is_pad, min_group_size, max_group_size,
            strand_split, None, mask, ext_gid, 0, two_bit, 32, mesh,
        )
        return _hist_or_sizes(size, qualifies, total, max_counts_bin, return_digest,
                              return_sizes, mesh)
    genome = replicate(packed2 if two_bit else packed, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    cap_len = [
        cap_lengths(compute_valid_len(pos, ss[i], se[i]), kmer_len)
        for i, pos in enumerate(sorted_positions)
    ]
    n_words = _cdiv(kmer_len, 16 if two_bit else 8)
    keep_bits = 32
    if sorted_words is not None:
        if len(sorted_words[0]) < n_words:
            raise ValueError("sorted_words shorter than kmer_len requires")
        keep_bits = (2 if two_bit else 4) * kmer_len - 32 * (n_words - 1)
    size, qualifies, total, _ = _dist_sizes_digest(
        lambda i, pos, cap, n: _words_for(genome[i], pos, cap, n, two_bit),
        sorted_positions, cap_len, is_pad, min_group_size, max_group_size,
        strand_split, sorted_words, mask, None, n_words, two_bit, keep_bits, mesh,
    )
    return _hist_or_sizes(size, qualifies, total, max_counts_bin, return_digest, return_sizes,
                          mesh)


def _hist_or_sizes(size, qualifies, total, max_counts_bin, return_digest, return_sizes, mesh):
    """What ``distributed_group_size_histogram_ragged`` returns from the
    sizes of ``_dist_sizes_digest``. ``hi`` is a maximum a shard and a
    ``pmax`` over the sizes already computed: no host read."""
    if return_sizes:
        hi = _largest_qualifying(size, qualifies, mesh)
        spec = distributed_hist_from_sizes(size, qualifies, _SPEC_HIST_BINS, mesh)
        return size, qualifies, torch.cat([hi.new_tensor([total]), hi.view(1), spec])
    counts = distributed_hist_from_sizes(size, qualifies, max_counts_bin, mesh)
    if not return_digest:
        return counts, total
    return counts, total, torch.clamp_max(_largest_qualifying(size, qualifies, mesh),
                                          max_counts_bin)


def _largest_qualifying(size, qualifies, mesh):
    """The largest qualifying group size over all shards (0 without one):
    a 0-dim int64 tensor on the mesh's first device."""
    local = [torch.where(q, s, 0).amax() if s.numel() else s.new_zeros(())
             for s, q in zip(size, qualifies)]
    return pmax(local, mesh)[0]


def distributed_group_size_histogram(
    packed,
    sorted_positions: torch.Tensor,
    seg_starts,
    seg_ends,
    kmer_len: int,
    mesh: Mesh,
    min_group_size: int = 1,
    max_group_size: int | None = None,
    max_counts_bin: int = 1000000,
    packed2=None,
    strand_split: int | None = None,
):
    """Group-size histogram and total over a globally sorted position
    tensor, cut into equal shards first: ``(counts, total)``, equal to the
    single-device ``get_kmer_group_counts``."""
    pos, pad = shard_evenly(sorted_positions, mesh)
    return distributed_group_size_histogram_ragged(
        packed, pos, pad, seg_starts, seg_ends, kmer_len, mesh,
        min_group_size=min_group_size, max_group_size=max_group_size,
        max_counts_bin=max_counts_bin, packed2=packed2, strand_split=strand_split,
    )
