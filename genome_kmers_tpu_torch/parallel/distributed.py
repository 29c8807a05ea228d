"""The single-process mesh, and group statistics over a sharded sorted index.

Counterpart of ``genome_kmers_tpu/parallel/distributed.py``. The JAX package
runs one controller over a ``jax.sharding.Mesh`` of ``shard_map`` bodies;
the port's mesh is single-process: an ordered list of ``torch.device``s, one
a shard (``make_mesh``), a sharded array is a list of per-shard tensors, and
the collectives are the plain functions of ``collectives.py``. On the CPU
``make_mesh(8, devices=["cpu"] * 8)`` stands where the JAX tests put XLA's 8
virtual CPU devices; on one card ``make_mesh(4, devices=["cuda:0"] * 4)``
runs the sharded code, exchange included, on that card; on a host with
more cards one shard goes to each.

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

Not ported here: the odd-even merge sort (``distributed_sort_positions``).
"""

from __future__ import annotations

import math

import torch

from ..ops.groups import fold_err_conditions
from ..ops.keys import build_key2_words, build_key_words, cap_lengths, compute_valid_len
from ..ops.sort import _masked
from ..sequence_collection import resolve_device
from .collectives import all_gather, psum, put_sharded, replicate

AXIS = "kmers"  # mesh axis name: position-sharded data parallelism
_PAD_POS = 0xFFFFFFF0  # padding position of an evenly sharded index (JAX ops/sort._PAD_POS)
_BIG = 1 << 62  # "no boundary here": above every counted-row index


class Mesh:
    """A single-process mesh: ``devices[p]`` holds shard ``p`` (several
    shards may share one device). One axis by default; ``axis_names`` and
    ``axis_sizes`` name more, the shards then in row-major order over them
    (``hier.make_mesh2``: ``("node", "local")``). Two meshes are equal when
    they list the same devices in the same order over the same axes."""

    def __init__(self, devices, axis_names=(AXIS,), axis_sizes=None):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        sizes = (len(self.devices),) if axis_sizes is None else tuple(int(a) for a in axis_sizes)
        if len(sizes) != len(self.axis_names) or math.prod(sizes) != len(self.devices):
            raise ValueError(
                f"axes {self.axis_names} of sizes {sizes} do not hold {len(self.devices)} devices"
            )
        self.shape = dict(zip(self.axis_names, sizes))

    def __eq__(self, other):
        return (
            isinstance(other, Mesh)
            and self.devices == other.devices
            and self.shape == other.shape
        )

    def __hash__(self):
        return hash((self.devices, self.axis_names))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.shape})"


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


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the position-sharding axis. ``devices`` (any
    ``torch.device`` specs, repeats allowed) are taken as given; without
    them the mesh takes the visible CUDA cards, the first ``n_devices`` of
    them where it is given, and raises without CUDA."""
    if devices is None:
        devices = visible_cards(n_devices, "make_mesh")
    return Mesh(devices)


def mesh_size(mesh: Mesh) -> int:
    """Number of shards."""
    return len(mesh.devices)


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


def _last_rows(shard: tuple, n_valid: torch.Tensor) -> torch.Tensor:
    """The shard's last valid row as one int64 value a lane (row 0 where
    it has none; zeros for a shard of no rows)."""
    if shard[0].shape[0] == 0:
        return torch.zeros(len(shard), dtype=torch.int64, device=shard[0].device)
    return torch.stack([lane[torch.clamp_min(n_valid - 1, 0)].to(torch.int64) for lane in shard])


def _halo_preds(valid: list, mesh: Mesh) -> list:
    """For each shard p, the nearest q < p whose shard has a valid row, as
    a 0-dim tensor on shard p's device (-1 if none), and the valid-row
    counts of all shards on every shard."""
    all_n_valid = all_gather([v.sum() for v in valid], mesh)
    preds = []
    for p in range(mesh_size(mesh)):
        dev = all_n_valid[p].device
        cand = torch.where(all_n_valid[p][:p] > 0, torch.arange(p, device=dev), -1)
        preds.append(cand.max() if p else torch.tensor(-1, device=dev))
    return preds


def _halo_adjacent_eq(lanes: list, valid: list, mesh: Mesh) -> list:
    """Adjacent equality of sharded rows, stitched across shard edges: row
    i of a shard equals row i - 1 in every lane (valid rows form each
    shard's prefix, so row i - 1 of a valid row is its true predecessor),
    and row 0 compares with the last valid row of the nearest previous
    shard that has one (False where there is none). ``lanes[p]`` is shard
    p's tuple of lanes, any integer or bool dtypes; a shard may have no
    rows."""
    n_valid = [v.sum() for v in valid]
    all_last = all_gather([_last_rows(shard, nv) for shard, nv in zip(lanes, n_valid)], mesh)
    preds = _halo_preds(valid, mesh)
    out = []
    for p, shard in enumerate(lanes):
        eq = torch.ones(shard[0].shape[0], dtype=torch.bool, device=shard[0].device)
        for lane in shard:
            eq[1:] &= lane[1:] == lane[:-1]
        if eq.shape[0]:
            pred = preds[p]
            first = torch.stack([lane[0].to(torch.int64) for lane in shard])
            eq[:1] = (first == all_last[p][torch.clamp_min(pred, 0)]).all() & (pred >= 0)
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
    for p, f in enumerate(flag):
        prev = torch.zeros_like(f)
        prev[1:] = f[:-1]
        if f.shape[0]:
            pred = preds[p]
            prev[:1] = (all_last[p][torch.clamp_min(pred, 0)] != 0) & (pred >= 0)
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
    (``words_fn(p, positions, caps, n_words)`` of shard p, or the retained
    ``sorted_words`` masked to ``keep_bits`` bits of the last word) and the
    cap on 2-bit keys; and the strand where ``strand_split`` is given."""
    n_dev = mesh_size(mesh)
    valid = [~pad for pad in is_pad]
    counted = valid if mask is None else [m & v for m, v in zip(mask, valid)]
    all_counted = all_gather([c.sum() for c in counted], mesh)
    lanes = []
    for p in range(n_dev):
        if ext_gid is not None:
            shard = (ext_gid[p],)
        else:
            cap = torch.where(valid[p], cap_len[p], 0)
            if sorted_words is None:
                words = words_fn(p, positions[p], cap, n_words)
            else:
                words = list(sorted_words[p][:n_words])
                if keep_bits < 32:
                    words[-1] = _masked(words[-1], (0xFFFFFFFF << (32 - keep_bits)) & 0xFFFFFFFF)
            shard = tuple(words) + ((cap,) if two_bit else ())
        if strand_split is not None:
            shard += (positions[p] >= strand_split,)
        lanes.append(shard)
    eqs = _halo_adjacent_eq(lanes, valid, mesh)
    del lanes
    starts, vbs, firsts, boundaries = [], [], [], []
    for p in range(n_dev):
        boundary = ~eqs[p] & valid[p]
        boundaries.append(boundary)
        c = counted[p].to(torch.int64)
        offset = all_counted[p][:p].sum()
        vidx = offset + torch.cumsum(c, dim=0) - c  # counted rows before each row, all shards
        b_idx = torch.nonzero(boundary).flatten()
        vb = vidx[b_idx]
        starts.append(b_idx)
        vbs.append(vb)
        firsts.append(torch.cat([vb, vb.new_full((1,), _BIG)])[0])
    all_firsts = all_gather(firsts, mesh)
    sizes, qualifies, totals = [], [], []
    for p in range(n_dev):
        dev = positions[p].device
        total_counted = all_counted[p].sum()
        # first boundary of a later shard, or none (the end of the index)
        after = all_firsts[p][p + 1 :].min() if p + 1 < n_dev else torch.tensor(_BIG, device=dev)
        next_v = torch.cat([vbs[p][1:], after.view(1)])
        size = torch.zeros(positions[p].shape[0], dtype=torch.int64, device=dev)
        size[starts[p]] = torch.minimum(next_v, total_counted) - vbs[p]
        q = torch.zeros_like(valid[p])
        q[starts[p]] = True
        q &= size >= max(min_gs, 1)  # groups with no counted row never existed for the walk
        if max_gs is not None:
            q &= size <= max_gs
        sizes.append(size)
        qualifies.append(q)
        totals.append(torch.where(q, size, 0).sum())
    return sizes, qualifies, int(psum(totals, mesh)[0]), boundaries


def distributed_hist_from_sizes(size: list, qualifies: list, max_counts_bin: int, mesh: Mesh):
    """Histogram of the sharded qualifying group sizes (sizes above
    ``max_counts_bin`` in the top bin): one ``bincount`` a shard and a
    ``psum``; an int64 tensor on shard 0's device."""
    counts = [
        torch.bincount(torch.clamp_max(s, max_counts_bin)[q], minlength=max_counts_bin + 1)
        for s, q in zip(size, qualifies)
    ]
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
    for p in range(mesh_size(mesh)):
        valid = ~is_pad[p]
        pos = torch.where(valid, positions[p], 0)
        cap = cap_lengths(compute_valid_len(pos, ss[p], se[p]), built_k)
        mask, errs = flags_fn(words[p], cap, pos, params)
        masks.append(mask & valid)
        digests.append(fold_err_conditions([e & valid for e in errs], pos))
    if digests[0] is None:
        return masks, []
    for digest in digests:
        values = digest.tolist()
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
    return_sizes: bool = False,
    ext_gid=None,
):
    """Group-size histogram and total over the ragged per-shard-padded
    layout of ``sample_sort_positions_ragged`` (or an evenly padded one):
    ``(counts, total)``, or with ``return_sizes`` the sharded ``(size,
    qualifies, total)``. ``packed`` / ``packed2`` are the genome's 4-bit or
    2-bit pack (one tensor, replicated here); ``sorted_words``, the lanes a
    sample sort retained on the same encoding, skip the key gathers
    (``kmer_len`` at most their built length); ``mask``, a sharded
    survivor mask, makes the sizes count survivors in unfiltered group
    identity; ``strand_split`` keeps the two strands of a both-strand index
    apart (positions at or past it are "-" k-mers). ``ext_gid``, sharded
    run ids (``sample_sort.distributed_adjacent_gids`` or the converged ids
    of ``sample_sort_positions_unbounded``), are the group identity alone:
    then ``kmer_len`` may be None or beyond one compare window and the
    genome is not read."""
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
        if return_sizes:
            return size, qualifies, total
        return distributed_hist_from_sizes(size, qualifies, max_counts_bin, mesh), total
    genome = replicate(packed2 if two_bit else packed, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    cap_len = [
        cap_lengths(compute_valid_len(pos, ss[p], se[p]), kmer_len)
        for p, pos in enumerate(sorted_positions)
    ]
    n_words = _cdiv(kmer_len, 16 if two_bit else 8)
    keep_bits = 32
    if sorted_words is not None:
        if len(sorted_words[0]) < n_words:
            raise ValueError("sorted_words shorter than kmer_len requires")
        keep_bits = (2 if two_bit else 4) * kmer_len - 32 * (n_words - 1)
    size, qualifies, total, _ = _dist_sizes_digest(
        lambda p, pos, cap, n: _words_for(genome[p], pos, cap, n, two_bit),
        sorted_positions, cap_len, is_pad, min_group_size, max_group_size,
        strand_split, sorted_words, mask, None, n_words, two_bit, keep_bits, mesh,
    )
    if return_sizes:
        return size, qualifies, total
    return distributed_hist_from_sizes(size, qualifies, max_counts_bin, mesh), total


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
