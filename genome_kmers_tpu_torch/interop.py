"""Carry the host state of a JAX-package collection and index into the port.

``from_numpy_state`` rebuilds a ``SequenceCollection`` and a ``Kmers`` from
NumPy arrays: the SBA of the loaded strand, its segment starts and record
names, the index's strand mode and, optionally, an index: a sorted one
(sorted positions and, where the sort was within one compare window, the
retained sorted key lanes ``words``/``cap``, 2-bit or 4-bit, as the JAX
package keeps them; for a suffix-mode or beyond-window sort the converged
run ids ``suffix_gid`` instead, or neither), an assigned, unsorted one
(positions alone), or an index sorted on a mesh: its ragged layout (per
shard the sorted positions with their pads, and for a sort beyond one
compare window the converged run ids) on a mesh of the port. The port then
computes over exactly the state the JAX package built.

``large_from_numpy_state`` does the same for a ``LargeKmers``: its strided
pack, segment tables and parameters, and its sorted layout per shard (the
(hi, lo) position pairs fused to uint64, the pad flags).
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import Kmers, _DistIndexCache
from .large_kmers import LargeKmers
from .ops.encoding import reverse_complement_bytes
from .ops.keys import u32_bits_as_int32
from .ops.sort import WINDOW2_BASES, WINDOW_BASES
from .sequence_collection import SequenceCollection


def _lane(values, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values).astype(np.int64)).to(device)


def _collection(sba, seg_starts, record_names, source_strand: str, device) -> SequenceCollection:
    sc = SequenceCollection(device=device)
    sba = np.ascontiguousarray(sba, dtype=np.uint8)
    seg_starts = np.asarray(seg_starts, dtype=np.uint32)
    if source_strand == "reverse_complement":
        sc.revcomp_sba, sc._revcomp_sba_seg_starts = sba, seg_starts
        sc.revcomp_record_names = list(record_names)
    else:
        sc.forward_sba, sc._forward_sba_seg_starts = sba, seg_starts
        sc.forward_record_names = list(record_names)
        if source_strand == "both":
            sc.revcomp_sba = reverse_complement_bytes(sba)
            sc._revcomp_sba_seg_starts = sc._get_opposite_strand_sba_start_indices(
                seg_starts, len(sba)
            )
            sc.revcomp_record_names = list(record_names)[::-1]
    sc._strands_loaded = source_strand
    return sc


def from_numpy_state(
    sba,
    seg_starts,
    record_names,
    min_kmer_len: int,
    max_kmer_len,
    positions=None,
    words=None,
    cap=None,
    two_bit: bool = True,
    is_sorted: bool = True,
    device="cuda",
    source_strand: str = "forward",
    track_strands_separately: bool = False,
    suffix_gid=None,
    mesh=None,
    mesh_positions=None,
    mesh_pad=None,
    mesh_gid=None,
):
    """(SequenceCollection, Kmers) on ``device`` holding the given state.

    ``sba``, ``seg_starts`` and ``record_names`` are those of the loaded
    strand: the reverse-complement SBA for
    ``source_strand="reverse_complement"``, else the forward one (for
    "both" the reverse complement is derived from it). A non-forward
    ``source_strand`` gives the index ``Kmers.from_strand`` builds;
    positions of a "both" index are those of the concatenated SBA.

    Without ``positions`` the Kmers is the fresh, unsorted index. With them
    and ``is_sorted`` it is the sorted index. Where ``max_kmer_len`` lies
    within one compare window, ``words`` (a sequence of uint32 arrays) are
    the sorted key lanes built at ``max_kmer_len``: 2-bit lanes
    (``two_bit``) with ``cap`` the sorted cap lane (None when min_kmer_len
    == max_kmer_len), or 4-bit lanes, which have no cap lane. Beyond it
    (``max_kmer_len`` None included) there are no such lanes, and
    ``suffix_gid`` may carry the converged run ids of the sort. With
    ``is_sorted=False`` the positions are an assigned index in the given
    order and there are no lanes.

    With ``mesh`` (a mesh of the port) the index is one sorted on a mesh
    of as many shards: ``mesh_positions`` and ``mesh_pad`` hold each
    shard's rows of the ragged layout (uint32 positions; pad flags, nonzero
    on a pad), and ``mesh_gid``, for a sort beyond one compare window
    (``max_kmer_len`` None included), each shard's converged run ids, the
    group identity at ``max_kmer_len``. The mesh statistics and queries
    then read that layout with no sort."""
    sc = _collection(sba, seg_starts, record_names, source_strand, device)
    if source_strand == "forward":
        km = Kmers(sc, min_kmer_len=min_kmer_len, max_kmer_len=max_kmer_len)
    else:
        km = Kmers.from_strand(
            sc, min_kmer_len, max_kmer_len, source_strand=source_strand,
            track_strands_separately=track_strands_separately,
        )
    if mesh is not None:
        if positions is not None or words is not None or cap is not None or suffix_gid is not None:
            raise ValueError("a mesh index is given by its layout alone (mesh_positions, mesh_pad)")
        if len(mesh_positions) != len(mesh.devices) or len(mesh_pad) != len(mesh.devices):
            raise ValueError(f"the layout has {len(mesh_positions)} shards, the mesh "
                             f"{len(mesh.devices)}")
        pos = [_lane(p, dev) for p, dev in zip(mesh_positions, mesh.devices)]
        pad = [torch.from_numpy(np.asarray(p) != 0).to(dev) for p, dev in zip(mesh_pad, mesh.devices)]
        gid = None if mesh_gid is None else [_lane(g, dev) for g, dev in zip(mesh_gid, mesh.devices)]
        km._dist_cache = _DistIndexCache(
            mesh, pos, pad, int(sum(int((~p).sum()) for p in pad)), gid_full=gid,
            gid_full_k=max_kmer_len if gid is not None else None,
        )
        km._pos_dev = km._pos_host = km._init_geometry = None
        km._is_sorted = True
        return sc, km
    if positions is None:
        return sc, km
    if not is_sorted:
        if words is not None or cap is not None or suffix_gid is not None:
            raise ValueError("an assigned, unsorted index has no sorted key lanes")
        km.kmer_sba_start_indices = np.asarray(positions).astype(np.uint32)
        return sc, km
    in_window = max_kmer_len is not None and max_kmer_len <= (
        WINDOW2_BASES if two_bit else WINDOW_BASES
    )
    if in_window:
        if words is None:
            raise ValueError("a sorted index needs its sorted key lanes (words)")
        if suffix_gid is not None:
            raise ValueError("run ids belong to a sort beyond one compare window")
        if two_bit and (cap is None) != (min_kmer_len == max_kmer_len):
            raise ValueError("cap must be given exactly when min_kmer_len < max_kmer_len")
        if not two_bit and cap is not None:
            raise ValueError("4-bit lanes carry termination in-word and have no cap lane")
    elif words is not None or cap is not None:
        raise ValueError("a sort beyond one compare window keeps no key lanes (words, cap)")
    km._pos_dev = _lane(positions, sc.device)
    km._pos_host = None
    km._init_geometry = None
    if in_window:
        if two_bit:  # the forms the port's own sorts retain (ops/sort.py)
            lane_words = tuple(_lane(w, sc.device) for w in words)
        else:
            lane_words = tuple(u32_bits_as_int32(_lane(w, sc.device)) for w in words)
        km._lanes_cache = {
            "two_bit": two_bit,
            "built_k": max_kmer_len,
            "words": lane_words,
            "cap": None if cap is None else _lane(cap, sc.device),
        }
    elif suffix_gid is not None:
        km._suffix_gid_cache = (_lane(suffix_gid, sc.device), max_kmer_len)
    km._is_sorted = True
    return sc, km


def large_from_numpy_state(
    packed_words,
    seg_starts_u64,
    seg_ends_u64,
    min_kmer_len: int,
    max_kmer_len,
    two_bit: bool = True,
    both_strands: bool = False,
    track_strands_separately: bool = False,
    record_names=None,
    mesh=None,
    mesh_positions=None,
    mesh_pad=None,
) -> LargeKmers:
    """A port ``LargeKmers`` over a JAX ``LargeKmers``'s host state: the
    strided ``packed_words`` (uint32), the uint64 segment starts and ends,
    the k-mer bounds, ``two_bit``, ``both_strands`` (the reverse-complement
    segments are the second half) and ``track_strands_separately``. Given
    ``mesh``, ``mesh_positions`` (per shard, the sorted (hi, lo) positions
    fused to uint64, pads included) and ``mesh_pad`` (per shard, the pad
    flags) place that sorted layout on it, shard for shard; the key lanes
    and run ids are rebuilt when a call needs them."""
    lk = LargeKmers(
        packed_words, seg_starts_u64, seg_ends_u64, min_kmer_len, max_kmer_len,
        two_bit=two_bit, record_names=record_names,
    )
    if both_strands:
        lk._n_fwd_records = len(lk.seg_starts) // 2
        lk._track_strands = bool(track_strands_separately)
    elif track_strands_separately:
        raise ValueError("track_strands_separately can only be true if both_strands is True")
    if mesh is None:
        if mesh_positions is not None or mesh_pad is not None:
            raise ValueError("a sorted layout needs the mesh it lies on")
        return lk
    if len(mesh_positions) != len(mesh.devices) or len(mesh_pad) != len(mesh.devices):
        raise ValueError(f"the layout has {len(mesh_positions)} shards, the mesh "
                         f"{len(mesh.devices)}")
    pos = [
        torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint64).view(np.int64)).to(dev)
        for p, dev in zip(mesh_positions, mesh.devices)
    ]
    pad = [torch.from_numpy(np.asarray(p) != 0).to(dev) for p, dev in zip(mesh_pad, mesh.devices)]
    lk._sorted = (pos, pad, mesh, int(sum(int((~p).sum()) for p in pad)), None)
    lk._is_sorted = True
    return lk
