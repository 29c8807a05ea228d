"""Group statistics of the large regime: a sorted layout over a strided pack.

Counterpart of ``genome_kmers_tpu/parallel/large.py``. The JAX package
rebuilds the mesh statistics of ``distributed.py`` for this regime because
three quantities outgrow uint32 past 2^32 k-mers (global row indices, group
sizes and the total, histogram bins) and a TPU has no 64-bit integers: it
carries them as (hi, lo) uint32 pairs with carry arithmetic and sums them
on the host in uint64. The port's statistics are int64 throughout, so the
large regime runs the same code as the flat one
(``distributed._dist_sizes_digest``, ``distributed_hist_from_sizes``,
``mesh_lanes_filter_flags``), with key words built by a funnel shift from
the strided pack (``ops/large.py``) and int64 positions. Counts and totals
come back as uint64, as the JAX package returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sort import _cdiv
from .distributed import _dist_sizes_digest, distributed_hist_from_sizes, mesh_lanes_filter_flags
from .sample_sort import _ONES, int64_tensor, strided_keys


def large_lanes_filter_flags(words: list, positions: list, is_pad: list, params, flags_fn,
                             seg_starts_u64, seg_ends_u64, built_k: int, mesh):
    """A library filter's survivor mask over the retained sorted lanes of a
    large index, and its error triple (``[]`` when it raises nothing; else
    ``[any, cond_id, first_bad_position]``): ``mesh_lanes_filter_flags``
    with int64 positions. The JAX package passes the lanes flags rebased
    uint32 proxies of its positions; the port's lanes flags compare int64
    positions with thresholds from the true SBA length, the same answer."""
    return mesh_lanes_filter_flags(
        words, positions, is_pad, params, flags_fn, int64_tensor(seg_starts_u64),
        int64_tensor(seg_ends_u64), built_k, mesh,
    )


def rebuild_large_lanes(packed_strided, positions: list, is_pad: list, seg_starts_u64,
                        seg_ends_u64, max_kmer_len: int, mesh, two_bit: bool) -> list:
    """The sorted key lanes (words and cap, int32, pad rows all-ones) of a
    layout that no sort of this process retained them from (a restored
    checkpoint, a refinement sort): one funnel-shift pass a shard."""
    keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
    n_words = _cdiv(max_kmer_len, keys.per_word)
    out = []
    for p, (pos, pad) in enumerate(zip(positions, is_pad)):
        cap = keys.caps(p, pos, max_kmer_len)
        lanes = keys.words(p, pos, cap, n_words) + (cap.to(torch.int32),)
        out.append(tuple(torch.where(pad, _ONES, w) for w in lanes))
    return out


def distributed_group_size_histogram_large_ragged(
    packed_strided,
    positions: list,
    is_pad: list,
    seg_starts_u64,
    seg_ends_u64,
    kmer_len: int | None,
    mesh,
    min_group_size: int = 1,
    max_group_size: int | None = None,
    max_counts_bin: int = 1000000,
    two_bit: bool = True,
    sorted_words=None,
    built_k: int | None = None,
    mask=None,
    return_rows: bool = False,
    ext_gid=None,
    strand_split: int | None = None,
):
    """Group-size histogram and total over a sorted large layout (that of
    ``sample_sort_positions_large_ragged`` or of the refinement sort).

    ``sorted_words`` (the retained lanes, words then cap, built at
    ``built_k``) skip the funnel-shift gathers for ``kmer_len <=
    built_k``; ``mask``, a survivor mask per shard, counts survivors in
    unfiltered group identity (zero-survivor groups never qualify, as in
    the reference's walk); ``ext_gid``, run ids per shard, are the group
    identity at ``kmer_len`` None or beyond one window; ``strand_split``, a
    position, keeps the rows at or past it (the "-" strand) in groups of
    their own.

    Returns ``(counts, total)``: counts a host uint64 array of length
    ``max_counts_bin + 1`` (sizes past the top bin counted in it), total a
    Python int. With ``return_rows`` also ``{"boundary", "size",
    "qualifies"}``, per shard, aligned with the layout: the first row of
    every group, its size (survivors where masked) and whether it
    qualifies."""
    limit = 64 if two_bit else 32
    if ext_gid is None and (kmer_len is None or kmer_len > limit):
        raise NotImplementedError(
            f"large stats require kmer_len <= {limit} "
            "(pass ext_gid for unbounded/beyond-window group identity)"
        )
    if ext_gid is not None:
        digest = _dist_sizes_digest(
            None, positions, None, is_pad, min_group_size, max_group_size, strand_split,
            None, mask, ext_gid, 0, two_bit, 32, mesh,
        )
    else:
        keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
        n_words = _cdiv(kmer_len, keys.per_word)
        cap_len = [keys.caps(p, pos, kmer_len) for p, pos in enumerate(positions)]
        words, keep_bits = None, 32
        if sorted_words is not None and built_k is not None and kmer_len <= built_k:
            # the retained words; the cap is recomputed (equal on real rows)
            words = [tuple(shard[: _cdiv(built_k, keys.per_word)]) for shard in sorted_words]
            keep_bits = (2 if two_bit else 4) * kmer_len - 32 * (n_words - 1)
        digest = _dist_sizes_digest(
            keys.words, positions, cap_len, is_pad, min_group_size, max_group_size,
            strand_split, words, mask, None, n_words, two_bit, keep_bits, mesh,
        )
    size, qualifies, total, boundary = digest
    counts = distributed_hist_from_sizes(size, qualifies, max_counts_bin, mesh)
    counts = counts.cpu().numpy().astype(np.uint64)
    if return_rows:
        return counts, total, {"boundary": boundary, "size": size, "qualifies": qualifies}
    return counts, total
