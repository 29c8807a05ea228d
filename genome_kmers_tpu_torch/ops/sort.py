"""Single-device sorted k-mer index construction (2-bit path).

Counterpart of ``genome_kmers_tpu/ops/sort.py::sort_positions_dense`` and
``boundaries_from_sorted_lanes``. The JAX package sorts its key lanes with
one stable ``lax.sort`` and the position as payload; here the lanes go
through ``torch.sort(..., stable=True)``, which CUDA needs asked for
explicitly (its default sort is not stable).

The key of a row is, most significant first: an "invalid" bit (rows that
are not k-mer starts), the meaningful 2k bits of its key words, and, when
the caps differ between rows, its cap. These bits are cut into int64 sort
keys of at most 63 bits (non-negative, so signed order is unsigned order)
and sorted least significant key first, each pass stable, starting from
ascending positions: ties keep the position order, the tie-break that the
JAX package gets from its iota payload. At ``min_kmer_len == max_kmer_len
<= 31`` the whole key is one int64 (1 + 2k <= 63 bits), so one sort does
it and the retained words come back out of the sorted key by shifts.
"""

from __future__ import annotations

import torch

from .encoding import BASES_PER_WORD2, DIBIT_MASKS
from .keys import build_key2_words_dense, valid_len_all

_KEY_BITS = 63  # bits per int64 sort key, keeping the sign bit clear


def _pack_chunks(lanes):
    """Concatenate the bits of ``lanes`` ((values, width) pairs, most
    significant first, 0 <= values < 2**width) and cut them into int64 keys
    of at most ``_KEY_BITS`` bits. Comparing the keys in order compares the
    lanes in order. Returns (keys, key widths)."""
    chunks, widths = [], []
    cur, used = None, 0
    for lane, width in lanes:
        left = width
        while left:
            if used == _KEY_BITS:
                chunks.append(cur)
                widths.append(used)
                cur, used = None, 0
            take = min(left, _KEY_BITS - used)
            part = (lane >> (left - take)) & ((1 << take) - 1)
            cur = part if cur is None else (cur << take) | part
            used += take
            left -= take
    chunks.append(cur)
    widths.append(used)
    return chunks, widths


def _unpack_chunks(chunks, chunk_widths, lane_widths):
    """Inverse of ``_pack_chunks``: the lanes of the given widths."""
    lanes = []
    ci, avail = 0, chunk_widths[0]
    for width in lane_widths:
        lane, left = None, width
        while left:
            if avail == 0:
                ci += 1
                avail = chunk_widths[ci]
            take = min(left, avail)
            part = (chunks[ci] >> (avail - take)) & ((1 << take) - 1)
            lane = part if lane is None else (lane << take) | part
            avail -= take
            left -= take
        lanes.append(lane)
    return lanes


def _dense_key_chunks(packed2, seg_starts, seg_ends, min_len, k, uniform_cap):
    """Sort keys for every position 0..L-1 of the pack (see module doc).
    Returns (keys, key widths, lane widths); the lanes are the invalid bit,
    the words (the last one cut to its meaningful bits) and, unless
    ``uniform_cap``, the cap. A function of its own so that the lanes, a
    few int64 tensors of L rows, are freed before the sort allocates."""
    n_words = -(-k // BASES_PER_WORD2)
    cap = torch.clamp_max(valid_len_all(seg_starts, seg_ends, packed2.shape[0]), k)
    invalid = (cap < min_len).to(torch.int64)
    words = build_key2_words_dense(packed2, cap, n_words)
    last_bits = 2 * (k - BASES_PER_WORD2 * (n_words - 1))
    lanes = [(invalid, 1)] + [(w, 32) for w in words[:-1]]
    lanes.append((words[-1] >> (32 - last_bits), last_bits))
    if not uniform_cap:
        lanes.append((cap, k.bit_length()))
    chunks, chunk_widths = _pack_chunks(lanes)
    return chunks, chunk_widths, [w for _, w in lanes]


def _sort_dense(packed2, seg_starts, seg_ends, min_len, k, uniform_cap):
    """Fresh sort over ALL positions 0..L-1 of the pack: key words are
    shifted slices of the pack and valid_len comes from the segment table,
    so nothing is gathered from the genome. Rows that are not k-mer starts
    (separators, tails shorter than ``min_len``) carry the invalid bit and
    sort after every real row.

    Returns (positions in sorted order, sorted keys, key widths, lane
    widths) over all L rows; the caller keeps the real-row prefix."""
    chunks, chunk_widths, lane_widths = _dense_key_chunks(
        packed2, seg_starts, seg_ends, min_len, k, uniform_cap
    )
    perm = None
    for chunk in reversed(chunks):
        vals, idx = torch.sort(chunk if perm is None else chunk[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    sorted_chunks = [vals] + [c[perm] for c in chunks[1:]]
    return perm, sorted_chunks, chunk_widths, lane_widths


def sort_positions_dense(packed2, seg_starts, seg_ends, n, min_kmer_len, max_kmer_len):
    """Fresh sort of the canonical k-mer start set (every position with
    valid_len >= min_kmer_len) of an ACGT genome, from its int32 2-bit pack.
    ``n`` is the known canonical start count.

    Returns ``(positions, lanes)``: int64 positions in sorted order, ties by
    position, and the retained sorted lanes in the JAX package's layout
    ``{"two_bit", "built_k", "words", "cap"}`` (words as int64 lanes of
    uint32 values; cap None when min_kmer_len == max_kmer_len)."""
    k = max_kmer_len
    uniform = min_kmer_len == max_kmer_len
    perm, sorted_chunks, chunk_widths, lane_widths = _sort_dense(
        packed2, seg_starts, seg_ends, min_kmer_len, k, uniform
    )
    lanes = _unpack_chunks([c[:n] for c in sorted_chunks], chunk_widths, lane_widths)
    n_words = -(-k // BASES_PER_WORD2)
    words = lanes[1 : 1 + n_words]
    words[-1] = words[-1] << (32 - lane_widths[n_words])
    return perm[:n], {
        "two_bit": True,
        "built_k": k,
        "words": tuple(words),
        "cap": None if uniform else lanes[-1],
    }


def boundaries_from_sorted_lanes(words, cap, kmer_len: int) -> torch.Tensor:
    """Group-boundary mask from retained sorted 2-bit key lanes: a pure
    adjacent compare, no genome gathers. Any ``kmer_len`` up to the built
    length works: word content beyond each row's cap is already zero, so
    masking each word to ``kmer_len`` bases and clamping the cap lane to
    ``min(cap, kmer_len)`` gives exactly the lanes of a build at kmer_len.
    ``cap=None`` is the uniform-cap case, which has no cap lane."""
    n = words[0].shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=words[0].device)
    for w_idx, w in enumerate(words):
        keep = min(max(kmer_len - BASES_PER_WORD2 * w_idx, 0), BASES_PER_WORD2)
        if keep == 0:
            break
        ww = w & int(DIBIT_MASKS[keep])
        eq[1:] &= ww[1:] == ww[:-1]
    if cap is not None:
        c = torch.clamp_max(cap, kmer_len)
        eq[1:] &= c[1:] == c[:-1]
    boundary = ~eq
    boundary[:1] = True
    return boundary
