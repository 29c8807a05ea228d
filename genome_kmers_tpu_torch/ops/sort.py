"""Single-device sorted k-mer index construction.

Counterpart of ``genome_kmers_tpu/ops/sort.py`` for bounded k (one compare
window: k <= 64 on 2-bit keys, k <= 32 on 4-bit keys). Three sorts live here.

**The dense 2-bit sort** (``sort_positions_dense(two_bit=True)``), the fresh
index of an ACGT genome. The JAX package sorts its key lanes with one stable
``lax.sort`` and the position as payload; here the lanes go through
``torch.sort(..., stable=True)``, which CUDA needs asked for explicitly (its
default sort is not stable). The key of a row is, most significant first: an
"invalid" bit (rows that are not k-mer starts), the meaningful 2k bits of
its key words, and, when the caps differ between rows, its cap. These bits
are cut into int64 sort keys of at most 63 bits (non-negative, so signed
order is unsigned order) and sorted least significant key first, each pass
stable, starting from ascending positions: ties keep the position order, the
tie-break that the JAX package gets from its iota payload. At
``min_kmer_len == max_kmer_len <= 31`` the whole key is one int64
(1 + 2k <= 63 bits), so one sort does it and the retained words come back
out of the sorted key by shifts.

**The dense 4-bit sort** (``sort_positions_dense(two_bit=False)``), the
fresh index of a genome with N runs or IUPAC codes. At k = 31 its key is an
invalid lane and four 32-bit words, wider than any int64, so the rows go
through the multi-lane sort ``kernels/lane_sort.py::sort_lanes_cuda`` with
the position as the last lane: the order a stable sort with an ascending
iota payload gives.

**The gather sort** (``sort_positions``) of any position set in any input
order: re-sorts, assigned indices. Key words are gathered per position and
the position is an explicit last key, again through ``sort_lanes_cuda``.

``sort_lanes`` is the plain version of that kernel (a block sort of 4096-row
tiles, then merge-path passes): chained stable ``torch.sort`` passes.
``sort_lanes_cuda`` takes it for CPU tensors; nothing on a CUDA device's
paths calls it.
"""

from __future__ import annotations

import torch

from ..kernels.lane_sort import sort_lanes_cuda
from .encoding import BASES_PER_WORD, BASES_PER_WORD2, DIBIT_MASKS, NIBBLE_MASKS
from .keys import (
    build_key2_words,
    build_key2_words_dense,
    build_key_words,
    build_key_words_dense,
    u32_bits_as_int32,
    valid_len_all,
    widen_u32,
)

WINDOW_BASES = 32  # one compare window of 4-bit keys: 4 words
WINDOW2_BASES = 64  # one compare window of 2-bit keys: 4 words
_INT32_MIN = -(1 << 31)


def _beyond_window(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to genome_kmers_tpu_torch yet (ROADMAP.md A7: suffix mode)"
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sort_lanes(lanes) -> tuple:
    """Rows of int32 lanes (uint32 bit patterns) sorted ascending,
    lexicographically over all lanes, most significant first, compared as
    unsigned; the lanes of a row move together. The plain version of
    ``kernels/lane_sort.py::sort_lanes_cuda``: one stable ``torch.sort`` a
    lane, least significant lane first. Flipping the sign bit turns the
    unsigned order of the bit patterns into the signed order torch sorts by.
    Being stable, it keeps the input order of fully equal rows; the kernel
    promises its result only when the last lane is unique."""
    lanes = tuple(lanes)
    if lanes[0].shape[0] <= 1:
        return lanes
    perm = None
    for lane in reversed(lanes):
        key = lane ^ _INT32_MIN
        idx = torch.sort(key if perm is None else key[perm], stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(lane[perm] for lane in lanes)


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
    n_words = _cdiv(k, BASES_PER_WORD2)
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


def _sort_dense4(packed, seg_starts, seg_ends, min_len, k):
    """Fresh sort over ALL positions 0..L-1 of the 4-bit pack. The lanes
    are (invalid, words..., iota): the leading invalid lane stays, because a
    real 4-bit word can be all-ones (rank 15 = 'Y'), and iota as the last
    key gives the order of a stable sort with iota as payload. Termination
    rides in the words (rank 0 past the cap), so there is no cap lane.

    Returns the sorted lanes (int32 bit patterns) over all L rows; the
    caller keeps the real-row prefix."""
    length = packed.shape[0]
    cap = torch.clamp_max(valid_len_all(seg_starts, seg_ends, length), k)
    invalid = (cap < min_len).to(torch.int32)
    words = build_key_words_dense(packed, cap, _cdiv(k, BASES_PER_WORD))
    del cap
    if length <= 1 << 31:
        iota = torch.arange(length, dtype=torch.int32, device=packed.device)
    else:
        iota = u32_bits_as_int32(torch.arange(length, dtype=torch.int64, device=packed.device))
    return sort_lanes_cuda((invalid,) + words + (iota,))


def sort_positions_dense(
    packed, seg_starts, seg_ends, n, min_kmer_len, max_kmer_len, two_bit=True
):
    """Fresh sort of the canonical k-mer start set (every position with
    valid_len >= min_kmer_len) from the genome's int32 pack: the 2-bit pack
    of an ACGT genome when ``two_bit``, else the 4-bit pack. ``n`` is the
    known canonical start count.

    Returns ``(positions, lanes)``: int64 positions in sorted order, ties by
    position, and the retained sorted lanes in the JAX package's layout
    ``{"two_bit", "built_k", "words", "cap"}``. 2-bit words are int64 lanes
    of uint32 values, with cap None when min_kmer_len == max_kmer_len; 4-bit
    words are int32 bit patterns and never have a cap lane."""
    k = max_kmer_len
    if not two_bit:
        n_words = _cdiv(k, BASES_PER_WORD)
        res = _sort_dense4(packed, seg_starts, seg_ends, min_kmer_len, k)
        return widen_u32(res[-1][:n]), {
            "two_bit": False,
            "built_k": k,
            "words": tuple(w[:n] for w in res[1 : 1 + n_words]),
            "cap": None,
        }
    uniform = min_kmer_len == max_kmer_len
    perm, sorted_chunks, chunk_widths, lane_widths = _sort_dense(
        packed, seg_starts, seg_ends, min_kmer_len, k, uniform
    )
    lanes = _unpack_chunks([c[:n] for c in sorted_chunks], chunk_widths, lane_widths)
    n_words = _cdiv(k, BASES_PER_WORD2)
    words = lanes[1 : 1 + n_words]
    words[-1] = words[-1] << (32 - lane_widths[n_words])
    return perm[:n], {
        "two_bit": True,
        "built_k": k,
        "words": tuple(words),
        "cap": None if uniform else lanes[-1],
    }


def sort_positions(packed, positions, cap_len, max_kmer_len, packed2=None, uniform_cap=False):
    """Sort k-mer start positions lexicographically by their capped k-mer.

    ``positions`` (int64) may come in ANY order (a sorted index, a
    descending or a subset index): the position is an explicit last key,
    not a stable payload. ``cap_len`` is min(valid_len, max_kmer_len) per
    position. With ``packed2`` (ACGT genome, max_kmer_len <= 64) the keys
    are 2-bit words and, unless ``uniform_cap``, the cap; else 4-bit words
    from ``packed`` (max_kmer_len <= 32).

    Returns ``(positions, lanes)``: int64 sorted positions, ties by
    position, and the retained sorted lanes (int32 bit-pattern words, int64
    cap), or None for an index of at most one k-mer. The compare lengths of
    more than one window take refinement rounds, which are not ported."""
    n = positions.shape[0]
    if n <= 1:
        return positions, None
    pos_lane = u32_bits_as_int32(positions)
    if packed2 is not None and max_kmer_len is not None and max_kmer_len <= WINDOW2_BASES:
        n_words = _cdiv(max_kmer_len, BASES_PER_WORD2)
        words = build_key2_words(packed2, positions, cap_len, n_words)
        caps = () if uniform_cap else (cap_len.to(torch.int32),)
        res = sort_lanes_cuda(words + caps + (pos_lane,))
        return widen_u32(res[-1]), {
            "two_bit": True,
            "built_k": max_kmer_len,
            "words": tuple(res[:n_words]),
            "cap": None if uniform_cap else res[n_words].to(torch.int64),
        }
    if max_kmer_len is not None and max_kmer_len <= WINDOW_BASES:
        n_words = _cdiv(max_kmer_len, BASES_PER_WORD)
        words = build_key_words(packed, positions, cap_len, n_words)
        res = sort_lanes_cuda(words + (pos_lane,))
        return widen_u32(res[-1]), {
            "two_bit": False,
            "built_k": max_kmer_len,
            "words": tuple(res[:n_words]),
            "cap": None,  # the 4-bit encoding carries termination in-word
        }
    raise _beyond_window(
        f"sorting at max_kmer_len ({max_kmer_len}) beyond one compare window"
    )


def _masked(word: torch.Tensor, mask_u32: int) -> torch.Tensor:
    """``word & mask`` for a word lane in either form (ops/keys.py)."""
    if word.dtype == torch.int32 and mask_u32 >= 1 << 31:
        mask_u32 -= 1 << 32
    return word & mask_u32


def boundaries_from_sorted_lanes(words, cap, kmer_len: int, two_bit: bool = True) -> torch.Tensor:
    """Group-boundary mask from retained sorted key lanes: a pure adjacent
    compare, no genome gathers. Any ``kmer_len`` up to the built length
    works: word content beyond each row's cap is already zero, so masking
    each word to ``kmer_len`` bases and clamping the cap lane to
    ``min(cap, kmer_len)`` gives exactly the lanes of a build at kmer_len.
    ``cap=None`` is the uniform-cap case, or the 4-bit one, which has no cap
    lane."""
    per_word = BASES_PER_WORD2 if two_bit else BASES_PER_WORD
    masks = DIBIT_MASKS if two_bit else NIBBLE_MASKS
    n = words[0].shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=words[0].device)
    for w_idx, w in enumerate(words):
        keep = min(max(kmer_len - per_word * w_idx, 0), per_word)
        if keep == 0:
            break
        ww = _masked(w, int(masks[keep]))
        eq[1:] &= ww[1:] == ww[:-1]
    if cap is not None:
        c = torch.clamp_max(cap, kmer_len)
        eq[1:] &= c[1:] == c[:-1]
    boundary = ~eq
    boundary[:1] = True
    return boundary


def adjacent_boundaries(
    packed, sorted_positions, cap_len, kmer_len, packed2=None, uniform_cap=False
) -> torch.Tensor:
    """Group-boundary mask over a sorted position array, from gathered key
    words: boundary[i] is True iff the k-mers at sorted_positions[i] and
    [i-1] differ when compared up to ``kmer_len`` bases (``cap_len`` is
    min(valid_len, kmer_len)); boundary[0] is True. On 2-bit keys the cap
    is part of the identity unless ``uniform_cap``."""
    n = sorted_positions.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=sorted_positions.device)
    if packed2 is not None and kmer_len is not None and kmer_len <= WINDOW2_BASES:
        lanes = build_key2_words(
            packed2, sorted_positions, cap_len, _cdiv(kmer_len, BASES_PER_WORD2)
        )
        if not uniform_cap:
            lanes += (cap_len,)
    elif kmer_len is not None and kmer_len <= WINDOW_BASES:
        lanes = build_key_words(packed, sorted_positions, cap_len, _cdiv(kmer_len, BASES_PER_WORD))
    else:
        raise _beyond_window(
            f"group boundaries at kmer_len ({kmer_len}) beyond one compare window"
        )
    eq = torch.ones(n, dtype=torch.bool, device=sorted_positions.device)
    for lane in lanes:
        eq[1:] &= lane[1:] == lane[:-1]
    boundary = ~eq
    boundary[:1] = True
    return boundary
