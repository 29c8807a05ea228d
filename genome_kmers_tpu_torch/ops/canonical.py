"""Canonical (strand-collapsed) k-mer keys and their group statistics.

Counterpart of ``genome_kmers_tpu/ops/canonical.py``. Each k-mer is
identified with min(kmer, revcomp(kmer)), so a k-mer and its reverse
complement count as one; only full-length k-mers take part.

On 2-bit keys (A0 C1 G2 T3) the reverse complement of a key is bit
arithmetic: the complement is a bitwise NOT (A<->T, C<->G), the reversal a
2-bit field reversal by masked shifts. On 4-bit keys (ranks in ASCII
order, ops/encoding.py) the complement is a table of the 16 ranks applied a
byte (two nibbles) at a time, the reversal a 4-bit field reversal. Either
way min(fwd, rc) over the packed words is the min of the strings.

Words here are int64 tensors holding uint32 values (ops/keys.widen_u32):
every shift and compare is then unsigned, and every ``~`` and ``<<`` is
masked back to 32 bits.

The statistics tail sorts (invalid, canonical words): on 2-bit keys as
int64 keys fused by ``ops/sort._pack_chunks`` under stable ``torch.sort``
(one key at k <= 31, a chain beyond), on 4-bit keys as int32 lanes with a
unique payload through ``kernels/lane_sort.sort_lanes_cuda``. Only group
sizes leave it.
"""

from __future__ import annotations

import torch

from ..kernels.lane_sort import sort_lanes_cuda
from .encoding import BASES_PER_WORD, BASES_PER_WORD2, COMPLEMENT_PAIRS, RANK_TABLE
from .groups import group_sizes_at_boundaries
from .keys import (
    build_key2_words,
    build_key2_words_dense,
    build_key_words,
    build_key_words_dense,
    u32_bits_as_int32,
    valid_len_all,
    widen_u32,
)
from .sort import _pack_chunks

_U32 = 0xFFFFFFFF

# 4-bit rank -> rank of its IUPAC complement ('$' -> '$'), and the same for
# a byte of two nibbles
_COMP_RANK = [0] * 16
for _ch, _cc in COMPLEMENT_PAIRS.items():
    _COMP_RANK[int(RANK_TABLE[ord(_ch)])] = int(RANK_TABLE[ord(_cc)])
_COMP_BYTE = [(_COMP_RANK[_b >> 4] << 4) | _COMP_RANK[_b & 0xF] for _b in range(256)]


def _reverse_2bit_fields(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit fields of each uint32 value."""
    x = ((x >> 16) | (x << 16)) & _U32
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    return ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)


def _reverse_4bit_fields(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 8 4-bit fields of each uint32 value."""
    x = ((x >> 16) | (x << 16)) & _U32
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)


def _complement_nibbles(x: torch.Tensor) -> torch.Tensor:
    """The IUPAC rank complement of every 4-bit field (four byte lookups)."""
    table = torch.tensor(_COMP_BYTE, dtype=torch.int64, device=x.device)
    out = torch.zeros_like(x)
    for sh in (0, 8, 16, 24):
        out |= table[(x >> sh) & 0xFF] << sh
    return out


def _justify(rev: list, k: int, per_word: int) -> tuple:
    """Shift the reversed container left by its f = per_word * W - k
    padding fields, across word boundaries, and clear the fields past k."""
    W = len(rev)
    bits = 32 // per_word
    f = per_word * W - k
    q, r = f // per_word, bits * (f % per_word)
    zero = torch.zeros_like(rev[0])
    out = []
    for i in range(W):
        hi = rev[i + q] if i + q < W else zero
        lo = rev[i + q + 1] if i + q + 1 < W else zero
        out.append((((hi << r) | (lo >> (32 - r))) & _U32) if r else hi)
    full_words, rem = divmod(k, per_word)
    for i in range(full_words, W):
        if i == full_words and rem:
            out[i] = out[i] & ((_U32 << (bits * (per_word - rem))) & _U32)
        else:
            out[i] = zero
    return tuple(out)


def revcomp_key_words(words: tuple, k: int) -> tuple:
    """Reverse complement of left-justified 2-bit key words (k <= 16 * W
    bases): complement, reverse the fields of the whole 32W-bit container,
    shift the k fields back to the left, clear the rest."""
    W = len(words)
    rev = [_reverse_2bit_fields(~words[W - 1 - i] & _U32) for i in range(W)]
    return _justify(rev, k, BASES_PER_WORD2)


def revcomp_key_words4(words: tuple, k: int) -> tuple:
    """Reverse complement of left-justified 4-bit (IUPAC) key words: rank
    complement a nibble, 4-bit field reversal of the container, shift back,
    clear past k. Full-length k-mers only (no '$' within the k fields)."""
    W = len(words)
    rev = [_reverse_4bit_fields(_complement_nibbles(words[W - 1 - i])) for i in range(W)]
    return _justify(rev, k, BASES_PER_WORD)


def revcomp_words_any(words: tuple, k: int, two_bit: bool) -> tuple:
    return revcomp_key_words(words, k) if two_bit else revcomp_key_words4(words, k)


def _min_words(a: tuple, b: tuple) -> tuple:
    """Row-wise lexicographic min of two word tuples."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(lt)
    for wa, wb in zip(a, b):
        lt |= eq & (wa < wb)
        eq &= wa == wb
    return tuple(torch.where(lt, wa, wb) for wa, wb in zip(a, b))


def canonical_words(fwd: tuple, k: int, two_bit: bool) -> tuple:
    """min(forward, reverse complement) of full-length k-mer key words
    (int64 lanes of uint32 values, 2-bit or 4-bit)."""
    return _min_words(revcomp_words_any(fwd, k, two_bit), fwd)


def canonical_key_words(packed2, positions, k: int) -> tuple:
    """min(forward key, revcomp key) of each position as 2-bit words (int64
    lanes of uint32 values). Positions must have at least k bases left."""
    n_words = -(-k // BASES_PER_WORD2)
    cap = torch.full_like(positions, k)
    fwd = tuple(widen_u32(w) for w in build_key2_words(packed2, positions, cap, n_words))
    return canonical_words(fwd, k, True)


def _adjacent_boundary(lanes) -> torch.Tensor:
    """boundary[i]: row i differs from row i-1 in some lane; row 0 True."""
    boundary = torch.zeros(lanes[0].shape[0], dtype=torch.bool, device=lanes[0].device)
    for lane in lanes:
        boundary[1:] |= lane[1:] != lane[:-1]
    boundary[:1] = True
    return boundary


def _canonical_sizes_tail(lead, fwd, k: int, two_bit: bool = True):
    """Fold forward key words to canonical ones, sort the rows by (lead,
    canonical words) and reduce to (group sizes, qualifying mask, total).
    ``lead`` is 1 on rows that are not full-length k-mers (their words are
    0): they sort after every real row and never qualify. Only sizes leave,
    so the order within a group does not matter; on 4-bit lanes the row
    number rides as the last lane, the unique lane the lane sort needs."""
    words = canonical_words(fwd, k, two_bit)
    if two_bit:
        per_word = BASES_PER_WORD2
        last_bits = 2 * (k - per_word * (len(words) - 1))
        lanes = [(lead, 1)] + [(w, 32) for w in words[:-1]]
        lanes.append((words[-1] >> (32 - last_bits), last_bits))
        chunks, widths = _pack_chunks(lanes)
        del lanes, words
        perm = None
        for chunk in reversed(chunks):
            vals, idx = torch.sort(chunk if perm is None else chunk[perm], stable=True)
            perm = idx if perm is None else perm[idx]
        keys = [vals] + [c[perm] for c in chunks[1:]]
        s_lead = keys[0] >> (widths[0] - 1)
    else:
        n = lead.shape[0]
        if n <= 1 << 31:
            iota = torch.arange(n, dtype=torch.int32, device=lead.device)
        else:
            iota = u32_bits_as_int32(torch.arange(n, dtype=torch.int64, device=lead.device))
        res = sort_lanes_cuda(
            (lead.to(torch.int32),) + tuple(u32_bits_as_int32(w) for w in words) + (iota,)
        )
        keys, s_lead = res[:-1], res[0]
    boundary = _adjacent_boundary(keys)
    size = group_sizes_at_boundaries(boundary)
    qualifies = boundary & (s_lead == 0)
    return size, qualifies, int(torch.where(qualifies, size, 0).sum())


def canonical_sizes_digest(packed2, positions, valid_len, k: int):
    """Canonical group sizes, qualifying mask and total over the given
    positions (2-bit keys). Rows with fewer than k bases left carry the
    leading invalid lane with zeroed words and are excluded."""
    valid = valid_len >= k
    cap = torch.where(valid, k, 0)
    fwd = build_key2_words(packed2, positions, cap, -(-k // BASES_PER_WORD2))
    return _canonical_sizes_tail(
        (~valid).to(torch.int64), tuple(widen_u32(w) for w in fwd), k
    )


def canonical_sizes_digest4(packed, positions, valid_len, k: int):
    """The 4-bit (IUPAC) variant of ``canonical_sizes_digest``."""
    valid = valid_len >= k
    cap = torch.where(valid, k, 0)
    fwd = build_key_words(packed, positions, cap, -(-k // BASES_PER_WORD))
    return _canonical_sizes_tail(
        (~valid).to(torch.int64), tuple(widen_u32(w) for w in fwd), k, two_bit=False
    )


def canonical_sizes_digest_dense(packed2, seg_starts, seg_ends, min_kmer_len: int, k: int,
                                 two_bit: bool = True):
    """``canonical_sizes_digest`` over the fresh index (every position with
    valid_len >= min_kmer_len) without a gather: the forward words of every
    SBA position are shifted slices of the pack and valid_len comes from the
    segment table. ``packed2`` is the 2-bit pack when ``two_bit``, else the
    4-bit pack (the parameter keeps the JAX package's name). Rows that are
    not full-length k-mer starts of the index (separators, short tails)
    carry the invalid lane with zeroed words."""
    length = packed2.shape[0]
    vl = valid_len_all(seg_starts, seg_ends, length)
    valid = vl >= max(k, min_kmer_len)
    del vl
    cap = torch.where(valid, k, 0)
    if two_bit:
        fwd = build_key2_words_dense(packed2, cap, -(-k // BASES_PER_WORD2))
    else:
        fwd = tuple(widen_u32(w)
                    for w in build_key_words_dense(packed2, cap, -(-k // BASES_PER_WORD)))
    del cap
    return _canonical_sizes_tail((~valid).to(torch.int64), fwd, k, two_bit=two_bit)


def canonical_sort(packed2, positions, k: int):
    """Sort positions by canonical key, ties by position (an explicit last
    key, so any input order works): (sorted positions, sorted words)."""
    words = canonical_key_words(packed2, positions, k)
    res = sort_lanes_cuda(tuple(u32_bits_as_int32(w) for w in words)
                          + (u32_bits_as_int32(positions),))
    return widen_u32(res[-1]), tuple(widen_u32(w) for w in res[:-1])


def canonical_boundaries(sorted_words: tuple) -> torch.Tensor:
    """Group-boundary mask over canonically sorted key words."""
    return _adjacent_boundary(sorted_words)
