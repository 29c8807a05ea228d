"""64-bit building blocks of the large regime: strided packs and key words.

Counterpart of ``genome_kmers_tpu/ops/large.py``. Past about 2 Gbp the flat
per-position pack (one uint32 word a base, ``ops/keys.py``) no longer fits,
so ``LargeKmers`` holds its genome as a **strided pack**: one uint32 word a
16 bases (2-bit ranks) or a 8 bases (4-bit ranks), big-endian, 0.25 or 0.5
bytes a base. The key words of a position are rebuilt from two adjacent
words by a funnel shift.

Positions are int64 tensors (the JAX package carries them as (hi, lo)
uint32 pairs because a TPU has no 64-bit integers; its pair arithmetic is
not carried over). Pack words are uint32 bit patterns held in int32 tensors
(``ops/keys.py``); shifts are done in int64 and masked to 32 bits.

The packs are built on the host: ``pack_rank2_strided_np`` /
``pack_rank_strided_np`` call the native library (``native/``), whose
failure raises; ``pack_strided_plain`` is their plain NumPy version, for
the tests and for nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoding import (
    BASES_PER_WORD,
    BASES_PER_WORD2,
    RANK2_TABLE,
    RANK_TABLE,
    UNRANK_TABLE,
)
from .keys import _mask_table, u32_bits_as_int32, widen_u32

# Saturation of a valid length, as the JAX package's uint32 caps saturate
# (its keys.NO_CAP): caps are only compared with lengths below it, or with
# each other in the refinement rounds, where the JAX order is kept.
NO_CAP = 0xFFFFFFF0
_CHUNK = 1 << 26  # bases a chunk of the plain pack


def pack_strided_plain(sba_u8: np.ndarray, bases_per_word: int, bits: int,
                       table: np.ndarray, extra_words: int) -> np.ndarray:
    """The plain version of the native strided pack: word w holds the ranks
    of bases ``w * bases_per_word ..`` big-endian (the first base in the
    top field), ranks past the end 0, then ``extra_words`` zero words."""
    n = len(sba_u8)
    n_words = -(-n // bases_per_word)
    out = np.zeros(n_words + extra_words, dtype=np.uint32)
    shift_top = 32 - bits
    for c0 in range(0, n, _CHUNK):
        c1 = min(c0 + _CHUNK, n)
        # chunks start on word boundaries: _CHUNK is a multiple of both widths
        ranks = table[sba_u8[c0:c1]].astype(np.uint32)
        pad = (-len(ranks)) % bases_per_word
        if pad:
            ranks = np.concatenate([ranks, np.zeros(pad, dtype=np.uint32)])
        grid = ranks.reshape(-1, bases_per_word)
        word = np.zeros(grid.shape[0], dtype=np.uint32)
        for j in range(bases_per_word):
            word |= grid[:, j] << np.uint32(shift_top - bits * j)
        out[c0 // bases_per_word : c0 // bases_per_word + len(word)] = word
    return out


def pack_rank2_strided_np(sba_u8: np.ndarray, extra_words: int = 8) -> np.ndarray:
    """S2[w] = 2-bit ranks of bases 16w..16w+15, big-endian, plus
    ``extra_words`` trailing zero words so that funnel shifts at the edge
    read rank 0. Built by the native library."""
    from ..native import pack_strided_native

    return pack_strided_native(sba_u8, RANK2_TABLE, 2, extra_words)


def pack_rank_strided_np(sba_u8: np.ndarray, extra_words: int = 8) -> np.ndarray:
    """S[w] = 4-bit ranks of bases 8w..8w+7, big-endian, zero tail. Built
    by the native library."""
    from ..native import pack_strided_native

    return pack_strided_native(sba_u8, RANK_TABLE, 4, extra_words)


def _funnel_words(packed_s, positions, cap_len, n_words: int, offset, per_word: int):
    """Key words (int32 bit patterns) of int64 ``positions`` from a strided
    pack (int32 words): word w covers bases ``[offset + per_word * w,
    offset + per_word * (w + 1))`` from each position, the fields at and
    past ``cap_len`` bases zeroed (the comparison ends where the k-mer
    does). ``offset`` is a Python int or a 0-dim tensor. Word indices are
    clipped to the pack, as the JAX package's gathers clip."""
    bits = 32 // per_word
    log2 = per_word.bit_length() - 1
    last = packed_s.shape[0] - 1
    masks = _mask_table(per_word, packed_s.device)
    words = []
    for w in range(n_words):
        off = offset + per_word * w
        base = positions + off
        widx = torch.clamp(base >> log2, 0, last)
        a = widen_u32(packed_s[widx])
        b = widen_u32(packed_s[torch.clamp_max(widx + 1, last)])
        sh = (base & (per_word - 1)) * bits
        # b >> 32 is 0 for a uint32 value: no special case at sh == 0
        word = ((a << sh) | (b >> (32 - sh))) & 0xFFFFFFFF
        keep = torch.clamp(cap_len - off, 0, per_word)
        words.append(u32_bits_as_int32(word) & masks[keep])
    return tuple(words)


def build_key2_words_strided(packed2_s, positions, cap_len, n_words: int, offset=0):
    """2-bit key words from the strided pack (16 bases a word); the cap
    must ride as its own sort lane, since rank 0 is a base here."""
    return _funnel_words(packed2_s, positions, cap_len, n_words, offset, BASES_PER_WORD2)


def build_key_words_strided(packed_s, positions, cap_len, n_words: int, offset=0):
    """4-bit key words from the strided pack (8 bases a word)."""
    return _funnel_words(packed_s, positions, cap_len, n_words, offset, BASES_PER_WORD)


def _fields(packed_words: np.ndarray, p: np.ndarray, two_bit: bool) -> np.ndarray:
    """ASCII bytes of the bases at uint64 positions ``p`` of a strided
    pack; reads past the last word hit the zero tail."""
    bpw = 16 if two_bit else 8
    bits = 2 if two_bit else 4
    lut = np.frombuffer(b"ACGT", dtype=np.uint8) if two_bit else UNRANK_TABLE
    w = packed_words[np.minimum(p // np.uint64(bpw), np.uint64(len(packed_words) - 1)).astype(np.int64)]
    sh = ((np.uint64(bpw - 1) - (p % np.uint64(bpw))) * np.uint64(bits)).astype(np.uint32)
    return lut[(w >> sh) & np.uint32((1 << bits) - 1)]


def decode_strided_np(packed_words: np.ndarray, positions_u64, length: int,
                      two_bit: bool) -> np.ndarray:
    """(n, length) ASCII byte matrix decoded from a strided pack at each
    uint64 position (the string path of the large regime, where no byte
    SBA exists). Callers bounds-check first."""
    pos = np.asarray(positions_u64, dtype=np.uint64)
    out = np.empty((len(pos), length), dtype=np.uint8)
    for j in range(length):
        out[:, j] = _fields(packed_words, pos + np.uint64(j), two_bit)
    return out


def decode_strided_var_np(packed_words: np.ndarray, positions_u64, lens,
                          two_bit: bool) -> tuple[np.ndarray, np.ndarray]:
    """Variable-width decode: ``(data, offsets)`` with ``data[offsets[r] :
    offsets[r + 1]]`` the ASCII bases at ``positions[r] ..
    positions[r] + lens[r] - 1``, an arrow-style string column."""
    pos = np.asarray(positions_u64, dtype=np.uint64)
    L = np.asarray(lens, dtype=np.int64)
    offsets = np.zeros(len(pos) + 1, dtype=np.int64)
    np.cumsum(L, out=offsets[1:])
    j = np.arange(int(offsets[-1]), dtype=np.uint64) - np.repeat(offsets[:-1].astype(np.uint64), L)
    return _fields(packed_words, np.repeat(pos, L) + j, two_bit), offsets


def build_dense_positions(seg_starts_u64, seg_ends_u64, min_kmer_len: int, device="cuda"):
    """Every k-mer start of the index (segment order) as an int64 tensor on
    ``device``, with no host position array: one iota and a
    ``searchsorted`` over the cumulative start counts. Returns
    ``(positions, n)``."""
    starts = np.asarray(seg_starts_u64, dtype=np.uint64).astype(np.int64)
    ends = np.asarray(seg_ends_u64, dtype=np.uint64).astype(np.int64)
    counts = (ends - starts + 1) - int(min_kmer_len) + 1
    if (counts < 1).any():
        raise ValueError(
            "every segment must hold at least one k-mer "
            "(min_kmer_len exceeds a segment length)"
        )
    n = int(counts.sum())
    cum_excl = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]), device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rec = torch.searchsorted(cum_excl, idx, right=True) - 1
    return torch.as_tensor(starts, device=device)[rec] + idx - cum_excl[rec], n


def compute_valid_len64(positions, seg_starts, seg_ends):
    """Bases from each int64 position to the end of its segment, saturated
    at ``NO_CAP`` (the JAX package's uint32 saturation); ``seg_starts`` /
    ``seg_ends`` int64 tensors. One ``torch.searchsorted`` on int64."""
    seg = torch.clamp_min(torch.searchsorted(seg_starts, positions, right=True) - 1, 0)
    return torch.clamp_max(seg_ends[seg] - positions + 1, NO_CAP)


def split64(positions: torch.Tensor) -> tuple:
    """int64 positions as the two int32 sort lanes (hi, lo) of their
    uint64 bit pattern: the lane sort compares them unsigned, so the pair
    sorts as the uint64 does (-1, a pad, last)."""
    return u32_bits_as_int32((positions >> 32) & 0xFFFFFFFF), u32_bits_as_int32(positions & 0xFFFFFFFF)


def fuse64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 of two int32 lanes (hi, lo): all-ones lanes give -1."""
    return (hi.to(torch.int64) << 32) | widen_u32(lo)
