"""K-mer key construction on torch tensors.

Counterpart of ``genome_kmers_tpu/ops/keys.py``. A k-mer is identified by
its start position in the SBA; its sort key is the ranks of its bases,
zeroed at and past its compare cap (min(valid_len, k)): 2-bit ranks, 16 to
a word, on an ACGT genome, else 4-bit ranks, 8 to a word.

Conventions: torch's unsigned types do not support shifts, compares,
``where``, ``cummax``, ``scatter_reduce`` or ``searchsorted``, and int32
shifts are arithmetic. So a uint32 word is held in one of two forms:

* an **int32 bit pattern** (4 bytes a row): the packs, every key word this
  module builds, and the lanes the multi-lane sort takes and returns.
  Masking and equality are right on bit patterns; order and shifts are not.
* an **int64 lane holding the uint32 value**: what the 2-bit dense sort
  works on, because it shifts and compares. ``widen_u32`` goes from the
  first form to the second, ``u32_bits_as_int32`` back.

Positions, lengths and caps are int64 tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .encoding import (
    BASES_PER_WORD,
    BASES_PER_WORD2,
    DIBIT_MASKS,
    NIBBLE_MASKS,
    RANK2_TABLE,
    RANK_TABLE,
)

_U32 = 0xFFFFFFFF


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 lane holding the uint32 values of an int32 bit-pattern tensor."""
    return x.to(torch.int64) & _U32


def keep_mask(k: int, w_idx: int, bases_per_word: int, bits: int) -> int:
    """Bit mask keeping the fields of key word ``w_idx`` below base count
    ``k`` (fields are big-endian within the word)."""
    keep = min(max(k - w_idx * bases_per_word, 0), bases_per_word)
    return 0 if keep == 0 else (_U32 << (32 - bits * keep)) & _U32


def u32_bits_as_int32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the bit pattern of int64 values in [0, 2**32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


@functools.cache
def _mask_table(per_word: int, device: torch.device) -> torch.Tensor:
    """The mask table of words of ``per_word`` fields (DIBIT_MASKS or
    NIBBLE_MASKS) as int32 bit patterns on ``device``, uploaded once: an
    upload from pageable memory waits for the device, which a loop of key
    builds (the query search) must not do every round."""
    masks = DIBIT_MASKS if per_word == BASES_PER_WORD2 else NIBBLE_MASKS
    return torch.as_tensor(masks.view(np.int32), device=device)


def ascii_to_ranks(sba_u8: torch.Tensor) -> torch.Tensor:
    """The 4-bit ranks (uint8) of ASCII bytes."""
    return torch.as_tensor(RANK_TABLE, device=sba_u8.device)[sba_u8.to(torch.int64)]


def _pack_ranks(sba_u8: torch.Tensor, rank_table: np.ndarray, per_word: int) -> torch.Tensor:
    """out[i] = ranks of bytes i..i+per_word-1, packed big-endian into a
    uint32 (32 // per_word bits a rank), as its int32 bit pattern; positions
    past the end of the array rank 0."""
    n = sba_u8.shape[0]
    bits = 32 // per_word
    table = torch.as_tensor(rank_table, device=sba_u8.device).to(torch.int64)
    padded = torch.zeros(n + per_word - 1, dtype=torch.int64, device=sba_u8.device)
    padded[:n] = table[sba_u8.to(torch.int64)]
    out = torch.zeros(n, dtype=torch.int64, device=sba_u8.device)
    for j in range(per_word):
        out |= padded[j : j + n] << (bits * (per_word - 1 - j))
    return u32_bits_as_int32(out)


def pack_rank2_words(sba_u8: torch.Tensor) -> torch.Tensor:
    """P2[i] = 2-bit ranks of bytes i..i+15, packed big-endian into a uint32
    (returned as its int32 bit pattern). Bytes other than ACGT rank 0, and
    positions past the end of the array read 0.

    The plain version of the CUDA kernel ``kernels/pack2.py``, which must be
    bit-identical to it at every position."""
    return _pack_ranks(sba_u8, RANK2_TABLE, BASES_PER_WORD2)


def pack_rank_words(sba_u8: torch.Tensor) -> torch.Tensor:
    """P[i] = 4-bit ranks of bytes i..i+7, nibble-packed big-endian into a
    uint32 (returned as its int32 bit pattern); positions past the end of
    the array pack as 0, like '$'."""
    return _pack_ranks(sba_u8, RANK_TABLE, BASES_PER_WORD)


def compute_seg_ends(seg_starts: torch.Tensor, sba_len: int) -> torch.Tensor:
    """Per-segment inclusive end index: seg_ends[i] = seg_starts[i+1] - 2
    (skipping the '$'); the last segment ends at sba_len - 1."""
    last = seg_starts.new_full((1,), sba_len - 1)
    return torch.cat([seg_starts[1:] - 2, last])


def segment_ids_for_positions(positions: torch.Tensor, seg_starts: torch.Tensor) -> torch.Tensor:
    """Batched segment lookup: searchsorted(seg_starts, pos, 'right') - 1."""
    return torch.searchsorted(seg_starts, positions, right=True) - 1


def compute_valid_len(
    positions: torch.Tensor, seg_starts: torch.Tensor, seg_ends: torch.Tensor
) -> torch.Tensor:
    """Number of real bases from each position to the end of its segment:
    seg_end(segment containing p) - p + 1."""
    seg_ids = segment_ids_for_positions(positions, seg_starts)
    return seg_ends[seg_ids] - positions + 1


def valid_len_all(seg_starts: torch.Tensor, seg_ends: torch.Tensor, length: int) -> torch.Tensor:
    """valid_len for EVERY position 0..length-1: ``compute_valid_len`` over
    all positions, where a '$' separator (seg_end + 1 of its segment) lands
    at 0.

    The JAX package forward-fills a scatter of the segment ends with
    ``lax.cummax`` to avoid a TPU gather. On an H100 80GB HBM3 (700 W limit),
    ``torch.cummax`` over 2^27 int64 rows took 390 ms (a generic scan that also carries indices),
    while a binary search of the few segment starts is one elementwise
    pass."""
    iota = torch.arange(length, dtype=torch.int64, device=seg_starts.device)
    return compute_valid_len(iota, seg_starts, seg_ends)


def cap_lengths(valid_len: torch.Tensor, max_kmer_len) -> torch.Tensor:
    """min(valid_len, max_kmer_len), with max_kmer_len=None meaning unbounded."""
    if max_kmer_len is None:
        return valid_len
    return torch.clamp_max(valid_len, max_kmer_len)


# --------------------------------------------------------------------------- #
# dense key builds: key words for EVERY position 0..L-1 at once. Word w of
# position p is the pack at p + per_word * w, a shifted slice and no gather.
# --------------------------------------------------------------------------- #


def _dense_words(packed: torch.Tensor, cap_len, n_words: int, per_word: int):
    """int32 bit-pattern key words for every position of the int32 pack,
    zero past its end, with the fields at and past ``cap_len`` zeroed."""
    length = packed.shape[0]
    masks = _mask_table(per_word, packed.device)
    words = []
    for w in range(n_words):
        off = per_word * w
        word = torch.zeros(length, dtype=torch.int32, device=packed.device)
        word[: max(length - off, 0)] = packed[off:]
        keep = torch.clamp(cap_len - off, 0, per_word)
        words.append(word & masks[keep])
    return tuple(words)


def build_key2_words_dense(packed2: torch.Tensor, cap_len, n_words: int):
    """2-bit key words for every position 0..L-1, as int64 lanes of uint32
    values (the dense 2-bit sort shifts and compares them)."""
    words = _dense_words(packed2, cap_len, n_words, BASES_PER_WORD2)
    return tuple(widen_u32(w) for w in words)


def build_key_words_dense(packed: torch.Tensor, cap_len, n_words: int):
    """4-bit key words for every position 0..L-1, as int32 bit patterns.
    Equal to ``build_key_words(packed, arange(L), cap_len, n_words)``."""
    return _dense_words(packed, cap_len, n_words, BASES_PER_WORD)


# --------------------------------------------------------------------------- #
# gathered key builds: key words for an arbitrary set of positions
# --------------------------------------------------------------------------- #


def _gathered_words(packed, positions, cap_len, n_words: int, offset: int, per_word: int):
    """int32 bit-pattern key words per position: word w covers the bases
    [offset + per_word * w, offset + per_word * (w + 1)) from the position,
    read from the pack with the index clipped to its last entry, and the
    fields at and past ``cap_len`` bases from the position zeroed."""
    masks = _mask_table(per_word, packed.device)
    last = packed.shape[0] - 1
    words = []
    for w in range(n_words):
        off = offset + per_word * w
        word = packed[torch.clamp_max(positions + off, last)]
        keep = torch.clamp(cap_len - off, 0, per_word)
        words.append(word & masks[keep])
    return tuple(words)


def build_key_words(packed, positions, cap_len, n_words: int, offset: int = 0):
    """``n_words`` 4-bit key words for each position (int32 bit patterns).
    Nibbles at or beyond ``cap_len`` are zero, so comparison ends exactly
    where the k-mer does."""
    return _gathered_words(packed, positions, cap_len, n_words, offset, BASES_PER_WORD)


def build_key2_words(packed2, positions, cap_len, n_words: int, offset: int = 0):
    """``n_words`` 2-bit key words for each position (int32 bit patterns);
    the cap itself must ride as a separate key lane."""
    return _gathered_words(packed2, positions, cap_len, n_words, offset, BASES_PER_WORD2)


# --------------------------------------------------------------------------- #
# strided-pack expansion: per-position words from a host-built strided pack
# (ops/large.pack_rank{2,}_strided_np), which is 1/4 (2-bit) or 1/2 (4-bit)
# the bytes of the SBA, so uploading it instead of the bytes cuts the
# host-to-device copy accordingly. A funnel shift of two adjacent words:
# out[i] = S[i / bpw] << r | S[i / bpw + 1] >> (32 - r).
# --------------------------------------------------------------------------- #


_EXPAND_STEP = 1 << 24  # positions a step of the expansion: int64 temporaries of 256 MB


def _expand_strided(packed_s: torch.Tensor, n: int, per_word: int) -> torch.Tensor:
    """``n`` per-position words (int32 bit patterns) from a strided pack
    of int32 bit patterns, ``per_word`` bases a word. A step of words, seen
    as ``(words, per_word)`` positions, is one broadcast of the words
    against the field offsets; the shifts are done in int64 and the result
    is cut to its low 32 bits by a shift up and an arithmetic shift down,
    which leaves the int32 bit pattern. Steps of ``_EXPAND_STEP``
    positions bound the int64 temporaries."""
    nw = -(-n // per_word)
    if packed_s.shape[0] < nw + 1:
        raise ValueError(
            f"a strided pack of {n} bases needs {nw + 1} words (a trailing zero word), "
            f"got {packed_s.shape[0]}"
        )
    sh = torch.arange(per_word, dtype=torch.int64, device=packed_s.device) * (32 // per_word)
    out = torch.empty(n, dtype=torch.int32, device=packed_s.device)
    step = _EXPAND_STEP // per_word
    for w0 in range(0, nw, step):
        w1 = min(w0 + step, nw)
        word = widen_u32(packed_s[w0:w1]).unsqueeze(1) << sh
        # b >> 32 is 0 for a uint32 value: no special case at sh == 0
        word |= widen_u32(packed_s[w0 + 1 : w1 + 1]).unsqueeze(1) >> (32 - sh)
        word <<= 32
        word >>= 32
        p0, p1 = w0 * per_word, min(w1 * per_word, n)
        out[p0:p1] = word.reshape(-1)[: p1 - p0]
    return out


def expand_strided2(packed2_s: torch.Tensor, n: int) -> torch.Tensor:
    """Per-position 2-bit words from a strided pack (16 bases a word):
    bit-identical to ``pack_rank2_words`` of the original bytes, zero ranks
    past ``n`` included, which the pack's trailing zero word (the host
    packers append 8) gives. Plain tensor ops, as the JAX package computes
    the expansion outside any kernel."""
    return _expand_strided(packed2_s, n, BASES_PER_WORD2)


def expand_strided4(packed_s: torch.Tensor, n: int) -> torch.Tensor:
    """Per-position 4-bit words from a strided pack (8 bases a word):
    bit-identical to ``pack_rank_words`` of the original bytes (the same
    trailing-zero-word requirement)."""
    return _expand_strided(packed_s, n, BASES_PER_WORD)
