"""K-mer key construction on torch tensors.

Counterpart of ``genome_kmers_tpu/ops/keys.py`` for the 2-bit path. A k-mer
is identified by its start position in the SBA; its sort key is the 2-bit
ranks of its bases, zeroed at and past its compare cap (min(valid_len, k)).

Conventions: torch's unsigned types do not support shifts, compares,
``where``, ``cummax``, ``scatter_reduce`` or ``searchsorted``, and int32
shifts are arithmetic, so key lanes are int64 tensors holding uint32 values.
The 2-bit pack itself is an int32 tensor holding the uint32 bit pattern
(4 bytes a position); ``widen_u32`` turns it into such an int64 lane before
any shift or compare.
"""

from __future__ import annotations

import torch

from .encoding import BASES_PER_WORD2, DIBIT_MASKS, RANK2_TABLE

_U32 = 0xFFFFFFFF


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 lane holding the uint32 values of an int32 bit-pattern tensor."""
    return x.to(torch.int64) & _U32


def u32_bits_as_int32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding the bit pattern of int64 values in [0, 2**32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_rank2_words(sba_u8: torch.Tensor) -> torch.Tensor:
    """P2[i] = 2-bit ranks of bytes i..i+15, packed big-endian into a uint32
    (returned as its int32 bit pattern). Bytes other than ACGT rank 0, and
    positions past the end of the array read 0.

    The plain version of the CUDA kernel ``kernels/pack2.py``, which must be
    bit-identical to it at every position."""
    n = sba_u8.shape[0]
    table = torch.as_tensor(RANK2_TABLE, device=sba_u8.device).to(torch.int64)
    padded = torch.zeros(n + BASES_PER_WORD2 - 1, dtype=torch.int64, device=sba_u8.device)
    padded[:n] = table[sba_u8.to(torch.int64)]
    out = torch.zeros(n, dtype=torch.int64, device=sba_u8.device)
    for j in range(BASES_PER_WORD2):
        out |= padded[j : j + n] << (2 * (BASES_PER_WORD2 - 1 - j))
    return u32_bits_as_int32(out)


def compute_seg_ends(seg_starts: torch.Tensor, sba_len: int) -> torch.Tensor:
    """Per-segment inclusive end index: seg_ends[i] = seg_starts[i+1] - 2
    (skipping the '$'); the last segment ends at sba_len - 1."""
    last = seg_starts.new_full((1,), sba_len - 1)
    return torch.cat([seg_starts[1:] - 2, last])


def compute_valid_len(
    positions: torch.Tensor, seg_starts: torch.Tensor, seg_ends: torch.Tensor
) -> torch.Tensor:
    """Number of real bases from each position to the end of its segment:
    seg_end(segment containing p) - p + 1."""
    seg_ids = torch.searchsorted(seg_starts, positions, right=True) - 1
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


def build_key2_words_dense(packed2: torch.Tensor, cap_len: torch.Tensor, n_words: int):
    """2-bit key words (int64 lanes of uint32 values) for every position
    0..L-1 of the int32 2-bit pack: word w of position p is the pack at
    p + 16w (0 past the end), a shifted slice and no gather, with the fields
    at and past ``cap_len`` zeroed."""
    length = packed2.shape[0]
    masks = torch.as_tensor(DIBIT_MASKS.astype("int64"), device=packed2.device)
    words = []
    for w in range(n_words):
        off = BASES_PER_WORD2 * w
        word = torch.zeros(length, dtype=torch.int64, device=packed2.device)
        word[: max(length - off, 0)] = widen_u32(packed2[off:])
        keep = torch.clamp(cap_len - off, 0, BASES_PER_WORD2)
        words.append(word & masks[keep])
    return tuple(words)
