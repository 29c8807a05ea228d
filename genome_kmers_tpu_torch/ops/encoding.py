"""Base encodings for the PyTorch k-mer engine (host tables).

Counterpart of ``genome_kmers_tpu/ops/encoding.py``. The 15 IUPAC codes
and the '$' record separator are 16 symbols whose ASCII order

    $ < A < B < C < D < G < H < K < M < N < R < S < T < V < W < Y

is the comparison order of k-mers, so each byte maps to a 4-bit rank
('$' 0, A 1, ... Y 15) and 8 ranks pack big-endian into one uint32 word:
unsigned comparison of packed words is byte-wise lexicographic comparison
of the bases, and rank 0 past a segment end gives "the shorter of two equal
prefixes is smaller" for free.

On an ACGT genome each base maps to a 2-bit rank (A0 C1 G2 T3) instead and
16 ranks pack into one word. With rank(A) = 0, zero padding past a segment
end looks like a run of As, so the 2-bit sort carries the compare cap as an
explicit key lane (see ops/sort.py).
"""

from __future__ import annotations

import numpy as np

from ..native import reverse_complement_native

# IUPAC complement, as a 256-entry byte-to-byte table so reverse complement
# is a flip plus one table gather.
COMPLEMENT_PAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W",
    "K": "M", "M": "K", "B": "V", "D": "H",
    "H": "D", "V": "B", "N": "N", "$": "$",
}
COMPLEMENT_TABLE = np.zeros(256, dtype=np.uint8)
for _k, _v in COMPLEMENT_PAIRS.items():
    COMPLEMENT_TABLE[ord(_k)] = ord(_v)

# The 16 allowed symbols in ASCII (== comparison) order.
ALLOWED_CHARS = "$ABCDGHKMNRSTVWY"

# uint8 byte -> 4-bit rank. Other bytes map to 0; SequenceCollection rejects
# them, so they never reach the device.
RANK_TABLE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(ALLOWED_CHARS):
    RANK_TABLE[ord(_c)] = _i

# 4-bit rank -> uint8 byte (the strided decodes of ops/large.py).
UNRANK_TABLE = np.frombuffer(ALLOWED_CHARS.encode(), dtype=np.uint8).copy()

BASES_PER_WORD = 8  # 8 nibbles per uint32

# NIBBLE_MASKS[r] keeps the top r nibbles of a packed word (r in [0, 8]).
NIBBLE_MASKS = np.zeros(9, dtype=np.uint32)
for _r in range(9):
    NIBBLE_MASKS[_r] = (0xFFFFFFFF << (4 * (8 - _r))) & 0xFFFFFFFF if _r else 0

# uint8 byte -> 2-bit rank; every other byte ('$', 'N', ...) maps to 0.
RANK2_TABLE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    RANK2_TABLE[ord(_c)] = _i

BASES_PER_WORD2 = 16  # 16 2-bit fields per uint32

# DIBIT_MASKS[r] keeps the top r 2-bit fields of a packed word (r in [0, 16]).
DIBIT_MASKS = np.zeros(17, dtype=np.uint32)
for _r in range(17):
    DIBIT_MASKS[_r] = (0xFFFFFFFF << (2 * (16 - _r))) & 0xFFFFFFFF if _r else 0


_QUERY_COMP_TABLE = str.maketrans({_k: _v for _k, _v in COMPLEMENT_PAIRS.items() if _k != "$"})
_QUERY_ALLOWED = frozenset(COMPLEMENT_PAIRS) - {"$"}


def iupac_revcomp_strs(queries) -> list[str]:
    """Reverse complements of uppercase IUPAC query strings. Raises
    ValueError on any non-IUPAC character."""
    out = []
    for q in queries:
        if set(q) - _QUERY_ALLOWED:
            raise ValueError(f"canonical queries must be uppercase IUPAC: '{q}'")
        out.append(q.translate(_QUERY_COMP_TABLE)[::-1])
    return out


def reverse_complement_bytes(sba: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII SBA: one native scan from 2^16 bytes
    on, below that (and as its plain version) a table gather and a flip."""
    if sba.size >= 1 << 16:
        return reverse_complement_native(sba, COMPLEMENT_TABLE)
    return COMPLEMENT_TABLE[sba][::-1].copy()


def pack_rank_words_np(sba: np.ndarray) -> np.ndarray:
    """Host (NumPy) 4-bit pack: P[i] = ranks of bytes i..i+7 packed
    big-endian into a uint32; positions past the end of the array pack as
    rank 0, as '$' does. Equal to ``ops/keys.pack_rank_words``."""
    n = len(sba)
    padded = np.zeros(n + BASES_PER_WORD - 1, dtype=np.uint32)
    padded[:n] = RANK_TABLE[sba]
    out = np.zeros(n, dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        out |= padded[j : j + n] << np.uint32(4 * (BASES_PER_WORD - 1 - j))
    return out
