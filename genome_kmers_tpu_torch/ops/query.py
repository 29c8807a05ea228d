"""Count queries against a sorted k-mer index.

Counterpart of ``genome_kmers_tpu/ops/query.py``. The query strings are
packed on the host into 4-bit (or 2-bit) rank words, all queries at once
through the rank table; the occurrences of each are the width of its range
in the sorted index, found by a lower and an upper bound search that runs
all queries together: ``ceil(log2 n) + 1`` rounds of torch ops driven from
the host, with no read back to the host inside. An index key is built only
where a round probes it (one gather a word), so no key array of the whole
index is made.

Query identity is ``get_kmers(kmer_len=L)`` group identity (an L-base
compare with the '$' ends-early rule), on the 4-bit key space, so any IUPAC
query works on any genome.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .encoding import RANK2_TABLE, RANK_TABLE
from .keys import build_key_words, widen_u32


def _query_bytes(queries, kmer_len: int, bad_rows):
    """(Q, kmer_len) uint8 matrix of the queries, after the first query
    (in order) whose length is not ``kmer_len`` has been reported. Every
    character outside ASCII becomes '?', a byte of no alphabet.

    ``bad_rows(matrix)`` flags the rows that raise a character error; the
    first query that is wrong raises, a wrong length before a character.
    Returns the matrix when no query raises."""
    lens = np.fromiter((len(q) for q in queries), dtype=np.int64, count=len(queries))
    wrong = np.flatnonzero(lens != kmer_len)
    head = len(queries) if wrong.size == 0 else int(wrong[0])
    text = "".join(queries[:head]).encode("ascii", errors="replace")
    mat = np.frombuffer(text, dtype=np.uint8).reshape(head, kmer_len)
    bad = bad_rows(mat)
    if bad is not None and bad.any():
        bad_q = queries[int(np.flatnonzero(bad)[0])]
        raise ValueError(f"query '{bad_q}' contains a non-IUPAC character")
    if wrong.size:
        q = queries[head]
        raise ValueError(f"query '{q}' length ({len(q)}) does not match kmer_len ({kmer_len})")
    return mat


def _pack_rows(ranks: np.ndarray, per_word: int) -> tuple:
    """Ranks (Q, k) packed big-endian, ``per_word`` to a uint32 word, the
    fields past k zero: a tuple of ceil(k / per_word) uint32 arrays."""
    q, k = ranks.shape
    n_words = -(-k // per_word)
    bits = 32 // per_word
    padded = np.zeros((q, n_words * per_word), dtype=np.uint32)
    padded[:, :k] = ranks
    fields = padded.reshape(q, n_words, per_word)
    shifts = np.arange(bits * (per_word - 1), -1, -bits, dtype=np.uint32)
    words = np.bitwise_or.reduce(fields << shifts, axis=2)
    return tuple(np.ascontiguousarray(words[:, w]) for w in range(n_words))


def encode_query_words(queries: list[str], kmer_len: int) -> tuple[np.ndarray, ...]:
    """Pack query strings into 4-bit rank words (uint32, 8 bases a word).
    Every query must have length ``kmer_len`` and only IUPAC characters."""
    mat = _query_bytes(queries, kmer_len, lambda m: (RANK_TABLE[m] == 0).any(axis=1))
    return _pack_rows(RANK_TABLE[mat], 8)


def encode_query2_words(queries: list[str], kmer_len: int):
    """Pack query strings into 2-bit rank words (uint32, 16 bases a word),
    the key space of the 2-bit packs. A query with a base other than ACGT
    cannot occur in an ACGT genome: its words are 0 and it is flagged.
    Returns ``(words_tuple, matchable_bool_array)``."""
    mat = _query_bytes(queries, kmer_len, lambda m: None)
    ok = np.isin(mat, np.frombuffer(b"ACGT", dtype=np.uint8)).all(axis=1)
    ranks = np.where(ok[:, None], RANK2_TABLE[mat], 0)
    return _pack_rows(ranks, 16), ok


def _lex_less(a: tuple, b: tuple) -> torch.Tensor:
    """a < b over tuples of int64 words holding uint32 values."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for wa, wb in zip(a, b):
        lt |= eq & (wa < wb)
        eq &= wa == wb
    return lt


def _bound_search(rows_at, q_key: tuple, n: int, n_rounds: int, upper: bool = False):
    """Lower (or upper) bound of every query key among ``n`` sorted rows:
    the first row whose key is >= (or >) the query, by ``n_rounds`` rounds
    of a binary search of all queries together. ``rows_at(indices)`` gives
    the keys of the sorted rows at ``indices`` as a tuple of int64 lanes,
    in the form of ``q_key`` (uint32 words as their values): a round reads
    one row a query, so no key of the whole index is built."""
    lo = torch.zeros(q_key[0].shape[0], dtype=torch.int64, device=q_key[0].device)
    hi = torch.full_like(lo, n)
    if n == 0:
        return lo
    for _ in range(n_rounds):
        active = lo < hi
        mid = (lo + hi) >> 1
        key = rows_at(torch.clamp_max(mid, n - 1))
        # move right while key[mid] <= query (upper) or key[mid] < query
        go_right = ~_lex_less(q_key, key) if upper else _lex_less(key, q_key)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def count_queries(packed, sorted_positions, cap_len, q_words: tuple, kmer_len: int) -> np.ndarray:
    """Occurrences of each query k-mer (uint32 array, one a query).

    ``packed`` is the 4-bit pack, ``sorted_positions`` the sorted index and
    ``cap_len`` its caps at ``kmer_len`` (min(valid_len, kmer_len)), so
    index keys compare as ``get_compare_sba_kmers_func(kmer_len)`` does.
    ``q_words`` are the uint32 arrays of ``encode_query_words``."""
    n = sorted_positions.shape[0]
    nq = q_words[0].shape[0]
    if n == 0:
        return np.zeros(nq, dtype=np.uint32)
    if n >= 2**31:
        raise NotImplementedError("count_queries supports indexes up to 2^31 entries")
    n_words = -(-kmer_len // 8)
    n_rounds = max(1, math.ceil(math.log2(n)) + 1)
    dev = sorted_positions.device
    q = tuple(torch.from_numpy(w.astype(np.int64)).to(dev) for w in q_words)

    def rows_at(probe):
        words = build_key_words(packed, sorted_positions[probe], cap_len[probe], n_words)
        return tuple(widen_u32(w) for w in words)

    lo = _bound_search(rows_at, q, n, n_rounds)
    hi = _bound_search(rows_at, q, n, n_rounds, upper=True)
    return (hi - lo).cpu().numpy().astype(np.uint32)
