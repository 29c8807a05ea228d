"""Count queries against a sharded sorted index.

Counterpart of ``genome_kmers_tpu/parallel/query.py``. The index is
globally sorted and cut into shards, possibly
ragged with trailing pads (the sample sort's layout), so a k-mer's count is
the sum of its per-shard counts: every shard runs the lower and upper bound
search of ops/query.py over its rows, with a pad flag as the leading key so
that the trailing pads compare above every query, and one ``psum`` adds the
shards' counts (over every rank of a process mesh: the counts come back the
same on each). ``distributed_count_queries_large`` searches a large index
(``LargeKmers``: a strided pack, int64 positions) in the key space of its
sort, 2-bit or 4-bit, and returns uint64 counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.keys import build_key_words, cap_lengths, compute_valid_len, widen_u32
from ..ops.query import _bound_search, encode_query2_words, encode_query_words
from .collectives import psum, replicate
from .sample_sort import strided_keys


def _local_counts(words_fn, positions, cap_len, is_pad, q_words: tuple, n_words: int,
                  n_rounds: int, cap_key: bool = False) -> torch.Tensor:
    """Occurrences of each query among one shard's sorted rows (int64):
    upper bound minus lower bound of the query in the key space (pad flag,
    the key words ``words_fn(positions, caps, n_words)``, and the cap where
    ``cap_key``: on 2-bit keys, whose rank 0 is a base, the sort's key ends
    with the cap), ``n_rounds`` rounds of a binary search of all queries
    together. ``q_words`` are int64 tensors of uint32 words on the shard's
    device, the query's cap last where ``cap_key``."""
    n = positions.shape[0]
    q_key = (torch.zeros_like(q_words[0]),) + q_words
    pad = is_pad.to(torch.int64)

    def rows_at(probe):
        words = words_fn(positions[probe], cap_len[probe], n_words)
        key = (pad[probe],) + tuple(widen_u32(w) for w in words)
        return key + (cap_len[probe],) if cap_key else key

    return (_bound_search(rows_at, q_key, n, n_rounds, upper=True)
            - _bound_search(rows_at, q_key, n, n_rounds))


def distributed_count_queries(
    packed,
    sorted_positions: list,
    is_pad: list,
    seg_starts,
    seg_ends,
    queries: list,
    kmer_len: int,
    mesh,
) -> np.ndarray:
    """Occurrence count (uint32) of each query string over a sharded sorted
    index (the ragged layout of ``sample_sort_positions_ragged`` or an
    evenly padded one), on the 4-bit key space ``packed``, so IUPAC
    genomes and queries work. Query identity is ``get_kmers(kmer_len)``
    group identity."""
    if not queries:
        return np.zeros(0, dtype=np.uint32)
    q_host = encode_query_words(queries, kmer_len)
    n_words = -(-kmer_len // 8)
    genome = replicate(packed, mesh)
    ss, se = replicate(seg_starts, mesh), replicate(seg_ends, mesh)
    counts = []
    for i, (pos, pad) in enumerate(zip(sorted_positions, is_pad)):
        dev = pos.device
        cap = cap_lengths(compute_valid_len(pos, ss[i], se[i]), kmer_len)
        cap = torch.where(pad, 0, cap)
        q = tuple(torch.from_numpy(w.astype(np.int64)).to(dev) for w in q_host)
        n_rounds = max(1, math.ceil(math.log2(max(pos.shape[0], 2))) + 1)
        words_fn = lambda pos, cap, n, g=genome[i]: build_key_words(g, pos, cap, n)  # noqa: E731
        counts.append(_local_counts(words_fn, pos, cap, pad, q, n_words, n_rounds))
    return psum(counts, mesh)[0].cpu().numpy().astype(np.uint32)


def distributed_count_queries_large(
    packed_strided,
    positions: list,
    is_pad: list,
    seg_starts_u64,
    seg_ends_u64,
    queries: list,
    kmer_len: int,
    mesh,
    two_bit: bool = True,
) -> np.ndarray:
    """Occurrence count (uint64) of each query string over a sorted large
    index (``sample_sort_positions_large_ragged``'s layout, or the
    refinement sort's), in the key space of its sort: 2-bit words and the
    cap when ``two_bit``, where a query with a base other than ACGT cannot
    occur and counts 0, else 4-bit words. Query identity is ``kmer_len``-base
    group identity."""
    if not queries:
        return np.zeros(0, dtype=np.uint64)
    if two_bit:
        q_host, matchable = encode_query2_words(queries, kmer_len)
    else:
        q_host, matchable = encode_query_words(queries, kmer_len), np.ones(len(queries), dtype=bool)
    keys = strided_keys(packed_strided, seg_starts_u64, seg_ends_u64, two_bit, mesh)
    n_words = -(-kmer_len // keys.per_word)
    counts = []
    for i, (pos, pad) in enumerate(zip(positions, is_pad)):
        dev = pos.device
        cap = torch.where(pad, 0, keys.caps(i, pos, kmer_len))
        q = tuple(torch.from_numpy(w.astype(np.int64)).to(dev) for w in q_host)
        if two_bit:
            q += (torch.full_like(q[0], kmer_len),)
        n_rounds = max(1, math.ceil(math.log2(max(pos.shape[0], 2))) + 1)
        words_fn = lambda x, c, n, i=i: keys.words(i, x, c, n)  # noqa: E731
        counts.append(_local_counts(words_fn, pos, cap, pad, q, n_words, n_rounds, cap_key=two_bit))
    out = psum(counts, mesh)[0].cpu().numpy().astype(np.uint64)
    out[~matchable] = 0
    return out
