"""Count queries against a sharded sorted index.

Counterpart of ``genome_kmers_tpu/parallel/query.py`` (its ``_local_counts``
and ``distributed_count_queries``; the 64-bit variants wait for
ROADMAP.md A12). The index is globally sorted and cut into shards, possibly
ragged with trailing pads (the sample sort's layout), so a k-mer's count is
the sum of its per-shard counts: every shard runs the lower and upper bound
search of ops/query.py over its rows, with a pad flag as the leading key so
that the trailing pads compare above every query, and one ``psum`` adds the
shards' counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.keys import build_key_words, cap_lengths, compute_valid_len, widen_u32
from ..ops.query import _lex_less, encode_query_words
from .collectives import psum, replicate
from .distributed import mesh_size


def _local_counts(packed, positions, cap_len, is_pad, q_words: tuple, n_words: int,
                  n_rounds: int) -> torch.Tensor:
    """Occurrences of each query among one shard's sorted rows (int64):
    upper bound minus lower bound of the query in the key space (pad flag,
    4-bit key words), ``n_rounds`` rounds of a binary search of all queries
    together. ``q_words`` are int64 tensors of uint32 words on the shard's
    device."""
    n = positions.shape[0]
    q_key = (torch.zeros_like(q_words[0]),) + q_words
    pad = is_pad.to(torch.int64)

    def bound(upper: bool):
        lo = torch.zeros_like(q_words[0])
        hi = torch.full_like(lo, n)
        for _ in range(n_rounds):
            active = lo < hi
            mid = (lo + hi) >> 1
            probe = torch.clamp_max(mid, n - 1)
            words = build_key_words(packed, positions[probe], cap_len[probe], n_words)
            key = (pad[probe],) + tuple(widen_u32(w) for w in words)
            # move right while key[mid] <= query (upper) or key[mid] < query
            go_right = ~_lex_less(q_key, key) if upper else _lex_less(key, q_key)
            lo = torch.where(active & go_right, mid + 1, lo)
            hi = torch.where(active & ~go_right, mid, hi)
        return lo

    return bound(True) - bound(False)


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
    for p in range(mesh_size(mesh)):
        pos, pad = sorted_positions[p], is_pad[p]
        dev = pos.device
        cap = cap_lengths(compute_valid_len(pos, ss[p], se[p]), kmer_len)
        cap = torch.where(pad, 0, cap)
        q = tuple(torch.from_numpy(w.astype(np.int64)).to(dev) for w in q_host)
        n_rounds = max(1, math.ceil(math.log2(max(pos.shape[0], 2))) + 1)
        counts.append(_local_counts(genome[p], pos, cap, pad, q, n_words, n_rounds))
    return psum(counts, mesh)[0].cpu().numpy().astype(np.uint32)
