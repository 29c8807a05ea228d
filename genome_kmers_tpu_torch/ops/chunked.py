"""Two-level single-device sort of a large position array.

Counterpart of ``genome_kmers_tpu/ops/chunked.py``. A single sort's
workspace bounds the largest index one device can build; this sort splits
the work the way the mesh's sample sort splits it across shards, but across
sequential chunks on one device:

  1. sort each chunk of ``chunk_rows`` rows;
  2. take splitters from regular-stride samples of every sorted chunk (one
     small sort);
  3. locate each splitter in every sorted chunk (a row-wise binary search
     over (words, cap, position) that reads one row a splitter a round);
  4. sort each bucket: the matching contiguous slice of every chunk;
  5. concatenate the buckets.

The partition compares full (words, cap, position) rows, so it is exact
even where every key is equal (positions are unique). Requires one-window
keys (k <= 32 on 4-bit keys, <= 64 on 2-bit keys). Opt-in, as in the JAX
package: ``Kmers.sort`` never takes this route. Every sort here goes through
the multi-lane sort kernel on a CUDA device (``ops/sort.sort_positions`` and
``kernels/lane_sort.py::sort_lanes_cuda``).
"""

from __future__ import annotations

import math

import torch

from ..kernels.lane_sort import sort_lanes_cuda
from .keys import build_key2_words, build_key_words, u32_bits_as_int32, widen_u32
from .query import _bound_search
from .sort import _cdiv, sort_positions


def sort_positions_chunked(
    packed,
    positions: torch.Tensor,
    cap_fn,
    max_kmer_len: int,
    packed2=None,
    uniform_cap: bool = False,
    chunk_rows: int = 1 << 24,
    n_samples_per_chunk: int = 512,
) -> torch.Tensor:
    """Sort a large position array (int64, any order) in two levels.

    ``cap_fn(positions) -> caps`` gives the compare caps of any positions
    (caps always travel with their positions). Falls through to one sort
    when the input fits one chunk. Returns the sorted int64 positions, ties
    by position: ``ops/sort.sort_positions`` of the whole array."""
    n = positions.shape[0]
    if n <= chunk_rows:
        return sort_positions(packed, positions, cap_fn(positions), max_kmer_len,
                              packed2=packed2, uniform_cap=uniform_cap)
    two_bit = packed2 is not None
    limit = 64 if two_bit else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError("chunked sort requires one-window keys")
    n_words = _cdiv(max_kmer_len, 16 if two_bit else 8)
    n_chunks = _cdiv(n, chunk_rows)

    def words_of(p, caps):  # int32 bit patterns
        if two_bit:
            return build_key2_words(packed2, p, caps, n_words)
        return build_key_words(packed, p, caps, n_words)

    def key_of(p):  # the (words..., cap, position) rows as int64 lanes
        caps = cap_fn(p)
        return tuple(widen_u32(w) for w in words_of(p, caps)) + (caps, p)

    def sort(p):
        return sort_positions(packed, p, cap_fn(p), max_kmer_len,
                              packed2=packed2, uniform_cap=uniform_cap)

    # 1. sort the chunks (the last may be shorter)
    chunks = [sort(positions[c * chunk_rows : (c + 1) * chunk_rows]) for c in range(n_chunks)]

    # 2. splitters from regular-stride samples of every sorted chunk, the
    # samples sorted as (words, cap, position) rows: distinct rows (distinct
    # positions), as the kernel needs
    samples = []
    for ch in chunks:
        m = ch.shape[0]
        s = min(n_samples_per_chunk, m)
        stride = max(m // s, 1)
        samples.append(ch[(torch.arange(s, device=ch.device) * stride + stride // 2) % m])
    samp = torch.cat(samples)
    caps = cap_fn(samp)
    samp_sorted = widen_u32(sort_lanes_cuda(
        words_of(samp, caps) + (caps.to(torch.int32), u32_bits_as_int32(samp)))[-1])
    total_s = samp.shape[0]
    pick = torch.tensor([(b + 1) * total_s // n_chunks for b in range(n_chunks - 1)],
                        dtype=torch.int64, device=samp.device)
    splitters = key_of(samp_sorted[pick])

    # 3. each splitter's place in every chunk: the bucket bounds (one read)
    rounds = max(1, math.ceil(math.log2(max(chunk_rows, 2)))) + 1
    ins = torch.stack([_bound_search(lambda idx, ch=ch: key_of(ch[idx]), splitters,
                                     ch.shape[0], rounds) for ch in chunks])
    bounds = [[0] + row + [ch.shape[0]] for row, ch in zip(ins.tolist(), chunks)]

    # 4. sort each bucket; 5. concatenate
    out = []
    for b in range(n_chunks):
        parts = [ch[lo[b] : lo[b + 1]] for ch, lo in zip(chunks, bounds) if lo[b + 1] > lo[b]]
        if parts:
            out.append(sort(parts[0] if len(parts) == 1 else torch.cat(parts)))
    return torch.cat(out) if len(out) > 1 else out[0]
