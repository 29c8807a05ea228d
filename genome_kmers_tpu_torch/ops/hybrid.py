"""Hybrid sort for genomes with sparse ambiguity (real chromosomes: ACGT
plus N runs at centromeres and telomeres).

Counterpart of ``genome_kmers_tpu/ops/hybrid.py``. One N anywhere in the
genome rules the 2-bit keys out for the whole index, yet the k-mer windows
that cover an ambiguous base are usually a small minority. So the positions
are split:

  * the majority (windows free of non-ACGT bases) sorts on 2-bit keys,
    from the pack of every byte (``_DeviceCache.packed2_any``);
  * the minority (windows that cover an ambiguous base) sorts on 4-bit
    keys;

and the two sorted streams are interleaved exactly. On ACGT-only windows
the 4-bit order is the 2-bit-and-cap order, and a minority k-mer never ties
a majority one, so each minority row's place in the majority is a binary
search under the 4-bit key order (``ops/query._bound_search``).

Opt-in, as in the JAX package: ``Kmers.sort`` never takes this route. Both
streams sort through ``ops/sort.sort_positions``, so on a CUDA device both
go through the multi-lane sort kernel. What differs from the JAX package:
the split stays on the device (only the minority's size is read back; the
JAX package copies the whole mask to the host), and the interleave scatters
each stream into its slots where the JAX package builds the output by
gathers alone.
"""

from __future__ import annotations

import math

import torch

from .keys import build_key_words, cap_lengths, compute_valid_len, widen_u32
from .query import _bound_search
from .sort import _cdiv, sort_positions


def ambiguity_mask(next_amb: torch.Tensor, positions: torch.Tensor, cap_len: torch.Tensor):
    """True where the capped window [p, p + cap) covers a non-ACGT base.
    ``next_amb`` is ``_DeviceCache.next_amb`` of the SBA."""
    na = next_amb[torch.clamp(positions, 0, next_amb.shape[0] - 1)]
    return na < positions + cap_len


def _caps_of(positions, seg_starts, seg_ends, max_kmer_len):
    return cap_lengths(compute_valid_len(positions, seg_starts, seg_ends), max_kmer_len)


def _split(positions, amb):
    """(majority positions, minority positions), each in input order."""
    return positions[~amb], positions[amb]


def _insertion_ranks_impl(packed, m_pos, m_cap, a_pos, a_cap, n_words):
    """For each minority row, its insertion index into the sorted majority
    stream under the 4-bit key order (no ties are possible across the
    streams): a binary search that builds the probed rows' words a round."""

    def words(pos, cap):
        return tuple(widen_u32(w) for w in build_key_words(packed, pos, cap, n_words))

    n = m_pos.shape[0]
    return _bound_search(lambda idx: words(m_pos[idx], m_cap[idx]), words(a_pos, a_cap), n,
                         max(1, math.ceil(math.log2(max(n, 2)))) + 1)


def _interleave(m_pos, a_pos, ins):
    """The merged stream: minority row j goes to slot ``ins[j] + j`` and
    majority row i to slot ``i`` plus the minority rows inserted at or
    before it (``ins`` is non-decreasing)."""
    n_m = m_pos.shape[0]
    out = torch.empty(n_m + a_pos.shape[0], dtype=m_pos.dtype, device=m_pos.device)
    out[ins + torch.arange(a_pos.shape[0], device=ins.device)] = a_pos
    i = torch.arange(n_m, device=m_pos.device)
    out[i + torch.searchsorted(ins, i, right=True)] = m_pos
    return out


def hybrid_sort_positions(
    packed: torch.Tensor,
    packed2: torch.Tensor,
    positions: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    max_kmer_len: int,
    next_amb: torch.Tensor,
    uniform_cap: bool = False,
) -> torch.Tensor:
    """Sort the positions (int64, any order) of a sparsely ambiguous genome:
    2-bit keys for the clean windows (``packed2``: ``packed2_any``), 4-bit
    keys (``packed``) for the ambiguous ones, and an exact interleave.

    Caps come from the segment extents, re-derived for each stream after
    its own sort. Requires a bounded ``max_kmer_len`` <= 64. With no
    ambiguous window this is the 2-bit sort of everything; with more than a
    quarter of them ambiguous the 4-bit sort of everything. Returns the
    sorted int64 positions, ties by position."""
    if max_kmer_len is None or max_kmer_len > 64:
        raise NotImplementedError("hybrid sort requires max_kmer_len <= 64")
    n = positions.shape[0]
    if n <= 1:
        return positions

    def caps_of(p):
        return _caps_of(p, seg_starts, seg_ends, max_kmer_len)

    cap_len = caps_of(positions)
    amb = ambiguity_mask(next_amb, positions, cap_len)
    n_amb = int(amb.sum())
    if n_amb == 0:
        return sort_positions(None, positions, cap_len, max_kmer_len,
                              packed2=packed2, uniform_cap=uniform_cap)
    # densely ambiguous input: the split buys nothing, so all of it is 4-bit
    if n_amb * 4 > n:
        return sort_positions(packed, positions, cap_len, max_kmer_len)
    m_pos, a_pos = _split(positions, amb)
    del amb, cap_len
    m_sorted = sort_positions(None, m_pos, caps_of(m_pos), max_kmer_len,
                              packed2=packed2, uniform_cap=uniform_cap)
    a_sorted = sort_positions(packed, a_pos, caps_of(a_pos), max_kmer_len)
    del m_pos, a_pos
    ins = _insertion_ranks_impl(packed, m_sorted, caps_of(m_sorted), a_sorted,
                                caps_of(a_sorted), _cdiv(max_kmer_len, 8))
    return _interleave(m_sorted, a_sorted, ins)
