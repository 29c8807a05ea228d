"""Carry the host state of a JAX-package collection and index into the port.

``from_numpy_state`` rebuilds a ``SequenceCollection`` and a ``Kmers`` from
NumPy arrays: the forward SBA, its segment starts and record names and,
optionally, an index: a sorted one (sorted positions and the retained
sorted key lanes ``words``/``cap``, 2-bit or 4-bit, as the JAX package keeps
them) or an assigned, unsorted one (positions alone). The port then
computes over exactly the state the JAX package built.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import Kmers
from .ops.keys import u32_bits_as_int32
from .sequence_collection import SequenceCollection


def _lane(values, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values).astype(np.int64)).to(device)


def from_numpy_state(
    sba,
    seg_starts,
    record_names,
    min_kmer_len: int,
    max_kmer_len: int,
    positions=None,
    words=None,
    cap=None,
    two_bit: bool = True,
    is_sorted: bool = True,
    device="cuda",
):
    """(SequenceCollection, Kmers) on ``device`` holding the given state.

    Without ``positions`` the Kmers is the fresh, unsorted index. With them
    and ``is_sorted`` it is the sorted index: ``positions`` in sorted order
    and ``words`` (a sequence of uint32 arrays) the sorted key lanes built
    at ``max_kmer_len``: 2-bit lanes (``two_bit``) with ``cap`` the sorted
    cap lane (None when min_kmer_len == max_kmer_len), or 4-bit lanes,
    which have no cap lane. With ``is_sorted=False`` the positions are an
    assigned index in the given order and there are no lanes."""
    sc = SequenceCollection(device=device)
    sc.forward_sba = np.ascontiguousarray(sba, dtype=np.uint8)
    sc._forward_sba_seg_starts = np.asarray(seg_starts, dtype=np.uint32)
    sc.forward_record_names = list(record_names)
    sc._strands_loaded = "forward"
    km = Kmers(sc, min_kmer_len=min_kmer_len, max_kmer_len=max_kmer_len)
    if positions is None:
        return sc, km
    if not is_sorted:
        if words is not None or cap is not None:
            raise ValueError("an assigned, unsorted index has no sorted key lanes")
        km.kmer_sba_start_indices = np.asarray(positions).astype(np.uint32)
        return sc, km
    if words is None:
        raise ValueError("a sorted index needs its sorted key lanes (words)")
    if two_bit and (cap is None) != (min_kmer_len == max_kmer_len):
        raise ValueError("cap must be given exactly when min_kmer_len < max_kmer_len")
    if not two_bit and cap is not None:
        raise ValueError("4-bit lanes carry termination in-word and have no cap lane")
    km._pos_dev = _lane(positions, sc.device)
    km._pos_host = None
    km._init_geometry = None
    if two_bit:  # the forms the port's own sorts retain (ops/sort.py)
        lane_words = tuple(_lane(w, sc.device) for w in words)
    else:
        lane_words = tuple(u32_bits_as_int32(_lane(w, sc.device)) for w in words)
    km._lanes_cache = {
        "two_bit": two_bit,
        "built_k": max_kmer_len,
        "words": lane_words,
        "cap": None if cap is None else _lane(cap, sc.device),
    }
    km._is_sorted = True
    return sc, km
