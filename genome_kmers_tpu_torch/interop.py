"""Carry the host state of a JAX-package collection and index into the port.

``from_numpy_state`` rebuilds a ``SequenceCollection`` and a ``Kmers`` from
NumPy arrays: the forward SBA, its segment starts and record names and,
optionally, a sorted index (sorted positions and the retained sorted key
lanes ``words``/``cap`` of an ACGT genome, as the JAX package keeps them).
The port then computes its statistics over exactly the state the JAX
package built.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import Kmers
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
    device="cuda",
):
    """(SequenceCollection, Kmers) on ``device`` holding the given state.

    Without ``positions`` the Kmers is the fresh, unsorted index. With them
    it is the sorted index: ``positions`` in sorted order and ``words`` (a
    sequence of uint32 arrays) the sorted 2-bit key lanes built at
    ``max_kmer_len``, with ``cap`` the sorted cap lane (None when
    min_kmer_len == max_kmer_len)."""
    sc = SequenceCollection(device=device)
    sc.forward_sba = np.ascontiguousarray(sba, dtype=np.uint8)
    sc._forward_sba_seg_starts = np.asarray(seg_starts, dtype=np.uint32)
    sc.forward_record_names = list(record_names)
    sc._strands_loaded = "forward"
    km = Kmers(sc, min_kmer_len=min_kmer_len, max_kmer_len=max_kmer_len)
    if positions is None:
        return sc, km
    if words is None:
        raise ValueError("a sorted index needs its sorted key lanes (words)")
    if (cap is None) != (min_kmer_len == max_kmer_len):
        raise ValueError("cap must be given exactly when min_kmer_len < max_kmer_len")
    km._pos_dev = _lane(positions, sc.device)
    km._pos_host = None
    km._init_geometry = None
    km._lanes_cache = {
        "two_bit": True,
        "built_k": max_kmer_len,
        "words": tuple(_lane(w, sc.device) for w in words),
        "cap": None if cap is None else _lane(cap, sc.device),
    }
    km._is_sorted = True
    return sc, km
