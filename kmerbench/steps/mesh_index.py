"""``mesh_index`` (``min``, ``max``): a new ``Kmers(sc, min, max)`` that the
mesh steps sort and count; the index the run's outputs are read from
(``reference/steps/mesh_index.py`` checks it, in blocks)."""

import numpy as np

import genome_kmers_tpu_torch as gk


def run(s, step):
    s.km = None
    s.km = gk.Kmers(s.sc, step["min"], step["max"])
    s.index_step = step


def positions(s) -> np.ndarray:
    """The sorted index on the host (uint32, every shard's rows in global
    order), as the run's output."""
    return np.asarray(s.km.kmer_sba_start_indices)
