"""``index`` (``min``, ``max``): a new ``Kmers(sc, min, max)``; the index
the run's outputs are read from (``reference/steps/index.py`` checks it)."""

import numpy as np

import genome_kmers_tpu_torch as gk


def run(s, step):
    s.km = None
    s.km = gk.Kmers(s.sc, step["min"], step["max"])
    s.index_step = step


def positions(s) -> np.ndarray:
    """The sorted index on the host, as the run's output."""
    return np.asarray(s.km.kmer_sba_start_indices)
