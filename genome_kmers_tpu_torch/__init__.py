"""genome_kmers_tpu_torch: the PyTorch and CUDA port of genome_kmers_tpu.

The JAX package ``genome_kmers_tpu`` is the reference; this package gives
the same outputs on the same inputs, on an NVIDIA GPU (Hopper, sm_90a) or,
for tests, on the CPU. Its first slice is the main path on an ACGT genome:
FASTA -> ``SequenceCollection`` (2-bit pack by a hand-written CUDA kernel)
-> ``Kmers(min_kmer_len, max_kmer_len <= 64)`` -> ``sort()`` ->
``get_kmer_group_counts`` / ``get_kmer_count``. It never imports jax.
"""

from .kmers import Kmers
from .large_kmers import LargeKmers
from .ops.filters import kmer_filter_keep_all
from .sequence_collection import SequenceCollection

__all__ = ["Kmers", "LargeKmers", "SequenceCollection", "kmer_filter_keep_all"]
