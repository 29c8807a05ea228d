"""genome_kmers_tpu_torch: the PyTorch and CUDA port of genome_kmers_tpu.

The JAX package ``genome_kmers_tpu`` is the reference; this package gives
the same outputs on the same inputs, on an NVIDIA GPU (Hopper, sm_90a) or,
for tests, on the CPU: FASTA -> ``SequenceCollection`` (2-bit pack by a
hand-written CUDA kernel) -> ``Kmers`` at any k-mer length, on either strand
or both -> ``sort()`` (the multi-lane sort kernel for 4-bit keys and
gathered keys) -> group counts, counts and yields, under any of the
library's filters, a ``VectorizedFilter`` or a plain callable; past 2^32
bases ``LargeKmers`` (a strided pack, int64 positions, sorted over a mesh).
The ``VectorizedFilter`` mask function takes torch tensors. It never
imports jax.
"""

from .kmers import (
    Kmers,
    compare_sba_kmers_always_less_than,
    compare_sba_kmers_lexicographically,
    crispr_ngg_pam_filter,
    gen_kmer_gc_content_filter_func,
    gen_kmer_homopolymer_filter_func,
    gen_kmer_length_filter_func,
    gen_no_ambiguous_bases_filter,
    get_compare_sba_kmers_func,
    get_kmer_group_size_hist,
    get_kmer_info_group_size_only,
    get_kmer_info_minimal,
    kmer_filter_keep_all,
    kmer_has_required_len,
    kmer_info_by_group_generator,
)
from .large_kmers import LargeKmers
from .ops.filters import VectorizedFilter
from .sequence_collection import SequenceCollection

__version__ = "0.1.0"

__all__ = [
    "Kmers",
    "LargeKmers",
    "SequenceCollection",
    "VectorizedFilter",
    "compare_sba_kmers_always_less_than",
    "compare_sba_kmers_lexicographically",
    "crispr_ngg_pam_filter",
    "gen_kmer_gc_content_filter_func",
    "gen_kmer_homopolymer_filter_func",
    "gen_kmer_length_filter_func",
    "gen_no_ambiguous_bases_filter",
    "get_compare_sba_kmers_func",
    "get_kmer_group_size_hist",
    "get_kmer_info_group_size_only",
    "get_kmer_info_minimal",
    "kmer_filter_keep_all",
    "kmer_has_required_len",
    "kmer_info_by_group_generator",
]
