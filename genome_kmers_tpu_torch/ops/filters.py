"""K-mer filters.

Counterpart of ``genome_kmers_tpu/ops/filters.py``, holding only the
keep-all filter, the default of every statistics call. The other filters
are not ported yet (ROADMAP.md A8); the statistics calls raise
NotImplementedError for them.
"""

from __future__ import annotations


class KmerFilter:
    """Base class of the library filters; a filter is called per k-mer with
    the reference signature ``(sba, sba_strand, kmer_sba_start_idx) -> bool``."""

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        raise NotImplementedError


class KeepAllFilter(KmerFilter):
    """Keeps every k-mer."""

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return True


kmer_filter_keep_all = KeepAllFilter()
