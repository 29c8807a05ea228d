"""``gc_content`` (min_frac, max_frac, k): the library's GC-content filter."""

import genome_kmers_tpu_torch as gk


def make(min_frac, max_frac, k):
    return gk.gen_kmer_gc_content_filter_func(min_frac, max_frac, k)
