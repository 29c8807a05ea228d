"""``homopolymer`` (max_homopolymer_len, k): the library's homopolymer filter."""

import genome_kmers_tpu_torch as gk


def make(max_h, k):
    return gk.gen_kmer_homopolymer_filter_func(max_h, k)
