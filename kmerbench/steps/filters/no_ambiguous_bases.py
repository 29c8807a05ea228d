"""``no_ambiguous_bases`` (k): the library's filter of k-mers with a base
other than A, C, G or T."""

import genome_kmers_tpu_torch as gk


def make(k):
    return gk.gen_no_ambiguous_bases_filter(k)
