"""``no_ambiguous_bases`` (k): only A, C, G and T inside the k bases."""

from kmerbench.reference.kmers_ref import require_window, window_sum


def mask(ix, k):
    require_window(ix, k)
    sba = ix.g.sba_t
    amb = (sba != ord("A")) & (sba != ord("C")) & (sba != ord("G")) & (sba != ord("T"))
    return (window_sum(amb, k) == 0)[ix.pos]
