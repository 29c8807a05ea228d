"""``gc_content`` (min_frac, max_frac, k): the G or C count of the k bases
lies within [ceil(k min_frac), floor(k max_frac)]."""

import math

from kmerbench.reference.kmers_ref import require_window, window_sum


def mask(ix, min_frac, max_frac, k):
    require_window(ix, k)
    lo, hi = int(math.ceil(k * min_frac)), int(math.floor(k * max_frac))
    sba = ix.g.sba_t
    count = window_sum((sba == ord("G")) | (sba == ord("C")), k)
    return ((count >= lo) & (count <= hi))[ix.pos]
