"""``homopolymer`` (max_h, k): no run of more than ``max_h`` equal bytes
inside the k bases."""

import torch

from kmerbench.reference.kmers_ref import require_window, window_sum


def mask(ix, max_h, k):
    require_window(ix, k)
    if k - 1 < max_h:
        return torch.ones(ix.n, dtype=torch.bool)
    sba, n = ix.g.sba_t, ix.g.n
    eq = torch.zeros(n, dtype=torch.bool)
    eq[:-1] = sba[:-1] == sba[1:]
    run = eq.clone()  # run[i]: bytes i .. i + max_h are all equal
    for j in range(1, max_h):
        run[: n - j] &= eq[j:]
        run[n - j:] = False
    return (window_sum(run, k - max_h) == 0)[ix.pos]
