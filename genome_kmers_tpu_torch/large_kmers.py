"""LargeKmers, the 64-bit regime: not ported yet (ROADMAP.md A12)."""

from __future__ import annotations


class LargeKmers:
    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "LargeKmers is not ported to genome_kmers_tpu_torch yet (ROADMAP.md A12: LargeKmers)"
        )
