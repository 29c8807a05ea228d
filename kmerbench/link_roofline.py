"""The peak of the link between two cards, for the exchange's share of it.

Frozen here with the benchmark, beside ``roofline.py``. The four-card cells
run on one host of four H100 SXM5 80GB cards joined all to all by NVLink 4:
every pair has peer access, and one 4 GiB copy from one card to another runs
at 393.7 GB/s, six times what PCIe could carry (``nvidia-smi topo -m`` does
not run on that machine). NVIDIA's H100 data sheet gives 900 GB/s of NVLink
bandwidth a card, both directions together, so 450 GB/s a direction. Over
PCIe Gen5 x16 (the data sheet's 128 GB/s, both directions) it would be
64 GB/s.
"""

from __future__ import annotations

NVLINK4_BYTES_PER_S = 450e9  # one direction, H100 SXM5
PCIE5_X16_BYTES_PER_S = 64e9  # one direction
LINK_BYTES_PER_S = NVLINK4_BYTES_PER_S  # the four-card cells' topology


def exchange_bytes(rows: int, row_bytes: int, cards: int) -> int:
    """The least bytes a card sends in the exchange of a sample sort of
    ``rows`` rows of ``row_bytes`` over ``cards`` cards with balanced
    buckets: its ``rows / cards`` rows, of which ``(cards - 1) / cards``
    leave it."""
    return rows * row_bytes * (cards - 1) // (cards * cards)


def share_of_link(nbytes: float, seconds: float) -> float:
    """The least time for ``nbytes`` at LINK_BYTES_PER_S over ``seconds``, %."""
    return 100.0 * nbytes / LINK_BYTES_PER_S / seconds
