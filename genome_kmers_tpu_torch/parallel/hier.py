"""The 2-D hierarchical ``(node, local)`` mesh.

Counterpart of ``genome_kmers_tpu/parallel/hier.py``. A mesh of nodes,
each of ``n_local`` shards, whose shards are taken in row-major order:
shard ``(n, l)`` is shard ``n * n_local + l`` of the flat mesh. Every mesh
call of the port takes it (sorts, statistics, filters, queries,
checkpoints); only the sample sort's exchange differs, the two stages of
``collectives.all_to_all``: one node-aggregated group of blocks a
destination node over the ``node`` axis, then the fan-out over ``local``.
The layouts are the flat mesh's byte for byte.
"""

from __future__ import annotations

from .distributed import Mesh, visible_cards
from .sample_sort import N_SAMPLES, CAPACITY_FACTOR, sample_sort_positions_ragged

AXES = ("node", "local")


def make_mesh2(n_nodes: int, n_local: int, devices=None) -> Mesh:
    """2-D ``(node, local)`` mesh over the first ``n_nodes * n_local`` of
    ``devices`` (any ``torch.device`` specs, repeats allowed), row-major;
    without them over the visible CUDA cards, raising without CUDA."""
    n = n_nodes * n_local
    devices = visible_cards(n, "make_mesh2") if devices is None else list(devices)[:n]
    return Mesh(devices, AXES, (n_nodes, n_local))


def sample_sort_positions_ragged_hier(
    packed,
    positions,
    seg_starts,
    seg_ends,
    max_kmer_len: int,
    mesh2: Mesh,
    packed2=None,
    n_samples: int = N_SAMPLES,
    capacity_factor: float = CAPACITY_FACTOR,
    uniform_cap: bool = False,
):
    """``sample_sort_positions_ragged`` over a 2-D ``(node, local)`` mesh:
    (positions, is_pad) per shard, byte for byte the 1-D sort's at the same
    shard count."""
    limit = 64 if packed2 is not None else 32
    if max_kmer_len is None or max_kmer_len > limit:
        raise NotImplementedError(
            f"hierarchical sample sort requires max_kmer_len <= {limit} bases"
        )
    if mesh2.axis_names != AXES:
        raise ValueError(f"expected a {AXES} mesh (make_mesh2), got axes {mesh2.axis_names}")
    return sample_sort_positions_ragged(
        packed, positions, seg_starts, seg_ends, max_kmer_len, mesh2, packed2=packed2,
        n_samples=n_samples, capacity_factor=capacity_factor, uniform_cap=uniform_cap,
    )
