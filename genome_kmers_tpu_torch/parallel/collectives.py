"""Collectives of the single-process mesh, as plain functions over lists.

A sharded array of the port is a list of per-shard tensors, shard ``p`` on
``mesh.devices[p]``; a replicated value is such a list holding the same
value on every shard. These functions are the counterparts of the
``jax.lax`` collectives that the JAX package's ``shard_map`` bodies call
(``all_gather``, ``all_to_all``, ``psum``, ``pmax``) and of its placement
helper ``put_global``. They are the only code of the port that moves data
from one shard to another: each move is one ``Tensor.to(device)``, a no-op
where two shards share a card.
"""

from __future__ import annotations

import torch


def hier_shape(mesh):
    """(n_nodes, n_local) of a 2-D ``(node, local)`` mesh, None for a 1-D
    one; a mesh of more axes is rejected here, the one place that decides
    which mesh shapes the port takes."""
    names = mesh.axis_names
    if len(names) == 1:
        return None
    if len(names) != 2:
        raise NotImplementedError(f"meshes must be 1-D (flat) or 2-D (node, local); got {names}")
    return (mesh.shape[names[0]], mesh.shape[names[1]])


def replicate(tensor: torch.Tensor, mesh) -> list:
    """``tensor`` on every shard (one copy per distinct device)."""
    copies = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = tensor.to(dev)
        out.append(copies[dev])
    return out


def put_sharded(tensor: torch.Tensor, mesh) -> list:
    """``tensor`` cut into ``mesh_size`` equal blocks along dim 0, block
    ``p`` on shard ``p``. The length must be a multiple of the shard
    count."""
    n_dev = len(mesh.devices)
    if tensor.shape[0] % n_dev:
        raise ValueError(f"{tensor.shape[0]} rows do not split into {n_dev} equal shards")
    return [block.to(dev) for block, dev in zip(torch.chunk(tensor, n_dev), mesh.devices)]


def all_gather(values: list, mesh) -> list:
    """Every shard's value stacked along a new leading dim, on every shard:
    ``out[p][q] = values[q]``."""
    return [torch.stack([v.to(dev) for v in values]) for dev in mesh.devices]


def all_to_all(blocks: list, mesh) -> list:
    """Transpose of a list of per-shard block lists: shard ``b`` receives
    block ``b`` of every shard, moved to ``mesh.devices[b]``. Blocks may
    differ in length.

    On a one-dimensional mesh one hop: ``out[b][p] = blocks[p][b]``, in
    shard order. On a 2-D ``(node, local)`` mesh (``hier.make_mesh2``,
    shards in row-major order, shard ``(n, l)`` = ``n * n_local + l``) the
    JAX package's two stages: stage A moves, over the ``node`` axis, one
    node-aggregated group of ``n_local`` blocks from each shard to the shard
    of the same local index on each destination node; stage B fans the
    blocks out over the ``local`` axis to their final shard. Shard ``(d,
    j)`` then holds the blocks of sources ``(n, l)`` in the order ``l``
    major, ``n`` minor, as the JAX package's stage B concatenates them; the
    same blocks as the one hop, in another order. Within one process the
    two stages move nothing the one hop does not; they matter where nodes
    are processes (ROADMAP.md A14)."""
    n_dev = len(mesh.devices)
    if len(blocks) != n_dev or any(len(row) != n_dev for row in blocks):
        raise ValueError(f"all_to_all expects {n_dev} lists of {n_dev} blocks")
    shape = hier_shape(mesh)
    if shape is None:
        return [[blocks[p][b].to(dev) for p in range(n_dev)] for b, dev in enumerate(mesh.devices)]
    n_nodes, n_local = shape
    # stage A: shard (n, l) -> shard (d, l), the blocks for node d's shards
    stage_a = [
        [
            [blocks[n * n_local + l][d * n_local + j].to(mesh.devices[d * n_local + l])
             for j in range(n_local)]
            for n in range(n_nodes)
        ]
        for d in range(n_nodes)
        for l in range(n_local)
    ]  # stage_a[(d, l)][n][j]: from (n, l), for (d, j)
    # stage B: shard (d, l) -> shard (d, j)
    return [
        [
            stage_a[d * n_local + l][n][j].to(mesh.devices[d * n_local + j])
            for l in range(n_local)
            for n in range(n_nodes)
        ]
        for d in range(n_nodes)
        for j in range(n_local)
    ]


def psum(values: list, mesh) -> list:
    """The sum over shards, on every shard."""
    return [g.sum(dim=0) for g in all_gather(values, mesh)]


def pmax(values: list, mesh) -> list:
    """The maximum over shards, on every shard."""
    return [g.amax(dim=0) for g in all_gather(values, mesh)]
