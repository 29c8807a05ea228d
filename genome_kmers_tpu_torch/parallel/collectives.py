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
    block ``b`` of every shard in shard order, ``out[b][p] =
    blocks[p][b]`` moved to ``mesh.devices[b]``. Blocks may differ in
    length."""
    n_dev = len(mesh.devices)
    if len(blocks) != n_dev or any(len(row) != n_dev for row in blocks):
        raise ValueError(f"all_to_all expects {n_dev} lists of {n_dev} blocks")
    return [[blocks[p][b].to(dev) for p in range(n_dev)] for b, dev in enumerate(mesh.devices)]


def psum(values: list, mesh) -> list:
    """The sum over shards, on every shard."""
    return [g.sum(dim=0) for g in all_gather(values, mesh)]


def pmax(values: list, mesh) -> list:
    """The maximum over shards, on every shard."""
    return [g.amax(dim=0) for g in all_gather(values, mesh)]
