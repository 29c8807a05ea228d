"""Collectives of the mesh: over lists of per-shard tensors, within one
process or across the processes of a ``torch.distributed`` group.

A sharded array of the port is a list of this process's per-shard tensors,
local shard ``i`` (global shard ``mesh.first + i``) on ``mesh.devices[i]``;
a replicated value is such a list holding the same value on every shard
(and on every rank). These functions are the counterparts of the
``jax.lax`` collectives that the JAX package's ``shard_map`` bodies call
(``all_gather``, ``all_to_all``, ``psum``, ``pmax``) and of its placement
helper ``put_global``. They are the only code of the port that moves data
from one shard to another.

Within one process (``mesh.group`` None) each move is one
``Tensor.to(device)`` (``to_device``), a no-op where two shards share a
card; a copy from one card to another is counted in ``TRAFFIC``. On a process
mesh (``distributed.make_mesh`` under an initialised ``torch.distributed``)
every rank calls each function with its own shards, and the data moves by
the group's backend: NCCL moves card tensors; Gloo moves host tensors, so
a shard on a card is copied to the host for the collective and back. That
copy is part of the collective (``TRAFFIC`` counts its bytes and seconds),
never a retry after a failure. Bool tensors travel as uint8.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

# what this process's collectives moved over a process group: "collectives"
# (calls), "device_bytes" (sent from card tensors: NCCL), "host_bytes" (sent
# from host tensors: Gloo), "staged_bytes" / "staging_seconds" (copies
# between a card and the host around a Gloo collective); and within the
# process "peer_bytes" / "peer_copies", the copies from one card to another
# (``to_device``); reset by callers
TRAFFIC = {"collectives": 0, "device_bytes": 0, "host_bytes": 0, "staged_bytes": 0,
           "staging_seconds": 0.0, "peer_bytes": 0, "peer_copies": 0}


def reset_traffic() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0.0 if key == "staging_seconds" else 0


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


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t.to(dev)``; a copy from one card to another is counted in
    ``TRAFFIC`` ("peer_bytes", "peer_copies")."""
    if t.device != dev and t.device.type == "cuda" and dev.type == "cuda":
        TRAFFIC["peer_bytes"] += t.numel() * t.element_size()
        TRAFFIC["peer_copies"] += 1
    return t.to(dev)


def _move(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``; a copy between a card and the host is counted as
    staging."""
    if t.device == dev:
        return t
    if dev.type == "cpu" or t.device.type == "cpu":
        t0 = time.perf_counter()
        out = t.to(dev)
        TRAFFIC["staged_bytes"] += t.numel() * t.element_size()
        TRAFFIC["staging_seconds"] += time.perf_counter() - t0
        return out
    return to_device(t, dev)


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the group's backend takes it: on the mesh's communication
    device, bool as uint8."""
    t = _move(t, mesh.comm_device)
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _count(t: torch.Tensor) -> None:
    TRAFFIC["collectives"] += 1
    key = "host_bytes" if t.device.type == "cpu" else "device_bytes"
    TRAFFIC[key] += t.numel() * t.element_size()


def _on_devices(t: torch.Tensor, mesh, dtype) -> list:
    """``t`` (off the wire) on every local shard, one copy per device."""
    if dtype == torch.bool:
        t = t.view(torch.bool)
    copies = {}
    return [copies.setdefault(dev, _move(t, dev)) for dev in mesh.devices]


def _gather_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` (same shape everywhere, on the wire) concatenated
    along dim 0 in rank order."""
    _count(t)
    out = [torch.empty_like(t) for _ in range(mesh.n_ranks)]
    dist.all_gather(out, t, group=mesh.group)
    return torch.cat(out)


def barrier(mesh) -> None:
    """Every rank of a process mesh waits for all the others here; nothing
    within one process."""
    if mesh.group is not None:
        _gather_ranks(torch.zeros(1, dtype=torch.int32, device=mesh.comm_device), mesh)


def replicate(tensor: torch.Tensor, mesh) -> list:
    """``tensor`` on every local shard (one copy per distinct device). On a
    process mesh every rank passes the same value (each holds the full
    host array, as in the JAX package)."""
    copies = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = to_device(tensor, dev)
        out.append(copies[dev])
    return out


def put_sharded(tensor: torch.Tensor, mesh) -> list:
    """``tensor`` cut into ``mesh_size`` equal blocks along dim 0, block
    ``p`` on shard ``p``: this process's blocks. The length must be a
    multiple of the shard count; on a process mesh every rank passes the
    whole tensor and keeps the slices it owns."""
    n_dev = mesh.n_shards
    if tensor.shape[0] % n_dev:
        raise ValueError(f"{tensor.shape[0]} rows do not split into {n_dev} equal shards")
    rows = tensor.shape[0] // n_dev
    return [to_device(tensor[p * rows : (p + 1) * rows], dev)
            for p, dev in zip(mesh.shard_ids, mesh.devices)]


def all_gather(values: list, mesh) -> list:
    """Every shard's value stacked along a new leading dim, on every local
    shard: ``out[i][q] = value of global shard q``. Values have one shape
    and dtype on every shard."""
    if mesh.group is None:
        return [torch.stack([to_device(v, dev) for v in values]) for dev in mesh.devices]
    dtype = values[0].dtype
    full = _gather_ranks(torch.stack([_wire(v, mesh) for v in values]), mesh)
    return _on_devices(full, mesh, dtype)


def gather_host(rows: list, mesh) -> np.ndarray:
    """Host arrays of one shape, one a local shard, stacked in global shard
    order on every rank (small metadata: counts, bounds)."""
    local = np.stack([np.asarray(r) for r in rows])
    if mesh.group is None:
        return local
    wire = torch.from_numpy(local).to(mesh.comm_device)
    return _gather_ranks(wire, mesh).cpu().numpy()


def all_gather_shards(values: list, mesh) -> list:
    """Every shard's tensor, of any length along dim 0, in global shard
    order: the lengths go first (one all-gather of int64 counts), then the
    rows padded to the longest. Within one process the list itself; on a
    process mesh the other ranks' shards arrive on ``mesh.devices[0]``.
    The counterpart of the JAX package's ``process_allgather``."""
    if mesh.group is None:
        return list(values)
    lengths = gather_host([v.shape[0] for v in values], mesh)
    longest = int(lengths.max()) if lengths.size else 0
    dtype = values[0].dtype
    padded = []
    for v in values:
        w = _wire(v, mesh)
        pad = w.new_zeros((longest - w.shape[0],) + tuple(w.shape[1:]))
        padded.append(torch.cat([w, pad]))
    full = _gather_ranks(torch.stack(padded), mesh)
    if dtype == torch.bool:
        full = full.view(torch.bool)
    out = []
    for q, n in enumerate(lengths.tolist()):
        local = q - mesh.first
        out.append(values[local] if 0 <= local < len(values) else _move(full[q, :n], mesh.devices[0]))
    return out


def all_to_all(blocks: list, mesh) -> list:
    """Transpose of a list of per-shard block lists: each local shard
    passes one block for every global shard, and shard ``b`` receives
    block ``b`` of every shard, moved to its device. Blocks may differ in
    length (split sizes of zero too).

    On a one-dimensional mesh one hop: ``out[b][p] = blocks[p][b]``, in
    shard order. On a 2-D ``(node, local)`` mesh (``hier.make_mesh2``,
    shards in row-major order, shard ``(n, l)`` = ``n * n_local + l``) the
    JAX package's two stages: stage A moves, over the ``node`` axis, one
    node-aggregated group of ``n_local`` blocks from each shard to the shard
    of the same local index on each destination node; stage B fans the
    blocks out over the ``local`` axis to their final shard. Shard ``(d,
    j)`` then holds the blocks of sources ``(n, l)`` in the order ``l``
    major, ``n`` minor, as the JAX package's stage B concatenates them; the
    same blocks as the one hop, in another order.

    On a process mesh the split sizes go first (one all-to-all of int64
    counts, so that each rank allocates what it receives), then the rows,
    one ``all_to_all_single`` over the ranks carrying one message a pair of
    ranks: on a 2-D mesh, whose nodes are the processes, that is stage A,
    and stage B is each rank's local moves."""
    n_dev = mesh.n_shards
    if len(blocks) != len(mesh.devices) or any(len(row) != n_dev for row in blocks):
        raise ValueError(f"all_to_all expects {len(mesh.devices)} lists of {n_dev} blocks")
    shape = hier_shape(mesh)
    if mesh.group is not None:
        return _all_to_all_ranks(blocks, mesh, shape is not None)
    if shape is None:
        return [[to_device(blocks[p][b], dev) for p in range(n_dev)]
                for b, dev in enumerate(mesh.devices)]
    n_nodes, n_local = shape
    # stage A: shard (n, l) -> shard (d, l), the blocks for node d's shards
    stage_a = [
        [
            [to_device(blocks[n * n_local + l][d * n_local + j], mesh.devices[d * n_local + l])
             for j in range(n_local)]
            for n in range(n_nodes)
        ]
        for d in range(n_nodes)
        for l in range(n_local)
    ]  # stage_a[(d, l)][n][j]: from (n, l), for (d, j)
    # stage B: shard (d, l) -> shard (d, j)
    return [
        [
            to_device(stage_a[d * n_local + l][n][j], mesh.devices[d * n_local + j])
            for l in range(n_local)
            for n in range(n_nodes)
        ]
        for d in range(n_nodes)
        for j in range(n_local)
    ]


def _all_to_all_ranks(blocks: list, mesh, two_d: bool) -> list:
    """``all_to_all`` over the ranks of a process mesh (see there)."""
    n_local, n_ranks = len(mesh.devices), mesh.n_ranks
    dtype = blocks[0][0].dtype
    comm = mesh.comm_device
    # (destination rank, source local shard, destination local shard)
    send_rows = torch.tensor([[b.shape[0] for b in row] for row in blocks], dtype=torch.int64)
    send_rows = send_rows.view(n_local, n_ranks, n_local).permute(1, 0, 2).contiguous()
    recv_rows = torch.empty_like(send_rows, device=comm)
    wire = send_rows.to(comm)
    _count(wire)
    dist.all_to_all_single(recv_rows, wire, group=mesh.group)
    recv_rows = recv_rows.cpu()
    order = [blocks[i][r * n_local + j] for r in range(n_ranks) for i in range(n_local)
             for j in range(n_local)]
    send = torch.cat([_wire(b, mesh) for b in order])
    recv = send.new_empty((int(recv_rows.sum()),) + tuple(send.shape[1:]))
    _count(send)
    dist.all_to_all_single(
        recv, send, output_split_sizes=recv_rows.sum(dim=(1, 2)).tolist(),
        input_split_sizes=send_rows.sum(dim=(1, 2)).tolist(), group=mesh.group,
    )
    del send
    if dtype == torch.bool:
        recv = recv.view(torch.bool)
    chunks = torch.split(recv, recv_rows.flatten().tolist())
    # chunk (q, i, j): from shard (rank q, local i), for local shard j
    at = lambda q, i, j: chunks[(q * n_local + i) * n_local + j]  # noqa: E731
    out = []
    for j, dev in enumerate(mesh.devices):
        if two_d:  # stage B: sources (node q, local i), local index major
            row = [at(q, i, j) for i in range(n_local) for q in range(n_ranks)]
        else:
            row = [at(q, i, j) for q in range(n_ranks) for i in range(n_local)]
        out.append([_move(c, dev) for c in row])
    return out


def psum(values: list, mesh) -> list:
    """The sum over shards, on every shard."""
    return [g.sum(dim=0) for g in all_gather(values, mesh)]


def pmax(values: list, mesh) -> list:
    """The maximum over shards, on every shard."""
    return [g.amax(dim=0) for g in all_gather(values, mesh)]
