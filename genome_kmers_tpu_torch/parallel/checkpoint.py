"""Checkpoints of a sorted k-mer index: the arrays as ``.npy`` files beside
a JSON metadata file.

Counterpart of ``genome_kmers_tpu/parallel/checkpoint.py``
(``save_sharded_index`` / ``load_sharded_index``, ``save_kmers_sharded`` /
``load_kmers_sharded`` and ``save_large_kmers`` / ``load_large_kmers``). The
JAX package writes its arrays through orbax, which is JAX's and is
not installed beside the port; the port writes each array as
``arrays/<name>.npy``. The metadata file, its name, its keys and the
validation messages are the JAX package's: ``gkt_meta.json`` holds the
caller's keys plus ``__n_real__`` (the index length) and ``__arrays__``
(each array's shape and dtype). The position array is padded to a multiple
of 1024 with 0xFFFFFFF0, as the JAX package pads it so that any mesh of up
to 1024 shards can take it in equal blocks.

Where ``torch.distributed`` is initialised every rank calls save and load:
a save gathers what a process mesh holds across ranks, one writer (rank 0)
writes the files, and a barrier holds every rank until they are written
(the JAX package's one writer plus ``sync_global_devices``), so a save on a
process mesh writes the files of a single-process save of the same index;
a load reads them on every rank and keeps this rank's shards.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather_shards, put_sharded, replicate
from .distributed import compact_ragged, process_group

_META_NAME = "gkt_meta.json"
_PAD_MULTIPLE = 1024
_PAD_VALUE = 0xFFFFFFF0


def _as_uint32(values) -> np.ndarray:
    """A host uint32 array of a tensor (int64 uint32 values or int32 bit
    patterns), of a list of per-shard tensors (concatenated in shard
    order) or of an array."""
    if isinstance(values, (list, tuple)):
        return np.concatenate([_as_uint32(v) for v in values])
    if isinstance(values, torch.Tensor):
        values = values.cpu().numpy()
    values = np.asarray(values)
    if values.dtype == np.int32:
        return values.view(np.uint32)
    return values.astype(np.uint32)


def _one_writer(write) -> None:
    """``write()`` on one process (rank 0 where ``torch.distributed`` is
    initialised), then a barrier: no rank reads before the files exist."""
    group = process_group()
    if group is None or dist.get_rank(group) == 0:
        write()
    if group is not None:
        dist.barrier(group=group)


def save_sharded_index(path, sorted_positions, meta: dict, packed_genome=None,
                       mesh=None) -> None:
    """Write a sorted index (a tensor, a list of per-shard tensors in
    global order, or an array) and ``meta`` to the directory ``path``;
    ``packed_genome`` (uint32 words) is written beside it when given. A
    list of a process ``mesh``'s shards is gathered from every rank."""
    path = Path(path).absolute()
    if mesh is not None and isinstance(sorted_positions, (list, tuple)):
        sorted_positions = all_gather_shards(list(sorted_positions), mesh)
    positions = _as_uint32(sorted_positions)
    n_real = int(positions.shape[0])
    n_pad = max(-(-n_real // _PAD_MULTIPLE) * _PAD_MULTIPLE, _PAD_MULTIPLE)
    if n_pad != n_real:
        positions = np.concatenate(
            [positions, np.full(n_pad - n_real, _PAD_VALUE, dtype=np.uint32)]
        )
    tree = {"sorted_positions": positions}
    if packed_genome is not None:
        tree["packed_genome"] = _as_uint32(packed_genome)
    meta = dict(meta)
    meta["__n_real__"] = n_real
    meta["__arrays__"] = {
        name: {"shape": list(a.shape), "dtype": str(a.dtype)} for name, a in tree.items()
    }
    _one_writer(lambda: _write(path, tree, meta))


def _write(path: Path, tree: dict, meta: dict) -> None:
    arrays = path / "arrays"
    arrays.mkdir(parents=True, exist_ok=True)
    for name, a in tree.items():
        np.save(arrays / f"{name}.npy", a)
    (path / _META_NAME).write_text(json.dumps(meta))


def load_sharded_index(path, mesh=None):
    """Restore ``(sorted_positions, packed_genome_or_None, meta)``. With
    ``mesh`` the positions come back cut into equal shards (a list, one
    tensor a shard) and the genome replicated (a list); without, both are
    host arrays. The positions keep their padding: ``meta["__n_real__"]``
    is the index length. On a process mesh each rank reads the files and
    keeps its own shards."""
    path = Path(path).absolute()
    meta = json.loads((path / _META_NAME).read_text())
    arrays_info = meta.pop("__arrays__", {"sorted_positions": None})
    tree = {name: np.load(path / "arrays" / f"{name}.npy") for name in arrays_info}
    for name, info in arrays_info.items():
        if info is not None and (
            list(tree[name].shape) != info["shape"] or str(tree[name].dtype) != info["dtype"]
        ):
            raise ValueError(
                f"checkpoint array {name} is {tree[name].dtype}{list(tree[name].shape)}, "
                f"its metadata says {info['dtype']}{info['shape']}"
            )
    meta["__n_real__"] = meta.get("__n_real__", tree["sorted_positions"].shape[0])
    positions, genome = tree["sorted_positions"], tree.get("packed_genome")
    if mesh is not None:
        positions = put_sharded(torch.from_numpy(positions.astype(np.int64)), mesh)
        if genome is not None:
            genome = replicate(torch.from_numpy(genome.view(np.int32)), mesh)
    return positions, genome, meta


def save_kmers_sharded(kmers, path, include_genome: bool = False) -> None:
    """Checkpoint a sorted Kmers. The metadata mirrors the reference's
    HDF5 "kmers" group fields; ``include_genome`` adds the 4-bit pack."""
    if not kmers._is_sorted:
        raise ValueError("save_kmers_sharded requires a sorted index")
    meta = {
        "min_kmer_len": kmers.min_kmer_len,
        "max_kmer_len": kmers.max_kmer_len,
        "kmer_source_strand": kmers.kmer_source_strand,
        "track_strands_separately": kmers.track_strands_separately,
        "_is_initialized": kmers._is_initialized,
        "_is_set": kmers._is_set,
        "_is_sorted": kmers._is_sorted,
        "num_kmers": int(len(kmers)),
    }
    genome = kmers._dc().packed if include_genome else None
    # on a process mesh the host index is every rank's layout gathered
    save_sharded_index(path, kmers.kmer_sba_start_indices, meta, packed_genome=genome)


def load_kmers_sharded(kmers, path, mesh=None) -> dict:
    """Restore a checkpoint into an initialized Kmers over the same
    collection; the metadata is checked against it. Returns the metadata.
    The index comes back as an assigned sorted index, whose statistics
    need no re-sort."""
    sorted_pos, _, meta = load_sharded_index(path, mesh=mesh)
    if meta["min_kmer_len"] != kmers.min_kmer_len or meta["max_kmer_len"] != kmers.max_kmer_len:
        raise ValueError(
            f"checkpoint kmer params (min={meta['min_kmer_len']}, max={meta['max_kmer_len']}) "
            f"do not match this Kmers (min={kmers.min_kmer_len}, max={kmers.max_kmer_len})"
        )
    if meta["num_kmers"] != len(kmers):
        raise ValueError(
            f"checkpoint has {meta['num_kmers']} kmers, this Kmers has {len(kmers)}"
        )
    n_real = int(meta["__n_real__"])
    if mesh is not None and mesh.group is not None:
        sorted_pos = all_gather_shards(sorted_pos, mesh)
    host = _as_uint32(sorted_pos)
    kmers.kmer_sba_start_indices = host[:n_real]
    kmers._is_sorted = bool(meta["_is_sorted"])
    return meta


def save_large_kmers(lk, path) -> None:
    """Checkpoint a sorted LargeKmers layout: the positions as (hi, lo)
    uint32 arrays ``pos_hi`` / ``pos_lo`` and the pad flags ``is_pad``
    (uint32), the shards concatenated in order and padded to a multiple of
    1024 rows with pad rows, beside the JAX package's metadata. The pack
    and segment tables are the constructor's inputs and are not written. A
    layout on a process mesh is gathered from every rank, pads included."""
    path = Path(path).absolute()
    positions, is_pad, mesh, n_real, _ = lk._sorted
    if mesh.group is not None:
        positions, is_pad = all_gather_shards(positions, mesh), all_gather_shards(is_pad, mesh)
    pos = np.concatenate([x.cpu().numpy() for x in positions]).view(np.uint64)
    pad = np.concatenate([x.cpu().numpy() for x in is_pad]).astype(np.uint32)
    n_rows = int(pos.shape[0])
    n_pad = max(-(-n_rows // _PAD_MULTIPLE) * _PAD_MULTIPLE, _PAD_MULTIPLE)
    pos = np.concatenate([pos, np.full(n_pad - n_rows, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)])
    pad = np.concatenate([pad, np.ones(n_pad - n_rows, dtype=np.uint32)])
    tree = {
        "pos_hi": (pos >> np.uint64(32)).astype(np.uint32),
        "pos_lo": (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        "is_pad": pad,
    }
    meta = {
        "kind": "large_kmers",
        "min_kmer_len": lk.min_kmer_len,
        "max_kmer_len": lk.max_kmer_len,
        "two_bit": lk.two_bit,
        "num_kmers": lk.num_kmers,
        "n_real": int(n_real),
        "custom_positions": bool(lk._custom_positions),
        "__n_real__": n_rows,
        "__arrays__": {
            name: {"shape": list(a.shape), "dtype": str(a.dtype)} for name, a in tree.items()
        },
    }
    _one_writer(lambda: _write(path, tree, meta))


def load_large_kmers(lk, path, mesh) -> dict:
    """Restore a LargeKmers sorted layout onto ``mesh`` (any shard count
    that divides the padded rows): the rows cut into equal shards, then
    each shard's valid rows moved before its pads in their order (a stable
    per-shard compaction, as the JAX package's stable sort by the pad
    flag), which leaves the global order of the real rows as it was. The
    key lanes are not saved; statistics rebuild them."""
    path = Path(path).absolute()
    meta = json.loads((path / _META_NAME).read_text())
    if meta.get("kind") != "large_kmers":
        raise ValueError(f"{path} is not a LargeKmers checkpoint")
    if (
        meta["min_kmer_len"] != lk.min_kmer_len
        or meta["max_kmer_len"] != lk.max_kmer_len
        or bool(meta["two_bit"]) != lk.two_bit
        or meta["num_kmers"] != lk.num_kmers
    ):
        raise ValueError(
            "checkpoint parameters do not match this LargeKmers "
            f"(ckpt: min={meta['min_kmer_len']} max={meta['max_kmer_len']} "
            f"two_bit={meta['two_bit']} n={meta['num_kmers']})"
        )
    tree = {name: np.load(path / "arrays" / f"{name}.npy") for name in meta["__arrays__"]}
    pos = (tree["pos_hi"].astype(np.uint64) << np.uint64(32)) | tree["pos_lo"].astype(np.uint64)
    positions = put_sharded(torch.from_numpy(pos.view(np.int64)), mesh)
    is_pad = put_sharded(torch.from_numpy(tree["is_pad"] != 0), mesh)
    positions, is_pad = compact_ragged(positions, is_pad, mesh)
    lk._sorted = (positions, is_pad, mesh, int(meta["n_real"]), None)
    lk._is_sorted = True
    lk._custom_positions = bool(meta.get("custom_positions", False))
    return meta
