"""Wrapper of the multi-lane bitonic sort kernel (``csrc/lane_sort.cu``).

The kernel replaces the TPU kernel
``genome_kmers_tpu/ops/pallas_sort.py::bitonic_sort_tile`` and widens it from
one tile to any length; its plain PyTorch version is
``ops/sort.py::sort_lanes`` (chained stable ``torch.sort`` passes), which it
must equal bit for bit whenever the last lane is unique. The wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "lane_sort.cu"
MAX_LANES = 8
# Rows a block of the kernel holds (512 threads x 8 rows in registers, and
# in shared memory between regroupings: 8 lanes x 4096 rows x 4 bytes is
# 128 KiB of the 227 KiB a block may opt into). The row count the kernel
# sorts is a power of two of at least one tile.
TILE_ROWS = 4096


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gkt_lane_sort.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.gkt_lane_sort.restype = ctypes.c_int
    lib.gkt_lane_sort_tile_rows.argtypes = []
    lib.gkt_lane_sort_tile_rows.restype = ctypes.c_int
    if lib.gkt_lane_sort_tile_rows() != TILE_ROWS:
        raise RuntimeError(
            f"lane_sort kernel was built for tiles of {lib.gkt_lane_sort_tile_rows()} rows, "
            f"the wrapper pads to {TILE_ROWS}"
        )
    return lib


def sort_lanes_cuda(lanes) -> tuple:
    """Rows of 1..8 int32 lanes (uint32 bit patterns) sorted ascending,
    lexicographically over all lanes, most significant first, compared as
    unsigned; the lanes of a row move together. The caller makes the last
    lane unique and never 0xFFFFFFFF, so the order is total.

    ``lanes`` are contiguous 1-D int32 tensors of equal length on one
    device; they are not modified. For CUDA tensors the kernel sorts a copy
    padded to the next power of two (at least one tile) with all-ones rows,
    which sort last and are cut off again (and ``sort_lanes_cuda.launches`` counts the call);
    for CPU tensors the plain version runs."""
    lanes = tuple(lanes)
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"sort_lanes_cuda: expected 1..{MAX_LANES} lanes, got {len(lanes)}")
    device = lanes[0].device
    n = lanes[0].shape[0] if lanes[0].dim() == 1 else -1
    for lane in lanes:
        if lane.device != device:
            raise ValueError("sort_lanes_cuda: the lanes lie on different devices")
        if lane.dtype != torch.int32 or lane.dim() != 1 or lane.shape[0] != n:
            raise ValueError(
                "sort_lanes_cuda: expected 1-D int32 lanes of equal length, got "
                f"{lane.dtype} of shape {tuple(lane.shape)}"
            )
        if not lane.is_contiguous():
            raise ValueError("sort_lanes_cuda: the lanes must be contiguous")
    if device.type == "cpu":
        from ..ops.sort import sort_lanes

        return sort_lanes(lanes)
    if device.type != "cuda":
        raise ValueError(f"sort_lanes_cuda: unsupported device {device}")
    if n <= 1:
        return lanes

    n_pad = max(TILE_ROWS, 1 << (n - 1).bit_length())
    bufs = []
    for lane in lanes:
        if n_pad == n:
            bufs.append(lane.clone())
        else:
            buf = torch.full((n_pad,), -1, dtype=torch.int32, device=device)
            buf[:n] = lane
            bufs.append(buf)
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gkt_lane_sort(ptrs, len(bufs), n_pad, stream)
    if rc != 0:
        raise RuntimeError(f"lane_sort kernel launch failed with CUDA error {rc}")
    sort_lanes_cuda.launches += 1
    return tuple(b[:n] for b in bufs)


sort_lanes_cuda.launches = 0
