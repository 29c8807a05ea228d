"""Wrapper of the multi-lane sort kernels (``csrc/lane_sort.cu``).

The kernels replace the TPU kernel
``genome_kmers_tpu/ops/pallas_sort.py::bitonic_sort_tile`` and widen it from
one tile to any length: a block sort of tiles of ``TILE_ROWS`` rows (what the
TPU kernel computes), then merge-path passes that double the width of the
sorted runs until one run is left. Their plain PyTorch version is
``ops/sort.py::sort_lanes`` (chained stable ``torch.sort`` passes), which
they must equal bit for bit whenever the last lane is unique. The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernels or raises.

The schedule of the passes lives here (``pass_schedule``), where the wrapper
sizes the scratch buffers, and in the source's host function; the wrapper
holds the two against each other on every call. The tiles and the blocks an
SM holds are the source's alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "lane_sort.cu"
MAX_LANES = 8
# Rows a block of the block sort holds in shared memory. The row count is
# rounded up to a multiple of it, never to a power of two; the rows added are
# all-ones, sort last and are cut off again.
TILE_ROWS = 4096


def pass_schedule(n: int, tile_rows: int = TILE_ROWS) -> tuple[int, tuple[int, ...], int]:
    """The passes that sort ``n`` rows: ``(rows of the scratch buffers,
    run width merged by each merge pass, buffer that ends up holding the
    result)``. The block sort writes buffer 0 in runs of ``tile_rows``; each
    merge pass reads one buffer and writes the other, so the result lies in
    buffer 0 after an even number of merge passes, else in buffer 1."""
    if n < 1:
        raise ValueError(f"pass_schedule: expected at least one row, got {n}")
    n_rows = -(-n // tile_rows) * tile_rows
    widths = []
    width = tile_rows
    while width < n_rows:
        widths.append(width)
        width *= 2
    return n_rows, tuple(widths), len(widths) % 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gkt_lane_sort.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.gkt_lane_sort.restype = ctypes.c_int
    lib.gkt_lane_sort_tile_rows.argtypes = []
    lib.gkt_lane_sort_tile_rows.restype = ctypes.c_int
    lib.gkt_lane_sort_merge_tile_rows.argtypes = [ctypes.c_int]
    lib.gkt_lane_sort_merge_tile_rows.restype = ctypes.c_int
    lib.gkt_lane_sort_blocks_resident.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.gkt_lane_sort_blocks_resident.restype = ctypes.c_int
    if lib.gkt_lane_sort_tile_rows() != TILE_ROWS:
        raise RuntimeError(
            f"lane_sort kernel was built with tiles of {lib.gkt_lane_sort_tile_rows()} rows, "
            f"the wrapper sizes for {TILE_ROWS}"
        )
    return lib


def blocks_resident(n_lanes: int) -> tuple[int, int]:
    """(block-sort blocks, merge blocks) an SM of the current CUDA device
    holds at ``n_lanes`` lanes, as the CUDA runtime computes them from the
    built kernels' registers and shared memory."""
    sort_blocks, merge_blocks = ctypes.c_int(-1), ctypes.c_int(-1)
    rc = _lib().gkt_lane_sort_blocks_resident(
        n_lanes, ctypes.byref(sort_blocks), ctypes.byref(merge_blocks))
    if rc != 0:
        raise RuntimeError(f"lane_sort: no occupancy for {n_lanes} lanes")
    return sort_blocks.value, merge_blocks.value


def sort_lanes_cuda(lanes) -> tuple:
    """Rows of 1..8 int32 lanes (uint32 bit patterns) sorted ascending,
    lexicographically over all lanes, most significant first, compared as
    unsigned; the lanes of a row move together. The caller makes the last
    lane unique and never 0xFFFFFFFF, so the order is total.

    ``lanes`` are contiguous 1-D int32 tensors of equal length on one
    device; they are not modified and not copied. For CUDA tensors the
    kernels sort them into scratch buffers of ``pass_schedule(n)[0]`` rows
    (two of them, one when a single tile holds all rows, and 8 bytes per
    output tile of a merge pass; the buffer without the result is freed),
    the rows past n read as all-ones, and views of the buffer that holds
    the result come back;
    ``sort_lanes_cuda.launches`` counts the call and ``sort_lanes_cuda.passes``
    is the number of its launches that read and wrote every lane. For CPU
    tensors the plain version runs."""
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

    n_lanes = len(lanes)
    n_rows, widths, result = pass_schedule(n)
    lib = _lib()
    with torch.cuda.device(device):
        buffers = [
            [torch.empty(n_rows, dtype=torch.int32, device=device) for _ in lanes]
            for _ in range(2 if widths else 1)
        ]
        splits = torch.empty(n_rows // lib.gkt_lane_sort_merge_tile_rows(n_lanes), dtype=torch.int64,
                             device=device)
        pointers = [
            (ctypes.c_void_p * n_lanes)(*[t.data_ptr() for t in group])
            for group in (lanes, buffers[0], buffers[-1])
        ]
        passes = ctypes.c_int(0)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gkt_lane_sort(*pointers, n_lanes, n, splits.data_ptr(), stream,
                               ctypes.byref(passes))
    if rc != 0:
        raise RuntimeError(f"lane_sort kernel launch failed with CUDA error {rc}")
    if passes.value != 1 + len(widths):
        raise RuntimeError(
            f"lane_sort made {passes.value} passes, the wrapper's schedule has {1 + len(widths)}"
        )
    sort_lanes_cuda.launches += 1
    sort_lanes_cuda.passes = passes.value
    return tuple(buf[:n] for buf in buffers[result])


sort_lanes_cuda.launches = 0
sort_lanes_cuda.passes = 0
