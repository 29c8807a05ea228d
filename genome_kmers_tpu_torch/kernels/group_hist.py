"""Wrapper of the group-size histogram kernel (``csrc/group_hist.cu``).

The kernel replaces no TPU kernel (its source says why it was added). Its
plain version, ``group_size_hist``, is the clamp, the qualifying select and
the ``torch.bincount`` that the port ran before, and the kernel equals it
bit for bit. The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "group_hist.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gkt_group_hist.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.gkt_group_hist.restype = ctypes.c_int
    return lib


def group_size_hist(size: torch.Tensor, qualifies: torch.Tensor, max_counts_bin: int) -> torch.Tensor:
    """counts[s] = number of rows with ``qualifies`` and ``min(size,
    max_counts_bin) == s``: an int64 tensor of ``max_counts_bin + 1`` bins.
    The plain version of the kernel."""
    return torch.bincount(torch.clamp_max(size, max_counts_bin)[qualifies],
                          minlength=max_counts_bin + 1)


def group_size_hist_cuda(size: torch.Tensor, qualifies: torch.Tensor,
                         max_counts_bin: int) -> torch.Tensor:
    """``group_size_hist`` of a 1-D int64 ``size`` and a bool ``qualifies``
    of the same length. For CUDA tensors one launch of the kernel into a
    zeroed output, on the current stream, with no synchronisation and no
    scalar read back (counted in ``group_size_hist_cuda.launches``; every
    launch is one pass over the rows, ``.passes``); for CPU tensors the
    plain version. Raises on any other device, type, shape or layout."""
    if size.device.type == "cpu" and qualifies.device.type == "cpu":
        return group_size_hist(size, qualifies, max_counts_bin)
    if size.device.type != "cuda" or qualifies.device != size.device:
        raise ValueError(f"group_size_hist_cuda: unsupported devices {size.device} and "
                         f"{qualifies.device}")
    if size.dtype != torch.int64 or qualifies.dtype != torch.bool:
        raise ValueError(f"group_size_hist_cuda: expected int64 sizes and a bool mask, got "
                         f"{size.dtype} and {qualifies.dtype}")
    if size.dim() != 1 or qualifies.shape != size.shape:
        raise ValueError(f"group_size_hist_cuda: expected two 1-D tensors of one length, got "
                         f"{tuple(size.shape)} and {tuple(qualifies.shape)}")
    if not (size.is_contiguous() and qualifies.is_contiguous()):
        raise ValueError("group_size_hist_cuda: the inputs must be contiguous")
    if size.data_ptr() % 8 != 0:
        raise ValueError("group_size_hist_cuda: the sizes must be 8-byte aligned")
    if max_counts_bin < 1:
        raise ValueError(f"group_size_hist_cuda: max_counts_bin ({max_counts_bin}) must be >= 1")
    counts = torch.zeros(max_counts_bin + 1, dtype=torch.int64, device=size.device)
    n = size.shape[0]
    if n == 0:
        return counts
    lib = _lib()
    with torch.cuda.device(size.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gkt_group_hist(size.data_ptr(), qualifies.data_ptr(), n, int(max_counts_bin),
                                counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"group_hist kernel launch failed with CUDA error {rc}")
    group_size_hist_cuda.launches += 1
    return counts


group_size_hist_cuda.launches = 0
group_size_hist_cuda.passes = 1
