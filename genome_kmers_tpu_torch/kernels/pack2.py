"""Wrapper of the 2-bit pack kernel (``csrc/pack2.cu``).

The kernel replaces the TPU kernel
``genome_kmers_tpu/ops/pallas_kernels.py::pack_rank2_words_pallas``; its
plain PyTorch version is ``ops/keys.py::pack_rank2_words``, which it must
equal bit for bit. The wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.keys import pack_rank2_words
from . import build

SOURCE = "pack2.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gkt_pack2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.gkt_pack2.restype = ctypes.c_int
    return lib


def pack_rank2_words_cuda(sba_u8: torch.Tensor) -> torch.Tensor:
    """2-bit pack of a 1-D uint8 SBA tensor: int32 tensor holding the uint32
    words of ``ops/keys.py::pack_rank2_words``. Launches the CUDA kernel for
    a CUDA tensor (and counts the launch in ``pack_rank2_words_cuda.launches``);
    computes the plain version for a CPU tensor."""
    if sba_u8.device.type == "cpu":
        return pack_rank2_words(sba_u8)
    if sba_u8.device.type != "cuda":
        raise ValueError(f"pack_rank2_words_cuda: unsupported device {sba_u8.device}")
    if sba_u8.dtype != torch.uint8 or sba_u8.dim() != 1:
        raise ValueError(
            f"pack_rank2_words_cuda: expected a 1-D uint8 tensor, got {sba_u8.dtype} "
            f"of shape {tuple(sba_u8.shape)}"
        )
    if not sba_u8.is_contiguous():
        raise ValueError("pack_rank2_words_cuda: the input must be contiguous")
    n = sba_u8.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=sba_u8.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(sba_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gkt_pack2(sba_u8.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"pack2 kernel launch failed with CUDA error {rc}")
    pack_rank2_words_cuda.launches += 1
    return out


pack_rank2_words_cuda.launches = 0
