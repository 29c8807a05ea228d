"""Wrapper of the lanes-flags kernel (``csrc/lanes_flags.cu``).

The kernel replaces no TPU kernel (its source says why it was added). Its
plain versions are the lanes flags of ``ops/filters.py`` for the
GC-content, homopolymer and no-ambiguous filters (``gc_lanes_flags4``,
``noamb_lanes_flags4``, ``homopoly_lanes_flags4``, ``gc_lanes_flags2``,
``homopoly_lanes_flags2``), which it equals bit for bit. Those functions
run their torch ops for CPU tensors and call the wrapper for any other,
which launches the kernel for CUDA tensors and raises on the rest.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.keys import keep_mask
from . import build

SOURCE = "lanes_flags.cu"
MAX_WORDS = 8  # word lanes the kernel reads (4-bit lanes: 8 x 8 bases)

# kind -> (the kernel's Kind, bases a word, bits a base, outputs, most words
# the kernel reads)
KINDS = {
    "gc4": (0, 8, 4, 2, 8),
    "noamb4": (1, 8, 4, 3, 8),
    "homopoly4": (2, 8, 4, 2, 4),
    "gc2": (3, 16, 2, 2, 4),
    "homopoly2": (4, 16, 2, 2, 4),
}
_ROWS, _CONSTANT = 0, 1  # the kernel's Mode


class _Args(ctypes.Structure):
    """The kernel's ``Args``, field for field."""

    _fields_ = [
        ("words", ctypes.c_void_p * MAX_WORDS),
        ("pos", ctypes.c_void_p),
        ("cap", ctypes.c_void_p),
        ("out", ctypes.c_void_p * 3),
        ("n", ctypes.c_int64),
        ("thr", ctypes.c_int64),
        ("cap_const", ctypes.c_int64),
        ("k", ctypes.c_int64),
        ("lo", ctypes.c_int64),
        ("hi", ctypes.c_int64),
        ("max_h", ctypes.c_int64),
        ("keep", ctypes.c_uint32 * MAX_WORDS),
        ("mode", ctypes.c_int32),
        ("aligned", ctypes.c_int32),
        ("n_out", ctypes.c_int32),
    ]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gkt_lanes_flags.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.gkt_lanes_flags.restype = ctypes.c_int
    return lib


class Scalars(NamedTuple):
    """The kernel's scalar arguments, decoded from a plain version's
    ``params`` next to it (``ops/filters._kernel_on_card``): ``k`` the
    filter's k_f, ``thr`` the overflow threshold of the positions, ``cap_const``
    the cap of 2-bit lanes without a cap lane, ``lo`` and ``hi`` the G/C
    counts allowed, ``max_h`` the longest run allowed, ``constant`` the
    filter's constant outcome (an impossible GC range, a homopolymer
    short circuit)."""

    k: int
    thr: int = 0
    cap_const: int = 0
    lo: int = 0
    hi: int = 0
    max_h: int = 0
    constant: bool = False


def _check(kind: str, words, cap, positions):
    """(word lanes, cap lane or None) after the checks that need no card;
    the 4-bit forms read no cap lane (their words carry the truncation).
    Raises ValueError on anything else."""
    if kind not in KINDS:
        raise ValueError(f"lanes_flags_cuda: unknown kind {kind!r} (one of {sorted(KINDS)})")
    two_bit = KINDS[kind][1] == 16
    words = list(words)
    if not words:
        raise ValueError("lanes_flags_cuda: no word lane")
    if positions.dtype != torch.int64 or positions.dim() != 1:
        raise ValueError(f"lanes_flags_cuda: expected 1-D int64 positions, got {positions.dtype} "
                         f"of shape {tuple(positions.shape)}")
    allowed = (torch.int32, torch.int64) if two_bit else (torch.int32,)
    if any(w.dtype != words[0].dtype for w in words) or words[0].dtype not in allowed:
        raise ValueError(f"lanes_flags_cuda: {kind} takes word lanes of one dtype among "
                         f"{[str(d) for d in allowed]}, got {[str(w.dtype) for w in words]}")
    cap = cap if two_bit else None
    lanes = words + [positions] + ([] if cap is None else [cap])
    if cap is not None and cap.dtype != torch.int64:
        raise ValueError(f"lanes_flags_cuda: expected an int64 cap lane, got {cap.dtype}")
    n = positions.shape[0]
    for lane in lanes:
        if lane.dim() != 1 or lane.shape[0] != n:
            raise ValueError(f"lanes_flags_cuda: expected 1-D lanes of {n} rows, got shape "
                             f"{tuple(lane.shape)}")
        if n > 1 and lane.stride(0) != 1:
            raise ValueError(f"lanes_flags_cuda: a lane has stride {lane.stride(0)}, not 1")
    return words, cap


def lanes_flags_cuda(kind: str, words, cap, positions, scalars: Scalars):
    """The lanes flags ``(mask, errs)`` of filter ``kind`` ("gc4", "noamb4",
    "homopoly4", "gc2", "homopoly2") with the plain version's lanes and
    results (``ops/filters.py``: the same shapes, dtypes and order) and its
    params as the kernel's ``Scalars``. For CUDA tensors one launch of the
    kernel on the current stream, with no synchronisation and no scalar
    read back (counted in ``lanes_flags_cuda.launches``; every launch is
    one pass over the rows, ``.passes``). Raises on another device (the CPU
    included: there the plain versions run), another dtype, a lane that is
    not 1-D with stride 1, or a CUDA error."""
    words, cap = _check(kind, words, cap, positions)
    lanes = words + [positions] + ([] if cap is None else [cap])
    device = positions.device
    if device.type != "cuda" or any(lane.device != device for lane in lanes):
        raise ValueError(f"lanes_flags_cuda: unsupported devices "
                         f"{sorted({str(lane.device) for lane in lanes})}")
    code, per_word, bits, n_out, max_words = KINDS[kind]
    k, thr, cap_const, lo, hi, max_h, constant = (int(v) for v in scalars)
    reach = min(len(words), max(-(-k // per_word), 1))
    if reach > max_words:
        raise ValueError(f"lanes_flags_cuda: k_f = {k} reaches {reach} words; the {kind} "
                         f"kernel reads at most {max_words}")
    n = positions.shape[0]
    outs = [torch.empty(n, dtype=torch.bool, device=device) for _ in range(n_out)]
    if n:
        args = _Args()
        for i in range(reach):
            args.words[i] = words[i].data_ptr()
            args.keep[i] = keep_mask(k, i, per_word, bits)
        read = ([] if kind.startswith("gc") else [positions]) + words[:reach]
        read += [] if cap is None else [cap]
        args.pos = positions.data_ptr()
        args.cap = None if cap is None else cap.data_ptr()
        for o, out in enumerate(outs):
            args.out[o] = out.data_ptr()
        args.n, args.thr, args.cap_const, args.k = n, thr, cap_const, k
        args.lo, args.hi, args.max_h = lo, hi, max_h
        args.mode = _CONSTANT if constant else _ROWS
        args.aligned = int(all(lane.data_ptr() % 16 == 0 for lane in read))
        args.n_out = n_out
        lib = _lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gkt_lanes_flags(code, reach, words[0].element_size(), ctypes.byref(args),
                                     stream)
        if rc != 0:
            raise RuntimeError(f"lanes_flags kernel launch failed with CUDA error {rc}")
        lanes_flags_cuda.launches += 1
    return outs[0], tuple(outs[1:])


lanes_flags_cuda.launches = 0
lanes_flags_cuda.passes = 1
