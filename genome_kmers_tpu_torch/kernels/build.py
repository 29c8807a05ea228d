"""Builds the package's shared libraries at first use.

Each CUDA kernel source under ``genome_kmers_tpu_torch/csrc/`` exports a
plain C function, so it compiles with ``nvcc`` alone, without PyTorch's
headers, in seconds; the host library of ``native/`` compiles with ``g++``.
Both are loaded with ctypes. A library goes to ``build/genome_kmers_tpu_torch/``
at the root of the checkout, named with a hash of its source and of its
compile command, so an edited source builds anew and an unchanged one is
reused. The compiler's report (for ``nvcc``, ``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genome_kmers_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def hashed_library_path(source: Path, key: bytes = b"") -> Path:
    """Where the library built from ``source`` lives: its name carries a hash
    of the source and of ``key`` (what else decides the binary)."""
    digest = hashlib.sha256(source.read_bytes() + key).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def compile_library(source: Path, command: list, lib: Path) -> Path:
    """Run ``command + ["-o", <temporary file>, source]`` unless ``lib``
    already exists, then move the result to ``lib`` in one step, so that a
    concurrent loader (another process building the same library) sees all
    of it or nothing. Raises RuntimeError with the compiler's output on
    failure."""
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*command, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(command[0]).name} failed to build {source.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    return hashed_library_path(CSRC / source)


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` with nvcc unless its library already
    exists; return the library's path. Raises RuntimeError with nvcc's
    output on failure."""
    lib = library_path(source)
    if lib.exists():
        return lib
    return compile_library(CSRC / source, [_nvcc(), *NVCC_FLAGS], lib)


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    return ctypes.CDLL(str(build(source)))
