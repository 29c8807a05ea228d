"""Where compiled code is kept across processes.

Counterpart of ``genome_kmers_tpu/runtime.py``, which points JAX's
persistent compilation cache at a directory. The port compiles its CUDA
kernels with ``nvcc`` and its host library with ``g++`` at first use, and
keeps each library, named with a hash of its source and compile command,
in ``kernels/build.BUILD_DIR`` (by default ``build/genome_kmers_tpu_torch/``
at the root of the checkout). A later process finds it there and builds
nothing.
"""

from __future__ import annotations

from pathlib import Path

from .kernels import build

DEFAULT_BUILD_DIR = build.BUILD_DIR


def enable_persistent_compilation_cache(cache_dir: str | None = None) -> None:
    """Keep the compiled kernels and host library in ``cache_dir`` (the
    default directory where it is None) from now on. Builds nothing and is
    safe to call more than once; a library that is already loaded stays
    loaded. It makes no kernel optional: a library that fails to build
    still raises."""
    build.BUILD_DIR = DEFAULT_BUILD_DIR if cache_dir is None else Path(cache_dir).resolve()
