"""The native (C++) host library: FASTA parsing and byte-table scans.

Counterpart of ``genome_kmers_tpu/native/``, with its own copy of
``fasta_parser.cpp``. The library is built with g++ at first use into
``build/genome_kmers_tpu_torch/`` (``kernels/build.py``), named with a hash
of the source, the compile command and the host CPU's feature flags (the
code is compiled for the building CPU), and loaded with ctypes. A failed
build or load raises RuntimeError with the compiler's or the loader's
message: nothing falls back to NumPy without a word.

Each function here has a plain NumPy version that gives the same bytes and
that the tests hold it against: ``io/fasta.parse_fasta_bytes`` for the
parse, ``decode_rows_plain`` / ``decode_rows_var_plain`` for the row
decoders, ``ops/large.pack_strided_plain`` for the strided pack, a table gather and a flip (``ops/encoding.py``) for the reverse
complement, ``scan_alphabet_plain`` for the alphabet scan. The parse falls back to
its NumPy version in one case only, the one the native parse reports: more
records than ``max(1024, len(data) // 8)``.

``parse_fasta_bytes_native.runs`` counts the native parses and
``parse_fasta_bytes_native.chunks`` is the number of line-aligned chunks
(threads) of the last one.
"""

from __future__ import annotations

import ctypes
import functools
import os
import platform
from pathlib import Path

import numpy as np

from ..kernels import build

SOURCE = Path(__file__).resolve().parent / "fasta_parser.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_MT_THRESHOLD = 8 << 20  # parse buffers of 8 MB and more with threads
_ROW_THREADS_BYTES = 4 << 20  # decode with threads from 4 MB of output on
_PACK_THREADS_BYTES = 4 << 20  # strided pack with threads from 4 MB of input on
_SCAN_THREADS_BYTES = 4 << 20  # alphabet scan with threads from 4 MB on


def _host_cpu() -> bytes:
    """The CPU's feature flags, which ``-march=native`` code depends on."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode() + platform.machine().encode()


def library_path() -> Path:
    return build.hashed_library_path(
        SOURCE, " ".join(["g++", *GXX_FLAGS]).encode() + _host_cpu()
    )


def build_library() -> Path:
    """Compile the library unless it exists; return its path. Raises
    RuntimeError with g++'s output on failure."""
    return build.compile_library(SOURCE, ["g++", *GXX_FLAGS], library_path())


@functools.cache
def _lib() -> ctypes.CDLL:
    lib_path = build_library()
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise RuntimeError(f"could not load the native library {lib_path}: {e}") from e
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    signatures = {
        "gk_fasta_stats": (i64, [u8p, i64, i64p, i64]),
        "gk_fasta_fill": (i64, [u8p, i64, u8p, i64, i64p, i64p]),
        "gk_validate_alphabet": (i64, [u8p, i64, u8p, i64, i64p]),
        "gk_reverse_complement": (None, [u8p, i64, u8p, u8p]),
        "gk_chunk_bounds": (None, [u8p, i64, i64, i64p]),
        "gk_fasta_stats_mt": (i64, [u8p, i64, i64, i64p, i64p, i64p, i64p, i64p, i64p, i64]),
        "gk_fasta_fill_mt": (None, [u8p, i64, i64, i64p, i64p, i64p, u8p, i64p, i64p]),
        "gk_decode_rows": (None, [u8p, i64p, i64, i64, i64, u8p]),
        "gk_decode_rows_var": (None, [u8p, i64p, i64p, i64p, i64, i64, u8p]),
        "gk_pack_strided": (None, [u8p, i64, u8p, i64, i64, ctypes.POINTER(ctypes.c_uint32)]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _seg_starts(seq_lens: np.ndarray) -> np.ndarray:
    seg_starts = np.zeros(len(seq_lens), dtype=np.uint32)
    if len(seq_lens) > 1:
        seg_starts[1:] = np.cumsum(seq_lens[:-1] + 1).astype(np.uint32)
    return seg_starts


def _check_no_empty(seq_lens: np.ndarray) -> None:
    # like the NumPy parser's seg-start diff check, this misses a trailing
    # empty record: only the records before the last are rejected
    if len(seq_lens) > 1 and (seq_lens[:-1] == 0).any():
        raise ValueError("At least one empty sequence was found in the input file")


def parse_fasta_bytes_native(data: bytes, n_chunks=None):
    """Parse a FASTA buffer: (sba, seg_starts, header_spans), where
    ``header_spans`` are the (start, end) byte offsets of each header line
    (without its line end), or None when the buffer holds more records than
    ``max(1024, len(data) // 8)``. Buffers of 8 MB and more are cut into
    line-aligned chunks parsed by one thread each (as many as the CPUs, at
    most 16); ``n_chunks`` forces the threaded parse with that many."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if n_chunks is None and arr.size >= _MT_THRESHOLD:
        n_chunks = max(1, min(os.cpu_count() or 4, 16))
    out = _parse_single(arr) if n_chunks is None else _parse_threaded(arr, n_chunks)
    if out is not None:
        parse_fasta_bytes_native.runs += 1
        parse_fasta_bytes_native.chunks = n_chunks or 1
    return out


parse_fasta_bytes_native.runs = 0
parse_fasta_bytes_native.chunks = 0


def _parse_single(arr: np.ndarray):
    lib = _lib()
    n = arr.size
    max_records = max(1024, n // 8)
    seq_lens = np.zeros(max_records, dtype=np.int64)
    num_records = lib.gk_fasta_stats(_u8(arr), n, _i64(seq_lens), max_records)
    if num_records < 0:
        return None
    seq_lens = seq_lens[:num_records]
    _check_no_empty(seq_lens)
    sba_len = int(seq_lens.sum()) + max(num_records - 1, 0)
    sba = np.empty(max(sba_len, 1), dtype=np.uint8)
    header_starts = np.zeros(max(num_records, 1), dtype=np.int64)
    header_ends = np.zeros(max(num_records, 1), dtype=np.int64)
    written = lib.gk_fasta_fill(
        _u8(arr), n, _u8(sba), sba.size, _i64(header_starts), _i64(header_ends)
    )
    if written != sba_len:
        raise AssertionError("After parsing the fasta file, we expect sba to be full")
    spans = list(zip(header_starts[:num_records], header_ends[:num_records]))
    return sba[:sba_len], _seg_starts(seq_lens), spans


def _parse_threaded(arr: np.ndarray, n_chunks: int):
    """Line-aligned chunks, a two-phase parallel count (bytes and headers a
    chunk, then each header's sequence bytes within its chunk), the merge of
    records that continue into later chunks here, then a parallel fill at
    offsets computed from the counts."""
    lib = _lib()
    n = arr.size
    bounds = np.zeros(n_chunks + 1, dtype=np.int64)
    lib.gk_chunk_bounds(_u8(arr), n, n_chunks, _i64(bounds))
    max_records = max(1024, n // 8)
    seq_bytes = np.zeros(n_chunks, dtype=np.int64)
    lead = np.zeros(n_chunks, dtype=np.int64)
    nheaders = np.zeros(n_chunks, dtype=np.int64)
    hdr_offsets = np.zeros(max_records, dtype=np.int64)
    hdr_counts = np.zeros(max_records, dtype=np.int64)
    num_records = lib.gk_fasta_stats_mt(
        _u8(arr), n, n_chunks, _i64(bounds), _i64(seq_bytes), _i64(lead),
        _i64(nheaders), _i64(hdr_offsets), _i64(hdr_counts), max_records,
    )
    if num_records < 0:
        return None
    seq_lens = hdr_counts[:num_records].copy()
    # a chunk's sequence bytes before its first header belong to the last
    # record opened in an earlier chunk
    headers_before = np.concatenate([[0], np.cumsum(nheaders)[:-1]])
    last_open = -1
    for c in range(n_chunks):
        if lead[c] > 0 and last_open >= 0:
            seq_lens[last_open] += lead[c]
        if nheaders[c] > 0:
            last_open = int(headers_before[c] + nheaders[c] - 1)
    _check_no_empty(seq_lens)
    sba_len = int(seq_bytes.sum()) + max(num_records - 1, 0)
    sba = np.empty(max(sba_len, 1), dtype=np.uint8)
    seqb_before = np.concatenate([[0], np.cumsum(seq_bytes)[:-1]])
    out_offsets = seqb_before + headers_before - (headers_before > 0)
    header_starts = np.zeros(max(num_records, 1), dtype=np.int64)
    header_ends = np.zeros(max(num_records, 1), dtype=np.int64)
    lib.gk_fasta_fill_mt(
        _u8(arr), n, n_chunks, _i64(bounds), _i64(out_offsets),
        _i64(np.ascontiguousarray(headers_before)), _u8(sba),
        _i64(header_starts), _i64(header_ends),
    )
    spans = list(zip(header_starts[:num_records], header_ends[:num_records]))
    return sba[:sba_len], _seg_starts(seq_lens), spans


ACGT_BYTES = frozenset(b"ACGT$")  # the alphabet of the 2-bit keys
ALL_BYTES = frozenset(range(256))


def scan_alphabet_native(sba: np.ndarray, allowed_bytes, n_threads=None) -> tuple[int, bool]:
    """One pass over ``sba``: (the first byte value outside
    ``allowed_bytes``, or -1; whether every byte lies in {A, C, G, T, $}),
    the second False once an offending byte is found. With ``ALL_BYTES``
    allowed it is the alphabet answer alone. Threads (at most 8) from 4 MB
    of input on, unless ``n_threads`` is given."""
    table = np.zeros(256, dtype=np.uint8)
    table[list(allowed_bytes)] = 1
    src = np.ascontiguousarray(sba, dtype=np.uint8)
    if n_threads is None:
        n_threads = 1 if src.size < _SCAN_THREADS_BYTES else min(os.cpu_count() or 1, 8)
    outside = np.zeros(1, dtype=np.int64)
    first = int(_lib().gk_validate_alphabet(_u8(src), src.size, _u8(table), n_threads,
                                            _i64(outside)))
    return first, not outside[0]


def scan_alphabet_plain(sba: np.ndarray, allowed_bytes) -> tuple[int, bool]:
    """The plain version of ``scan_alphabet_native``: a scan for the first
    offending byte and a ``np.bincount``."""
    src = np.asarray(sba, dtype=np.uint8)
    bad = np.flatnonzero(~np.isin(src, np.fromiter(allowed_bytes, dtype=np.int64)))
    if len(bad):
        return int(src[bad[0]]), False
    present = set(np.flatnonzero(np.bincount(src, minlength=256)).tolist())
    return -1, present <= ACGT_BYTES


def validate_alphabet_native(sba: np.ndarray, allowed_bytes) -> int:
    """The first byte value of ``sba`` outside ``allowed_bytes``, or -1."""
    return scan_alphabet_native(sba, allowed_bytes)[0]


def reverse_complement_native(sba: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``table[sba][::-1]`` in one native scan."""
    src = np.ascontiguousarray(sba, dtype=np.uint8)
    out = np.empty_like(src)
    _lib().gk_reverse_complement(
        _u8(src), src.size, _u8(np.ascontiguousarray(table, dtype=np.uint8)), _u8(out)
    )
    return out


def _row_threads(out_bytes: int) -> int:
    return 1 if out_bytes < _ROW_THREADS_BYTES else min(os.cpu_count() or 1, 8)


def decode_rows_native(sba: np.ndarray, pos: np.ndarray, kmer_len: int) -> np.ndarray:
    """(n, kmer_len) uint8 matrix, row r = sba[pos[r] : pos[r] + kmer_len]:
    one contiguous copy a row, with threads for large outputs. Raises
    IndexError for a row past the end of ``sba``."""
    sba = np.ascontiguousarray(sba, dtype=np.uint8)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    n = len(pos)
    out = np.empty((n, kmer_len), dtype=np.uint8)
    if n == 0:
        return out
    if int(pos.min()) < 0 or int(pos.max()) + kmer_len > len(sba):
        raise IndexError("decode position out of bounds")
    _lib().gk_decode_rows(
        _u8(sba), _i64(pos), n, kmer_len, _row_threads(n * kmer_len), _u8(out)
    )
    return out


def decode_rows_plain(sba: np.ndarray, pos: np.ndarray, kmer_len: int) -> np.ndarray:
    """The plain version of ``decode_rows_native``: one gather an offset."""
    p = np.asarray(pos, dtype=np.int64)
    out = np.empty((len(p), kmer_len), dtype=np.uint8)
    for j in range(kmer_len):
        out[:, j] = sba[p + j]
    return out


def decode_rows_var_native(sba: np.ndarray, pos: np.ndarray, lens: np.ndarray):
    """(data, offsets) with data[offsets[r] : offsets[r + 1]] =
    sba[pos[r] : pos[r] + lens[r]], an arrow-style string column. Raises
    ValueError for a negative length, IndexError for a row past the end."""
    sba = np.ascontiguousarray(sba, dtype=np.uint8)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = len(pos)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    data = np.empty(max(total, 1), dtype=np.uint8)[:total]
    if n == 0:
        return data, offsets
    if (lens < 0).any():
        raise ValueError("negative decode length")
    if int(pos.min()) < 0 or int((pos + lens).max()) > len(sba):
        raise IndexError("decode position out of bounds")
    _lib().gk_decode_rows_var(
        _u8(sba), _i64(pos), _i64(lens), _i64(offsets), n, _row_threads(total), _u8(data)
    )
    return data, offsets


def decode_rows_var_plain(sba: np.ndarray, pos: np.ndarray, lens: np.ndarray):
    """The plain version of ``decode_rows_var_native``: one repeat-gather."""
    p = np.asarray(pos, dtype=np.int64)
    L = np.asarray(lens, dtype=np.int64)
    offsets = np.zeros(len(p) + 1, dtype=np.int64)
    np.cumsum(L, out=offsets[1:])
    idx = np.repeat(p - offsets[:-1], L) + np.arange(int(offsets[-1]), dtype=np.int64)
    return sba[idx], offsets


def pack_strided_native(sba: np.ndarray, table: np.ndarray, bits: int,
                        extra_words: int = 8) -> np.ndarray:
    """Strided rank pack (``bits`` 2 or 4; ``table`` byte -> rank): word w
    holds the ranks of bases ``w * (32 // bits) ..`` big-endian, ranks past
    the end 0, then ``extra_words`` zero words. Threads from 4 MB of input
    on. Bit-identical to ``ops/large.pack_strided_plain``."""
    if bits not in (2, 4):
        raise ValueError(f"pack_strided_native: bits must be 2 or 4, got {bits}")
    sba = np.ascontiguousarray(sba, dtype=np.uint8)
    table = np.ascontiguousarray(table, dtype=np.uint8)
    n = len(sba)
    out = np.zeros(-(-n // (32 // bits)) + extra_words, dtype=np.uint32)
    if n == 0:
        return out
    n_threads = 1 if n < _PACK_THREADS_BYTES else min(os.cpu_count() or 1, 8)
    _lib().gk_pack_strided(
        _u8(sba), n, _u8(table), bits, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out
