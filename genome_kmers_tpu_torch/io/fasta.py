"""FASTA ingestion.

Counterpart of ``genome_kmers_tpu/io/fasta.py``. ``parse_fasta_file`` parses
with the native C++ library (``native/``, multithreaded from 8 MB on);
``parse_fasta_bytes``, one whole-buffer NumPy pipeline (boolean-mask
compress, table-lookup uppercase, one ``np.insert`` for the '$'
separators), is its plain version: the tests hold the two byte for byte,
and it parses the one buffer the native parse declines, one with more
records than ``max(1024, len // 8)``. Output and error strings are the JAX
package's: one uint8 ASCII array with records joined by '$', uint32 segment
start indices, and the record-name list (after '>' up to whitespace).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..native import parse_fasta_bytes_native

_UPPER_TABLE = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER_TABLE[_c] = _c - 32


def parse_fasta_bytes(data: bytes) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Parse an in-memory FASTA buffer into (sba, sba_seg_starts, record_names):
    sequence lines uppercased, empty sequences rejected via the seg-start diff
    check."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    if n == 0:
        raise AssertionError("After parsing the fasta file, we expect sba to be full")

    # line structure
    nl = np.flatnonzero(arr == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    if line_starts[-1] >= n:  # trailing newline -> no final partial line
        line_starts = line_starts[:-1]
    line_ends = np.concatenate([nl, [n]])[: len(line_starts)]  # exclusive of '\n'

    is_header = arr[line_starts] == ord(">")
    header_idx = np.flatnonzero(is_header)
    num_records = int(header_idx.size)

    record_names = []
    for h in header_idx:
        s, e = int(line_starts[h]), int(line_ends[h])
        line = data[s:e].decode()
        record_names.append(_get_fasta_record_name(line))

    # keep-mask over the raw buffer: sequence-line bytes only, minus \n and \r
    keep = np.ones(n, dtype=bool)
    keep[nl] = False
    keep[arr == ord("\r")] = False
    for h in header_idx:
        keep[int(line_starts[h]) : int(line_ends[h])] = False

    body = _UPPER_TABLE[arr[keep]]
    total_seq_len = int(body.size)

    # per-record sequence lengths from per-LINE kept-byte counts: kept(line)
    # = line length minus a trailing '\r', zeroed for header lines; cumulate
    # and read off at each header's line index
    line_kept = (line_ends - line_starts).astype(np.int64)
    nonempty = line_ends > line_starts
    has_cr = np.zeros(len(line_starts), dtype=np.int64)
    has_cr[nonempty] = (arr[line_ends[nonempty] - 1] == ord("\r")).astype(np.int64)
    line_kept -= has_cr
    line_kept[header_idx] = 0
    kept_before_line = np.concatenate([[0], np.cumsum(line_kept)])
    kept_before_header = kept_before_line[header_idx]
    seq_lens = np.diff(np.concatenate([kept_before_header, [total_seq_len]]))

    sba_len = total_seq_len + num_records - 1
    # '$' insertion points: after each record except the last
    ins = np.cumsum(seq_lens[:-1]).astype(np.int64)
    sba = np.insert(body, ins, np.uint8(ord("$"))) if num_records > 1 else body
    if sba.size != max(sba_len, 0):
        raise AssertionError("After parsing the fasta file, we expect sba to be full")

    sba_seg_starts = np.zeros(num_records, dtype=np.uint32)
    if num_records > 1:
        sba_seg_starts[1:] = (ins + np.arange(1, num_records, dtype=np.int64)).astype(
            np.uint32
        )

    # empty-sequence detection: adjacent seg starts closer than 2
    if (np.diff(sba_seg_starts.astype(np.int64)) < 2).any():
        raise ValueError("At least one empty sequence was found in the input file")

    return sba, sba_seg_starts, record_names


def iter_fasta_records(fasta_file_path):
    """Yield ``(name, sequence_bytes)`` per FASTA record without building the
    concatenated SBA. Same parsing rules as ``parse_fasta_bytes``; duplicate
    names and mid-file empty sequences are rejected, a trailing empty record
    is skipped."""
    data = Path(fasta_file_path).read_bytes()
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    if n == 0:
        raise AssertionError("After parsing the fasta file, we expect sba to be full")
    nl = np.flatnonzero(arr == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    if line_starts[-1] >= n:
        line_starts = line_starts[:-1]
    line_ends = np.concatenate([nl, [n]])[: len(line_starts)]
    is_header = arr[line_starts] == ord(">")
    header_idx = np.flatnonzero(is_header)
    if header_idx.size == 0:
        # headerless input: parse_fasta_bytes fails its fullness check
        raise AssertionError("After parsing the fasta file, we expect sba to be full")
    seen = set()
    for hi_i, h in enumerate(header_idx):
        s, e = int(line_starts[h]), int(line_ends[h])
        name = _get_fasta_record_name(data[s:e].decode())
        if name in seen:
            raise ValueError(
                f"Repeated record name ({name}) found in the input file"
            )
        seen.add(name)
        if hi_i == 0 and int(line_starts[h]) != 0:
            raise ValueError(
                f"sequence data before the first '>' header in "
                f"{fasta_file_path} (malformed FASTA)"
            )
        body_start = int(line_ends[h]) + 1
        body_end = (
            int(line_starts[header_idx[hi_i + 1]])
            if hi_i + 1 < len(header_idx)
            else n
        )
        chunk = arr[body_start:body_end] if body_start < body_end else arr[0:0]
        keep = (chunk != ord("\n")) & (chunk != ord("\r"))
        seq = _UPPER_TABLE[chunk[keep]]
        if seq.size == 0:
            if hi_i + 1 == len(header_idx):
                continue  # trailing empty record: accepted (skipped)
            raise ValueError(
                f"At least one empty sequence was found in the input file ({fasta_file_path})"
            )
        yield name, seq.tobytes()


def parse_fasta_file(fasta_file_path) -> tuple[np.ndarray, np.ndarray, list[str]]:
    data = Path(fasta_file_path).read_bytes()
    try:
        return _parse_fasta_dispatch(data)
    except ValueError as e:
        if "empty sequence" in str(e):
            raise ValueError(
                f"At least one empty sequence was found in the input file ({fasta_file_path})"
            ) from None
        raise


def _parse_fasta_dispatch(data: bytes) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """The native parse, or the NumPy one where the native parse declines
    the buffer (too many records); byte-identical outputs. A buffer with no
    sequence bytes (no record, or blank lines only) raises the reference's
    AssertionError on both routes."""
    result = parse_fasta_bytes_native(data)
    if result is None:
        sba, seg_starts, record_names = parse_fasta_bytes(data)
    else:
        sba, seg_starts, header_spans = result
        record_names = None
    if sba.size == 0:
        raise AssertionError("After parsing the fasta file, we expect sba to be full")
    if record_names is None:
        record_names = [
            _get_fasta_record_name(data[int(s) : int(e)].decode()) for s, e in header_spans
        ]
    return sba, seg_starts, record_names


def _get_fasta_record_name(line: str) -> str:
    if not line.startswith(">"):
        raise ValueError("line does not start with '>'")
    return line[1:].strip().split()[0]
