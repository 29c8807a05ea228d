"""SequenceCollection: the genome container of the PyTorch engine.

Counterpart of ``genome_kmers_tpu/sequence_collection.py``. The host side
is the same code with the same error strings: records joined by '$' into
one ASCII "sequence byte array" (SBA), uint32 segment starts, record names
in read order; the FASTA parse, the alphabet check and the reverse
complement of a large SBA run in the native library (``native/``); the
alphabet scan also answers whether the genome is ACGT only. The device side
is a ``_DeviceCache`` of torch tensors on the collection's explicit
``device``: the segment starts and ends, the 2-bit pack of an ACGT genome,
the 4-bit pack that any genome has, and the filters' genome scans and flag
planes (ops/filters.py). The packs are built from the uploaded bytes: the
2-bit pack by the hand-written kernel ``kernels/pack2.py`` on a CUDA
device, the 4-bit pack by tensor ops. ``_DeviceCache._build_from_strided``
is the strided upload of the JAX package: the host packs the bytes
strided (``ops/large.pack_rank{2,}_strided_np``, 1/4 or 1/2 the bytes),
uploads that and expands it on the device (``ops/keys.expand_strided2/4``)
to the same words, the bytes never crossing. Timed on an H100 it lost to
the bytes at 2 bits and tied at 4 (PERF.md §6), so no path takes it.
"""

from __future__ import annotations

import pickle
import shelve
from collections import Counter
from pathlib import Path
from typing import Callable, List, Union

import numpy as np
import torch

from .io.fasta import _get_fasta_record_name, parse_fasta_file
from .kernels.pack2 import pack_rank2_words_cuda
from .native import ALL_BYTES, scan_alphabet_native
from .ops.encoding import COMPLEMENT_TABLE, reverse_complement_bytes
from .ops.filters import (
    _gc_cumsum_ranks2,
    _gc_cumsum_ranks4,
    _next_ambiguous_ranks4,
    _run_lengths_ranks2,
    _run_lengths_ranks4,
    no_ambiguous_scan,
)
from .ops.keys import (
    compute_seg_ends,
    expand_strided2,
    expand_strided4,
    pack_rank_words,
    valid_len_all,
)
from .ops.large import pack_rank2_strided_np, pack_rank_strided_np


def resolve_device(device) -> torch.device:
    """The torch.device for ``device``; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{device}' was requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device ({device}) must be a CUDA device or the CPU")
    return dev


def bisect_right(a, x):
    """Rightmost insertion point of ``x`` in the sorted array ``a``."""
    lo, hi = 0, len(a)
    while lo < hi:
        mid = (lo + hi) // 2
        if x < a[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def reverse_complement_sba(sba: np.ndarray, complement_mapping_arr: np.ndarray, inplace=False):
    """Reverse complement of an ASCII SBA through a 256-entry byte table,
    written into ``sba`` when ``inplace``."""
    out = complement_mapping_arr[sba][::-1]
    if inplace:
        sba[:] = out
        return sba
    return out.copy()


def get_segment_num_from_sba_index(sba_idx: int, sba_strand: str, sba_seg_starts: np.ndarray) -> int:
    return int(np.searchsorted(sba_seg_starts, sba_idx, side="right")) - 1


def get_forward_seq_idx(
    sba_idx: int,
    sba_strand: str,
    seg_sba_start_idx: int,
    seg_sba_end_idx: int,
    one_based: bool = False,
) -> int:
    if sba_idx < seg_sba_start_idx:
        raise ValueError(f"sba_idx ({sba_idx}) must be >= seg_sba_start_idx ({seg_sba_start_idx})")
    if sba_idx > seg_sba_end_idx:
        raise ValueError(f"sba_idx ({sba_idx}) must be <= seg_end_start_idx ({seg_sba_end_idx})")
    if seg_sba_start_idx > seg_sba_end_idx:
        raise ValueError(
            f"seg_sba_start_idx ({seg_sba_start_idx}) must be <= seg_sba_end_idx ({seg_sba_end_idx})"
        )
    if seg_sba_start_idx < 0:
        raise ValueError(f"seg_sba_start_idx ({seg_sba_start_idx}) must be > 0")

    if sba_strand == "forward":
        seq_idx = sba_idx - seg_sba_start_idx
    elif sba_strand == "reverse_complement":
        seq_idx = seg_sba_end_idx - sba_idx
    else:
        raise ValueError(f"sba_strand ({sba_strand}) not recognized")

    if one_based:
        seq_idx += 1
    return int(seq_idx)


def get_sba_start_end_indices_for_segment(
    segment_num: int, sba_strand: str, sba_seg_starts: np.ndarray, len_sba: int
) -> tuple[int, int]:
    if segment_num < 0:
        raise ValueError(f"segment_num ({segment_num}) is out of bounds")
    elif segment_num >= len(sba_seg_starts):
        raise ValueError(f"segment_num ({segment_num}) is out of bounds")

    sba_start_index = int(sba_seg_starts[segment_num])
    if segment_num == len(sba_seg_starts) - 1:
        sba_end_index = len_sba - 1
    else:
        sba_end_index = int(sba_seg_starts[segment_num + 1]) - 2
    return sba_start_index, sba_end_index


class _DeviceCache:
    """Lazily built device tensors of one strand's SBA: the raw bytes, the
    segment starts and ends (int64), the 2-bit and 4-bit packs (int32 bit
    patterns of uint32 words), and the filters' genome scans (int32) and
    flag planes (uint8). ``acgt_only`` seeds the alphabet answer where the
    collection's scan already knows it."""

    def __init__(self, sba: np.ndarray, seg_starts: np.ndarray, device: torch.device,
                 acgt_only=None):
        self._sba_np = sba
        self._seg_starts_np = seg_starts
        self.device = device
        self._is_acgt_only = acgt_only
        self._sba_dev = None
        self._packed = None
        self._packed2 = None
        self._packed2_any = None
        self._seg_starts_dev = None
        self._seg_ends_dev = None
        self._vl_genome = None
        self._is_dollar = None
        self._next_amb = None
        self._gc_cumsum = None
        self._run_len = None
        # genome-order filter flag planes, keyed by (filter, params, k):
        # built once a strand, reused across queries (ops/filters.py)
        self.filter_flags = {}

    @property
    def sba(self) -> torch.Tensor:
        """The SBA bytes on the device, uploaded once."""
        if self._sba_dev is None:
            self._sba_dev = torch.from_numpy(self._sba_np).to(self.device)
        return self._sba_dev

    @property
    def is_acgt_only(self) -> bool:
        """True when the SBA alphabet is a subset of {A,C,G,T,$}, which the
        2-bit keys need: the answer of the collection's alphabet scan where
        it seeded one, else one native scan of the host bytes on up to 8
        threads (no device pass: the strided upload never needs the bytes
        on the device)."""
        if self._is_acgt_only is None:
            self._is_acgt_only = scan_alphabet_native(self._sba_np, ALL_BYTES)[1]
        return self._is_acgt_only

    def _build_from_strided(self, bits: int) -> torch.Tensor:
        """Per-position packed words through the strided upload: the host
        packs the SBA strided (``bits`` 2 or 4 a base), the pack is
        uploaded, and the device expands it; the bytes stay on the host.
        Equal to ``packed2`` / ``packed`` bit for bit. A failure of any step
        raises: no other route is tried."""
        n = len(self._sba_np)
        if bits == 2:
            strided, expand = pack_rank2_strided_np(self._sba_np), expand_strided2
        else:
            strided, expand = pack_rank_strided_np(self._sba_np), expand_strided4
        return expand(torch.from_numpy(strided.view(np.int32)).to(self.device), n)

    @property
    def packed(self) -> torch.Tensor:
        """4-bit packed words, from the uploaded bytes (plain tensor ops, as
        the JAX package computes them outside any kernel)."""
        if self._packed is None:
            self._packed = pack_rank_words(self.sba)
        return self._packed

    @property
    def packed2(self):
        """2-bit packed words, or None when the alphabet rules them out. On a
        CUDA device the pack kernel builds them from the uploaded bytes."""
        if not self.is_acgt_only:
            return None
        if self._packed2 is None:
            self._packed2 = pack_rank2_words_cuda(self.sba)
        return self._packed2

    @property
    def packed2_any(self) -> torch.Tensor:
        """2-bit packed words whatever the alphabet, for the hybrid sort
        (``ops/hybrid.py``), whose 2-bit stream never reads past a window
        free of non-ACGT bases: ``packed2`` on an ACGT genome, else the same
        pack of the bytes with every other byte ranked 0, built once (the
        pack kernel on a CUDA device)."""
        if self.is_acgt_only:
            return self.packed2
        if self._packed2_any is None:
            self._packed2_any = pack_rank2_words_cuda(self.sba)
        return self._packed2_any

    @property
    def seg_starts(self) -> torch.Tensor:
        if self._seg_starts_dev is None:
            self._seg_starts_dev = torch.from_numpy(
                self._seg_starts_np.astype(np.int64)
            ).to(self.device)
        return self._seg_starts_dev

    @property
    def seg_ends(self) -> torch.Tensor:
        if self._seg_ends_dev is None:
            self._seg_ends_dev = compute_seg_ends(self.seg_starts, len(self._sba_np))
        return self._seg_ends_dev

    # the filters' genome scans: int32 (every value is below 2^31 on one
    # device), each built once from the pack the sort reads, so a filtered
    # query on an ACGT genome reads no second copy of the bytes

    @property
    def valid_len_genome(self) -> torch.Tensor:
        """Bases to the segment end for every genome row (0 on a '$' row,
        which no k-mer position references)."""
        if self._vl_genome is None:
            self._vl_genome = valid_len_all(
                self.seg_starts, self.seg_ends, len(self._sba_np)
            ).to(torch.int32)
        return self._vl_genome

    @property
    def is_dollar(self) -> torch.Tensor:
        """Bool mask of the '$' rows, from the segment table, not the bytes."""
        if self._is_dollar is None:
            self._is_dollar = torch.zeros(len(self._sba_np), dtype=torch.bool, device=self.device)
            self._is_dollar[self.seg_starts[1:] - 1] = True
        return self._is_dollar

    @property
    def next_amb(self) -> torch.Tensor:
        """next_amb[i] = the first j >= i whose byte is neither ACGT nor
        '$': a constant sentinel on an ACGT genome, else from the 4-bit
        ranks."""
        if self._next_amb is None:
            if self.is_acgt_only:
                self._next_amb = no_ambiguous_scan(len(self._sba_np), self.device)
            else:
                self._next_amb = _next_ambiguous_ranks4(self.packed)
        return self._next_amb

    @property
    def gc_cumsum(self) -> torch.Tensor:
        """Prefix G/C counts (length n + 1), from the 2-bit pack on an ACGT
        genome, else from the 4-bit pack."""
        if self._gc_cumsum is None:
            if self.is_acgt_only:
                self._gc_cumsum = _gc_cumsum_ranks2(self.packed2)
            else:
                self._gc_cumsum = _gc_cumsum_ranks4(self.packed)
        return self._gc_cumsum

    @property
    def run_len(self) -> torch.Tensor:
        """Equal-byte run lengths. From the 2-bit ranks on an ACGT genome,
        with breaks at the '$' rows ('$' packs as rank 0, as A does); from
        the 4-bit ranks otherwise, which tell '$' apart themselves."""
        if self._run_len is None:
            if self.is_acgt_only:
                self._run_len = _run_lengths_ranks2(self.packed2, self.is_dollar)
            else:
                self._run_len = _run_lengths_ranks4(self.packed)
        return self._run_len


class SequenceCollection:
    """Holds all the information contained within a fasta file in a format
    conducive to k-mer sorting on a GPU.

    Terminology, invariants and members match the JAX package: record =
    header + sequence in read order; segment = leftmost-numbered span in the
    current SBA; '$' separators; >= 1 sequence; all sequence lengths > 0;
    unique record names. ``device`` (default "cuda") is where the k-mer
    engine's tensors live; it raises if CUDA was asked for and is absent.
    """

    def __init__(
        self,
        fasta_file_path: Union[Path, None] = None,
        sequence_list: Union[list, None] = None,
        strands_to_load: str = "forward",
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.forward_sba = None
        self._forward_sba_seg_starts = None
        self.forward_record_names = None
        self.revcomp_sba = None
        self._revcomp_sba_seg_starts = None
        self.revcomp_record_names = None
        self._strands_loaded = None
        self._fasta_file_path = None
        self._device = {}
        self._both_concat = None
        # (ACGT only, the host SBAs it holds for): the answer of the
        # alphabet scan at construction, which every strand shares (the
        # complement maps ACGT$ onto itself)
        self._alphabet = None
        self._scanned_acgt = None  # the answer of the last alphabet scan

        self._initialize_mapping_arrays()

        if fasta_file_path is None and sequence_list is None:
            return

        if fasta_file_path is not None and sequence_list is not None:
            raise ValueError("Only one of fasta_file_path and sequence_list can be specified")
        if strands_to_load not in ("forward", "reverse_complement", "both"):
            raise ValueError(f"strands_to_load unrecognized ({strands_to_load})")

        if fasta_file_path is not None:
            self._fasta_file_path = fasta_file_path
            self._initialize_from_fasta(fasta_file_path, strands_to_load)
        else:
            self._initialize_from_sequence_list(sequence_list, strands_to_load)

    # ------------------------------------------------------------------ #
    # device cache
    # ------------------------------------------------------------------ #

    def _invalidate_device_cache(self):
        self._device = {}
        self._both_concat = None

    def both_concat_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Host ``(sba, seg_starts)`` of the concatenated both-strand SBA:
        ``forward_sba + b'$' + revcomp_sba`` with 2R segments (the R forward
        segments, then the R reverse-complement segments in revcomp-SBA
        order). It backs a ``source_strand="both"`` k-mer index
        (``Kmers.from_strand``). Requires both strands loaded; a both-strand
        k-mer index stays under the uint32 ceiling, so uint32 segment starts
        suffice."""
        if self.forward_sba is None or self.revcomp_sba is None:
            raise ValueError(
                "both strands must be loaded to build the concatenated view"
            )
        if self._both_concat is None:
            n_fwd = len(self.forward_sba)
            off = n_fwd + 1
            sba = np.empty(off + len(self.revcomp_sba), dtype=np.uint8)
            sba[:n_fwd] = self.forward_sba
            sba[n_fwd] = ord("$")
            sba[off:] = self.revcomp_sba
            starts = np.concatenate(
                [
                    self._forward_sba_seg_starts.astype(np.uint64),
                    self._revcomp_sba_seg_starts.astype(np.uint64) + np.uint64(off),
                ]
            )
            if len(sba) > 2**32:
                raise NotImplementedError(
                    "concatenated both-strand SBA exceeds uint32 coordinates"
                )
            self._both_concat = (sba, starts.astype(np.uint32))
        return self._both_concat

    def device_cache(self, sba_strand: str) -> _DeviceCache:
        """Device tensors for the given strand's SBA: "forward",
        "reverse_complement" or "both_concat" (``both_concat_arrays``)."""
        if sba_strand not in self._device:
            if sba_strand == "forward":
                if self.forward_sba is None:
                    raise ValueError("forward strand is not loaded")
                arrays = (self.forward_sba, self._forward_sba_seg_starts)
            elif sba_strand == "reverse_complement":
                if self.revcomp_sba is None:
                    raise ValueError("reverse_complement strand is not loaded")
                arrays = (self.revcomp_sba, self._revcomp_sba_seg_starts)
            elif sba_strand == "both_concat":
                arrays = self.both_concat_arrays()
            else:
                raise ValueError(f"sba_strand ({sba_strand}) not recognized")
            sources = {"forward": (self.forward_sba,), "reverse_complement": (self.revcomp_sba,),
                       "both_concat": (self.forward_sba, self.revcomp_sba)}[sba_strand]
            self._device[sba_strand] = _DeviceCache(
                *arrays, self.device, acgt_only=self._known_acgt(*sources)
            )
        return self._device[sba_strand]

    def _known_acgt(self, *sbas):
        """The alphabet scan's answer where every one of the host ``sbas``
        is an array it holds for, else None (an SBA set from outside, as
        ``interop`` does, is scanned when asked)."""
        if self._alphabet is None:
            return None
        answer, known = self._alphabet
        return answer if all(any(a is k for k in known) for a in sbas) else None

    def _keep_alphabet(self, acgt_only: bool) -> None:
        self._alphabet = (acgt_only, tuple(
            a for a in (self.forward_sba, self.revcomp_sba) if a is not None))

    # ------------------------------------------------------------------ #
    # dunder / info
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        if self._strands_loaded == "forward" or self._strands_loaded == "both":
            return len(self._forward_sba_seg_starts)
        elif self._strands_loaded == "reverse_complement":
            return len(self._revcomp_sba_seg_starts)
        else:
            raise AssertionError(f"strands_loaded ({self._strands_loaded}) not recognized")

    def __str__(self) -> str:
        sba_strand = (
            "reverse_complement" if self._strands_loaded == "reverse_complement" else "forward"
        )
        sba = self.forward_sba if sba_strand == "forward" else self.revcomp_sba
        lines = []
        for record_name, s, e in self.iter_records(sba_strand):
            seq = bytearray(sba[s : e + 1]).decode()
            lines.append(f">{record_name}")
            lines.append(seq)
        return "\n".join(lines)

    def sequence_length(self, record_num=None, record_name=None):
        """Length of one record's sequence, or the total across all records."""
        if record_name is not None and record_num is not None:
            raise ValueError(
                f"record_num ({record_num}) and record_name ({record_name}) cannot both be specified"
            )
        strand = (
            "reverse_complement"
            if self._strands_loaded == "reverse_complement"
            else "forward"
        )
        records = list(self.iter_records(strand))
        if record_num is not None:
            if record_num < 0 or record_num >= len(records):
                raise ValueError(f"record_num ({record_num}) is out of bounds")
            _, s, e = records[record_num]
            return e - s + 1
        if record_name is not None:
            for name, s, e in records:
                if name == record_name:
                    return e - s + 1
            raise ValueError(f"record_name ({record_name}) not found")
        return sum(e - s + 1 for _, s, e in records)

    def iter_records(self, sba_strand: str = None):
        """Yield (record_name, sba_start, sba_end) in record_num order."""
        sba_strand = self._get_sba_strand_to_use(sba_strand)
        if sba_strand == "forward":
            for segment_num in range(len(self)):
                record_name = self.forward_record_names[segment_num]
                s, e = get_sba_start_end_indices_for_segment(
                    segment_num, sba_strand, self._forward_sba_seg_starts, len(self.forward_sba)
                )
                yield (record_name, s, e)
        elif sba_strand == "reverse_complement":
            # reverse segment order to keep record_num ordering
            for segment_num in range(len(self) - 1, -1, -1):
                record_name = self.revcomp_record_names[segment_num]
                s, e = get_sba_start_end_indices_for_segment(
                    segment_num, sba_strand, self._revcomp_sba_seg_starts, len(self.revcomp_sba)
                )
                yield (record_name, s, e)
        else:
            raise ValueError(f"sba_strand ({sba_strand}) must be 'forward' or 'reverse_complement'")

    def strands_loaded(self) -> str:
        return self._strands_loaded

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @staticmethod
    def _get_complement_mapping_array():
        return COMPLEMENT_TABLE.copy()

    def _initialize_mapping_arrays(self):
        self._allowed_bases = set("ACGTRYSWKMBDHVN$")
        self._allowed_uint8 = {ord(b) for b in self._allowed_bases}
        self._complement_mapping_arr = SequenceCollection._get_complement_mapping_array()
        self._uint8_to_u1_mapping = np.zeros(256, dtype="U1")
        self._u1_to_uint8_mapping = dict()
        for i in range(256):
            self._u1_to_uint8_mapping[chr(i)] = i
            self._uint8_to_u1_mapping[i] = chr(i)

    @staticmethod
    def _get_fasta_record_name(line: str) -> str:
        return _get_fasta_record_name(line)

    def _validate_alphabet(self, sba: np.ndarray) -> None:
        """Reject bytes outside IUPAC + '$', and keep in ``_scanned_acgt``
        whether every byte is one of ACGT$ (the 2-bit keys' alphabet), in
        one native scan; only when it finds an offending byte does
        ``np.bincount`` run, because the message lists every offending byte
        value."""
        first_bad, self._scanned_acgt = scan_alphabet_native(sba, self._allowed_uint8)
        if first_bad < 0:
            return
        counts = np.bincount(sba, minlength=256)
        values_not_allowed = {int(v) for v in np.flatnonzero(counts)} - self._allowed_uint8
        if values_not_allowed != set():
            raise ValueError(f"Sequence contains non-allowed characters! ({values_not_allowed})")

    def _load_forward_sba_from_fasta(self, fasta_file_path):
        sba, sba_seg_starts, record_names = parse_fasta_file(fasta_file_path)
        SequenceCollection._verify_record_names_are_unique(record_names)
        self._validate_alphabet(sba)
        return sba, sba_seg_starts, record_names

    def _initialize_from_fasta(self, fasta_file_path, strands_to_load: str) -> None:
        if strands_to_load not in ("forward", "reverse_complement", "both"):
            raise ValueError(f"strands_to_load not recognized ({strands_to_load})")

        self.forward_sba = None
        self._forward_sba_seg_starts = None
        self.revcomp_sba = None
        self._revcomp_sba_seg_starts = None
        self.forward_record_names = None
        self.revcomp_record_names = None
        self._invalidate_device_cache()

        if strands_to_load in ("forward", "both"):
            self.forward_sba, self._forward_sba_seg_starts, self.forward_record_names = (
                self._load_forward_sba_from_fasta(fasta_file_path)
            )

        if strands_to_load == "both":
            self.revcomp_sba = reverse_complement_bytes(self.forward_sba)
            self._revcomp_sba_seg_starts = self._get_opposite_strand_sba_start_indices(
                self._forward_sba_seg_starts, len(self.revcomp_sba)
            )
            self.revcomp_record_names = self.forward_record_names.copy()
            self.revcomp_record_names.reverse()
        elif strands_to_load == "reverse_complement":
            self.forward_sba, self._forward_sba_seg_starts, self.forward_record_names = (
                self._load_forward_sba_from_fasta(fasta_file_path)
            )
            self._strands_loaded = "forward"
            self.reverse_complement()

        self._strands_loaded = strands_to_load
        self._keep_alphabet(self._scanned_acgt)

    @staticmethod
    def _get_required_sba_length_from_sequence_list(sequence_list) -> int:
        total_seq_len = 0
        for record_name, seq in sequence_list:
            if len(seq) == 0:
                raise ValueError(
                    f"Each sequence in the collection must have length > 0.  Record '{record_name}' has a sequence lengt of 0"
                )
            total_seq_len += len(seq)
        return total_seq_len + len(sequence_list) - 1

    def _get_sba_from_sequence_list(self, sequence_list) -> np.ndarray:
        """No uppercasing: invalid characters, lowercase included, raise."""
        sba_length = SequenceCollection._get_required_sba_length_from_sequence_list(sequence_list)
        parts = []
        for i, (_, seq) in enumerate(sequence_list):
            parts.append(np.frombuffer(seq.encode("utf-8"), dtype=np.uint8))
            if i != len(sequence_list) - 1:
                parts.append(np.array([ord("$")], dtype=np.uint8))
        sba = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
        if len(sba) != sba_length:
            raise AssertionError("logic error building sba from sequence_list")
        self._validate_alphabet(sba)
        return sba

    @staticmethod
    def _get_sba_starts_from_sequence_list(sequence_list) -> np.ndarray:
        lens = np.array([len(seq) for _, seq in sequence_list], dtype=np.int64)
        starts = np.zeros(len(sequence_list), dtype=np.uint32)
        if len(sequence_list) > 1:
            starts[1:] = np.cumsum(lens[:-1] + 1).astype(np.uint32)
        return starts

    @staticmethod
    def _verify_record_names_are_unique(record_names):
        counter = Counter(record_names)
        if len(record_names) != len(counter):
            num_repeated = len([1 for c in counter.values() if c > 1])
            raise ValueError(f"sequence_list contains {num_repeated} repeated record_names")

    @staticmethod
    def _get_record_names_from_sequence_list(sequence_list) -> List[str]:
        record_names = [record_name for record_name, _ in sequence_list]
        SequenceCollection._verify_record_names_are_unique(record_names)
        return record_names

    def _initialize_from_sequence_list(self, sequence_list, strands_to_load: str):
        if strands_to_load not in ("forward", "reverse_complement", "both"):
            raise ValueError(f"strands_to_load not recognized ({strands_to_load})")

        self.forward_sba = None
        self._forward_sba_seg_starts = None
        self.revcomp_sba = None
        self._revcomp_sba_seg_starts = None
        self.forward_record_names = None
        self.revcomp_record_names = None
        self._invalidate_device_cache()

        if strands_to_load in ("forward", "both"):
            self.forward_sba = self._get_sba_from_sequence_list(sequence_list)
            self._forward_sba_seg_starts = self._get_sba_starts_from_sequence_list(sequence_list)
            self.forward_record_names = self._get_record_names_from_sequence_list(sequence_list)

        if strands_to_load == "both":
            self.revcomp_sba = reverse_complement_bytes(self.forward_sba)
            self._revcomp_sba_seg_starts = self._get_opposite_strand_sba_start_indices(
                self._forward_sba_seg_starts, len(self.revcomp_sba)
            )
            self.revcomp_record_names = self.forward_record_names.copy()
            self.revcomp_record_names.reverse()
        elif strands_to_load == "reverse_complement":
            fwd = self._get_sba_from_sequence_list(sequence_list)
            self.revcomp_sba = reverse_complement_bytes(fwd)
            starts = self._get_sba_starts_from_sequence_list(sequence_list)
            self._revcomp_sba_seg_starts = self._get_opposite_strand_sba_start_indices(
                starts, len(self.revcomp_sba)
            )
            self.revcomp_record_names = self._get_record_names_from_sequence_list(sequence_list)
            self.revcomp_record_names.reverse()

        self._strands_loaded = strands_to_load
        self._keep_alphabet(self._scanned_acgt)

    # ------------------------------------------------------------------ #
    # strand manipulation
    # ------------------------------------------------------------------ #

    def reverse_complement(self):
        if self._strands_loaded == "both":
            raise ValueError(f"self._strands_loaded ({self._strands_loaded}) cannot be 'both'")
        self._invalidate_device_cache()
        acgt_only = self._known_acgt(
            self.forward_sba if self._strands_loaded == "forward" else self.revcomp_sba)

        if self._strands_loaded == "forward":
            self.revcomp_sba = reverse_complement_bytes(self.forward_sba)
            self.forward_sba = None
            self._revcomp_sba_seg_starts = self._get_opposite_strand_sba_start_indices(
                self._forward_sba_seg_starts, len(self.revcomp_sba)
            )
            self._forward_sba_seg_starts = None
            self.revcomp_record_names = self.forward_record_names
            self.revcomp_record_names.reverse()
            self.forward_record_names = None
            self._strands_loaded = "reverse_complement"
        elif self._strands_loaded == "reverse_complement":
            self.forward_sba = reverse_complement_bytes(self.revcomp_sba)
            self.revcomp_sba = None
            self._forward_sba_seg_starts = self._get_opposite_strand_sba_start_indices(
                self._revcomp_sba_seg_starts, len(self.forward_sba)
            )
            self._revcomp_sba_seg_starts = None
            self.forward_record_names = self.revcomp_record_names
            self.forward_record_names.reverse()
            self.revcomp_record_names = None
            self._strands_loaded = "forward"
        if acgt_only is not None:
            self._keep_alphabet(acgt_only)

    @staticmethod
    def _get_opposite_strand_sba_index(sba_idx: int, sba_len: int) -> int:
        if sba_idx < 0 or sba_idx >= sba_len:
            raise ValueError(f"sba_idx ({sba_idx}) is out of bounds")
        return sba_len - 1 - sba_idx

    @staticmethod
    def _get_opposite_strand_sba_indices(sba_indices: np.ndarray, sba_len: int) -> np.ndarray:
        if (sba_indices.astype(np.int64) < 0).any() or (
            sba_indices.astype(np.int64) >= sba_len
        ).any():
            raise ValueError("There is at least one sba index that is out of bounds")
        return (sba_len - 1 - sba_indices.astype(np.int64)).astype(sba_indices.dtype)

    @staticmethod
    def _get_opposite_strand_sba_start_indices(sba_starts: np.ndarray, sba_len: int) -> np.ndarray:
        """End-index flip: the opposite strand's segment starts."""
        sba_end_indices = np.copy(sba_starts)
        if len(sba_end_indices) > 1:
            sba_end_indices[:-1] = sba_end_indices[1:] - 2
        sba_end_indices[-1] = sba_len - 1
        return SequenceCollection._get_opposite_strand_sba_indices(
            np.flip(sba_end_indices), sba_len
        )

    # ------------------------------------------------------------------ #
    # record lookups
    # ------------------------------------------------------------------ #

    def get_record_loc_from_sba_index(
        self, sba_idx: int, sba_strand: str = None, one_based: bool = False
    ) -> tuple[str, str, int]:
        """(strand, record_name, seq_idx) for an SBA index."""
        sba_strand = self._get_sba_strand_to_use(sba_strand)
        if sba_strand == "forward":
            seg_starts, names, sba = (
                self._forward_sba_seg_starts,
                self.forward_record_names,
                self.forward_sba,
            )
        elif sba_strand == "reverse_complement":
            seg_starts, names, sba = (
                self._revcomp_sba_seg_starts,
                self.revcomp_record_names,
                self.revcomp_sba,
            )
        else:
            raise ValueError(f"sba_strand ({sba_strand}) not recognized")

        segment_num = get_segment_num_from_sba_index(sba_idx, sba_strand, seg_starts)
        record_name = names[segment_num]
        s, e = get_sba_start_end_indices_for_segment(segment_num, sba_strand, seg_starts, len(sba))
        seq_idx = get_forward_seq_idx(sba_idx, sba_strand, s, e, one_based=one_based)
        strand = "+" if sba_strand == "forward" else "-"
        return (strand, record_name, seq_idx)

    def get_record_name_from_sba_index(self, sba_idx: int, sba_strand: str = None) -> str:
        sba_strand = self._get_sba_strand_to_use(sba_strand)
        if sba_strand == "forward":
            segment_num = get_segment_num_from_sba_index(
                sba_idx, sba_strand, self._forward_sba_seg_starts
            )
            return self.forward_record_names[segment_num]
        elif sba_strand == "reverse_complement":
            segment_num = get_segment_num_from_sba_index(
                sba_idx, sba_strand, self._revcomp_sba_seg_starts
            )
            return self.revcomp_record_names[segment_num]
        raise ValueError(f"sba_strand ({sba_strand}) not recognized")

    def _get_sba_strand_to_use(self, sba_strand: str) -> str:
        if sba_strand is not None:
            if sba_strand == "forward":
                if self._strands_loaded == "reverse_complement":
                    raise ValueError(
                        f"sba_strand ({sba_strand}) does not match _strands_loaded ({self._strands_loaded})"
                    )
            elif sba_strand == "reverse_complement":
                if self._strands_loaded == "forward":
                    raise ValueError(
                        f"sba_strand ({sba_strand}) does not match _strands_loaded ({self._strands_loaded})"
                    )
            else:
                raise ValueError(f"sba_strand ({sba_strand}) not recognized")
        if self._strands_loaded == "both" and sba_strand is None:
            raise ValueError("sba_strand must be specified when both strands are loaded")
        return self._strands_loaded if self._strands_loaded != "both" else sba_strand

    def get_segment_num_from_sba_index(self, sba_idx: int, sba_strand: str = None) -> int:
        sba_strand = self._get_sba_strand_to_use(sba_strand)
        if sba_strand == "forward":
            if sba_idx < 0 or sba_idx >= len(self.forward_sba):
                raise IndexError(f"sba_idx ({sba_idx}) is out of bounds")
            return get_segment_num_from_sba_index(
                sba_idx, sba_strand, self._forward_sba_seg_starts
            )
        elif sba_strand == "reverse_complement":
            if sba_idx < 0 or sba_idx >= len(self.revcomp_sba):
                raise IndexError(f"sba_idx ({sba_idx}) is out of bounds")
            return get_segment_num_from_sba_index(
                sba_idx, sba_strand, self._revcomp_sba_seg_starts
            )

    def get_sba_start_end_indices_for_segment(
        self, segment_num: int, sba_strand: str = None
    ) -> tuple[int, int]:
        sba_strand = self._get_sba_strand_to_use(sba_strand)
        if sba_strand == "forward":
            seg_starts, sba = self._forward_sba_seg_starts, self.forward_sba
        elif sba_strand == "reverse_complement":
            seg_starts, sba = self._revcomp_sba_seg_starts, self.revcomp_sba
        if segment_num < 0 or segment_num >= len(seg_starts):
            raise ValueError(f"segment_num ({segment_num}) is out of bounds")
        return get_sba_start_end_indices_for_segment(segment_num, sba_strand, seg_starts, len(sba))

    def generate_get_record_info_from_sba_index_func(self, one_based: bool = False) -> Callable:
        """Host closure mapping an SBA index to full record info."""
        sba_strand = self._get_sba_strand_to_use(self.strands_loaded())
        if sba_strand == "forward":
            record_names = tuple(self.forward_record_names)
            sba_seg_starts = self._forward_sba_seg_starts
            seq_strand = "+"
            len_sba = len(self.forward_sba)
        elif sba_strand == "reverse_complement":
            record_names = tuple(self.revcomp_record_names)
            sba_seg_starts = self._revcomp_sba_seg_starts
            seq_strand = "-"
            len_sba = len(self.revcomp_sba)
        else:
            raise ValueError(f"sba_strand ({sba_strand}) not recognized")

        def get_record_info_from_sba_index(sba_idx: int):
            seg_num = get_segment_num_from_sba_index(sba_idx, sba_strand, sba_seg_starts)
            s, e = get_sba_start_end_indices_for_segment(
                seg_num, sba_strand, sba_seg_starts, len_sba
            )
            seq_start_idx = get_forward_seq_idx(sba_idx, sba_strand, s, e, one_based=one_based)
            return (seg_num, s, e, seq_strand, record_names[seg_num], seq_start_idx)

        return get_record_info_from_sba_index

    # ------------------------------------------------------------------ #
    # equality
    # ------------------------------------------------------------------ #

    def __ne__(self, other):
        return not self.__eq__(other)

    def __eq__(self, other):
        """Memberwise equality ignoring _fasta_file_path and the device."""

        def _arr_eq(a, b):
            if a is None and b is not None:
                return False
            if a is not None and b is None:
                return False
            if a is None and b is None:
                return True
            return np.array_equal(a, b)

        def _val_eq(a, b):
            if (a is None) != (b is None):
                return False
            return a == b

        return (
            _arr_eq(self.forward_sba, other.forward_sba)
            and _arr_eq(self._forward_sba_seg_starts, other._forward_sba_seg_starts)
            and _val_eq(self.forward_record_names, other.forward_record_names)
            and _arr_eq(self.revcomp_sba, other.revcomp_sba)
            and _arr_eq(self._revcomp_sba_seg_starts, other._revcomp_sba_seg_starts)
            and _val_eq(self.revcomp_record_names, other.revcomp_record_names)
            and _val_eq(self._strands_loaded, other._strands_loaded)
        )

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    # The JAX package's schema (its sequence_collection.py:930-1013): group
    # "seq_coll" in hdf5, keys "seq_coll.<member>" in shelve, the same
    # dataset names, dtypes and sentinels for None, so a file either package
    # writes loads into the other. Loading replaces the host arrays and
    # drops the device cache: the next device call uploads to this
    # collection's own device.

    @staticmethod
    def _set_for_export(value, value_if_none):
        return value_if_none if value is None else value

    @staticmethod
    def _correct_import(value, value_if_none):
        if isinstance(value, np.ndarray):
            if value.shape == (0,):
                return None
        elif value == value_if_none:
            return None
        return value

    def save(self, save_file_path, mode: str = "a", format: str = "hdf5") -> None:
        """Write the collection to ``save_file_path``: ``format`` "hdf5"
        (needs h5py; ``mode`` is the file's open mode) or "shelve"."""
        if format == "hdf5":
            self._save_hdf5(save_file_path, mode=mode)
        elif format == "shelve":
            self._save_shelve(save_file_path)
        else:
            raise ValueError(f"format ({format}) not recognized")

    def load(self, load_file_path, format: str = "hdf5"):
        """Replace this collection's contents with the file's."""
        if format == "hdf5":
            self._load_h5py(load_file_path)
        elif format == "shelve":
            self._load_shelve(load_file_path)
        else:
            raise ValueError(f"format ({format}) not recognized")

    def _save_hdf5(self, save_file_path, mode: str = "a") -> None:
        import h5py

        with h5py.File(save_file_path, mode) as file:
            grp = file.create_group("seq_coll")
            grp["forward_sba"] = self._set_for_export(
                self.forward_sba, np.array([], dtype=np.uint8)
            )
            grp["_forward_sba_seg_starts"] = self._set_for_export(self._forward_sba_seg_starts, [])
            grp["forward_record_names"] = self._set_for_export(self.forward_record_names, [])
            grp["revcomp_sba"] = self._set_for_export(
                self.revcomp_sba, np.array([], dtype=np.uint8)
            )
            grp["_revcomp_sba_seg_starts"] = self._set_for_export(self._revcomp_sba_seg_starts, [])
            grp["revcomp_record_names"] = self._set_for_export(self.revcomp_record_names, [])
            grp["_strands_loaded"] = self._set_for_export(self._strands_loaded, "")
            grp["_fasta_file_path"] = str(self._set_for_export(self._fasta_file_path, ""))

    def _load_h5py(self, load_file_path):
        import h5py

        with h5py.File(load_file_path, "r") as file:
            grp = file["seq_coll"]
            empty_sba = np.array([], dtype=np.uint8)
            self.forward_sba = self._correct_import(grp["forward_sba"][:], empty_sba)
            self._forward_sba_seg_starts = self._correct_import(
                grp["_forward_sba_seg_starts"][:], []
            )
            self.forward_record_names = [v.decode("utf-8") for v in grp["forward_record_names"]]
            self.forward_record_names = self._correct_import(self.forward_record_names, [])
            self.revcomp_sba = self._correct_import(grp["revcomp_sba"][:], empty_sba)
            self._revcomp_sba_seg_starts = self._correct_import(
                grp["_revcomp_sba_seg_starts"][:], []
            )
            self.revcomp_record_names = [v.decode("utf-8") for v in grp["revcomp_record_names"]]
            self.revcomp_record_names = self._correct_import(self.revcomp_record_names, [])
            self._strands_loaded = self._correct_import(
                grp["_strands_loaded"][()].decode("utf-8"), ""
            )
            self._fasta_file_path = self._correct_import(
                grp["_fasta_file_path"][()].decode("utf-8"), ""
            )
            if self._fasta_file_path is not None:
                self._fasta_file_path = Path(self._fasta_file_path)
            self._initialize_mapping_arrays()
            self._invalidate_device_cache()
            self._alphabet = None  # the loaded arrays were not scanned

    def _save_shelve(self, save_file_path) -> None:
        with shelve.open(save_file_path, protocol=pickle.DEFAULT_PROTOCOL) as db:
            db["seq_coll.forward_sba"] = self.forward_sba
            db["seq_coll._forward_sba_seg_starts"] = self._forward_sba_seg_starts
            db["seq_coll.forward_record_names"] = self.forward_record_names
            db["seq_coll.revcomp_sba"] = self.revcomp_sba
            db["seq_coll._revcomp_sba_seg_starts"] = self._revcomp_sba_seg_starts
            db["seq_coll.revcomp_record_names"] = self.revcomp_record_names
            db["seq_coll._strands_loaded"] = self._strands_loaded
            db["seq_coll._fasta_file_path"] = self._fasta_file_path

    def _load_shelve(self, load_file_path):
        with shelve.open(load_file_path) as db:
            self.forward_sba = db["seq_coll.forward_sba"]
            self._forward_sba_seg_starts = db["seq_coll._forward_sba_seg_starts"]
            self.forward_record_names = db["seq_coll.forward_record_names"]
            self.revcomp_sba = db["seq_coll.revcomp_sba"]
            self._revcomp_sba_seg_starts = db["seq_coll._revcomp_sba_seg_starts"]
            self.revcomp_record_names = db["seq_coll.revcomp_record_names"]
            self._strands_loaded = db["seq_coll._strands_loaded"]
            self._fasta_file_path = db["seq_coll._fasta_file_path"]
            self._initialize_mapping_arrays()
            self._invalidate_device_cache()
            self._alphabet = None  # the loaded arrays were not scanned
