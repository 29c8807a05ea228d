"""LargeKmers: the k-mer index of the 64-bit regime, past 2^32 bases.

Counterpart of ``genome_kmers_tpu/large_kmers.py``. ``Kmers`` keeps the
reference's hard limit of 2^32 k-mers; ``LargeKmers`` is the index past it
(a both-strand human genome holds about 6.2G k-mers). The genome lives as a
strided pack (``ops/large.py``: 16 bases a uint32 word on 2-bit keys for
ACGT genomes, 8 on 4-bit keys for IUPAC ones), built while the records
stream in, so the ASCII SBA never exists whole. Positions and run ids are
int64 tensors (the JAX package's (hi, lo) uint32 pairs); in the lane sort a
position takes two int32 lanes, hi then lo. Counts and totals are exact
and come back as uint64.

``sort(mesh)`` is a sample sort over a mesh (``parallel/make_mesh``; one
shard works): a ``max_kmer_len`` within one compare window (64 bases on
2-bit keys, 32 on 4-bit keys) takes one exchange and keeps the sorted key
lanes for the statistics; anything longer, and suffix mode (None), takes
the refinement rounds and keeps the converged run ids. A
``both_strands=True`` index also takes ``track_strands_separately``.

The mesh decides where the work runs: ``make_mesh()`` takes the CUDA cards
(and raises without one), ``make_mesh(n, devices=["cpu"] * n)`` the CPU.
The strided pack is uploaded to the mesh's devices once and kept there.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

from .ops.large import (
    build_dense_positions,
    decode_strided_np,
    decode_strided_var_np,
    pack_rank2_strided_np,
    pack_rank_strided_np,
)
from .ops.keys import widen_u32

_ACGT = b"ACGT"
_IUPAC = b"ACGTRYSWKMBDHVN"
# streaming pack chunk: a multiple of both 8 and 16 bases per word
_CHUNK = 1 << 24


def _is_acgt_only(seq: bytes) -> bool:
    return not seq.translate(None, _ACGT)


def _as_bytes(seq) -> bytes:
    return seq.encode() if isinstance(seq, str) else bytes(seq)


def _real(per_shard: list, is_pad: list) -> np.ndarray:
    """The real rows of a per-shard array, in global order, on the host."""
    return np.concatenate([x[~pad].cpu().numpy() for x, pad in zip(per_shard, is_pad)])


class LargeKmers:
    """64-bit-regime k-mer index over a strided genome pack."""

    def __init__(
        self,
        packed_words: np.ndarray,
        seg_starts_u64: np.ndarray,
        seg_ends_u64: np.ndarray,
        min_kmer_len: int,
        max_kmer_len: Union[int, None],
        two_bit: bool = True,
        record_names: Union[list, None] = None,
    ) -> None:
        limit = 64 if two_bit else 32
        if min_kmer_len < 1 or (max_kmer_len is not None and min_kmer_len > max_kmer_len):
            raise ValueError(f"min_kmer_len ({min_kmer_len}) must be in [1, max_kmer_len]")
        # within one window: the single-exchange sort with kept lanes;
        # suffix mode and longer bounds: the refinement rounds
        self._one_window = max_kmer_len is not None and max_kmer_len <= limit
        self.packed_words = np.asarray(packed_words, dtype=np.uint32)
        self.seg_starts = np.asarray(seg_starts_u64, dtype=np.uint64)
        self.seg_ends = np.asarray(seg_ends_u64, dtype=np.uint64)
        if len(self.seg_starts) != len(self.seg_ends) or len(self.seg_starts) == 0:
            raise ValueError("segment starts/ends must be non-empty and aligned")
        self.min_kmer_len = int(min_kmer_len)
        self.max_kmer_len = None if max_kmer_len is None else int(max_kmer_len)
        self.two_bit = bool(two_bit)
        self.record_names = record_names
        seg_kmers = (
            self.seg_ends.astype(np.int64) - self.seg_starts.astype(np.int64) + 1
        ) - self.min_kmer_len + 1
        if (seg_kmers < 1).any():
            raise ValueError(
                f"min_kmer_len ({min_kmer_len}) must be <= the shortest sequence length"
            )
        self._seg_kmers = seg_kmers
        self.num_kmers = int(seg_kmers.sum())
        # (positions, is_pad, mesh, n_real, sorted lanes) per shard after sort()
        self._sorted = None
        self._is_sorted = False
        self._custom_positions = False
        self._n_fwd_records = None  # set by from_records(both_strands=True)
        self._track_strands = False  # from_records(track_strands_separately=)
        # converged run ids per shard: {identity kmer_len (None: suffix): ids}
        self._gid_cache = {}
        self._packed_dev = {}  # device -> the strided pack there

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @classmethod
    def from_records(
        cls,
        records: Iterable,
        min_kmer_len: int,
        max_kmer_len: Union[int, None],
        both_strands: bool = False,
        two_bit: Union[bool, None] = None,
        track_strands_separately: bool = False,
    ) -> "LargeKmers":
        """Build from ``(name, sequence)`` pairs (str or bytes), packed in
        chunks of ``_CHUNK`` bases with '$' separators: the joined ASCII SBA
        never exists. ``both_strands=True`` appends every record's reverse
        complement as more segments (equal strings of the two strands share
        groups); ``track_strands_separately=True`` also splits every group by
        strand. ``two_bit=None`` scans the records for a base other than
        ACGT first, so ``records`` must be re-iterable; pass a bool to
        stream a one-shot iterator."""
        if track_strands_separately and not both_strands:
            raise ValueError(
                "track_strands_separately can only be true if both_strands is True"
            )
        if two_bit is None or both_strands:
            records = list(records)
        if two_bit is None:
            two_bit = all(_is_acgt_only(_as_bytes(s)) for _, s in records)

        pack = pack_rank2_strided_np if two_bit else pack_rank_strided_np
        comp = bytes.maketrans(b"ACGTRYSWKMBDHVN$", b"TGCAYRSWMKVHDBN$")
        # the pack tables rank any other byte 0, so the bytes are checked
        # here as SequenceCollection checks them (uppercase IUPAC; ACGT on
        # the 2-bit pack)
        allowed = _ACGT if two_bit else _IUPAC

        def byte_stream():
            first = True
            for name, seq in records:
                yield name, _as_bytes(seq), first
                first = False
            if both_strands:
                for name, seq in reversed(records):
                    yield name, _as_bytes(seq).translate(comp)[::-1], False

        word_chunks, pending, n_pending = [], [], 0
        starts, ends, names = [], [], []
        offset = 0
        for name, sb, first in byte_stream():
            if len(sb) == 0:
                raise ValueError(f"record ({name}) has an empty sequence")
            bad = set(sb.translate(None, allowed))  # one C pass; the bytes left are bad
            if bad:
                raise ValueError(
                    f"record ({name}) contains disallowed characters "
                    f"{sorted(chr(b) for b in bad)} "
                    f"({'ACGT only on the 2-bit pack' if two_bit else 'uppercase IUPAC only'})"
                )
            if not first:
                pending.append(b"$")
                n_pending += 1
                offset += 1
            starts.append(offset)
            ends.append(offset + len(sb) - 1)
            names.append(name)
            pending.append(sb)
            n_pending += len(sb)
            offset += len(sb)
            if n_pending >= _CHUNK:
                buf = b"".join(pending)
                whole = len(buf) - len(buf) % _CHUNK
                word_chunks.append(pack(np.frombuffer(buf[:whole], dtype=np.uint8), extra_words=0))
                pending, n_pending = [buf[whole:]], len(buf) - whole
        if n_pending:
            word_chunks.append(pack(np.frombuffer(b"".join(pending), dtype=np.uint8), extra_words=0))
        # the funnel shift reads up to 8 words past the last position
        word_chunks.append(np.zeros(8, dtype=np.uint32))
        out = cls(
            np.concatenate(word_chunks),
            np.asarray(starts, dtype=np.uint64),
            np.asarray(ends, dtype=np.uint64),
            min_kmer_len,
            max_kmer_len,
            two_bit=two_bit,
            record_names=names,
        )
        if both_strands:
            out._n_fwd_records = len(names) // 2
            out._track_strands = bool(track_strands_separately)
        return out

    @classmethod
    def from_fasta(
        cls,
        fasta_file_path,
        min_kmer_len: int,
        max_kmer_len: Union[int, None],
        both_strands: bool = False,
        two_bit: Union[bool, None] = None,
        track_strands_separately: bool = False,
    ) -> "LargeKmers":
        """Build from a FASTA file, its records streamed out of it
        (``io/fasta.iter_fasta_records``: the parsing rules of the
        collection loader) into the chunked strided pack."""
        from .io.fasta import iter_fasta_records

        return cls.from_records(
            iter_fasta_records(fasta_file_path), min_kmer_len, max_kmer_len,
            both_strands=both_strands, two_bit=two_bit,
            track_strands_separately=track_strands_separately,
        )

    @classmethod
    def from_sequence_collection(
        cls, seq_coll, min_kmer_len: int, max_kmer_len: Union[int, None],
        both_strands: bool = False, track_strands_separately: bool = False,
    ) -> "LargeKmers":
        """Build from a SequenceCollection's forward records."""
        records = [
            (name, bytes(seq_coll.forward_sba[s : e + 1]))
            for name, s, e in seq_coll.iter_records("forward")
        ]
        return cls.from_records(
            records, min_kmer_len, max_kmer_len, both_strands=both_strands,
            two_bit=None, track_strands_separately=track_strands_separately,
        )

    # ------------------------------------------------------------------ #
    # index
    # ------------------------------------------------------------------ #

    def _packed(self, mesh) -> torch.Tensor:
        """The strided pack on the mesh's first device, uploaded once."""
        from .parallel.sample_sort import words_tensor

        dev = mesh.devices[0]
        if dev not in self._packed_dev:
            self._packed_dev[dev] = words_tensor(self.packed_words).to(dev)
        return self._packed_dev[dev]

    def build_positions(self) -> np.ndarray:
        """Every k-mer start position (uint64, segment order) on the host."""
        out = np.empty(self.num_kmers, dtype=np.uint64)
        write = 0
        for s, n in zip(self.seg_starts, self._seg_kmers):
            out[write : write + n] = np.arange(s, s + np.uint64(n), dtype=np.uint64)
            write += int(n)
        return out

    def _dense_positions_for_sort(self, mesh) -> torch.Tensor:
        """Every k-mer start as an int64 tensor on the mesh's first device,
        built there (no host position array)."""
        pos, n = build_dense_positions(
            self.seg_starts, self.seg_ends, self.min_kmer_len, device=mesh.devices[0]
        )
        assert n == self.num_kmers
        return pos

    def __len__(self) -> int:
        return self.num_kmers

    def sort(self, mesh, positions=None, on_round=None, on_step=None, info=None) -> None:
        """Sample sort of the index over ``mesh``. A bound within one window
        takes one exchange (``sample_sort_positions_large_ragged``) and
        keeps the sorted key lanes; suffix mode and longer bounds take the
        refinement rounds (``sample_sort_positions_large_unbounded``) and
        keep the converged run ids, the group identity at the built length.
        ``positions`` (uint64 array or int64 tensor) restricts the index to
        a subset. ``on_round``, ``on_step`` and ``info`` are passed to the
        sort (see ``parallel/sample_sort.py``)."""
        from .parallel.sample_sort import (
            int64_tensor,
            sample_sort_positions_large_ragged,
            sample_sort_positions_large_unbounded,
        )

        if positions is None:
            pos = self._dense_positions_for_sort(mesh)
            self._custom_positions = False
        else:
            pos = int64_tensor(positions)
            self._custom_positions = True
        n_real = int(pos.shape[0])
        self._gid_cache = {}
        packed = self._packed(mesh)
        if self._one_window:
            out_pos, is_pad, lanes = sample_sort_positions_large_ragged(
                packed, pos, self.seg_starts, self.seg_ends, self.max_kmer_len, mesh,
                two_bit=self.two_bit, return_lanes=True, on_step=on_step, info=info,
            )
            if on_round is not None:
                on_round("sample_sort_positions_large_ragged")
            self._sorted = (out_pos, is_pad, mesh, n_real, lanes)
        else:
            out_pos, is_pad, gid = sample_sort_positions_large_unbounded(
                packed, pos, self.seg_starts, self.seg_ends, mesh, two_bit=self.two_bit,
                max_kmer_len=self.max_kmer_len, on_round=on_round, on_step=on_step, info=info,
            )
            self._sorted = (out_pos, is_pad, mesh, n_real, None)
            # the identity the sort converged on comes free
            self._gid_cache[self.max_kmer_len] = gid
        self._is_sorted = True

    def sorted_positions(self) -> np.ndarray:
        """The globally sorted positions as host uint64, pads removed."""
        from .parallel.sample_sort import large_rows

        if not self._is_sorted:
            raise ValueError("LargeKmers must be sorted first. Run sort(mesh).")
        positions, is_pad, _, n_real, _ = self._sorted
        out = large_rows(positions, is_pad)
        assert out.shape[0] == n_real
        return out

    # ------------------------------------------------------------------ #
    # statistics (uint64-exact)
    # ------------------------------------------------------------------ #

    @property
    def sba_len(self) -> int:
        """The conceptual SBA length (last segment end + 1), may pass 2^32."""
        return int(self.seg_ends[-1]) + 1

    def _require_sorted(self, what="get_kmer_group_counts"):
        if not self._is_sorted:
            raise AssertionError(f"The kmers must be sorted when calling {what}")

    def _check_kmer_len(self, kmer_len):
        if kmer_len is None:
            # unbounded suffix identity on any build, as Kmers and the
            # reference comparator (kmers.py:315-316)
            return None
        if kmer_len < 1 or (self.max_kmer_len is not None and kmer_len > self.max_kmer_len):
            raise ValueError(
                f"kmer_len ({kmer_len}) must be in [1, max_kmer_len ({self.max_kmer_len})]"
            )
        return kmer_len

    def _row_lens(self, pos, seg_e) -> np.ndarray:
        """Extraction lengths at ``kmer_len=None``: the natural length (to
        the segment end), at most ``max_kmer_len``."""
        lens = (seg_e - pos + np.uint64(1)).astype(np.int64)
        if self.max_kmer_len is not None:
            lens = np.minimum(lens, np.int64(self.max_kmer_len))
        return lens

    @property
    def _lanes_k(self) -> int:
        """Built length of the kept or rebuilt key lanes."""
        limit = 64 if self.two_bit else 32
        return self.max_kmer_len if self._one_window else limit

    def _strand_split(self) -> Union[int, None]:
        """The position that splits "+" rows from "-" rows for
        track_strands_separately, or None."""
        if not self._track_strands:
            return None
        return int(self.seg_starts[self._n_fwd_records])

    def _ensure_gid(self, kmer_len) -> list:
        """Converged run ids at ``kmer_len`` identity (None: full suffix)
        over the sorted layout (``distributed_adjacent_gids_large``),
        cached: the built identity, and at most one other (run ids are 8
        bytes a row)."""
        if kmer_len not in self._gid_cache:
            from .parallel.sample_sort import distributed_adjacent_gids_large

            positions, is_pad, mesh, _, _ = self._sorted
            for stale in [k for k in self._gid_cache if k != self.max_kmer_len]:
                del self._gid_cache[stale]
            self._gid_cache[kmer_len] = distributed_adjacent_gids_large(
                self._packed(mesh), positions, is_pad, self.seg_starts, self.seg_ends,
                kmer_len, mesh, two_bit=self.two_bit,
            )
        return self._gid_cache[kmer_len]

    def _identity_kwargs(self, kmer_len) -> dict:
        """Key words for a ``kmer_len`` within one window; converged run
        ids for suffix identity (None) and beyond."""
        limit = 64 if self.two_bit else 32
        if kmer_len is None or kmer_len > limit:
            return {"kmer_len": None, "ext_gid": self._ensure_gid(kmer_len)}
        return {"kmer_len": kmer_len, "ext_gid": None}

    def _ensure_lanes(self) -> list:
        """The sorted key lanes (words, then cap) at ``_lanes_k``, rebuilt
        once from the sorted positions where no sort kept them."""
        positions, is_pad, mesh, n_real, lanes = self._sorted
        if lanes is None:
            from .parallel.large import rebuild_large_lanes

            lanes = rebuild_large_lanes(
                self._packed(mesh), positions, is_pad, self.seg_starts, self.seg_ends,
                self._lanes_k, mesh, self.two_bit,
            )
            self._sorted = (positions, is_pad, mesh, n_real, lanes)
        return lanes

    def _cap_covers_min_k(self) -> bool:
        """Whether every real row has min_kmer_len bases or more: true by
        construction, checked on the kept cap lane for a ``positions``
        subset (the CRISPR PAM lanes flags depend on it)."""
        if not self._custom_positions:
            return True
        if self.min_kmer_len > self._lanes_k:
            return False  # the cap lane saturates below min_kmer_len
        _, is_pad, _, _, _ = self._sorted
        caps = [widen_u32(shard[-1])[~pad] for shard, pad in zip(self._ensure_lanes(), is_pad)]
        caps = [c for c in caps if c.shape[0]]
        if not caps:
            return True
        return min(int(c.min()) for c in caps) >= self.min_kmer_len

    def _filter_mask(self, kmer_filter_func, kmer_len):
        """Survivor mask per shard of a library filter, evaluated on the
        sorted lanes (``large_lanes_filter_flags``), or None for keep-all.
        Raises the filter's reference error at the first offending row, and
        NotImplementedError for a filter the lanes cannot express (no byte
        SBA exists to fall back to)."""
        from .ops.filters import KeepAllFilter, KmerFilter
        from .parallel.large import large_lanes_filter_flags

        if kmer_filter_func is None or isinstance(kmer_filter_func, KeepAllFilter):
            return None
        if not isinstance(kmer_filter_func, KmerFilter):
            raise NotImplementedError(
                "the large regime supports the library KmerFilter classes "
                "only (filters evaluate on packed key lanes; arbitrary "
                "callables would need a byte SBA, which never materializes "
                "past 2^32)"
            )
        positions, is_pad, mesh, _, _ = self._sorted
        lanes = self._ensure_lanes()
        lanes_k = self._lanes_k
        nwb = -(-lanes_k // (16 if self.two_bit else 8))
        words = [tuple(shard[:nwb]) for shard in lanes]
        spec = kmer_filter_func.lanes_spec(
            {
                "two_bit": self.two_bit,
                "built_k": lanes_k,
                "words": words[0],
                "cap": widen_u32(lanes[0][nwb]),
                "cap_cover_check": self._cap_covers_min_k,
            },
            self.sba_len,
            self.min_kmer_len,
        )
        if spec is None:
            raise NotImplementedError(
                f"filter {type(kmer_filter_func).__name__} cannot be "
                f"evaluated on the large index's key lanes at this "
                f"configuration (lane length {lanes_k}, "
                f"min_kmer_len={self.min_kmer_len})"
            )
        flags_fn, params, msgs = spec
        mask, err = large_lanes_filter_flags(
            words, positions, is_pad, params, flags_fn, self.seg_starts, self.seg_ends,
            lanes_k, mesh,
        )
        if err and int(err[0]):
            raise ValueError(msgs[int(err[1])](int(err[2])))
        return mask

    def get_kmer_group_counts(
        self,
        kmer_len: Union[int, None] = None,
        kmer_filter_func=None,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        max_counts_bin: int = 1000000,
    ) -> tuple[np.ndarray, int]:
        """Group-size histogram (uint64) and exact total over the sorted
        layout (``distributed_group_size_histogram_large_ragged``), over the
        kept lanes where they serve. A bounded ``kmer_len <= max_kmer_len``
        is exact; ``kmer_len=None`` is unbounded suffix identity on any
        build, through converged run ids. ``kmer_filter_func``: a library
        KmerFilter, survivors counted in unfiltered group identity (the
        reference's previous-survivor walk, kmers.py:597-601). With
        ``track_strands_separately`` groups also split by strand."""
        from .parallel.large import distributed_group_size_histogram_large_ragged

        self._require_sorted()
        kmer_len = self._check_kmer_len(kmer_len)
        if max_counts_bin <= 0:
            raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
        mask = self._filter_mask(kmer_filter_func, kmer_len)
        positions, is_pad, mesh, _, lanes = self._sorted
        idk = self._identity_kwargs(kmer_len)
        return distributed_group_size_histogram_large_ragged(
            self._packed(mesh), positions, is_pad, self.seg_starts, self.seg_ends,
            idk["kmer_len"], mesh, min_group_size=min_group_size,
            max_group_size=max_group_size, max_counts_bin=max_counts_bin,
            two_bit=self.two_bit, sorted_words=lanes,
            built_k=self._lanes_k if lanes is not None else None, mask=mask,
            ext_gid=idk["ext_gid"], strand_split=self._strand_split(),
        )

    def get_kmer_count(
        self,
        kmer_len: Union[int, None] = None,
        kmer_filter_func=None,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
    ) -> int:
        """Total k-mers in qualifying groups (exact)."""
        _, total = self.get_kmer_group_counts(
            kmer_len, kmer_filter_func=kmer_filter_func, min_group_size=min_group_size,
            max_group_size=max_group_size, max_counts_bin=1,
        )
        return total

    # ------------------------------------------------------------------ #
    # canonical (strand-collapsed) statistics
    # ------------------------------------------------------------------ #

    def get_canonical_kmer_group_counts(
        self,
        kmer_len: int,
        max_counts_bin: int = 1000000,
        mesh=None,
        positions=None,
    ) -> tuple[np.ndarray, int]:
        """Group-size histogram over canonical (min(kmer, reverse
        complement)) k-mers, by a canonical sample sort of its own; only
        full-length k-mers take part. ``kmer_len`` at most 64 on 2-bit keys,
        32 on 4-bit keys. ``mesh`` defaults to the mesh of ``sort``;
        ``positions`` restricts the index to a subset."""
        from .parallel.large import distributed_group_size_histogram_large_ragged
        from .parallel.sample_sort import int64_tensor, sample_sort_canonical_large_ragged

        if self._n_fwd_records is not None:
            raise NotImplementedError(
                "canonical statistics are defined on a single-strand index "
                "(a both-strand index already contains each k-mer's reverse "
                "complement)"
            )
        limit = 64 if self.two_bit else 32
        if kmer_len is None or kmer_len < 1 or kmer_len > limit:
            raise ValueError(f"kmer_len ({kmer_len}) must be in [1, {limit}]")
        if max_counts_bin <= 0:
            raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
        if mesh is None:
            if self._sorted is None:
                raise ValueError(
                    "pass mesh= (or sort(mesh) first) so the canonical "
                    "pipeline knows its device mesh"
                )
            mesh = self._sorted[2]
        pos = (
            self._dense_positions_for_sort(mesh) if positions is None else int64_tensor(positions)
        )
        packed = self._packed(mesh)
        can_pos, is_pad, can_lanes = sample_sort_canonical_large_ragged(
            packed, pos, self.seg_starts, self.seg_ends, kmer_len, mesh, two_bit=self.two_bit,
        )
        # the canonical words are the group identity (full-length rows only)
        return distributed_group_size_histogram_large_ragged(
            packed, can_pos, is_pad, self.seg_starts, self.seg_ends, kmer_len, mesh,
            max_counts_bin=max_counts_bin, two_bit=self.two_bit, sorted_words=can_lanes,
            built_k=kmer_len,
        )

    # ------------------------------------------------------------------ #
    # count queries
    # ------------------------------------------------------------------ #

    def count_queries(self, queries: list, kmer_len: Union[int, None] = None) -> np.ndarray:
        """Occurrence counts (uint64) of each query string, by a bound
        search of the sorted index (``distributed_count_queries_large``) at
        ``kmer_len``-base group identity, the first query's length by
        default. On the 2-bit pack a query with a base other than ACGT
        counts 0."""
        from .parallel.query import distributed_count_queries_large

        self._require_sorted("count_queries")
        if not queries:
            return np.zeros(0, dtype=np.uint64)
        if kmer_len is None:
            kmer_len = len(queries[0])
        kmer_len = self._check_kmer_len(kmer_len)
        limit = 64 if self.two_bit else 32
        if kmer_len > limit:
            raise NotImplementedError(
                f"count_queries requires kmer_len <= {limit} (query keys "
                f"are one-window; the sorted order itself supports any "
                f"kmer_len)"
            )
        positions, is_pad, mesh, _, _ = self._sorted
        return distributed_count_queries_large(
            self._packed(mesh), positions, is_pad, self.seg_starts, self.seg_ends, queries,
            kmer_len, mesh, two_bit=self.two_bit,
        )

    def count_queries_canonical(self, queries: list, kmer_len: Union[int, None] = None) -> np.ndarray:
        """Strand-collapsed counts: forward hits plus reverse-complement hits
        (once for a palindrome). Uppercase IUPAC queries."""
        from .ops.encoding import iupac_revcomp_strs

        if self._n_fwd_records is not None:
            raise NotImplementedError(
                "canonical queries are defined on a single-strand index; "
                "count_queries on a both-strand index already counts both "
                "strands"
            )
        if not queries:
            return np.zeros(0, dtype=np.uint64)
        rcs = iupac_revcomp_strs(queries)
        fwd = self.count_queries(queries, kmer_len)
        rc = self.count_queries(rcs, kmer_len)
        is_palindrome = np.array([q == r for q, r in zip(queries, rcs)])
        return fwd + np.where(is_palindrome, 0, rc).astype(np.uint64)

    # ------------------------------------------------------------------ #
    # extraction (host arrays)
    # ------------------------------------------------------------------ #

    def _rows_for_arrays(self, kmer_len, kmer_filter_func, min_group_size, max_group_size):
        """Host per-row arrays in global sorted order, pads removed:
        (positions, survivor mask, boundary, rows a group, boundary rows,
        expanded group sizes, group qualifies)."""
        from .parallel.large import distributed_group_size_histogram_large_ragged

        mask = self._filter_mask(kmer_filter_func, kmer_len)
        positions, is_pad, mesh, n_real, lanes = self._sorted
        idk = self._identity_kwargs(kmer_len)
        _, _, rows = distributed_group_size_histogram_large_ragged(
            self._packed(mesh), positions, is_pad, self.seg_starts, self.seg_ends,
            idk["kmer_len"], mesh, min_group_size=min_group_size,
            max_group_size=max_group_size, max_counts_bin=1, two_bit=self.two_bit,
            sorted_words=lanes, built_k=self._lanes_k if lanes is not None else None,
            mask=mask, return_rows=True, ext_gid=idk["ext_gid"],
            strand_split=self._strand_split(),
        )
        pos = _real(positions, is_pad).view(np.uint64)
        boundary = _real(rows["boundary"], is_pad)
        size = _real(rows["size"], is_pad)
        qualifies = _real(rows["qualifies"], is_pad)
        surv = np.ones(len(pos), dtype=bool) if mask is None else _real(mask, is_pad)
        assert len(pos) == n_real
        b_idx = np.flatnonzero(boundary)
        counts_per_group = np.diff(np.concatenate([b_idx, [len(pos)]]))
        gst = np.repeat(size[b_idx], counts_per_group)
        gq = np.repeat(qualifies[b_idx], counts_per_group)
        return pos, surv, boundary, counts_per_group, b_idx, gst, gq

    def get_kmers(
        self,
        kmer_len: Union[int, None] = None,
        one_based_seq_index: bool = False,
        kmer_filter_func=None,
        kmer_info_to_yield: str = "minimum",
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ):
        """Generator of ``Kmers.get_kmers``'s tuples: ``(kmer_num,
        group_size_yielded, group_size_total)`` for "minimum", ``(kmer_num,
        strand, chrom, seq_start_idx, kmer_len, group_size_yielded,
        group_size_total)`` for "full", with the same lazy beyond-segment
        raise (the valid rows before it are yielded first). The index must
        be sorted. Backed by ``get_kmers_arrays``."""
        self._require_sorted("get_kmers")
        if kmer_info_to_yield not in ("minimum", "full"):
            raise ValueError(f"kmer_info_to_yield ({kmer_info_to_yield}) not recognized")
        nums, pos, gsy, gst = self.get_kmers_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size, yield_first_n,
        )
        if kmer_info_to_yield == "minimum":
            for i in range(len(nums)):
                yield (int(nums[i]), int(gsy[i]), int(gst[i]))
            return
        kmer_len = self._check_kmer_len(kmer_len)
        record_num, strand, seq_idx, seg_e = self._record_cols(
            pos, nums, kmer_len, one_based_seq_index, check=False
        )
        names = self.record_names
        if kmer_len is None:
            viol = np.zeros(len(nums), dtype=bool)
            row_len = self._row_lens(pos, seg_e)
        else:
            viol = pos + np.uint64(kmer_len - 1) > seg_e
            row_len = None
        for i in range(len(nums)):
            if viol[i]:
                raise ValueError(
                    f"kmer_len ({kmer_len}) for kmer_num ({int(nums[i])}) extends beyond the end of the segment"
                )
            rn = int(record_num[i])
            yield (
                int(nums[i]),
                str(strand[i]),
                names[rn] if names is not None else str(rn),
                int(seq_idx[i]),
                kmer_len if row_len is None else int(row_len[i]),
                int(gsy[i]),
                int(gst[i]),
            )

    def get_kmers_arrays(
        self,
        kmer_len: Union[int, None] = None,
        kmer_filter_func=None,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(kmer_nums int64, sba_start_indices uint64, group_size_yielded,
        group_size_total) in yield order: the survivors of qualifying
        groups, the first ``yield_first_n`` of each group. kmer_num is the
        row's index in the sorted order. Host memory O(rows)."""
        self._require_sorted("get_kmers_arrays")
        kmer_len = self._check_kmer_len(kmer_len)
        pos, surv, boundary, counts_per_group, b_idx, gst, gq = self._rows_for_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size
        )
        svc = np.cumsum(surv.astype(np.int64))
        start_excl = np.repeat(svc[b_idx] - surv[b_idx].astype(np.int64), counts_per_group)
        rank = svc - 1 - start_excl  # survivor rank within its group
        yielded = surv & gq
        if yield_first_n is not None:
            yielded &= rank < yield_first_n
        sel = np.flatnonzero(yielded)
        gst_sel = gst[sel].astype(np.int64)
        gsy = gst_sel if yield_first_n is None else np.minimum(gst_sel, np.int64(yield_first_n))
        return sel.astype(np.int64), pos[sel], gsy, gst_sel

    def get_kmers_full_arrays(
        self,
        kmer_len: Union[int, None] = None,
        one_based_seq_index: bool = False,
        kmer_filter_func=None,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ) -> dict:
        """Full-info arrays: kmer_num, record_num, strand, seq_start_idx,
        kmer_len, group_size_yielded, group_size_total. On a
        ``both_strands=True`` index the reverse-complement segments report
        strand "-", forward-strand seq_start_idx and the record's number."""
        kmer_len = self._check_kmer_len(kmer_len)
        nums, pos, gsy, gst = self.get_kmers_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size, yield_first_n,
        )
        record_num, strand, seq_idx, seg_e = self._record_cols(
            pos, nums, kmer_len, one_based_seq_index
        )
        return {
            "kmer_num": nums,
            "record_num": record_num,
            "strand": strand,
            "seq_start_idx": seq_idx,
            "kmer_len": (
                np.full(len(pos), kmer_len, dtype=np.int64)
                if kmer_len is not None
                else self._row_lens(pos, seg_e)
            ),
            "group_size_yielded": gsy,
            "group_size_total": gst,
        }

    def _record_cols(self, pos, nums, kmer_len, one_based=False, check=True):
        """(record_num int64, strand U1, seq_start_idx, seg_e) of sorted
        rows, raising at the first row (by ``nums``) that runs past its
        segment unless ``check`` is False."""
        starts = self.seg_starts.astype(np.uint64)
        seg_ids = np.searchsorted(starts, pos, side="right") - 1
        seg_s = starts[seg_ids]
        seg_e = self.seg_ends.astype(np.uint64)[seg_ids]
        base = np.uint64(1 if one_based else 0)
        n_fwd = self._n_fwd_records
        if n_fwd is not None:
            rc_row = seg_ids >= n_fwd
            strand = np.where(rc_row, "-", "+").astype("U1")
            seq_idx = np.where(rc_row, seg_e - pos, pos - seg_s) + base
            record_num = np.where(rc_row, 2 * n_fwd - 1 - seg_ids, seg_ids)
        else:
            strand = np.full(len(pos), "+", dtype="U1")
            seq_idx = pos - seg_s + base
            record_num = seg_ids
        if check and kmer_len is not None:
            over = pos + np.uint64(kmer_len - 1) > seg_e
            if over.any():
                bad = int(nums[np.flatnonzero(over)[0]])
                raise ValueError(
                    f"kmer_len ({kmer_len}) for kmer_num ({bad}) extends beyond the end of the segment"
                )
        return record_num.astype(np.int64), strand, seq_idx, seg_e

    def get_kmer_strs(self, kmer_nums, kmer_len: Union[int, None] = None) -> list:
        """Decode k-mers from the strided pack (no byte SBA exists here);
        kmer_num indexes the sorted order. ``kmer_len=None`` decodes each
        row at its natural length, as ``Kmers.get_kmer_strs(None)``."""
        self._require_sorted("get_kmer_strs")
        kmer_len = self._check_kmer_len(kmer_len)
        nums = np.asarray(kmer_nums, dtype=np.int64)
        if nums.size == 0:
            return []
        if (nums < 0).any() or (nums >= self._sorted[3]).any():
            raise ValueError("kmer_num out of bounds")
        pos = self.sorted_positions()[nums]
        starts = self.seg_starts.astype(np.uint64)
        seg_ids = np.searchsorted(starts, pos, side="right") - 1
        seg_e = self.seg_ends.astype(np.uint64)[seg_ids]
        if kmer_len is None:
            data, offsets = decode_strided_var_np(
                self.packed_words, pos, self._row_lens(pos, seg_e), self.two_bit
            )
            b = data.tobytes()
            return [b[offsets[r] : offsets[r + 1]].decode("ascii") for r in range(len(pos))]
        over = pos + np.uint64(kmer_len - 1) > seg_e
        if over.any():
            bad = int(nums[np.flatnonzero(over)[0]])
            raise ValueError(
                f"kmer_len ({kmer_len}) for kmer_num ({bad}) extends beyond the end of the segment"
            )
        block = np.ascontiguousarray(decode_strided_np(self.packed_words, pos, kmer_len, self.two_bit))
        return block.view(f"S{kmer_len}").ravel().astype(f"U{kmer_len}").tolist()

    def get_kmer_str(self, kmer_num: int, kmer_len: Union[int, None] = None) -> str:
        """One k-mer's string (see ``get_kmer_strs``)."""
        return self.get_kmer_strs([int(kmer_num)], kmer_len)[0]

    def to_csv(self, kmer_len, output_file_path, fields=["kmer"]) -> None:
        """CSV output with the fields and bytes of ``Kmers.to_csv``, through
        the columnar writer (``io/csv_out.py``); ``kmer_len=None`` writes
        each row's natural-length suffix. Host memory O(rows)."""
        from .io.csv_out import write_csv_columnar

        allowed = {"kmer", "kmer_num", "chrom", "start", "strand", "group_size"}
        bad = set(fields) - allowed
        if bad:
            raise ValueError(f"unrecognized fields: {sorted(bad)}")
        self._require_sorted("to_csv")
        kmer_len = self._check_kmer_len(kmer_len)
        fset = set(fields)
        need_full = bool({"chrom", "start", "strand"} & fset)
        names = self.record_names
        record_num = strand_col = seq_idx = gst = seg_e = None
        if "group_size" not in fset:
            # default group parameters yield every row in sorted order
            nums = np.arange(self._sorted[3], dtype=np.int64)
            pos = self.sorted_positions()
        else:
            nums, pos, _, gst = self.get_kmers_arrays(kmer_len)
        if need_full or "kmer" in fset:
            record_num, strand_col, seq_idx, seg_e = self._record_cols(pos, nums, kmer_len)
        var_kmer = None
        cols = {}
        for field in dict.fromkeys(fields):
            if field == "kmer":
                if kmer_len is None:
                    var_kmer = decode_strided_var_np(
                        self.packed_words, pos, self._row_lens(pos, seg_e), self.two_bit
                    )
                    cols[field] = var_kmer
                    continue
                block = np.ascontiguousarray(
                    decode_strided_np(self.packed_words, pos, kmer_len, self.two_bit)
                )
                cols[field] = block.view(f"S{kmer_len}").ravel()
            elif field == "kmer_num":
                cols[field] = nums
            elif field == "chrom":
                cols[field] = record_num  # ids; the writer applies the names
            elif field == "start":
                cols[field] = seq_idx.astype(np.int64)
            elif field == "strand":
                cols[field] = strand_col
            elif field == "group_size":
                cols[field] = gst
        if "chrom" in cols and names is None:
            names = (
                [str(i) for i in range(int(cols["chrom"].max()) + 1)] if len(cols["chrom"]) else []
            )
        write_csv_columnar(cols, fields, names, kmer_len, var_kmer, output_file_path)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, path) -> None:
        """Write the sorted layout (``parallel/checkpoint.save_large_kmers``).
        The pack and the segment tables are the constructor's inputs and
        are not written: build the LargeKmers the same way, then
        ``load_checkpoint``."""
        from .parallel.checkpoint import save_large_kmers

        self._require_sorted("save_checkpoint")
        save_large_kmers(self, path)

    def load_checkpoint(self, path, mesh) -> None:
        """Restore a sorted layout onto ``mesh`` (any shard count); the key
        lanes and run ids are rebuilt when a call needs them."""
        from .parallel.checkpoint import load_large_kmers

        load_large_kmers(self, path, mesh)
        self._gid_cache = {}
