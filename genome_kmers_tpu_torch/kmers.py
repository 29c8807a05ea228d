"""Kmers: the k-mer index and its group statistics, on torch tensors.

Counterpart of ``genome_kmers_tpu/kmers.py`` for the main path: an index
over every k-mer start of an ACGT genome, ``sort()`` from the fresh index
(the gather-free dense sort of ops/sort.py), and ``get_kmer_group_counts``
/ ``get_kmer_count`` over the sorted key lanes that the sort retains.
Construction checks and their messages are the JAX package's. The index
inherits its collection's device.

Everything outside that path raises NotImplementedError naming the
ROADMAP.md item that will port it.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from .ops.filters import KeepAllFilter, kmer_filter_keep_all
from .ops.groups import hist_from_sizes, lanes_group_total, lanes_sizes_digest
from .ops.sort import sort_positions_dense
from .sequence_collection import SequenceCollection


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to genome_kmers_tpu_torch yet (ROADMAP.md {item})"
    )


class Kmers:
    """Memory-efficient k-mer calculations on a genome, on a GPU.

    Constructor arguments, validation and error behavior match the JAX
    package (track_strands_separately, a non-forward source_strand and
    double_pass raise NotImplementedError)."""

    def __init__(
        self,
        seq_coll: Union[SequenceCollection, None] = None,
        min_kmer_len: int = 1,
        max_kmer_len: Union[int, None] = None,
        source_strand: str = "forward",
        track_strands_separately: bool = False,
        method: str = "single_pass",
    ) -> None:
        if track_strands_separately:
            raise NotImplementedError(
                f"This function has not been implemented for track_strands_separately = '{track_strands_separately}'"
            )
        if source_strand != "forward":
            raise NotImplementedError(
                f"This function has not been implemented for source_strand = '{source_strand}'"
            )
        self._construct(
            seq_coll, min_kmer_len, max_kmer_len, source_strand,
            track_strands_separately, method,
        )

    @classmethod
    def from_strand(cls, *args, **kwargs) -> "Kmers":
        raise _not_ported("Kmers.from_strand", "A6: gather path")

    def _construct(
        self,
        seq_coll,
        min_kmer_len,
        max_kmer_len,
        source_strand,
        track_strands_separately,
        method,
    ) -> None:
        if source_strand not in ("forward", "reverse_complement", "both"):
            raise ValueError(f"source_strand ({source_strand}) not recognized")
        if source_strand != "both" and track_strands_separately:
            raise ValueError(
                f"track_strands_separately can only be true if source_strand is 'both', but it is '{source_strand}'"
            )
        if min_kmer_len < 1:
            raise ValueError(f"min_kmer_len ({min_kmer_len}) must be greater than zero")
        if max_kmer_len is not None:
            if max_kmer_len < 1:
                raise ValueError(f"max_kmer_len ({max_kmer_len}) must be greater than zero")
            if min_kmer_len is not None and max_kmer_len < min_kmer_len:
                raise ValueError(
                    f"max_kmer_len ({max_kmer_len}) is less than min_kmer_len ({min_kmer_len})"
                )

        self.min_kmer_len = min_kmer_len
        self.max_kmer_len = max_kmer_len
        self.kmer_source_strand = source_strand
        self.track_strands_separately = track_strands_separately

        self._is_sorted = False
        # The index lives as a host uint32 array or as a device int64
        # tensor; either is materialized lazily from the other or from the
        # init geometry, so sort -> stats never round-trips through the host.
        self._pos_host = None
        self._pos_dev = None
        self._init_geometry = None
        self._lanes_cache = None

        if seq_coll is None:
            return

        min_seq_len = None
        num_records = 0
        for _, s, e in seq_coll.iter_records():
            seq_length = e - s + 1
            if min_seq_len is None or seq_length < min_seq_len:
                min_seq_len = seq_length
            num_records += 1

        if num_records == 0:
            raise ValueError("sequence_collection is empty")
        if min_kmer_len is not None and min_kmer_len > min_seq_len:
            raise ValueError(
                f"min_kmer_len ({min_kmer_len}) must be <= the shortest sequence length ({min_seq_len})"
            )
        if seq_coll.strands_loaded() != source_strand:
            raise ValueError(
                f"source_strand ({source_strand}) does not match sequence_collection loaded strand ({seq_coll.strands_loaded()})"
            )

        self.seq_coll = seq_coll
        self.device = seq_coll.device
        self._initialize(method=method)

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #

    def _initialize(self, method: str = "single_pass"):
        if method == "double_pass":
            raise NotImplementedError(f"method '{method}' has not been implemented")
        elif method == "single_pass":
            self._initialize_single_pass()
        else:
            raise ValueError(f"method '{method}' not recognized")

    def _initialize_single_pass(self):
        """Every k-mer start position in [seg_start, seg_end - min_kmer_len + 1]
        per record. Only the O(records) geometry is stored; the position
        array is built lazily, on the host when ``kmer_sba_start_indices``
        is read, and never for the fresh sort, which covers every SBA
        position at once."""
        num_kmers = self._get_unfiltered_kmer_count()
        if num_kmers > 2**32 - 1:
            msg = "the size of the required kmers array exceeds the limit set by a uint32"
            raise NotImplementedError(msg)

        seg_starts = []
        counts = []
        for _, s, e in self.seq_coll.iter_records():
            seg_starts.append(s)
            counts.append((e - s + 1) - self.min_kmer_len + 1)
        self._init_geometry = (
            np.asarray(seg_starts, dtype=np.uint32),
            np.asarray(counts, dtype=np.int64),
            int(num_kmers),
        )
        self._pos_host = None
        self._pos_dev = None

    def _build_positions_host(self) -> np.ndarray:
        seg_starts, counts, num_kmers = self._init_geometry
        out = np.empty(num_kmers, dtype=np.uint32)
        write = 0
        for s, count in zip(seg_starts, counts):
            out[write : write + count] = np.arange(s, s + count, dtype=np.uint32)
            write += int(count)
        if write != num_kmers:
            raise AssertionError("logic error filling kmer_sba_start_indices")
        return out

    def _get_unfiltered_kmer_count(self) -> int:
        num_kmers = 0
        num_records = 0
        for _, s, e in self.seq_coll.iter_records():
            num_kmers += (e - s + 1) - self.min_kmer_len + 1
            num_records += 1
        if num_records == 0:
            raise ValueError("SequenceCollection does not have any records")
        return num_kmers

    @property
    def kmer_sba_start_indices(self):
        """Host uint32 view of the k-mer index, materialized lazily from the
        device tensor or the init geometry."""
        if self._pos_host is None:
            if self._pos_dev is not None:
                self._pos_host = self._pos_dev.cpu().numpy().astype(np.uint32)
            elif self._init_geometry is not None:
                self._pos_host = self._build_positions_host()
        return self._pos_host

    @kmer_sba_start_indices.setter
    def kmer_sba_start_indices(self, value):
        self._pos_host = value
        self._pos_dev = None
        self._init_geometry = None
        self._lanes_cache = None

    def __len__(self):
        if self._pos_host is not None:
            return len(self._pos_host)
        if self._pos_dev is not None:
            return int(self._pos_dev.shape[0])
        if self._init_geometry is not None:
            return self._init_geometry[2]
        raise TypeError("Kmers index is not initialized")

    # ------------------------------------------------------------------ #
    # checks
    # ------------------------------------------------------------------ #

    def _check_forward_only(self):
        condition1 = self.kmer_source_strand != "forward"
        condition2 = self.seq_coll.strands_loaded() != "forward"
        if condition1 or condition2:
            raise NotImplementedError(
                f"both kmer_source_strand ({self.kmer_source_strand}) and "
                "sequence_collection.strands_loaded() must be 'forward'"
            )

    def _check_group_params_unsorted(self, min_group_size, max_group_size):
        """Group params require a sorted index."""
        if not self._is_sorted:
            if min_group_size != 1:
                msg = "Returning group parameters is not supported when kmers has not been"
                msg += f" sorted. min_group_size ({min_group_size}) cannot be specified. Did you"
                msg += " mean to run sort() before getting kmers?"
                raise ValueError(msg)
            if max_group_size is not None:
                msg = "Returning group parameters is not supported when kmers has not been"
                msg += f" sorted. max_group_size ({max_group_size}) cannot be specified. Did you"
                msg += " mean to run sort() before getting kmers?"
                raise ValueError(msg)

    def _stats_lanes(self, kmer_len, kmer_filter_func, mesh):
        """The retained sorted lanes that answer a statistics query, or the
        NotImplementedError of the part of the engine that would."""
        if mesh is not None:
            raise _not_ported("statistics over a mesh (mesh=)", "A11: torch.distributed")
        if not isinstance(kmer_filter_func, KeepAllFilter):
            raise _not_ported("statistics with a filter other than keep-all", "A8: filters")
        if kmer_len is None:
            raise _not_ported("statistics at kmer_len=None (suffix identity)", "A7: suffix mode")
        if not self._is_sorted:
            raise _not_ported("statistics over an unsorted index", "A6: gather path")
        if self._lanes_cache is None or kmer_len > self._lanes_cache["built_k"]:
            raise _not_ported(
                f"statistics at kmer_len ({kmer_len}) beyond the sorted lanes "
                f"(max_kmer_len {self.max_kmer_len})",
                "A6: gather path",
            )
        return self._lanes_cache

    # ------------------------------------------------------------------ #
    # statistics
    # ------------------------------------------------------------------ #

    def get_kmer_count(
        self,
        kmer_len: Union[int, None],
        kmer_filter_func: Callable = kmer_filter_keep_all,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        mesh=None,
    ) -> int:
        """Total k-mers in groups of size in [min_group_size, max_group_size]
        at ``kmer_len`` base identity."""
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size)
        lanes = self._stats_lanes(kmer_len, kmer_filter_func, mesh)
        return lanes_group_total(
            lanes["words"], lanes["cap"], min_group_size, max_group_size, kmer_len
        )

    def get_kmer_group_counts(
        self,
        kmer_len: Union[int, None],
        kmer_filter_func: Callable = kmer_filter_keep_all,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        max_counts_bin: int = 1000000,
        mesh=None,
    ) -> tuple[np.ndarray, int]:
        """Histogram of group sizes (int64, max_counts_bin + 1 bins, larger
        groups in the top bin) and the total k-mer count of the qualifying
        groups."""
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size)
        if not self._is_sorted:
            raise AssertionError("The kmers must be sorted when calling get_kmer_group_counts")
        if max_counts_bin <= 0:
            raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
        lanes = self._stats_lanes(kmer_len, kmer_filter_func, mesh)
        size, qualifies, total = lanes_sizes_digest(
            lanes["words"], lanes["cap"], kmer_len, min_group_size, max_group_size
        )
        counts = hist_from_sizes(size, qualifies, max_counts_bin)
        return counts.cpu().numpy().astype(np.int64), total

    # ------------------------------------------------------------------ #
    # sort
    # ------------------------------------------------------------------ #

    def sort(self, mesh=None):
        """Sort the index lexicographically by the k-mers it defines, on the
        collection's device. Equal k-mers end up ordered by start index.

        Only the fresh index of an ACGT genome with a bounded
        ``max_kmer_len <= 64`` sorts here: the pack, a shifted-slice key
        build and stable sorts over every SBA position
        (ops/sort.sort_positions_dense). The sorted key lanes are retained
        for the statistics calls."""
        self._check_forward_only()
        if mesh is not None:
            raise _not_ported("Kmers.sort(mesh=...)", "A11: torch.distributed")
        if self._init_geometry is None:
            raise _not_ported(
                "sorting an index that is not the fresh one (a re-sort or an "
                "assigned kmer_sba_start_indices)",
                "A6: gather path",
            )
        if self.max_kmer_len is None or self.max_kmer_len > 64:
            raise _not_ported(
                f"sorting at max_kmer_len ({self.max_kmer_len}) beyond 64 bases",
                "A7: suffix mode",
            )
        dc = self.seq_coll.device_cache("forward")
        packed2 = dc.packed2
        if packed2 is None:
            raise _not_ported(
                "sorting a genome with bases other than A, C, G, T (4-bit keys)",
                "A3: the 4-bit pack and sort",
            )
        self._pos_dev, self._lanes_cache = sort_positions_dense(
            packed2, dc.seg_starts, dc.seg_ends, int(self._init_geometry[2]),
            self.min_kmer_len, self.max_kmer_len,
        )
        self._pos_host = None
        self._init_geometry = None
        self._is_sorted = True

    # ------------------------------------------------------------------ #
    # not ported yet
    # ------------------------------------------------------------------ #

    def save(self, *args, **kwargs):
        raise _not_ported("Kmers.save", "A10: persistence")

    def load(self, *args, **kwargs):
        raise _not_ported("Kmers.load", "A10: persistence")

    def count_queries(self, *args, **kwargs):
        raise _not_ported("Kmers.count_queries", "A9: queries and canonical stats")

    def count_queries_canonical(self, *args, **kwargs):
        raise _not_ported("Kmers.count_queries_canonical", "A9: queries and canonical stats")

    def get_canonical_kmer_group_counts(self, *args, **kwargs):
        raise _not_ported(
            "Kmers.get_canonical_kmer_group_counts", "A9: queries and canonical stats"
        )
