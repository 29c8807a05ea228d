"""Kmers: the k-mer index and its group statistics, on torch tensors.

Counterpart of ``genome_kmers_tpu/kmers.py`` at any ``max_kmer_len``, None
(suffix mode: compare to the end of the record) included, on the forward
strand, the reverse complement or both (``Kmers.from_strand``):

* ``sort()`` of the fresh index, gather-free over every SBA position: within
  one compare window (64 bases on an ACGT genome's 2-bit keys, 32 on the
  4-bit keys of a genome with N runs or IUPAC codes) by
  ops/sort.sort_positions_dense, beyond it by the refinement rounds of
  ops/sort.sort_positions_suffix_dense, whose converged run ids are kept;
  and of any other index (a re-sort, an assigned
  ``kmer_sba_start_indices``) through gathered keys with the position as
  the last key (ops/sort.sort_positions);
* ``get_kmer_group_counts`` / ``get_kmer_count`` over the sorted key lanes
  that a one-window sort retains (rebuilt once for an assigned sorted
  index), over the run ids of a suffix sort at its own identity, or over
  gathered keys (window by window when ``kmer_len`` is None or beyond a
  window);
* ``get_kmers``, ``get_kmers_arrays``, ``get_kmer_str`` and
  ``get_kmer_strs``;
* every filter (ops/filters.py) on all of these, by the JAX package's
  routes in its order: the sorted lanes (lanes flags), then a flag plane in
  genome order or window gathers, then a compaction to the survivors for
  the yields and for a filter that is a plain callable (a host loop); and
  init-time ``kmer_filters`` of ``Kmers.from_strand``;
* ``count_queries`` / ``count_queries_canonical`` (ops/query.py: a bound
  search over the sorted index on the 4-bit pack) and
  ``get_canonical_kmer_group_counts`` (ops/canonical.py), gather-free over
  the fresh index, else over gathered keys;
* the reference's host methods: equality, ``get_kmer_str_no_checks``,
  ``get_is_less_than_func``, ``generate_get_kmer_info_func``;
* persistence and export: ``save`` / ``load`` (hdf5 and shelve, the JAX
  package's schema: a file either package writes loads into the other),
  ``get_kmers_full_arrays`` and ``to_csv`` (byte for byte the JAX
  package's output, through the native row decoders);
* a mesh (parallel/; 1-D, or 2-D ``(node, local)``; within one process or
  spanning the processes of ``torch.distributed``) at any
  ``max_kmer_len``: ``sort(mesh=)`` by the sample sort, or beyond one
  compare window by its refinement rounds, whose ragged layout (and run
  ids) the index keeps (``_DistIndexCache``: on a process mesh this rank's
  shards; the host index ``kmer_sba_start_indices`` gathers every rank's);
  ``get_kmer_count`` / ``get_kmer_group_counts`` at any ``kmer_len``,
  ``count_queries`` / ``count_queries_canonical`` and
  ``get_canonical_kmer_group_counts`` with ``mesh=``. On a process mesh
  every rank holds the whole collection and makes the same calls, as in
  the JAX package; the answers come back the same on every rank.

The module-level functions (``compare_sba_kmers_lexicographically``,
``kmer_info_by_group_generator``, ``get_kmer_group_size_hist``, ...) are the
reference's host walk API, NumPy only.

Construction checks and their messages are the JAX package's. The index
inherits its collection's device. Past the reference's 2^32 k-mers the
index is ``LargeKmers`` (``large_kmers.py``).
"""

from __future__ import annotations

import shelve
import warnings
from typing import Callable, Generator, Union

import numpy as np
import torch

from .ops.filters import (  # noqa: F401  (re-exported reference API)
    FilterContext,
    KeepAllFilter,
    KmerFilter,
    crispr_ngg_pam_filter,
    gen_kmer_gc_content_filter_func,
    gen_kmer_homopolymer_filter_func,
    gen_kmer_length_filter_func,
    gen_no_ambiguous_bases_filter,
    kmer_filter_keep_all,
    kmer_has_required_len,
)
from .io.csv_out import write_csv_columnar
from .kernels.group_hist import group_size_hist_cuda
from .native import decode_rows_native, decode_rows_var_native
from .ops.canonical import (
    canonical_sizes_digest,
    canonical_sizes_digest4,
    canonical_sizes_digest_dense,
)
from .ops.encoding import iupac_revcomp_strs
from .ops.groups import (
    filtered_sizes_digest,
    group_geometry,
    group_sizes_at_boundaries,
    hist_from_sizes,
    hist_to_host,
    lanes_filtered_sizes_digest,
    lanes_sizes_digest,
    selection_masks,
    sizes_digest,
    strand_order,
)
from .ops.keys import (
    build_key2_words,
    build_key_words,
    cap_lengths,
    compute_valid_len,
)
from .ops.query import count_queries as _count_queries
from .ops.query import encode_query_words
from .ops.sort import (
    WINDOW2_BASES,
    WINDOW_BASES,
    adjacent_boundaries,
    boundaries_from_sorted_lanes,
    lanes_view,
    sort_positions,
    sort_positions_dense,
    sort_positions_suffix_dense,
)
from .parallel import (
    compact_ragged,
    distributed_adjacent_gids,
    distributed_count_queries,
    distributed_group_size_histogram_ragged,
    mesh_lanes_filter_flags,
    sample_sort_canonical_dense_ragged,
    sample_sort_canonical_ragged,
    sample_sort_positions_dense_ragged,
    sample_sort_positions_ragged,
    sample_sort_positions_unbounded,
)
from .parallel.collectives import all_gather_shards, replicate
from .parallel.distributed import shard_evenly
from .parallel.sample_sort import ragged_rows
from .sequence_collection import (
    SequenceCollection,
    get_forward_seq_idx,
    get_sba_start_end_indices_for_segment,
    get_segment_num_from_sba_index,
)
from .tracing import mesh_span, new_call, span

_DOLLAR = ord("$")

# index size at which a filter that is a plain callable (a per-position
# Python loop) warns and points at VectorizedFilter; module-level so tests
# can lower it
_CALLABLE_WARN_THRESHOLD = 1_000_000


# --------------------------------------------------------------------------- #
# comparison kernels (host parity versions of reference kmers.py:262-397)
# --------------------------------------------------------------------------- #


_CMP_CHUNK = 64


def _terminator_offset(chunk: np.ndarray, want: int) -> Union[int, None]:
    """Offset of the first k-mer terminator within ``chunk`` (a '$' byte, or
    the array end if the slice came back short of ``want``); None if the
    chunk is clean."""
    hits = np.flatnonzero(chunk == _DOLLAR)
    if hits.size:
        return int(hits[0])
    if chunk.shape[0] < want:
        return chunk.shape[0]
    return None


def compare_sba_kmers_lexicographically(
    sba_a,
    sba_b,
    kmer_sba_start_idx_a: int,
    kmer_sba_start_idx_b: int,
    max_kmer_len: Union[int, None] = None,
) -> tuple[int, int]:
    """Host-side lexicographic k-mer compare with the '$'/array-end => smaller
    rule; behavior (including the no-valid-bases AssertionError) matches the
    reference comparator (reference kmers.py:306-397).

    Returns (comparison in {-1, 0, 1}, last_kmer_index_compared). The
    decision is derived from two scan results rather than a byte-at-a-time
    walk: t = offset of the nearest terminator on either side, d = offset of
    the first byte difference. A terminator at t decides whenever
    t <= min(d, max_kmer_len - 1); otherwise a difference at d < max_kmer_len
    decides; otherwise the compare cap does. Bytes are scanned a numpy chunk
    at a time, so the common early-mismatch case touches one small slice.

    The device path never calls this (packed keys reproduce it wholesale,
    ops/encoding.py); tests and the generic host walk do.
    """
    arr_a = np.asarray(sba_a)
    arr_b = np.asarray(sba_b)
    # None = compare to the segment end; a non-positive cap never trips the
    # reference's `kmer_idx == max_kmer_len - 1` break, i.e. it is unbounded
    cap = max_kmer_len if (max_kmer_len is None or max_kmer_len >= 1) else None

    scanned = 0
    term_at = None  # (offset, a_terminated, b_terminated)
    diff_at = None  # (offset, sign)
    while term_at is None and diff_at is None:
        if cap is not None and scanned >= cap:
            break
        want = _CMP_CHUNK if cap is None else min(_CMP_CHUNK, cap - scanned)
        lo_a = kmer_sba_start_idx_a + scanned
        lo_b = kmer_sba_start_idx_b + scanned
        chunk_a = arr_a[lo_a : lo_a + want]
        chunk_b = arr_b[lo_b : lo_b + want]
        t_a = _terminator_offset(chunk_a, want)
        t_b = _terminator_offset(chunk_b, want)
        if t_a is not None or t_b is not None:
            t = min(x for x in (t_a, t_b) if x is not None)
            term_at = (scanned + t, t_a == t, t_b == t)
        span = min(chunk_a.shape[0], chunk_b.shape[0])
        unequal = np.flatnonzero(chunk_a[:span] != chunk_b[:span])
        if unequal.size:
            d = int(unequal[0])
            sign = -1 if chunk_a[d] < chunk_b[d] else 1
            diff_at = (scanned + d, sign)
        scanned += want

    horizon = cap - 1 if cap is not None else None
    if term_at is not None and (diff_at is None or term_at[0] <= diff_at[0]):
        t, a_ends, b_ends = term_at
        if horizon is None or t <= horizon:
            if t == 0:
                raise AssertionError("There were no valid kmer bases to compare")
            return (0 if a_ends == b_ends else (-1 if a_ends else 1)), t - 1
        return 0, horizon
    if diff_at is not None and (horizon is None or diff_at[0] <= horizon):
        return diff_at[1], diff_at[0]
    return 0, horizon


class _AlwaysLessThanComparator:
    """Unsorted-path comparator: every k-mer its own group (reference
    kmers.py:295-303)."""

    def __call__(self, sba_a, sba_b, idx_a, idx_b, max_kmer_len=None):
        return -1, 0


compare_sba_kmers_always_less_than = _AlwaysLessThanComparator()


class _FixedLenComparator:
    """Comparator with max_kmer_len bound (reference kmers.py:285-292). The
    vectorized engine recognizes instances by their ``kmer_len`` attribute."""

    def __init__(self, kmer_len):
        self.kmer_len = kmer_len

    def __call__(self, sba_a, sba_b, idx_a, idx_b):
        return compare_sba_kmers_lexicographically(
            sba_a, sba_b, idx_a, idx_b, max_kmer_len=self.kmer_len
        )


def get_compare_sba_kmers_func(kmer_len) -> _FixedLenComparator:
    """Reference kmers.py:285-292."""
    return _FixedLenComparator(kmer_len)


def get_kmer_info_minimal(
    kmer_num, kmer_sba_start_indices, sba, kmer_len, group_size_yielded, group_size_total
):
    """Reference kmers.py:400-425."""
    return kmer_num, group_size_yielded, group_size_total


def get_kmer_info_group_size_only(
    kmer_num, kmer_sba_start_indices, sba, kmer_len, group_size_yielded, group_size_total
):
    """Reference kmers.py:428-451."""
    return group_size_total


# --------------------------------------------------------------------------- #
# generic group walk (host fallback; exact reference semantics)
# --------------------------------------------------------------------------- #


def _check_group_bounds(min_group_size, max_group_size, yield_first_n) -> None:
    """Shared validation for the group-walk APIs (error strings are part of
    the public contract — reference kmers.py:552-562)."""
    if min_group_size < 1:
        raise ValueError(f"min_group_size ({min_group_size}) must be >= 1")
    if max_group_size is not None and max_group_size < min_group_size:
        raise ValueError(
            f"if max_group_size ({max_group_size}) is specified, it must be >= min_group_size ({min_group_size})"
        )
    if yield_first_n is not None and yield_first_n < 1:
        raise ValueError(f"if yield_first_n ({yield_first_n}) is specified, it must be > 0")


def _group_qualifies(size: int, min_group_size, max_group_size) -> bool:
    return size >= min_group_size and (max_group_size is None or size <= max_group_size)


def _iter_filter_survivors(sba, sba_strand, kmer_start_indices, keep):
    """Stream of (kmer_num, sba_start_idx) for every k-mer passing ``keep``
    — the lazy equivalent of the vectorized engine's survivor mask."""
    for kmer_num in range(len(kmer_start_indices)):
        sba_idx = int(kmer_start_indices[kmer_num])
        if keep(sba, sba_strand, sba_idx):
            yield kmer_num, sba_idx


def _iter_equal_runs(survivors, sba, same_key, head_limit):
    """Collapse a survivor stream into (head_members, run_size) tuples.

    A run is a maximal stretch of adjacent survivors whose pairwise
    comparison (``same_key``, previous survivor vs current) returns equal —
    the streaming mirror of ops/sort.adjacent_boundaries. Only the first
    ``head_limit`` member kmer_nums are retained per run (None = all);
    ``run_size`` always counts every member.
    """
    head: list[int] = []
    run_size = 0
    anchor_idx = None
    for kmer_num, sba_idx in survivors:
        if run_size and same_key(sba, sba, anchor_idx, sba_idx)[0] != 0:
            yield head, run_size
            head, run_size = [], 0
        if head_limit is None or len(head) < head_limit:
            head.append(kmer_num)
        run_size += 1
        anchor_idx = sba_idx
    if run_size:
        yield head, run_size


def kmer_info_by_group_generator(
    sba,
    sba_strand,
    kmer_len,
    kmer_start_indices,
    kmer_comparison_func,
    kmer_filter_func,
    kmer_info_func,
    min_group_size: int = 1,
    max_group_size: Union[int, None] = None,
    yield_first_n: Union[int, None] = None,
) -> Generator[tuple, None, None]:
    """Host generator over k-mer groups, output-identical to the reference's
    JIT'd group walk (reference kmers.py:523-648) but built as a two-stage
    stream: filter survivors -> collapse into equal-key runs -> emit
    ``kmer_info_func`` for (up to yield_first_n) members of each run whose
    size is within [min_group_size, max_group_size].

    The Kmers methods use the vectorized segmented-op engine instead whenever
    the supplied callables are the library's own; this stream is the fully
    general escape hatch for arbitrary user callables. It stays lazy: a run
    is emitted as soon as the first survivor beyond it is seen, and filter/
    comparator exceptions surface at the same iteration point they would in
    the reference.
    """
    _check_group_bounds(min_group_size, max_group_size, yield_first_n)

    runs = _iter_equal_runs(
        _iter_filter_survivors(sba, sba_strand, kmer_start_indices, kmer_filter_func),
        sba,
        kmer_comparison_func,
        yield_first_n,
    )
    for head, run_size in runs:
        if not _group_qualifies(run_size, min_group_size, max_group_size):
            continue
        for member in head:
            yield kmer_info_func(
                member, kmer_start_indices, sba, kmer_len, len(head), run_size
            )


def get_kmer_group_size_hist(
    sba,
    sba_strand,
    kmer_len,
    kmer_start_indices,
    kmer_comparison_func,
    kmer_filter_func,
    min_group_size: int = 1,
    max_group_size: Union[int, None] = None,
    max_counts_bin: int = 1000000,
) -> tuple[np.ndarray, int]:
    """Histogram of group sizes + total k-mer count over the host group walk
    (same outputs as reference kmers.py:454-520). Consumes the run stream
    directly — a histogram needs sizes, not member yields.
    Kmers.get_kmer_group_counts uses the device engine instead; this free
    function keeps the reference kernel API."""
    if max_counts_bin <= 0:
        raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
    _check_group_bounds(min_group_size, max_group_size, None)

    counts_by_group_size = np.zeros((max_counts_bin + 1,), dtype=np.int64)
    total_kmer_count = 0
    runs = _iter_equal_runs(
        _iter_filter_survivors(sba, sba_strand, kmer_start_indices, kmer_filter_func),
        sba,
        kmer_comparison_func,
        head_limit=1,
    )
    for _head, run_size in runs:
        if _group_qualifies(run_size, min_group_size, max_group_size):
            counts_by_group_size[min(run_size, max_counts_bin)] += 1
            total_kmer_count += run_size
    return counts_by_group_size, total_kmer_count


class _DistIndexCache:
    """The sorted index a ``sort(mesh=...)`` keeps: the sample sort's ragged
    layout (per shard: positions, pad flags, and the sorted key words built
    at ``built_k``, ``lanes_two_bit`` their encoding), so that a following
    mesh statistics or query call on the same mesh needs no re-sort and no
    key gather. ``n_real`` is the index length. A sort beyond one compare
    window keeps no key words but its converged run ids ``gid_full`` (per
    shard), the group identity at ``gid_full_k`` (None: suffix mode)."""

    def __init__(self, mesh, positions, is_pad, n_real: int, lanes=None,
                 lanes_two_bit=None, built_k=None, gid_full=None, gid_full_k=None):
        self.mesh = mesh
        self.positions = positions
        self.is_pad = is_pad
        self.n_real = n_real
        self.lanes = lanes
        self.lanes_two_bit = lanes_two_bit
        self.built_k = built_k
        self.gid_full = gid_full
        self.gid_full_k = gid_full_k


class _ShardScans:
    """The collection's device cache (``_DeviceCache``) as shard ``p`` of a
    mesh sees it, the ``scans`` of a filter's ``FilterContext``: each
    tensor it hands out (genome scans, packs, valid lengths) is the cache's,
    replicated over the mesh once (``shared`` holds the copies of all
    shards), and a shard on the cache's own device shares its filter
    planes."""

    def __init__(self, dc, mesh, p: int, shared: dict):
        self._dc, self._mesh, self._p, self._shared = dc, mesh, p, shared
        dev = mesh.devices[p]
        if dc.filter_flags is None:
            self.filter_flags = None
        elif dev == dc.seg_starts.device:
            self.filter_flags = dc.filter_flags
        else:
            self.filter_flags = shared.setdefault(("filter_flags", dev), {})

    def __getattr__(self, name):
        if name not in self._shared:
            value = getattr(self._dc, name)
            n_dev = len(self._mesh.devices)
            self._shared[name] = (
                replicate(value, self._mesh) if isinstance(value, torch.Tensor) else [value] * n_dev
            )
        return self._shared[name][self._p]


class Kmers:
    """Memory-efficient k-mer calculations on a genome, on a GPU.

    Constructor arguments, validation and error behavior match the JAX
    package (track_strands_separately, a non-forward source_strand and
    double_pass raise NotImplementedError; ``from_strand`` implements
    them)."""

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
    def from_strand(
        cls,
        seq_coll: Union[SequenceCollection, None] = None,
        min_kmer_len: int = 1,
        max_kmer_len: Union[int, None] = None,
        source_strand: str = "forward",
        track_strands_separately: bool = False,
        method: str = "single_pass",
        kmer_filters: list = (),
    ) -> "Kmers":
        """Construct a Kmers over a chosen strand.

        - ``source_strand="reverse_complement"``: the index enumerates,
          sorts and groups the k-mers of the reverse-complement SBA exactly
          as the forward index does for the forward SBA.
        - ``source_strand="both"``: one index over the k-mers of both
          strands, built on the concatenated SBA ``forward + '$' + revcomp``
          (SequenceCollection.both_concat_arrays), an ordinary 2R-segment
          single-SBA problem for the sort and the statistics. Positions
          below ``len(forward_sba)`` are "+" k-mers, positions above it "-"
          k-mers. Equal k-mer strings of the two strands share a group; with
          ``track_strands_separately=True`` the strand joins the group
          identity (within a run of equal strings the position tie-break
          puts every "+" entry before every "-" entry, so the split is one
          more term of the boundary mask, not another sort).

        ``method="double_pass"`` fills an exactly sized position array
        record by record and gives the same index as ``single_pass``.
        ``kmer_filters`` keep the positions every one of them passes, in
        either method (the library filters by window gathers on the device,
        a plain callable by a host loop)."""
        self = cls.__new__(cls)
        self._construct(
            seq_coll, min_kmer_len, max_kmer_len, source_strand,
            track_strands_separately, method, kmer_filters=kmer_filters,
            init_extension=True,
        )
        self._strand_extension = source_strand != "forward"
        return self

    def _construct(
        self,
        seq_coll,
        min_kmer_len,
        max_kmer_len,
        source_strand,
        track_strands_separately,
        method,
        kmer_filters=(),
        init_extension=False,
    ) -> None:
        self._strand_extension = False
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

        self._is_initialized = False
        self._is_set = False
        self._is_sorted = False
        # The index lives as a host uint32 array or as a device int64
        # tensor; either is materialized lazily from the other or from the
        # init geometry, so sort -> stats never round-trips through the host.
        self._pos_host = None
        self._pos_dev = None
        self._init_geometry = None
        self._lanes_cache = None
        # (converged run ids of a suffix sort, the max_kmer_len they hold at)
        self._suffix_gid_cache = None
        # the ragged layout a sort(mesh=...) keeps (_DistIndexCache)
        self._dist_cache = None
        # every position has valid_len >= min_kmer_len: true by construction;
        # unknown (None) after an assignment, checked once on demand by
        # _cap_covers_min_k (the CRISPR lanes gate depends on it)
        self._cap_cover_ok = True

        if seq_coll is None:
            return

        min_seq_len = None
        num_records = 0
        # "both": record lengths are the same on the two strands, so they
        # are checked on the forward segments. For from_strand() the
        # strand-match check comes before the iteration, so that any
        # mismatched collection fails with the message below.
        if (source_strand == "both" or init_extension) and (
            seq_coll.strands_loaded() != source_strand
        ):
            raise ValueError(
                f"source_strand ({source_strand}) does not match sequence_collection loaded strand ({seq_coll.strands_loaded()})"
            )
        records_it = (
            seq_coll.iter_records("forward")
            if source_strand == "both"
            else seq_coll.iter_records()
        )
        for _, s, e in records_it:
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
        self._initialize(
            kmer_filters=list(kmer_filters), method=method, extension=init_extension
        )

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #

    def _initialize(self, kmer_filters=(), method: str = "single_pass", extension=False):
        # the plain constructor keeps the reference's errors; from_strand()
        # passes extension=True
        if kmer_filters and not extension:
            raise NotImplementedError("kmer_filters have not been implemented")
        if method == "double_pass":
            if not extension:
                raise NotImplementedError(f"method '{method}' has not been implemented")
            self._initialize_double_pass(kmer_filters)
        elif method == "single_pass":
            self._initialize_single_pass(kmer_filters)
        else:
            raise ValueError(f"method '{method}' not recognized")
        self._is_initialized = True

    def _initialize_single_pass(self, kmer_filters=()):
        """Every k-mer start position in [seg_start, seg_end - min_kmer_len + 1]
        per record. Only the O(records) geometry is stored; the position
        array is built lazily, on the host when ``kmer_sba_start_indices``
        is read, and never for the fresh sort, which covers every SBA
        position at once. Init-time ``kmer_filters`` materialize every
        position on the device, mask them once and compact."""
        num_kmers = self._get_unfiltered_kmer_count()
        if num_kmers > 2**32 - 1:
            msg = "the size of the required kmers array exceeds the limit set by a uint32"
            raise NotImplementedError(msg)

        seg_starts = []
        counts = []
        for s, e in self._iter_segments():
            seg_starts.append(s)
            counts.append((e - s + 1) - self.min_kmer_len + 1)
        self._init_geometry = (
            np.asarray(seg_starts, dtype=np.uint32),
            np.asarray(counts, dtype=np.int64),
            int(num_kmers),
        )
        self._pos_host = None
        self._pos_dev = None

        if kmer_filters:
            positions = self._build_positions_device()
            mask = self._init_filter_mask(positions, kmer_filters)
            self._reset_index()  # the geometry no longer describes the index
            self._pos_dev = positions[mask]
            # a subset of the canonical positions keeps the cap coverage
            self._cap_cover_ok = True

    def _initialize_double_pass(self, kmer_filters=()):
        """The lower-memory init: count the k-mers of every record first,
        then fill an exactly sized array. Init-time ``kmer_filters`` are
        evaluated record by record (the genome scans once, shared through
        ``scan_cache``), so the unfiltered whole-genome index never
        materializes. The same positions as single_pass, as an assigned
        host array."""
        if self._get_unfiltered_kmer_count() > 2**32 - 1:
            msg = "the size of the required kmers array exceeds the limit set by a uint32"
            raise NotImplementedError(msg)
        chunks = []
        total = 0
        scan_cache = {}
        for s, e in self._iter_segments():
            stop = e - self.min_kmer_len + 2
            mask = None
            if kmer_filters:
                pos = torch.arange(s, stop, dtype=torch.int64, device=self.device)
                mask = self._init_filter_mask(
                    pos, kmer_filters, valid_len=e - pos + 1, scan_cache=scan_cache
                ).cpu().numpy()
            chunks.append((s, stop, mask))
            total += stop - s if mask is None else int(mask.sum())
        out = np.empty(total, dtype=np.uint32)
        write = 0
        for s, stop, mask in chunks:
            pos = np.arange(s, stop, dtype=np.uint32)
            if mask is not None:
                pos = pos[mask]
            out[write : write + len(pos)] = pos
            write += len(pos)
        if write != total:
            raise AssertionError("logic error filling kmer_sba_start_indices")
        self.kmer_sba_start_indices = out
        # the canonical fill, filtered or not: the cap coverage holds
        self._cap_cover_ok = True

    def _callable_mask(self, f: Callable, positions: np.ndarray) -> np.ndarray:
        """Host bool mask from a filter that is a plain callable with the
        reference's signature (the slow path, one Python call a position).
        A both-strand index presents each position in its own strand's SBA
        coordinates, keeping the reference's single-strand filter contract."""
        n = len(positions)
        if n >= _CALLABLE_WARN_THRESHOLD:
            warnings.warn(
                f"kmer filter {getattr(f, '__name__', type(f).__name__)} is an "
                f"arbitrary callable, so it runs as a per-position Python loop "
                f"over {n} positions (the reference's walk semantics). For a "
                f"vectorized device evaluation wrap it as "
                f"genome_kmers_tpu_torch.VectorizedFilter, or use the library "
                f"KmerFilter classes.",
                RuntimeWarning,
                stacklevel=3,
            )
        if self.kmer_source_strand == "both":
            off = self._revcomp_offset()
            fwd, rc = self.seq_coll.forward_sba, self.seq_coll.revcomp_sba
            return np.fromiter(
                (
                    bool(
                        f(fwd, "forward", int(p))
                        if int(p) < off
                        else f(rc, "reverse_complement", int(p) - off)
                    )
                    for p in positions
                ),
                dtype=bool,
                count=n,
            )
        sba = self._host_sba()
        strand = self._strand_to_use()
        return np.fromiter((bool(f(sba, strand, int(p))) for p in positions), dtype=bool, count=n)

    def _init_filter_mask(self, positions: torch.Tensor, kmer_filters, valid_len=None,
                          scan_cache=None) -> torch.Tensor:
        """AND of every init-time filter over the given device positions (a
        bool tensor on the same device). The library filters share one
        FilterContext with no device cache, so they take the window route
        and compute the genome scans once a call (and, through
        ``scan_cache``, once over double_pass's records); plain callables
        take the host loop (``_callable_mask``)."""
        if valid_len is None:
            dc = self._dc()
            valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
        mask = torch.ones(positions.shape[0], dtype=torch.bool, device=positions.device)
        ctx = None
        cached = ("_sba_dev", "_gc_cumsum", "_run_len", "_next_amb")
        for f in kmer_filters:
            if isinstance(f, KmerFilter):
                if ctx is None:
                    ctx = FilterContext(self._host_sba(), positions, valid_len)
                    if scan_cache:
                        for field in cached:
                            setattr(ctx, field, scan_cache[field])
                mask &= f.batch_mask(ctx)
            else:
                host = self._callable_mask(f, positions.cpu().numpy())
                mask &= torch.from_numpy(host).to(positions.device)
        if ctx is not None and scan_cache is not None:
            for field in cached:
                scan_cache[field] = getattr(ctx, field)
        return mask

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

    def _build_positions_device(self) -> torch.Tensor:
        """The initial position array computed on the device: the record of
        each index by a search of the cumulative counts, then its start
        plus the offset within it."""
        seg_starts, counts, num_kmers = self._init_geometry
        cum_excl = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        cum_excl = torch.from_numpy(cum_excl).to(self.device)
        starts = torch.from_numpy(seg_starts.astype(np.int64)).to(self.device)
        idx = torch.arange(num_kmers, dtype=torch.int64, device=self.device)
        rec = torch.searchsorted(cum_excl, idx, right=True) - 1
        return starts[rec] + (idx - cum_excl[rec])

    def _device_positions(self) -> torch.Tensor:
        """The index as an int64 device tensor, materialized lazily."""
        if self._pos_dev is None:
            if (
                self._pos_host is None
                and self._init_geometry is not None
                and self._dist_cache is None
            ):
                self._pos_dev = self._build_positions_device()
            else:
                host = np.asarray(self.kmer_sba_start_indices).astype(np.int64)
                self._pos_dev = torch.from_numpy(host).to(self.device)
        return self._pos_dev

    def _iter_segments(self):
        """(sba_start, sba_end) of every segment of the active SBA: the
        forward or revcomp records in record order, or, for a both-strand
        index, all 2R segments of the concatenated SBA in SBA order (k-mer
        numbering then runs over the forward positions first)."""
        if self.kmer_source_strand == "both":
            sba, starts = self.seq_coll.both_concat_arrays()
            starts64 = starts.astype(np.int64)
            ends64 = np.concatenate([starts64[1:] - 2, [len(sba) - 1]])
            for s, e in zip(starts64, ends64):
                yield int(s), int(e)
        else:
            for _, s, e in self.seq_coll.iter_records():
                yield s, e

    def _get_unfiltered_kmer_count(self) -> int:
        num_kmers = 0
        num_records = 0
        for s, e in self._iter_segments():
            num_kmers += (e - s + 1) - self.min_kmer_len + 1
            num_records += 1
        if num_records == 0:
            raise ValueError("SequenceCollection does not have any records")
        return num_kmers

    def _ragged_to_host(self) -> np.ndarray:
        """The kept mesh layout compacted to a host uint32 array (global
        sorted order, pads removed; every rank's shards on a process
        mesh)."""
        cache = self._dist_cache
        out = ragged_rows(cache.positions, cache.is_pad, cache.mesh)
        if out.shape[0] != cache.n_real:
            raise AssertionError(
                f"the mesh layout holds {out.shape[0]} rows, the index {cache.n_real}"
            )
        return out

    @property
    def kmer_sba_start_indices(self):
        """Host uint32 view of the k-mer index, materialized lazily from the
        device tensor, the kept mesh layout or the init geometry."""
        if self._pos_host is None:
            if self._pos_dev is not None:
                self._pos_host = self._pos_dev.cpu().numpy().astype(np.uint32)
            elif self._dist_cache is not None:
                self._pos_host = self._ragged_to_host()
            elif self._init_geometry is not None:
                self._pos_host = self._build_positions_host()
        return self._pos_host

    @kmer_sba_start_indices.setter
    def kmer_sba_start_indices(self, value):
        self._reset_index()
        self._pos_host = value

    def _reset_index(self):
        """Forget the index and everything derived from it."""
        self._pos_host = None
        self._pos_dev = None
        self._init_geometry = None
        self._lanes_cache = None
        self._suffix_gid_cache = None
        self._dist_cache = None
        # unknown until checked: an assigned set may hold positions with
        # valid_len < min_kmer_len (the canonical build never does)
        self._cap_cover_ok = None

    @property
    def suffix_run_ids(self):
        """Run ids of the sorted rows, kept by a fresh sort in suffix mode or
        beyond one window: rows share an id iff their k-mers are equal at the
        sort's own compare length. None where the last sort kept none."""
        return None if self._suffix_gid_cache is None else self._suffix_gid_cache[0]

    def __len__(self):
        if self._pos_host is not None:
            return len(self._pos_host)
        if self._pos_dev is not None:
            return int(self._pos_dev.shape[0])
        if self._dist_cache is not None:
            return self._dist_cache.n_real
        if self._init_geometry is not None:
            return self._init_geometry[2]
        raise TypeError("Kmers index is not initialized")

    def __getitem__(self):
        """Stub, as in the reference."""
        pass

    # ------------------------------------------------------------------ #
    # checks
    # ------------------------------------------------------------------ #

    def _check_forward_only(self):
        if self._strand_extension and self.kmer_source_strand in (
            "reverse_complement",
            "both",
        ):
            # from_strand() instances work on the revcomp or the
            # concatenated both-strand SBA; the forward-only error stays
            # for every plain-constructed Kmers
            return
        condition1 = self.kmer_source_strand != "forward"
        condition2 = self.seq_coll.strands_loaded() != "forward"
        if condition1 or condition2:
            raise NotImplementedError(
                f"both kmer_source_strand ({self.kmer_source_strand}) and "
                "sequence_collection.strands_loaded() must be 'forward'"
            )

    # strand-aware accessors: every compute and query path goes through
    # these, so from_strand() switches the whole class to the
    # reverse-complement (or concatenated both-strand) SBA in one place
    def _strand_to_use(self) -> str:
        if self.kmer_source_strand == "both":
            return "both_concat"
        return (
            "reverse_complement"
            if self.kmer_source_strand == "reverse_complement"
            else "forward"
        )

    def _host_sba(self) -> np.ndarray:
        sc = self.seq_coll
        strand = self._strand_to_use()
        if strand == "both_concat":
            return sc.both_concat_arrays()[0]
        if strand == "reverse_complement":
            return sc.revcomp_sba
        return sc.forward_sba

    def _host_seg_starts(self) -> np.ndarray:
        sc = self.seq_coll
        strand = self._strand_to_use()
        if strand == "both_concat":
            return sc.both_concat_arrays()[1]
        if strand == "reverse_complement":
            return sc._revcomp_sba_seg_starts
        return sc._forward_sba_seg_starts

    def _revcomp_offset(self) -> int:
        """First concatenated-SBA index of the revcomp half (both mode):
        positions >= this offset are "-"-strand k-mers. The byte at
        ``offset - 1`` is the joining '$', never a k-mer position."""
        return len(self.seq_coll.forward_sba) + 1

    def _dc(self):
        return self.seq_coll.device_cache(self._strand_to_use())

    def _check_group_params_unsorted(self, min_group_size, max_group_size, yield_first_n=None):
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
            if yield_first_n is not None:
                msg = "Returning group parameters is not supported when kmers has not been"
                msg += f" sorted. yield_first_n ({yield_first_n}) cannot be specified. Did you"
                msg += " mean to run sort() before getting kmers?"
                raise ValueError(msg)

    # ------------------------------------------------------------------ #
    # group structure on the device
    # ------------------------------------------------------------------ #

    def _survivors(self, kmer_filter_func):
        """The positions a filter keeps: (their index numbers as a device
        tensor, or None when every position survives; their positions;
        their valid lengths). A KmerFilter is one device mask (plane or
        window route), a plain callable a host loop; the survivors are then
        compacted on the device."""
        dc = self._dc()
        positions = self._device_positions()
        valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
        if isinstance(kmer_filter_func, KeepAllFilter):
            return None, positions, valid_len
        if isinstance(kmer_filter_func, KmerFilter):
            ctx = FilterContext(
                self._host_sba(), positions, valid_len, sba_dev=lambda: dc.sba, scans=dc
            )
            mask = kmer_filter_func.batch_mask(ctx)
        else:
            host = self._callable_mask(kmer_filter_func, self.kmer_sba_start_indices)
            mask = torch.from_numpy(host).to(self.device)
        surv_nums = torch.nonzero(mask).flatten()
        return surv_nums, positions[surv_nums], valid_len[surv_nums]

    def _cap_covers_min_k(self) -> bool:
        """True when every index position has valid_len >= min_kmer_len:
        guaranteed by construction, checked against the data once (one
        device reduce) after an assignment to ``kmer_sba_start_indices``.
        The CRISPR lanes gate consults it."""
        if self._cap_cover_ok is None:
            positions = self._device_positions()
            if positions.shape[0] == 0:
                self._cap_cover_ok = True
            else:
                dc = self._dc()
                vl = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
                self._cap_cover_ok = int(vl.min()) >= self.min_kmer_len
        return self._cap_cover_ok

    def _ensure_lanes(self):
        """The retained sorted key lanes, rebuilt ONCE from the sorted
        positions when absent: an assigned index has no sort of this
        process to retain lanes from. The one key gather makes every later
        statistics query gather-free. ``_lanes_rebuild = False`` switches
        the rebuild off, which sends filtered queries to the plane and
        window routes."""
        lanes = self._lanes_cache
        if lanes is not None or not self._is_sorted or self.max_kmer_len is None:
            return lanes
        if not getattr(self, "_lanes_rebuild", True):
            return None
        dc = self._dc()
        use2 = self.max_kmer_len <= WINDOW2_BASES and dc.packed2 is not None
        if not use2 and self.max_kmer_len > WINDOW_BASES:
            return None
        positions = self._device_positions()
        if positions.shape[0] <= 1:
            return None
        valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
        cap = cap_lengths(valid_len, self.max_kmer_len)
        if use2:
            words = build_key2_words(dc.packed2, positions, cap, -(-self.max_kmer_len // 16))
            uniform = self.min_kmer_len == self.max_kmer_len
        else:
            words = build_key_words(dc.packed, positions, cap, -(-self.max_kmer_len // 8))
            uniform = True  # the 4-bit encoding carries termination in-word
        self._lanes_cache = lanes_view(
            use2, self.max_kmer_len, words, None if uniform else cap, self._cap_covers_min_k
        )
        return self._lanes_cache

    def _within_max(self, kmer_len) -> bool:
        """Groups at ``kmer_len`` lie within the sort's compare length."""
        return self.max_kmer_len is None or (kmer_len is not None and kmer_len <= self.max_kmer_len)

    def _covering_lanes(self, kmer_len):
        """The retained sorted lanes of a sorted index when they cover
        ``kmer_len``, else None. Rebuilt lanes are built at max_kmer_len:
        no rebuild for a query they could never serve."""
        if not self._is_sorted or kmer_len is None or not self._within_max(kmer_len):
            return None
        lanes = self._ensure_lanes()
        return lanes if lanes is not None and kmer_len <= lanes["built_k"] else None

    def _stats_route(self, kmer_len, kmer_filter_func):
        """The route of a one-card statistics query, in the JAX package's
        order, as (name, lanes, spec):

        * ``"lanes"``: no filter, no strand-split term, over the retained
          sorted lanes that cover ``kmer_len``;
        * ``"lanes_filtered"``: a library filter that can be read from
          those lanes (``spec``, its ``lanes_spec``): no genome row is read;
        * ``"plane"``: any other library filter where the groups at
          ``kmer_len`` are contiguous in index order (unsorted, within the
          sort's compare length, or suffix-sorted), by its flag plane or
          window gathers (``_filtered_device_stats``);
        * ``"boundary"``: the group boundary of the survivors
          (``_boundary_parts``).

        No route's device work runs here: at most the one rebuild of
        absent lanes (``_ensure_lanes``) and a filter's cap check."""
        keep_all = isinstance(kmer_filter_func, KeepAllFilter)
        library = isinstance(kmer_filter_func, KmerFilter) and not keep_all
        if keep_all and not self.track_strands_separately:
            lanes = self._covering_lanes(kmer_len)
            if lanes is not None:
                return "lanes", lanes, None
        if library and self._is_sorted and kmer_len is not None and len(self) > 0:
            lanes = self._covering_lanes(kmer_len)
            if lanes is not None:
                spec = kmer_filter_func.lanes_spec(
                    lanes, len(self._host_sba()), self.min_kmer_len
                )
                if spec is not None:
                    return "lanes_filtered", lanes, spec
        if library and (not self._is_sorted or self._within_max(kmer_len)):
            return "plane", None, None
        return "boundary", None, None

    @staticmethod
    def _raise_lanes_errs(err, msg_makers) -> None:
        """Raise the filter's reference error from the lanes digest's
        [any, cond_id, first_bad_position] (ops/groups.fold_err_conditions):
        the first offending row in sorted order, the row the reference's
        walk raises at."""
        if err and err[0]:
            raise ValueError(msg_makers[err[1]](err[2]))

    def _filtered_device_stats(self, kmer_len, kmer_filter_func):
        """(boundary of all rows, device survivor mask) for a filtered query
        by the plane or window route (``_stats_route``'s ``"plane"``). The
        groups at ``kmer_len`` are contiguous in index order, so the
        survivors' groups are the groups of all rows restricted to the
        survivors (the reference's previous-survivor walk), and no
        compaction is needed."""
        order, _, boundary = self._boundary_parts(kmer_len, kmer_filter_keep_all)
        dc = self._dc()
        positions = self._device_positions()
        valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
        ctx = FilterContext(
            self._host_sba(), positions, valid_len, sba_dev=lambda: dc.sba, scans=dc
        )
        kmer_filter_func.check_batch(ctx)
        mask = kmer_filter_func.mask_pure(ctx)
        # tracked strands: the boundary is in (string, strand) order
        return boundary, mask if order is None else mask[order]

    def _boundary_parts(self, kmer_len, kmer_filter_func):
        """(survivor index numbers or None, surviving positions,
        group-boundary mask) on the device, in index order. An unsorted
        index has every k-mer as its own group. The sort's run ids and the
        retained lanes describe all rows, so they serve only when every
        position survives."""
        dc = self._dc()
        surv_nums, surv_pos, surv_vl = self._survivors(kmer_filter_func)
        m = surv_pos.shape[0]
        if m == 0:
            return surv_nums, surv_pos, torch.zeros(0, dtype=torch.bool, device=self.device)
        if not self._is_sorted:
            return surv_nums, surv_pos, torch.ones(m, dtype=torch.bool, device=self.device)
        sg = self._suffix_gid_cache
        if (
            sg is not None
            and surv_nums is None
            and not self.track_strands_separately
            and kmer_len == sg[1]
        ):
            # run ids kept by the suffix sort: identity at the sort's own
            # comparison (None = to the end of the record), so the boundary
            # is an adjacent difference and no window round runs
            gid = sg[0]
            boundary = torch.ones(m, dtype=torch.bool, device=self.device)
            boundary[1:] = gid[1:] != gid[:-1]
            return surv_nums, surv_pos, boundary
        lanes = self._covering_lanes(kmer_len) if surv_nums is None else None
        if lanes is not None:
            boundary = boundaries_from_sorted_lanes(
                lanes["words"], lanes["cap"], kmer_len, lanes["two_bit"]
            )
        else:
            cap = cap_lengths(surv_vl, kmer_len)
            use2 = kmer_len is not None and kmer_len <= WINDOW2_BASES
            packed2 = dc.packed2 if use2 else None
            packed = dc.packed if packed2 is None else None
            uniform = kmer_len is not None and self.min_kmer_len >= kmer_len
            boundary = adjacent_boundaries(
                packed, surv_pos, cap, kmer_len, packed2=packed2, uniform_cap=uniform
            )
        if self.track_strands_separately:
            # the strand joins the group identity: each group's "+" rows
            # go before its "-" rows (ops/groups.strand_order), and the rows
            # come back in that order with their index numbers. At the
            # sort's own uniform length they are already in that order.
            is_rc = surv_pos >= self._revcomp_offset()
            if kmer_len is not None and kmer_len == self.max_kmer_len <= self.min_kmer_len:
                boundary[1:] |= is_rc[1:] != is_rc[:-1]
                return surv_nums, surv_pos, boundary
            order, boundary = strand_order(boundary, is_rc)
            surv_nums = order if surv_nums is None else surv_nums[order]
            surv_pos = surv_pos[order]
        return surv_nums, surv_pos, boundary

    def _group_arrays(self, kmer_len, kmer_filter_func, min_group_size, max_group_size,
                      yield_first_n):
        """Host arrays for the yielding calls, over the filter's survivors
        in index order: (kmer numbers, positions, yielded mask, group size
        yielded, group size total). A survivor's kmer number is its index
        number."""
        surv_nums, surv_pos, boundary = self._boundary_parts(kmer_len, kmer_filter_func)
        m = surv_pos.shape[0]
        if m == 0:
            empty_u32 = np.zeros(0, dtype=np.uint32)
            return (np.zeros(0, dtype=np.int64), empty_u32, np.zeros(0, dtype=bool),
                    empty_u32, empty_u32)
        _, _, size, rank = group_geometry(boundary)
        yielded, gsy = selection_masks(
            boundary, size, rank, min_group_size, max_group_size, yield_first_n
        )
        nums = np.arange(m, dtype=np.int64) if surv_nums is None else surv_nums.cpu().numpy()
        return (
            nums,
            surv_pos.cpu().numpy().astype(np.uint32),
            yielded.cpu().numpy(),
            gsy.cpu().numpy().astype(np.uint32),
            size.cpu().numpy().astype(np.uint32),
        )

    # ------------------------------------------------------------------ #
    # public queries
    # ------------------------------------------------------------------ #

    def get_kmers(
        self,
        kmer_len: Union[int, None],
        one_based_seq_index: bool = False,
        kmer_filter_func: Callable = kmer_filter_keep_all,
        kmer_info_to_yield: str = "minimum",
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ) -> Generator[tuple, None, None]:
        """Generator of k-mer info tuples: (kmer_num, group_size_yielded,
        group_size_total), or with ``kmer_info_to_yield="full"`` (kmer_num,
        strand, record name, seq_start_idx, kmer_len, group_size_yielded,
        group_size_total)."""
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size, yield_first_n)
        if kmer_info_to_yield not in ("minimum", "full"):
            raise ValueError(f"kmer_info_to_yield ({kmer_info_to_yield}) not recognized")

        surv_nums, surv_pos, yielded, gsy, gst = self._group_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size, yield_first_n
        )
        full = kmer_info_to_yield == "full"
        if full:
            get_record_info = self._record_info_func(one_based_seq_index)
        for j in np.flatnonzero(yielded):
            kmer_num = int(surv_nums[j])
            if not full:
                yield (kmer_num, int(gsy[j]), int(gst[j]))
                continue
            sba_idx = int(surv_pos[j])
            _, _, e, seq_strand, seq_chrom, seq_start_idx = get_record_info(sba_idx)
            if kmer_len is None:
                out_kmer_len = e - sba_idx + 1
            else:
                if sba_idx + kmer_len - 1 > e:
                    raise ValueError(
                        f"kmer_len ({kmer_len}) for kmer_num ({kmer_num}) extends beyond the end of the segment"
                    )
                out_kmer_len = kmer_len
            yield (kmer_num, seq_strand, seq_chrom, seq_start_idx, out_kmer_len,
                   int(gsy[j]), int(gst[j]))

    def _record_info_func(self, one_based_seq_index: bool) -> Callable:
        """Closure mapping an index of the active SBA to ``(seg_num,
        sba_start, sba_end, strand, record_name, seq_idx)``.

        Forward and revcomp indexes take the collection's closure. A
        both-strand index looks at the half of the concatenated SBA the
        index lies in: segments number 0..R-1 forward, then R..2R-1
        revcomp, bounds are in concatenated coordinates, and seq_idx counts
        along the forward sequence for either strand."""
        if self.kmer_source_strand != "both":
            return self.seq_coll.generate_get_record_info_from_sba_index_func(
                one_based_seq_index
            )
        sc = self.seq_coll
        off = self._revcomp_offset()
        n_fwd_records = len(sc.forward_record_names)
        fwd_starts = sc._forward_sba_seg_starts
        rc_starts = sc._revcomp_sba_seg_starts
        len_fwd, len_rc = len(sc.forward_sba), len(sc.revcomp_sba)

        def get_record_info_from_sba_index(sba_idx: int):
            if sba_idx >= off:
                local = sba_idx - off
                seg = get_segment_num_from_sba_index(local, "reverse_complement", rc_starts)
                s, e = get_sba_start_end_indices_for_segment(
                    seg, "reverse_complement", rc_starts, len_rc
                )
                seq_idx = get_forward_seq_idx(
                    local, "reverse_complement", s, e, one_based=one_based_seq_index
                )
                return (n_fwd_records + seg, s + off, e + off, "-",
                        sc.revcomp_record_names[seg], seq_idx)
            seg = get_segment_num_from_sba_index(sba_idx, "forward", fwd_starts)
            s, e = get_sba_start_end_indices_for_segment(seg, "forward", fwd_starts, len_fwd)
            seq_idx = get_forward_seq_idx(sba_idx, "forward", s, e, one_based=one_based_seq_index)
            return (seg, s, e, "+", sc.forward_record_names[seg], seq_idx)

        return get_record_info_from_sba_index

    def generate_get_kmer_info_func(self, one_based_seq_index: bool) -> Callable:
        """The reference's full-info closure: (kmer_num, kmer_sba_start_indices,
        sba, kmer_len, group_size_yielded, group_size_total) -> (kmer_num,
        strand, record name, seq_start_idx, kmer_len, group_size_yielded,
        group_size_total)."""
        get_record_info_from_sba_index = self._record_info_func(one_based_seq_index)

        def get_kmer_info(
            kmer_num, kmer_sba_start_indices, sba, kmer_len, group_size_yielded, group_size_total
        ):
            if kmer_num < 0:
                raise ValueError(f"kmer_num ({kmer_num}) cannot be less than zero")
            if kmer_num >= len(kmer_sba_start_indices):
                raise ValueError(
                    f"kmer_num ({kmer_num}) is out of bounds (num kmers = {len(kmer_sba_start_indices)})"
                )
            sba_idx = int(kmer_sba_start_indices[kmer_num])
            _, _, e, seq_strand, seq_chrom, seq_start_idx = get_record_info_from_sba_index(sba_idx)
            if kmer_len is None:
                kmer_len = e - sba_idx + 1
            elif sba_idx + kmer_len - 1 > e:
                raise ValueError(
                    f"kmer_len ({kmer_len}) for kmer_num ({kmer_num}) extends beyond the end of the segment"
                )
            return (kmer_num, seq_strand, seq_chrom, seq_start_idx, kmer_len,
                    group_size_yielded, group_size_total)

        return get_kmer_info

    # ------------------------------------------------------------------ #
    # equality
    # ------------------------------------------------------------------ #

    def __ne__(self, other):
        return not self.__eq__(other)

    def __eq__(self, other):
        """Lengths, strand fields, state flags, the index and the
        collection are equal (the device is not compared)."""
        if self.min_kmer_len != other.min_kmer_len:
            return False
        if (self.max_kmer_len is None) != (other.max_kmer_len is None):
            return False
        if self.max_kmer_len is not None and self.max_kmer_len != other.max_kmer_len:
            return False
        if self.kmer_source_strand != other.kmer_source_strand:
            return False
        if self.track_strands_separately != other.track_strands_separately:
            return False
        if self._is_initialized != other._is_initialized:
            return False
        if self._is_set != other._is_set:
            return False
        if self._is_sorted != other._is_sorted:
            return False
        if (self.kmer_sba_start_indices is None) != (other.kmer_sba_start_indices is None):
            return False
        if self.kmer_sba_start_indices is not None and not np.array_equal(
            self.kmer_sba_start_indices, other.kmer_sba_start_indices
        ):
            return False
        if self.seq_coll != other.seq_coll:
            return False
        return True

    def get_kmers_arrays(
        self,
        kmer_len: Union[int, None],
        kmer_filter_func: Callable = kmer_filter_keep_all,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Bulk form of ``get_kmers(kmer_info_to_yield="minimum")``:
        (kmer_nums, sba_start_indices, group_size_yielded, group_size_total)
        as NumPy arrays in yield order."""
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size, yield_first_n)
        surv_nums, surv_pos, yielded, gsy, gst = self._group_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size, yield_first_n
        )
        sel = np.flatnonzero(yielded)
        return (
            surv_nums[sel].astype(np.int64),
            surv_pos[sel].astype(np.uint32),
            gsy[sel].astype(np.int64),
            gst[sel].astype(np.int64),
        )

    def _check_stats_args(self, kmer_len, min_group_size, max_group_size):
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size)

    def get_kmer_count(
        self,
        kmer_len: Union[int, None],
        kmer_filter_func: Callable = kmer_filter_keep_all,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        mesh=None,
    ) -> int:
        """Total k-mers in groups of size in [min_group_size, max_group_size]
        at ``kmer_len`` base identity; under a filter, the survivors in
        groups whose survivor count is in range. On an unsorted index every
        k-mer is its own group. Routes, in order: unfiltered lanes,
        filtered lanes, flag plane or window, compaction to the survivors.
        ``mesh``: count over the mesh (``_mesh_group_hist``); the index must
        be sorted."""
        new_call()
        self._check_stats_args(kmer_len, min_group_size, max_group_size)
        if mesh is not None:
            if not self._is_sorted:
                raise NotImplementedError("get_kmer_count(mesh=...) requires a sorted index")
            return self._mesh_group_hist(
                kmer_len, kmer_filter_func, min_group_size, max_group_size, 1, mesh
            )[1]
        digest = self._route_sizes(kmer_len, kmer_filter_func, min_group_size, max_group_size)
        return 0 if digest is None else digest[2]

    def _route_sizes(self, kmer_len, kmer_filter_func, min_group_size, max_group_size):
        """(size, qualifies, total) of a one-card statistics query on its
        route (``_stats_route``): each group's size (under a filter, its
        survivors) at its first row, whether it qualifies, and the total
        k-mers of the qualifying groups. None for an empty boundary."""
        route, lanes, spec = self._stats_route(kmer_len, kmer_filter_func)
        if route == "lanes":
            return lanes_sizes_digest(
                lanes["words"], lanes["cap"], kmer_len, min_group_size, max_group_size,
                lanes["two_bit"],
            )
        if route == "lanes_filtered":
            flags_fn, params, msgs = spec
            split = self._revcomp_offset() if self.track_strands_separately else None
            size, qualifies, total, err = lanes_filtered_sizes_digest(
                lanes["words"], lanes["cap"], self._device_positions(), params, kmer_len,
                min_group_size, max_group_size, split, lanes["two_bit"], flags_fn,
            )
            self._raise_lanes_errs(err, msgs)
            return size, qualifies, total
        if route == "plane":
            boundary, mask = self._filtered_device_stats(kmer_len, kmer_filter_func)
            if boundary.shape[0] == 0:
                return None
            return filtered_sizes_digest(boundary, mask, min_group_size, max_group_size)
        _, _, boundary = self._boundary_parts(kmer_len, kmer_filter_func)
        if boundary.shape[0] == 0:
            return None
        with span("gk:groups.sizes", boundary):
            return sizes_digest(
                boundary, group_sizes_at_boundaries(boundary), min_group_size, max_group_size
            )

    @staticmethod
    def _hist_tail(size, qualifies, max_counts_bin: int) -> np.ndarray:
        """The int64 histogram of the qualifying groups' sizes, on the host."""
        with span("gk:groups.histogram", size, kernel=group_size_hist_cuda):
            counts = hist_from_sizes(size, qualifies, max_counts_bin)
        with span("gk:groups.readback", counts):
            return hist_to_host(counts)

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
        groups; under a filter, of the groups' survivor counts. Routes as
        in ``get_kmer_count``; ``mesh`` computes them over the mesh
        (``_mesh_group_hist``)."""
        new_call()
        self._check_stats_args(kmer_len, min_group_size, max_group_size)
        if not self._is_sorted:
            raise AssertionError("The kmers must be sorted when calling get_kmer_group_counts")
        if max_counts_bin <= 0:
            raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
        if mesh is not None:
            return self._mesh_group_hist(
                kmer_len, kmer_filter_func, min_group_size, max_group_size, max_counts_bin,
                mesh,
            )
        digest = self._route_sizes(kmer_len, kmer_filter_func, min_group_size, max_group_size)
        if digest is None:
            return np.zeros(max_counts_bin + 1, dtype=np.int64), 0
        size, qualifies, total = digest
        return self._hist_tail(size, qualifies, max_counts_bin), total

    def _mesh_group_hist(self, kmer_len, kmer_filter_func, min_group_size, max_group_size,
                         max_counts_bin, mesh) -> tuple[np.ndarray, int]:
        """Group-size histogram and total over the mesh, equal to the
        single-device statistics.

        A layout kept by ``sort(mesh=...)`` on the same mesh serves a
        library filter (or none) directly: unfiltered over its sorted lanes;
        a filter with a lanes form as a survivor mask over them
        (``mesh_lanes_filter_flags``); any other library filter is checked
        shard by shard over the valid rows (the first offending row in
        global order raises) and masked, and the pads it makes are moved to
        each shard's tail (``compact_ragged``). Otherwise (no kept layout,
        another mesh, or a filter that is a plain callable) the survivors
        are sample-sorted over the mesh afresh. Identity at ``kmer_len`` is
        the key words of one compare window; beyond it (or None) it is run
        ids: the kept ones of an unbounded sort at its own length (no
        round), those of an unbounded sort of the survivors, or the run
        structure of ``distributed_adjacent_gids`` over the layout (no
        re-sort)."""
        dc = self._dc()
        strand_split = self._revcomp_offset() if self.track_strands_separately else None
        use2 = dc.packed2 is not None
        packed2 = dc.packed2 if use2 else None
        packed = None if use2 else dc.packed
        need_gid = kmer_len is None or kmer_len > (WINDOW2_BASES if use2 else WINDOW_BASES)
        keep_all = isinstance(kmer_filter_func, KeepAllFilter)
        cache = self._dist_cache
        sorted_words = None
        mask = None
        ext_gid = None
        if cache is not None and cache.mesh == mesh and isinstance(kmer_filter_func, KmerFilter):
            rag_pos, rag_pad = cache.positions, cache.is_pad
            lanes_fit = (
                cache.lanes is not None
                and cache.lanes_two_bit == use2
                and not need_gid
                and kmer_len <= cache.built_k
            )
            if keep_all and lanes_fit:
                sorted_words = cache.lanes
            elif keep_all and need_gid and cache.gid_full is not None and kmer_len == cache.gid_full_k:
                ext_gid = cache.gid_full
            elif not keep_all:
                spec = None
                if lanes_fit:
                    # the ragged sort keeps no cap lane: the caps are
                    # recomputed in mesh_lanes_filter_flags
                    view = lanes_view(cache.lanes_two_bit, cache.built_k, cache.lanes[0], None,
                                      self._cap_covers_min_k)
                    spec = kmer_filter_func.lanes_spec(
                        view, len(self._host_sba()), self.min_kmer_len
                    )
                if spec is not None:
                    flags_fn, params, msgs = spec
                    mask, err = mesh_lanes_filter_flags(
                        cache.lanes, rag_pos, rag_pad, params, flags_fn, dc.seg_starts,
                        dc.seg_ends, cache.built_k, mesh,
                    )
                    self._raise_lanes_errs(err, msgs)
                    sorted_words = cache.lanes
                else:
                    masks = self._mesh_filter_masks(kmer_filter_func, rag_pos, rag_pad, mesh)
                    new_pad = [pad | ~m for pad, m in zip(rag_pad, masks)]
                    rag_pos, rag_pad = compact_ragged(rag_pos, new_pad, mesh)
        else:
            _, surv_pos, _ = self._survivors(kmer_filter_func)
            if need_gid:
                # the survivors sorted at exactly kmer_len: their converged
                # run ids are the identity
                rag_pos, rag_pad, ext_gid = sample_sort_positions_unbounded(
                    packed, surv_pos, dc.seg_starts, dc.seg_ends, mesh, packed2=packed2,
                    max_kmer_len=kmer_len, return_ragged=True,
                )
            else:
                rag_pos, rag_pad, sorted_words = sample_sort_positions_ragged(
                    packed, surv_pos, dc.seg_starts, dc.seg_ends, kmer_len, mesh,
                    packed2=packed2, return_lanes=True,
                )
        if need_gid and ext_gid is None:
            ext_gid = distributed_adjacent_gids(
                packed, rag_pos, rag_pad, dc.seg_starts, dc.seg_ends, kmer_len, mesh,
                packed2=packed2,
            )
        counts, total = distributed_group_size_histogram_ragged(
            packed, rag_pos, rag_pad, dc.seg_starts, dc.seg_ends, kmer_len, mesh,
            min_group_size=min_group_size, max_group_size=max_group_size,
            max_counts_bin=max_counts_bin, packed2=packed2, strand_split=strand_split,
            sorted_words=sorted_words, mask=mask, ext_gid=ext_gid,
        )
        with mesh_span("gk:mesh.readback", [counts]):
            counts = hist_to_host(counts)
        return counts, total

    def _mesh_filter_masks(self, kmer_filter_func, positions, is_pad, mesh) -> list:
        """A library filter over the sharded rows by its plane or window
        route: its raise check shard by shard in shard order over the valid
        rows only (``FilterContext.valid_rows``), so the first offending row
        in global sorted order raises, as in the reference's walk; then its
        survivor mask per shard. Pad rows read position 0 here. On a
        process mesh the check runs over every rank's rows gathered in
        shard order (the JAX package's ``process_allgather``), so every
        rank raises the same error."""
        dc = self._dc()
        shared = {}

        def context(i, pos, pad):
            scans = _ShardScans(dc, mesh, i, shared)
            pos = torch.where(pad, 0, pos)
            valid_len = compute_valid_len(pos, scans.seg_starts, scans.seg_ends)
            return FilterContext(
                self._host_sba(), pos, valid_len, sba_dev=lambda s=scans: s.sba,
                valid_rows=~pad, scans=scans,
            )

        ctxs = [context(i, pos, pad) for i, (pos, pad) in enumerate(zip(positions, is_pad))]
        if mesh.group is None:
            for ctx in ctxs:
                kmer_filter_func.check_batch(ctx)
        else:
            dev = mesh.devices[0]
            every = lambda xs: torch.cat([x.to(dev) for x in all_gather_shards(list(xs), mesh)])  # noqa: E731
            kmer_filter_func.check_batch(context(0, every(positions), every(is_pad)))
        return [kmer_filter_func.mask_pure(ctx) for ctx in ctxs]

    # ------------------------------------------------------------------ #
    # k-mer strings (host)
    # ------------------------------------------------------------------ #

    def _segment_ends(self, pos: np.ndarray) -> np.ndarray:
        """Inclusive SBA end of the segment of each int64 position."""
        seg_starts = self._host_seg_starts().astype(np.int64)
        seg_ids = np.searchsorted(seg_starts, pos, side="right") - 1
        return np.where(
            seg_ids == len(seg_starts) - 1,
            len(self._host_sba()) - 1,
            seg_starts[np.minimum(seg_ids + 1, len(seg_starts) - 1)] - 2,
        )

    def get_kmer_str_no_checks(self, kmer_num: int, kmer_strand: str, kmer_len: int) -> str:
        if kmer_strand == "+":
            sba = self._host_sba()
            sba_start_idx = self.kmer_sba_start_indices[kmer_num]
        elif kmer_strand == "-":
            raise NotImplementedError("Only implemented for kmer_strand='+'")
        else:
            raise ValueError(f"kmer_strand ({kmer_strand}) not recognized")
        return bytearray(sba[sba_start_idx : sba_start_idx + kmer_len]).decode("utf-8")

    def get_kmer_strs(self, kmer_nums, kmer_len: Union[int, None]) -> list:
        """Decode many k-mers at once, by the native row decoders (one
        contiguous copy a row). A k-mer running past its segment end raises
        like ``get_kmer_str``; ``kmer_len=None`` decodes each k-mer at its
        natural length, min(max_kmer_len, bases to segment end)."""
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be a positive int")
        self._check_forward_only()
        nums = np.asarray(kmer_nums, dtype=np.int64)
        if nums.size == 0:
            return []
        if (nums < 0).any() or (nums >= len(self)).any():
            raise ValueError("kmer_num out of bounds")
        pos = self.kmer_sba_start_indices[nums].astype(np.int64)
        sba = self._host_sba()
        seg_e = self._segment_ends(pos)
        if kmer_len is None:
            lens = seg_e - pos + 1
            if self.max_kmer_len is not None:
                lens = np.minimum(lens, self.max_kmer_len)
            data, offsets = decode_rows_var_native(sba, pos, lens)
            b = data.tobytes()
            return [b[offsets[r] : offsets[r + 1]].decode("ascii") for r in range(len(pos))]
        if (pos + kmer_len - 1 > seg_e).any():
            bad = int(nums[np.flatnonzero(pos + kmer_len - 1 > seg_e)[0]])
            raise ValueError(
                f"kmer_len ({kmer_len}) for kmer_num ({bad}) extends beyond the end of the segment"
            )
        block = decode_rows_native(sba, pos, kmer_len)
        return block.view(f"S{kmer_len}").ravel().astype(f"U{kmer_len}").tolist()

    def get_kmer_str(self, kmer_num: int, kmer_len: Union[int, None] = None) -> str:
        self._check_forward_only()
        if kmer_num < 0:
            raise ValueError(f"kmer_num ({kmer_num}) cannot be less than zero")
        if kmer_num >= len(self):
            raise ValueError(f"kmer_num ({kmer_num}) is out of bounds (num kmers = {len(self)})")
        if kmer_len is not None and kmer_len < self.min_kmer_len:
            raise ValueError(
                f"kmer_len ({kmer_len}) is less than min_kmer_len ({self.min_kmer_len})"
            )
        if self.max_kmer_len is not None and kmer_len is not None and kmer_len > self.max_kmer_len:
            raise ValueError(
                f"kmer_len ({kmer_len}) is greater than max_kmer_len ({self.max_kmer_len})"
            )
        sba_start_idx = int(self.kmer_sba_start_indices[kmer_num])
        if self.kmer_source_strand == "both":
            # the collection's per-strand lookups need a strand when both
            # are loaded; the bounds come off the concatenated SBA instead
            _, _, sba_seg_end_idx, _, _, _ = self._record_info_func(False)(sba_start_idx)
        else:
            seg_num = self.seq_coll.get_segment_num_from_sba_index(sba_start_idx)
            _, sba_seg_end_idx = self.seq_coll.get_sba_start_end_indices_for_segment(seg_num)
        if kmer_len is None:
            largest_kmer_len = sba_seg_end_idx - sba_start_idx + 1
            if self.max_kmer_len is None:
                kmer_len = largest_kmer_len
            else:
                kmer_len = min(self.max_kmer_len, largest_kmer_len)
        if sba_start_idx + kmer_len - 1 > sba_seg_end_idx:
            raise ValueError(
                f"kmer_len ({kmer_len}) for kmer_num ({kmer_num}) extends beyond the end of the segment"
            )
        sba = self._host_sba()
        return bytearray(sba[sba_start_idx : sba_start_idx + kmer_len]).decode("utf-8")

    # ------------------------------------------------------------------ #
    # sort
    # ------------------------------------------------------------------ #

    def sort(self, mesh=None, on_round=None, on_step=None, mesh_info=None):
        """Sort the index lexicographically by the k-mers it defines, on the
        collection's device. Equal k-mers end up ordered by start index.

        ``mesh`` (parallel.make_mesh or make_mesh2) runs the sample sort
        over the mesh instead (parallel/sample_sort.py): within one compare
        window gather-free over every SBA position for the fresh index, by
        gathered keys otherwise; beyond it by refinement rounds
        (``sample_sort_positions_unbounded``, which calls ``on_round``).
        The index keeps the ragged layout for the mesh statistics and
        queries; ``on_step`` and ``mesh_info`` see
        ``sample_sort_positions_ragged``.

        The fresh index sorts gather-free over every SBA position: 2-bit
        keys at max_kmer_len <= 64 on an ACGT genome, else 4-bit keys at
        max_kmer_len <= 32 (ops/sort.sort_positions_dense, which keeps the
        sorted key lanes for the statistics calls); with max_kmer_len None
        (suffix mode) or beyond that window by refinement rounds
        (ops/sort.sort_positions_suffix_dense, which keeps the converged
        run ids). Any other index (a re-sort, an assigned
        ``kmer_sba_start_indices``) sorts by gathered keys with the position
        as the last key (ops/sort.sort_positions). ``on_round(name)`` is
        called as each refinement round finishes on the device (ops/sort's
        module doc); a sort within one window has no rounds."""
        new_call()
        self._check_forward_only()
        if mesh is not None:
            self._sort_mesh(mesh, on_round, on_step, mesh_info)
            return
        self._lanes_cache = None  # every branch below re-establishes or clears
        self._suffix_gid_cache = None
        self._dist_cache = None
        dc = self._dc()
        uniform = self.max_kmer_len is not None and self.min_kmer_len == self.max_kmer_len

        if self._init_geometry is not None and int(self._init_geometry[2]) > 1:
            n = int(self._init_geometry[2])
            use2 = (
                self.max_kmer_len is not None
                and self.max_kmer_len <= WINDOW2_BASES
                and dc.packed2 is not None
            )
            limit = WINDOW2_BASES if use2 else WINDOW_BASES
            if self.max_kmer_len is not None and self.max_kmer_len <= limit:
                self._pos_dev, self._lanes_cache = sort_positions_dense(
                    dc.packed2 if use2 else dc.packed, dc.seg_starts, dc.seg_ends,
                    n, self.min_kmer_len, self.max_kmer_len, two_bit=use2,
                    uniform_cap=uniform, return_lanes=True,
                )
            else:
                # ACGT genomes take the 2-bit rounds (half the key lanes)
                packed2 = dc.packed2
                packed = dc.packed if packed2 is None else None
                self._pos_dev, gid = sort_positions_suffix_dense(
                    packed, dc.seg_starts, dc.seg_ends, n, self.min_kmer_len,
                    self.max_kmer_len, packed2=packed2, return_gid=True, on_round=on_round,
                )
                self._suffix_gid_cache = (gid, self.max_kmer_len)
        else:
            positions = self._device_positions()
            valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
            if self.min_kmer_len > 1:
                vl_min = int(valid_len.min()) if positions.shape[0] else self.min_kmer_len
                if vl_min < self.min_kmer_len:
                    raise AssertionError(
                        f"kmers compared were less than min_kmer_len ({self.min_kmer_len}).  Was kmer_sba_start_indices initialized correctly?"
                    )
            # 2-bit keys whenever the alphabet allows; only then is the
            # 4-bit pack never built
            packed2 = dc.packed2
            packed = dc.packed if packed2 is None else None
            self._pos_dev, self._lanes_cache = sort_positions(
                packed, positions, cap_lengths(valid_len, self.max_kmer_len),
                self.max_kmer_len, packed2=packed2, uniform_cap=uniform, return_lanes=True,
                on_round=on_round,
            )
        self._pos_host = None
        self._init_geometry = None  # no longer describes the (sorted) order
        self._is_sorted = True

    def _sort_mesh(self, mesh, on_round, on_step, info) -> None:
        """``sort(mesh=...)``: within one compare window (2-bit keys on an
        ACGT genome: k <= 64; else 4-bit: k <= 32) the dense sample sort of
        the fresh index or the gather sample sort of any other, which keep
        their sorted key words; beyond it (or None) the refinement rounds
        of ``sample_sort_positions_unbounded`` on the 2-bit keys where the
        alphabet allows, which keep their converged run ids. The kept
        layout of the rounds has one pad row a shard: the JAX pad tail grows
        1.5x a round (parallel/sample_sort.py)."""
        self._lanes_cache = None
        self._suffix_gid_cache = None
        self._dist_cache = None
        dc = self._dc()
        max_k = self.max_kmer_len
        uniform = max_k is not None and self.min_kmer_len == max_k
        use2 = max_k is not None and max_k <= WINDOW2_BASES and dc.packed2 is not None
        in_window = max_k is not None and max_k <= (WINDOW2_BASES if use2 else WINDOW_BASES)
        gid = None
        if in_window and self._init_geometry is not None and int(self._init_geometry[2]) > 1:
            n = int(self._init_geometry[2])
            pos, pad, lanes = sample_sort_positions_dense_ragged(
                dc.packed2 if use2 else dc.packed, dc.seg_starts, dc.seg_ends, n,
                self.min_kmer_len, max_k, mesh, two_bit=use2, uniform_cap=uniform,
                return_lanes=True, on_step=on_step, info=info,
            )
        else:
            positions = self._device_positions()
            n = int(positions.shape[0])
            if self.min_kmer_len > 1 and n:
                valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
                if int(valid_len.min()) < self.min_kmer_len:
                    raise AssertionError(
                        f"kmers compared were less than min_kmer_len ({self.min_kmer_len}).  Was kmer_sba_start_indices initialized correctly?"
                    )
            # 2-bit keys whenever the alphabet allows: the 4-bit pack is
            # then never built
            packed2 = dc.packed2
            use2 = packed2 is not None
            packed = None if use2 else dc.packed
            if max_k is not None and max_k <= (WINDOW2_BASES if use2 else WINDOW_BASES):
                pos, pad, lanes = sample_sort_positions_ragged(
                    packed, positions, dc.seg_starts, dc.seg_ends, max_k, mesh, packed2=packed2,
                    uniform_cap=uniform, return_lanes=True, on_step=on_step, info=info,
                )
            else:
                pos, pad, gid = sample_sort_positions_unbounded(
                    packed, positions, dc.seg_starts, dc.seg_ends, mesh, packed2=packed2,
                    max_kmer_len=max_k, return_ragged=True,
                    on_round=on_round, on_step=on_step, info=info,
                )
                lanes = None
        self._dist_cache = _DistIndexCache(
            mesh, pos, pad, n, lanes=lanes, lanes_two_bit=use2,
            built_k=None if gid is not None else max_k, gid_full=gid,
            gid_full_k=max_k if gid is not None else None,
        )
        self._pos_dev = None
        self._pos_host = None
        self._init_geometry = None
        self._is_sorted = True

    def get_is_less_than_func(self, validate_kmers: bool = True, break_ties: bool = False) -> Callable:
        """The reference's sort comparator closure over SBA start indices, on
        the host; the sort never calls it."""
        self._check_forward_only()
        sba = self._host_sba()
        min_kmer_len = self.min_kmer_len
        max_kmer_len = self.max_kmer_len

        def is_less_than(kmer_sba_start_idx_a: int, kmer_sba_start_idx_b: int) -> bool:
            comparison, last_kmer_index_compared = compare_sba_kmers_lexicographically(
                sba, sba, kmer_sba_start_idx_a, kmer_sba_start_idx_b, max_kmer_len=max_kmer_len
            )
            if comparison < 0:
                a_lt_b = True
            elif comparison > 0:
                a_lt_b = False
            else:
                a_lt_b = kmer_sba_start_idx_a < kmer_sba_start_idx_b if break_ties else False
            if validate_kmers:
                num_bases_to_check = min_kmer_len - (last_kmer_index_compared + 1)
                kmer_a_is_valid = kmer_has_required_len(
                    sba, kmer_sba_start_idx_a + last_kmer_index_compared + 1, num_bases_to_check
                )
                kmer_b_is_valid = kmer_has_required_len(
                    sba, kmer_sba_start_idx_b + last_kmer_index_compared + 1, num_bases_to_check
                )
                if not kmer_a_is_valid or not kmer_b_is_valid:
                    raise AssertionError(
                        f"kmers compared were less than min_kmer_len ({min_kmer_len}).  Was kmer_sba_start_indices initialized correctly?"
                    )
            return a_lt_b

        return is_less_than

    # ------------------------------------------------------------------ #
    # queries and canonical statistics
    # ------------------------------------------------------------------ #

    def count_queries(self, queries: list, kmer_len: Union[int, None] = None, mesh=None) -> np.ndarray:
        """Occurrences of each query k-mer string in the sorted index (uint32
        array), by a bound search on the 4-bit pack (ops/query.py). Query
        identity is ``get_kmers(kmer_len=L)`` group identity, L defaulting to
        the first query's length, so a query shorter than max_kmer_len
        counts prefix occurrences."""
        if not self._is_sorted:
            raise ValueError("count_queries requires a sorted index. Run sort() first.")
        self._check_forward_only()
        if not queries:
            return np.zeros(0, dtype=np.uint32)
        if kmer_len is None:
            kmer_len = len(queries[0])
        if kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        dc = self._dc()
        if mesh is not None:
            # the layout a sort(mesh=...) kept, or the index cut into equal
            # shards: a per-shard bound search and one psum
            cache = self._dist_cache
            if cache is not None and cache.mesh == mesh:
                pos, pad = cache.positions, cache.is_pad
            else:
                pos, pad = shard_evenly(self._device_positions(), mesh)
            return distributed_count_queries(
                dc.packed, pos, pad, dc.seg_starts, dc.seg_ends, queries, kmer_len, mesh
            )
        positions = self._device_positions()
        cap = cap_lengths(compute_valid_len(positions, dc.seg_starts, dc.seg_ends), kmer_len)
        q_words = encode_query_words(queries, kmer_len)
        return _count_queries(dc.packed, positions, cap, q_words, kmer_len)

    def count_queries_canonical(
        self, queries: list, kmer_len: Union[int, None] = None, mesh=None
    ) -> np.ndarray:
        """Strand-collapsed occurrences: each query counts its own hits plus
        its reverse complement's (once for a palindrome). Uppercase IUPAC
        queries on a single-strand sorted index."""
        if self.kmer_source_strand == "both":
            raise NotImplementedError(
                "canonical queries are defined on a single-strand index; "
                "count_queries on a both-strand index already counts both "
                "strands"
            )
        if not queries:
            return np.zeros(0, dtype=np.uint32)
        rcs = iupac_revcomp_strs(queries)
        fwd = self.count_queries(queries, kmer_len, mesh=mesh)
        rc = self.count_queries(rcs, kmer_len, mesh=mesh)
        is_palindrome = np.array([q == r for q, r in zip(queries, rcs)])
        return fwd + np.where(is_palindrome, 0, rc).astype(np.uint32)

    def get_canonical_kmer_group_counts(
        self, kmer_len: int, max_counts_bin: int = 1000000, mesh=None
    ) -> tuple[np.ndarray, int]:
        """Group-size histogram and total over canonical k-mers, each
        identified with min(kmer, revcomp(kmer)) (ops/canonical.py); only
        full-length k-mers take part. 2-bit keys on an ACGT genome (kmer_len
        <= 64), 4-bit keys otherwise (kmer_len <= 32). Gather-free over the
        fresh index (dense route), else over gathered keys; ``mesh``
        computes them over the mesh (``_mesh_canonical_hist``)."""
        new_call()
        self._check_forward_only()
        if self.kmer_source_strand == "both":
            raise NotImplementedError(
                "canonical statistics are defined on a single-strand index "
                "(a both-strand index already contains each k-mer's reverse "
                "complement)"
            )
        if max_counts_bin <= 0:
            raise ValueError(f"max_counts_bin ({max_counts_bin}) must be >= 1")
        dc = self._dc()
        two_bit = dc.packed2 is not None
        limit = WINDOW2_BASES if two_bit else WINDOW_BASES
        if kmer_len is None or kmer_len < 1 or kmer_len > limit:
            raise ValueError(
                f"kmer_len ({kmer_len}) must be in [1, {limit}]"
                + ("" if two_bit else " (4-bit IUPAC lanes)")
            )
        packed = dc.packed2 if two_bit else dc.packed
        if len(self) == 0:
            return np.zeros(max_counts_bin + 1, dtype=np.int64), 0
        if mesh is not None:
            return self._mesh_canonical_hist(packed, kmer_len, max_counts_bin, mesh)
        if self._init_geometry is not None:
            size, qualifies, total = canonical_sizes_digest_dense(
                packed, dc.seg_starts, dc.seg_ends, self.min_kmer_len, kmer_len, two_bit=two_bit
            )
        else:
            positions = self._device_positions()
            valid_len = compute_valid_len(positions, dc.seg_starts, dc.seg_ends)
            digest = canonical_sizes_digest if two_bit else canonical_sizes_digest4
            size, qualifies, total = digest(packed, positions, valid_len, kmer_len)
        return self._hist_tail(size, qualifies, max_counts_bin), total

    def _mesh_canonical_hist(self, packed, kmer_len: int, max_counts_bin: int, mesh):
        """Canonical statistics over the mesh: the canonical sample sort,
        gather-free over the fresh index (dense route), else of the index's
        positions (gather route), then the stitched histogram over its
        canonical word lanes."""
        dc = self._dc()
        two_bit = dc.packed2 is not None
        if self._init_geometry is not None:
            pos, pad, words = sample_sort_canonical_dense_ragged(
                packed, dc.seg_starts, dc.seg_ends, self.min_kmer_len, kmer_len, mesh,
                two_bit=two_bit,
            )
        else:
            pos, pad, words = sample_sort_canonical_ragged(
                packed, self._device_positions(), dc.seg_starts, dc.seg_ends, kmer_len, mesh,
                two_bit=two_bit,
            )
        counts, total = distributed_group_size_histogram_ragged(
            None if two_bit else packed, pos, pad, dc.seg_starts, dc.seg_ends, kmer_len, mesh,
            max_counts_bin=max_counts_bin, packed2=dc.packed2, sorted_words=words,
        )
        return hist_to_host(counts), total

    # ------------------------------------------------------------------ #
    # persistence: the JAX package's schema (its kmers.py:2099-2213), group
    # "kmers" in hdf5, plain keys in shelve; positions as uint32
    # ------------------------------------------------------------------ #

    def save(
        self,
        save_file_path,
        include_sequence_collection: bool = False,
        format: str = "hdf5",
        mode: str = "w",
    ) -> None:
        """Write the index (and, with ``include_sequence_collection``, its
        collection) to ``save_file_path``: ``format`` "hdf5" (needs h5py)
        or "shelve"."""
        if format == "hdf5":
            self._save_hdf5(save_file_path, include_sequence_collection, mode=mode)
        elif format == "shelve":
            self._save_shelve(save_file_path, include_sequence_collection)
        else:
            raise ValueError(f"format ({format}) not recognized")

    def load(self, load_file_path, seq_coll=None, format: str = "hdf5", device="cuda") -> None:
        """Replace this index with the file's. With ``seq_coll`` None the
        collection is loaded from the same file onto ``device`` (default
        "cuda", as ``SequenceCollection(device=...)``); else the index
        takes ``seq_coll`` and its device. A loaded sorted index serves
        statistics and queries with no re-sort (its key lanes are rebuilt
        once, as for any assigned sorted index)."""
        if format == "hdf5":
            self._load_hdf5(load_file_path, seq_coll, device)
        elif format == "shelve":
            self._load_shelve(load_file_path, seq_coll, device)
        else:
            raise ValueError(f"format ({format}) not recognized")
        self.device = self.seq_coll.device

    _set_for_export = staticmethod(SequenceCollection._set_for_export)
    _correct_import = staticmethod(SequenceCollection._correct_import)

    def _save_hdf5(self, save_file_path, include_sequence_collection=False, mode="w") -> None:
        import h5py

        with h5py.File(save_file_path, mode) as file:
            grp = file.create_group("kmers")
            empty_start_indices = np.array([], dtype=np.uint32)
            grp["min_kmer_len"] = self.min_kmer_len
            grp["max_kmer_len"] = self._set_for_export(self.max_kmer_len, 0)
            grp["kmer_source_strand"] = self.kmer_source_strand
            grp["track_strands_separately"] = self.track_strands_separately
            grp["_is_initialized"] = self._is_initialized
            grp["_is_set"] = self._is_set
            grp["_is_sorted"] = self._is_sorted
            grp["kmer_sba_start_indices"] = self._set_for_export(
                self.kmer_sba_start_indices, empty_start_indices
            )
        if include_sequence_collection:
            self.seq_coll.save(save_file_path, mode="a", format="hdf5")

    def _load_collection(self, load_file_path, seq_coll, device, format: str) -> None:
        if seq_coll is None:
            seq_coll = SequenceCollection(device=device)
            seq_coll.load(load_file_path, format=format)
        self.seq_coll = seq_coll

    def _load_hdf5(self, load_file_path, seq_coll, device) -> None:
        import h5py

        with h5py.File(load_file_path, "r") as file:
            grp = file["kmers"]
            empty_start_indices = np.array([], dtype=np.uint32)
            self.min_kmer_len = int(grp["min_kmer_len"][()])
            self.max_kmer_len = self._correct_import(grp["max_kmer_len"][()], 0)
            if self.max_kmer_len is not None:
                self.max_kmer_len = int(self.max_kmer_len)
            self.kmer_source_strand = grp["kmer_source_strand"][()].decode("utf-8")
            # a persisted non-forward index came from from_strand(): restore
            # its working mode
            self._strand_extension = self.kmer_source_strand != "forward"
            self.track_strands_separately = bool(grp["track_strands_separately"][()])
            self._is_initialized = bool(grp["_is_initialized"][()])
            self._is_set = bool(grp["_is_set"][()])
            self._is_sorted = bool(grp["_is_sorted"][()])
            self.kmer_sba_start_indices = self._correct_import(
                grp["kmer_sba_start_indices"][:], empty_start_indices
            )
        self._load_collection(load_file_path, seq_coll, device, "hdf5")

    def _save_shelve(self, save_file_path, include_sequence_collection=False) -> None:
        with shelve.open(save_file_path) as db:
            db["min_kmer_len"] = self.min_kmer_len
            db["max_kmer_len"] = self.max_kmer_len
            db["kmer_source_strand"] = self.kmer_source_strand
            db["track_strands_separately"] = self.track_strands_separately
            db["_is_initialized"] = self._is_initialized
            db["_is_set"] = self._is_set
            db["_is_sorted"] = self._is_sorted
            db["kmer_sba_start_indices"] = self.kmer_sba_start_indices
        if include_sequence_collection:
            self.seq_coll.save(save_file_path, format="shelve")

    def _load_shelve(self, load_file_path, seq_coll, device) -> None:
        with shelve.open(load_file_path) as db:
            self.min_kmer_len = db["min_kmer_len"]
            self.max_kmer_len = db["max_kmer_len"]
            self.kmer_source_strand = db["kmer_source_strand"]
            self._strand_extension = self.kmer_source_strand != "forward"
            self.track_strands_separately = db["track_strands_separately"]
            self._is_initialized = db["_is_initialized"]
            self._is_set = db["_is_set"]
            self._is_sorted = db["_is_sorted"]
            self.kmer_sba_start_indices = db["kmer_sba_start_indices"]
        self._load_collection(load_file_path, seq_coll, device, "shelve")

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #

    def _record_columns(self, pos: np.ndarray, one_based_seq_index: bool):
        """Record lookup for int64 positions, all rows at once: (record_num,
        strand U1, seq_start_idx, seg_end). seq_start_idx counts along the
        forward sequence on either strand; record_num indexes
        ``forward_record_names`` (``revcomp_record_names`` for a
        reverse-complement index)."""
        seg_starts = self._host_seg_starts().astype(np.int64)
        seg_ids = np.searchsorted(seg_starts, pos, side="right") - 1
        seg_s = seg_starts[seg_ids]
        sba_len = len(self._host_sba())
        seg_e = np.where(
            seg_ids == len(seg_starts) - 1,
            sba_len - 1,
            seg_starts[np.minimum(seg_ids + 1, len(seg_starts) - 1)] - 2,
        )
        base = 1 if one_based_seq_index else 0
        if self.kmer_source_strand == "reverse_complement":
            # count from the segment's right edge on the revcomp strand
            strand = np.full(len(pos), "-", dtype="U1")
            seq_idx = seg_e - pos + base
            record_num = seg_ids
        elif self.kmer_source_strand == "both":
            n_rec = len(self.seq_coll.forward_record_names)
            rc_row = seg_ids >= n_rec
            strand = np.where(rc_row, "-", "+").astype("U1")
            seq_idx = np.where(rc_row, seg_e - pos, pos - seg_s) + base
            # revcomp segment k is record R-1-k, so concatenated segment
            # R+k maps to forward record 2R-1-(R+k)
            record_num = np.where(rc_row, 2 * n_rec - 1 - seg_ids, seg_ids)
        else:
            strand = np.full(len(pos), "+", dtype="U1")
            seq_idx = pos - seg_s + base
            record_num = seg_ids
        return record_num, strand, seq_idx, seg_e

    def get_kmers_full_arrays(
        self,
        kmer_len: Union[int, None],
        one_based_seq_index: bool = False,
        kmer_filter_func: Callable = kmer_filter_keep_all,
        min_group_size: int = 1,
        max_group_size: Union[int, None] = None,
        yield_first_n: Union[int, None] = None,
    ) -> dict:
        """Bulk form of ``get_kmers(kmer_info_to_yield="full")``: a dict of
        aligned arrays in yield order: kmer_num, record_num, strand
        ("+"/"-"), seq_start_idx (forward-sequence convention), kmer_len,
        group_size_yielded, group_size_total."""
        self._check_forward_only()
        if kmer_len is not None and kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be > 0")
        self._check_group_params_unsorted(min_group_size, max_group_size, yield_first_n)
        surv_nums, surv_pos, yielded, gsy, gst = self._group_arrays(
            kmer_len, kmer_filter_func, min_group_size, max_group_size, yield_first_n
        )
        sel = np.flatnonzero(yielded)
        pos = surv_pos[sel].astype(np.int64)
        record_num, strand, seq_idx, seg_e = self._record_columns(pos, one_based_seq_index)
        if kmer_len is None:
            out_len = seg_e - pos + 1
        else:
            if (pos + kmer_len - 1 > seg_e).any():
                bad = int(sel[np.flatnonzero(pos + kmer_len - 1 > seg_e)[0]])
                raise ValueError(
                    f"kmer_len ({kmer_len}) for kmer_num ({int(surv_nums[bad])}) extends beyond the end of the segment"
                )
            out_len = np.full(len(pos), kmer_len, dtype=np.int64)
        return {
            "kmer_num": surv_nums[sel].astype(np.int64),
            "record_num": record_num.astype(np.int64),
            "strand": strand,
            "seq_start_idx": seq_idx,
            "kmer_len": out_len,
            "group_size_yielded": gsy[sel].astype(np.int64),
            "group_size_total": gst[sel].astype(np.int64),
        }

    def to_csv(self, kmer_len, output_file_path, fields=("kmer",)):
        """Write k-mers to CSV, one row a yielded k-mer in index order.
        Fields: "kmer", "kmer_num", "chrom", "start", "strand",
        "group_size". The bytes are those of ``_to_csv_row_loop`` (the
        reference-shaped writer), raises included, written by a columnar
        writer (``io/csv_out.py``: pyarrow, else pandas) over one bulk
        record lookup and one native decode of the k-mer strings."""
        fields = list(fields)
        allowed = {"kmer", "kmer_num", "chrom", "start", "strand", "group_size"}
        bad = set(fields) - allowed
        if bad:
            raise ValueError(f"unrecognized fields: {sorted(bad)}")
        need_full = bool({"chrom", "start", "strand"} & set(fields))
        names = (
            self.seq_coll.revcomp_record_names
            if self.kmer_source_strand == "reverse_complement"
            else self.seq_coll.forward_record_names
        )
        seg_e = None
        if "group_size" not in fields:
            # with default group parameters every k-mer is yielded in index
            # order: no group pass is needed
            nums = np.arange(len(self), dtype=np.int64)
            pos64 = self.kmer_sba_start_indices.astype(np.int64)
            gst_arr = None
            record_num, strand_col, seq_idx, seg_e = self._record_columns(pos64, False)
            # the row loop reaches a per-row length check only when it
            # decodes a k-mer or yields full info: a bare kmer_num run never
            # raises, so neither does this
            if (
                kmer_len is not None
                and (need_full or "kmer" in set(fields))
                and (pos64 + kmer_len - 1 > seg_e).any()
            ):
                bad = int(nums[np.flatnonzero(pos64 + kmer_len - 1 > seg_e)[0]])
                raise ValueError(
                    f"kmer_len ({kmer_len}) for kmer_num ({bad}) extends beyond the end of the segment"
                )
            arrs = {"record_num": record_num, "strand": strand_col, "seq_start_idx": seq_idx}
        else:
            arrs = self.get_kmers_full_arrays(kmer_len) if need_full else None
            if need_full:
                nums = arrs["kmer_num"]
                gst_arr = arrs["group_size_total"]
            else:
                nums, _, _, gst_arr = self.get_kmers_arrays(kmer_len)
        var_kmer = None  # (data, offsets) when kmer_len is None
        cols = {}
        for field in dict.fromkeys(fields):
            if field == "kmer":
                cols[field], var_kmer = self._kmer_column(kmer_len, nums, seg_e, need_full)
            elif field == "kmer_num":
                cols[field] = nums
            elif field == "chrom":
                cols[field] = arrs["record_num"]  # ids; the writer maps them to names
            elif field == "start":
                cols[field] = arrs["seq_start_idx"]
            elif field == "strand":
                cols[field] = arrs["strand"]
            elif field == "group_size":
                cols[field] = gst_arr
        write_csv_columnar(cols, fields, names, kmer_len, var_kmer, output_file_path)

    def _kmer_column(self, kmer_len, nums, seg_e, need_full):
        """(kmer column, (data, offsets) or None) of ``to_csv``: fixed-width
        ``S{kmer_len}`` strings, or at ``kmer_len=None`` a variable-width
        byte column, with the row loop's raises."""
        sba = self._host_sba()
        pos = self.kmer_sba_start_indices[nums].astype(np.int64)
        if kmer_len is not None:
            if seg_e is None:
                # the group_size routes skipped the upfront check
                bad_rows = np.flatnonzero(pos + kmer_len - 1 > self._segment_ends(pos))
                if bad_rows.size:
                    raise ValueError(
                        f"kmer_len ({kmer_len}) for kmer_num ({int(nums[bad_rows[0]])}) extends beyond the end of the segment"
                    )
            return decode_rows_native(sba, pos, kmer_len).view(f"S{kmer_len}").ravel(), None
        if seg_e is None:
            seg_e = self._segment_ends(pos)
        lens = seg_e - pos + 1
        if need_full:
            # the row loop hands the unclamped full-info length to
            # get_kmer_str, which checks it against min and max per row
            viol_min = lens < self.min_kmer_len
            viol_max = (
                (lens > self.max_kmer_len)
                if self.max_kmer_len is not None
                else np.zeros_like(viol_min)
            )
            viol = np.flatnonzero(viol_min | viol_max)
            if viol.size:
                r = int(viol[0])
                if viol_min[r]:
                    raise ValueError(
                        f"kmer_len ({int(lens[r])}) is less than min_kmer_len ({self.min_kmer_len})"
                    )
                raise ValueError(
                    f"kmer_len ({int(lens[r])}) is greater than max_kmer_len ({self.max_kmer_len})"
                )
        elif self.max_kmer_len is not None:
            lens = np.minimum(lens, self.max_kmer_len)  # get_kmer_str(num, None) clamps
        var_kmer = decode_rows_var_native(sba, pos, lens)
        return var_kmer, var_kmer

    def _to_csv_row_loop(self, kmer_len, output_file_path, fields=("kmer",)):
        """The reference-shaped writer, one Python row at a time (the
        generator walk and ``get_kmer_str`` per k-mer): the plain version of
        ``to_csv``, which must write the same bytes."""
        fields = list(fields)
        need_full = bool({"chrom", "start", "strand"} & set(fields))
        info_kind = "full" if need_full else "minimum"
        with open(output_file_path, "w") as f:
            f.write(",".join(fields) + "\n")
            for info in self.get_kmers(kmer_len, kmer_info_to_yield=info_kind):
                if need_full:
                    kmer_num, strand, chrom, start, klen, gsy, gst = info
                else:
                    kmer_num, gsy, gst = info
                    strand = chrom = start = None
                    klen = kmer_len
                row = []
                for field in fields:
                    if field == "kmer":
                        row.append(self.get_kmer_str(kmer_num, klen))
                    elif field == "kmer_num":
                        row.append(str(kmer_num))
                    elif field == "chrom":
                        row.append(str(chrom))
                    elif field == "start":
                        row.append(str(start))
                    elif field == "strand":
                        row.append(str(strand))
                    elif field == "group_size":
                        row.append(str(gst))
                f.write(",".join(row) + "\n")
