"""Smoke run of genome_kmers_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises (exit code 1) on failure:

1. Require CUDA; print the card's name and power limit (nvidia-smi), and
   the torch and CUDA versions.
2. Build the four kernels from ``genome_kmers_tpu_torch/csrc/``, one nvcc each,
   and the native host library (``native/fasta_parser.cpp``, g++), all
   started together; print the build time and nvcc's register and
   shared-memory report.
3. Hold each kernel against its plain PyTorch version on the card, bitwise:
   the 2-bit pack on seeded random bytes from "ACGT$N" (and all 256 byte
   values) at n in {1, 15, 16, 17, 4099, 2^20+7, 2^27}; the multi-lane sort
   on 1, 2, 3, 6 and 8 lanes at n in {1, 2, 127, 128, T-1, T, T+1, 2T+1, 3T,
   2^20+7, 2^24, 2^24+4097} (T the kernel's tile), heavily tied keys that
   include 0xFFFFFFFF and values >= 2^31, the last lane a permutation (at
   4, 5, 6 and 7 lanes also with a tied payload lane behind the permutation,
   the shape of a refinement round: run id, words, position, cap; at 6 and
   7 such lanes also at 2^27 rows, the shapes the full-width rounds of
   phases 9 and 10 give the kernel; and 2^27 rows of 5 lanes whose position
   is two lanes, hi then lo, the lo lane repeating and holding values >=
   2^31, the shape of LargeKmers' sort), and on inputs already sorted, reverse-sorted, with every key lane constant,
   and with a run that lies wholly before its left partner. Time each kernel
   and its plain version at the main path's shape (2^27 bytes; 2^27 rows x
   6 lanes) beside the least time the card could take and, for the sort,
   beside the one PyTorch call that computes the same rows,
   torch.unique(dim=0), and at 2^27+1 rows, which must not cost 1.2 times
   what 2^27 rows cost.
3b. The group-size histogram kernel (it replaces no TPU kernel) against its
   plain version (the clamp, the select and torch.bincount), bitwise, on
   the sizes and qualifying mask of sorted repeat genomes of 1e8 bases
   (ACGT) and 2.5e8 (IUPAC, N runs), at max_counts_bin 1, 35 and 10^6; its
   time beside its bound (9 B a row plus 8 B a bin at 3.35 TB/s), the plain
   version's, and as yardsticks the port never calls torch.bincount alone
   and ROADMAP A4's split (one reduction for the size-1 groups, a bincount
   of the rest). On the 1e8 index one get_kmer_group_counts(31) and one
   canonical call launch the kernel once each, and the same call on a mesh
   of 4 shards of the card once a shard.
3c. The lanes-flags kernel of the GC-content, homopolymer and no-ambiguous
   filters (it replaces no TPU kernel) against its plain versions (the
   torch ops of ops/filters.py), bitwise, on the sorted lanes of a
   248956422-row 4-bit index (chr1's 31-mers; N runs and IUPAC codes) and a
   1e8-row 2-bit one, each filter's time beside its byte bound and the
   plain chain's; launches counted from 0 on each route of a filtered
   get_kmer_group_counts(31) at 2^24 bp, on an ACGT genome (2-bit lanes)
   and one with N runs (4-bit): one card (1 a call), a mesh of 4 shards of
   the card (1 a shard), LargeKmers on one shard and on four (0 for the
   2-bit no-ambiguous filter, which the kernel does not compute).
4. ACGT main path at 2^27 bp: a seeded synthetic FASTA of 24 uneven
   records with copied segments -> SequenceCollection(device="cuda") ->
   Kmers(sc, 31, 31) -> sort() -> get_kmer_group_counts(31) ->
   get_kmer_count(31), with each phase's time and the peak device memory.
   The FASTA must go through the native parser, multithreaded, once; the
   native parse alone and the alphabet check alone are timed, and the NumPy
   parse of the same file (its plain version) must give the same (sba,
   seg_starts, names) byte for byte. Checks that the pack kernel ran, that the sorted keys do not decrease
   (ties by position), that the positions are the valid starts, that a
   sample of the sorted key words matches the genome, and that the
   histogram, the total and the index length agree.
5. IUPAC main path (4-bit keys) at an SBA of exactly 2^27 bytes: the same
   genome with long N runs (2% of the bases) and sparse IUPAC codes,
   through the same calls and checks (the NumPy parse is not run again); the
   sort must go through the multi-lane sort kernel.
5b. The upload routes of a pack at 2^27 SBA bytes on both genomes, three
   interleaved samples of each and their medians, each step timed: the
   bytes (upload, the device bincount that answered the alphabet before,
   the pack: the kernel at 2 bits, tensor ops at 4), the strided upload
   (native strided pack on the host, its upload, the expansion) and, for
   the record, a pinned-memory upload of the bytes with its pinning; the
   bytes uploaded and the build's peak device memory; the expansion's
   device time beside its bound; the host alphabet scan (one thread and
   threads) beside the device bincount it replaced. The routes' packs are
   held bitwise against each other (the 2-bit byte route is the pack
   kernel), and the collection's default build (the bytes) and its strided
   build against them.
6. The general 2-bit sort (cap lane, multi-key chain) with Kmers(sc, 20, 48)
   at 2^24 bp under the same checks.
7. The gather path at 2^22 bp, on 2-bit and on 4-bit keys: a re-sort of a
   sorted index, an assigned descending index, an assigned subset index,
   an unsorted count, statistics at a kmer_len above the built lanes held
   against a NumPy adjacent compare, and get_kmers_arrays held against the
   histogram. Both kernels must have launched.
8. A NumPy oracle (byte-string sort and unique) at 2^20 bp: ACGT genome at
   (31, 31) and (20, 48), IUPAC genome at (31, 31) and (12, 32), and both
   again from an assigned descending index (the gather path); at a few
   thousand bases also suffix mode (1, None) and (3, None), (5, 70) on
   2-bit keys, (3, 40) on 4-bit keys and the reverse-complement and both-strand
   indexes of ``Kmers.from_strand``. At 2^20 bp, on the ACGT and the IUPAC
   genome, Kmers(sc, 20, 31): canonical histograms at k = 31 and 20 on the
   fresh and the sorted index against np.unique of min(kmer, revcomp(kmer))
   byte strings, and count_queries / count_queries_canonical against a
   dictionary of the k-mers' counts.
9. Suffix main path at full width: the ACGT genome of phase 4 (its host
   arrays, no second parse, as a new collection with its own upload and
   pack), Kmers(sc) = (1, None) -> sort() (a folded 28-base first round,
   then prefix-doubling rounds) -> get_kmer_group_counts(None) and
   get_kmer_count(None) from the run ids the sort keeps ->
   get_kmer_group_counts(31), which must equal phase 4's histogram plus
   the records' short tails. Logs the rounds, the seconds of each,
   suffixes/s (also of a second fresh sort, which finds the allocator
   warm), the kernels' launches and the peak device memory; checks
   the positions, sampled neighbours against the genome's bytes and the
   run ids against string equality. All of this genome's rounds have 64-bit
   keys and take one stable torch.sort each, so the path launches the pack
   kernel and not the multi-lane sort. One torch.cumsum over 2^27 rows,
   which every round pays, is timed. Then the same on the IUPAC genome of
   phase 5, whose first round is seven lanes through the kernel.
10. Beyond one window at full width: Kmers(sc, 100, 100) on the ACGT genome
    (2-bit window rounds of 6 lanes) and Kmers(sc, 48, 48) on the IUPAC
    genome (a 7-lane first round, then 4-bit window rounds), under the same
    checks; every window round must launch the multi-lane sort kernel.
11. Unbounded window rounds without doubling, Kmers(sc, 20, None), at 2^24
    bp: the count of rounds is the longest repeat / 32 (the copied segments
    are at most 2000 bases: about 63 rounds) and every round sorts every
    row, so this path stays at the smaller size on purpose.
12. Strands: from_strand(..., "reverse_complement") at 2^24 bp and
    from_strand(..., "both") at 2^26 bp (a concatenated SBA of 2^27 + 1
    bytes), (31, 31), with and without track_strands_separately. A
    reverse-complement index has the forward index's histogram, and the
    both-strand histogram with the strands tracked apart is the sum of the
    two. At 2^24 bp a both-strand index with the strands tracked apart,
    sorted at (20, 31), statistics at 20 and 12: the histogram and a count equal a
    NumPy (k-mer, strand) oracle (ROADMAP.md §C7).

13. Filters, on collections of their own rebuilt from the main paths' host
    arrays (own upload and pack): on phase 4's index, Kmers(sc, 31, 31) on the
    ACGT genome, the bench's filtered track (get_kmer_group_counts(31,
    GcContentFilter(0.3, 0.7, 31)) cold, warm, then the median of 3, and
    k-mers/s); each of five library filters (GC, homopolymer, no-ambiguous,
    length, CRISPR NGG) through the sorted lanes and through the flag plane,
    counts and histograms equal, with the genome scans' and each plane's
    build time, the ms of each route and the kernels each lanes route
    launches (torch.profiler), and the lanes-flags kernel's launches counted
    from 0 around each filtered call (1 for the GC, homopolymer and 4-bit
    no-ambiguous filters on the lanes route, else 0); each filter's mask on
    4096 seeded rows against its scalar filter on the host bytes. The same
    five, lanes against plane, on phase 5's IUPAC index (4-bit lanes). On the suffix
    index Kmers(sc) of the ACGT genome (plane and window route):
    LengthFilter(31) gives phase 4's histogram, and the GC filter raises at
    the row a host oracle names. At 2^22 bp, Kmers(sc, 20, 48) with records
    as short as 20 bp: the GC and homopolymer filters raise the message and
    position of a NumPy oracle of the reference's left-to-right walk, past
    rows the homopolymer preemption saves. At 2^24 bp, both strands of an
    IUPAC genome: from_strand(..., kmer_filters=[no-ambiguous, GC]) in both
    methods against sliding-window sums over the SBA, then sort() through
    the lane sort and its histogram against a NumPy oracle.
14. Queries and canonical statistics, on collections of their own rebuilt
    from phase 4's and phase 5's host arrays (own upload and pack):
    get_canonical_kmer_group_counts(31) on the fresh Kmers(sc, 31, 31)
    (dense route, cold and warm) and on the sorted index (gather route):
    equal histograms, the total the count of full-length k-mers, the pack
    kernel launched on the ACGT genome and the multi-lane sort on the IUPAC
    genome (6 lanes: invalid, four words, row number). Then count_queries
    and count_queries_canonical of 2^16 k-mers at seeded positions, 4096
    random k-mers and, on the IUPAC genome, 1024 k-mers with an N, against
    the sizes of their groups read by torch.searchsorted over the sorted
    index's fused int64 keys; queries/s and the peak device memory.

15. The sorted index on a mesh of 4 shards of one card (make_mesh(4,
    devices=["cuda:0"] * 4)), on collections of their own rebuilt from
    phase 4's and phase 5's host arrays (own upload and pack): Kmers(sc, 31,
    31).sort(mesh=m), the dense sample sort, timed step by step (local sort,
    splitters, bucket bounds, exchange, merge), cold and warm; the real rows
    of its ragged layout must be phase 4's and phase 5's sorted positions;
    get_kmer_group_counts(31, mesh=m) and get_kmer_count(31, mesh=m) must be
    phase 4's and 5's histogram and total; the bench's GC filter and
    count_queries / count_queries_canonical of 2^14 + 1024 k-mers must equal
    one card's; the same sort on make_mesh(1). Both kernels must launch (the
    pack on the ACGT genome; the lane sort for every shard's local sort,
    the splitters and the merge). The lane sort on 2^22 rows x 7 lanes of
    which 40% are identical all-ones rows against its plain version (the
    mesh path itself gives the kernel real rows only). Per-shard real rows,
    the capacity factor,
    seconds by step and the peak device memory are printed. Then the gather
    path (an assigned descending index at 2^22 bp, 2-bit and 4-bit keys)
    against one card's sort, and an all-'A' record that makes the exchange
    retry.
16. Persistence and export: the sorted 2^27 ACGT index with its collection
    saved and loaded in shelve, and in hdf5 where h5py imports; the loaded
    index's histogram and count on the card equal phase 4's and no sort
    launches; the 4-shard mesh index through save_kmers_sharded /
    load_kmers_sharded; seconds and MB/s of each. At 2^20 bp
    get_kmers_full_arrays and to_csv (where pyarrow or pandas imports)
    against a NumPy oracle, and at 2^18 bp to_csv against its row loop;
    the profiling sweep of the index build at 2^20 bp, where pandas imports.

17. The mesh beyond one compare window, on the mesh of phase 15 and
    collections of its own rebuilt from phase 4's and phase 5's host arrays:
    ACGT suffix mode Kmers(sc, 1, None).sort(mesh=m) at 2^27 bp, timed round
    by round and step by step, cold and warm: its real rows must be phase
    9's sorted suffixes, and every refinement round must leave no shard more
    than twice the mean rows (the largest shard's share is printed round by
    round); get_kmer_group_counts(None, mesh=m) from the kept
    run ids (no refinement round, no sort) must be phase 9's histogram, and
    at 31 phase 9's too. Kmers(sc, 100, 100) on the ACGT genome and (48, 48)
    on the IUPAC genome at 2^27 SBA bytes against phase 10's sorts and
    histograms, at the built length and at 80 / 40 (the run structure over
    the kept layout, no sort). IUPAC suffix mode against one card's sort at
    2^20 bp and larger sizes while a mesh sort stays within about 30 s (the
    rounds number the longest N stretch / 32; the sizes and rounds are
    printed). get_canonical_kmer_group_counts(31, mesh=m) on the fresh
    (dense route) and the sorted index (gather route) of both genomes
    against phase 14's counts. make_mesh2(2, 2) on one card: the (31, 31)
    layout at 2^27 bp and the suffix layout at 2^24 bp byte for byte the
    1-D mesh's. The refinement retry (4 samples a shard, capacity factor
    0.05) on a repeat-heavy genome of 2^16 bp, 2-bit and 4-bit keys, against
    one card's sort. Both kernels must launch (the pack on the ACGT
    collections; the lane sort in every round's local sort, splitter sort
    and merge, and in every canonical sort).

18. LargeKmers, the 64-bit regime. 18a: LargeKmers.from_sequence_collection
    on phase 4's and phase 5's collections at (31, 31), sorted on
    make_mesh(1) and on the mesh of phase 15 (cold and warm, beside a warm
    Kmers sort of the same genome on one card and on that mesh): the sorted
    positions, get_kmer_group_counts(31) and get_kmer_count(31) must be
    phases 4's and 5's, get_canonical_kmer_group_counts(31) phase 14's; and
    suffix mode (1, None) at 2^24 bp against the Kmers suffix sort of the
    same collection (positions and histogram). 18b: a genome of two
    segments and 2^32 + 2^27 bases made from the seed as a strided 2-bit
    pack (1.1 GB, never an SBA), with 4096 word ranges of 1024 bases copied
    to 1-7 places each, half of them past 2^32; 2^27 distinct 31-mer starts,
    30% at or past 2^32, sorted on one shard and on four and held to a host
    oracle (np.lexsort of each position's 62-bit key and the position):
    sorted positions, histogram, totals, and count_queries of 2^16 strings
    against the oracle's counts. Then suffix mode (1, None) at 2^22
    positions of a second such genome whose segments end in the same 256
    bases, 120 mirrored pairs in them, against 320-base prefixes capped at
    each segment's end, with its rounds and the seconds of each. Every path
    must launch the multi-lane sort; each prints its times and its peak
    device memory.

19. The mesh across processes on the one card (``torch.distributed``; the
    script starts each rank as a fresh process, ``chip_smoke.py --rank``,
    on host arrays of phases 4 and 5 that it writes to a temporary
    directory; every rank builds its own collection, upload and pack, and
    its shards live on cuda:0; a rank that fails or passes its time limit
    fails the phase). (a) NCCL, one rank of 4 local shards: Kmers(sc, 31,
    31).sort(mesh=m) at 2^27 on both genomes; every shard's layout equals
    phase 15's byte for byte, the statistics phases 4's and 5's, and the
    collectives moved card tensors only. (b) Gloo, 4 ranks of one shard, the
    same sorts, shard for shard phase 15's layouts; get_kmer_count(31,
    GcContentFilter(0.3, 0.7, 31), mesh=m) against phase 15, count_queries
    and count_queries_canonical against phase 14's counts; LargeKmers (31,
    31) on the same ranks against phase 18a's rows and histogram; the
    collectives staged every card tensor through the host. (c) Gloo, 2
    ranks of 2 shards as make_mesh2(2, 2), a node a rank (stage A of the
    exchange crosses processes): the layouts equal phase 17's 2-D layouts;
    save_kmers_sharded there, load_kmers_sharded onto 2 ranks of one shard:
    the same rows and histogram. (d) On the ranks of (b), ACGT suffix mode
    Kmers(sc) at 2^24 bp against one card's sort of the same collection
    (positions, histogram at None), each refinement round within twice the
    mean rows a shard. Each rank prints its seconds, peak device memory and
    kernel launches by step (the exchange's host staging under Gloo
    included, with the bytes staged); the launches go into the kernels
    line under the runs' names. On the ranks of (b) also phase 20 (d): the
    odd-even merge sort of every (31, 31) start of the ACGT genome at 2^27
    over the 4 Gloo ranks, each rank's positions against phase 4's.

20. The opt-in sorts (the JAX package's routes off every default), on
    phase 4's and phase 5's collections and positions, (31, 31) at 2^27
    SBA bytes, each output held bit for bit against phase 4's or 5's
    positions, warm medians of 3 beside the default route of the same
    positions. (a) ``ops.hybrid.hybrid_sort_positions`` of every start of
    the IUPAC genome (``uniform_cap``; ``packed2_any`` built by the pack
    kernel on the first call): its ambiguous share, its ms cold and warm
    and by step (split, majority 2-bit sort, minority 4-bit sort, insertion
    ranks, interleave), beside the 4-bit ``sort_positions`` of the same
    positions and ``Kmers.sort()``. (b) ``ops.chunked.sort_positions_chunked``
    at the default 2^24 rows a chunk on both genomes (a collection of its
    own a genome, its upload and pack counted with the path), ms and peak
    memory beside one ``sort_positions``. (c)
    ``parallel.distributed_sort_positions`` on 4 shards of cuda:0 and on
    ``make_mesh(1)``, both genomes (the collections of (b)), ms, launches
    (one local sort a shard and one merge a paired shard a phase, all
    through the lane sort) and peak memory beside the sample sort of the
    same positions to its layout on the same mesh. Launches of both kernels
    by path.

21. The repo's entry points on the card, the scripts' functions called in
    this process (any CSV to a temporary directory): (a) the three sweeps
    of ``tools/torch_run_soak.py`` at its defaults (150 oracle cases, 40
    mesh cases on 2-8 shards of cuda:0, 60 filtered cases), no case may
    fail, the seconds and the launches of both kernels of each sweep; (b)
    ``tools/torch_run_applications.py``'s unique_vs_k at 4.6 Mbp, ks
    8-55, sorted once and per k: the rows equal, and at k <= 31 equal to a
    NumPy count of every window's key; (c) its group_size_dist at 46 Mbp,
    k=31, the script's defaults: histogram and total equal to the NumPy
    count, the sort's and the statistics call's seconds, the
    ``torch.bincount``'s device ms (torch.profiler) and the peak memory;
    then the same genome with six N runs (2% of the bases) sorted at (31,
    31) through the lane sort, beside phase 5's sort; (d)
    ``tools/torch_run_e2e_validation.py`` at the ecoli and chr21 scales:
    ingest Mbp/s, sort + statistics cold and warm, queries, counts equal
    to NumPy's.

22. The JAX package's call contracts, run after phase 20 on phases 4's and
    5's collections: (a) ``sort_positions_dense`` by the JAX defaults (a
    4-bit pack, positions alone) on phase 5's IUPAC pack at 2^27 SBA
    bytes, then with ``return_lanes=True``, then ``Kmers.sort()``: one
    lane sort launch each, the positions bitwise equal to each other and
    to phase 5's, the kept lanes equal; (b) ``sort_positions`` with
    ``return_lanes`` False and True on the gather path, the (31, 31)
    starts below 2^22 of both genomes in descending order: one launch
    each, the positions bitwise equal to each other and in phase 4's or
    5's order; (c) ``Kmers.sort(mesh=)`` of both genomes on 4 shards of
    cuda:0, then ``distributed_group_size_histogram_ragged`` over its
    layout with and without ``return_digest``: the same counts and total,
    phases 4's and 5's histograms, ``hi`` the last nonzero bin, and at a
    ``max_counts_bin`` below it ``hi`` clipped and the top bin folded; with
    ``return_sizes`` the JAX digest ``[total, largest size, the counts
    folded at 256 bins]``. Each call's device ms (CUDA events) beside the
    card's name and power limit.

``--profile DIR`` adds a warm second run of phase 5's calls and of phase 9's,
and a canonical dense-route call and a count_queries call of phase 14 on
each genome, under torch.profiler and writes the device time by kernel to
DIR.

The next-to-last line of output is a JSON object describing each kernel of
the paths; the last is {"ok": true, "device": {...}}. No JAX is imported.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import pickle
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import genome_kmers_tpu_torch as gkt
from genome_kmers_tpu_torch import native, profiling
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.lane_sort import SOURCE as LANE_SORT_SOURCE
from genome_kmers_tpu_torch.kernels.lane_sort import (
    TILE_ROWS,
    blocks_resident,
    pass_schedule,
    sort_lanes_cuda,
)
from genome_kmers_tpu_torch.io.fasta import _parse_fasta_dispatch, parse_fasta_bytes
from genome_kmers_tpu_torch.kernels.group_hist import SOURCE as GROUP_HIST_SOURCE
from genome_kmers_tpu_torch.kernels.group_hist import group_size_hist, group_size_hist_cuda
from genome_kmers_tpu_torch.kernels.lanes_flags import SOURCE as LANES_FLAGS_SOURCE
from genome_kmers_tpu_torch.kernels.lanes_flags import lanes_flags_cuda
from genome_kmers_tpu_torch.kernels.pack2 import SOURCE as PACK2_SOURCE
from genome_kmers_tpu_torch.kernels.pack2 import pack_rank2_words_cuda
from genome_kmers_tpu_torch.native import parse_fasta_bytes_native
from genome_kmers_tpu_torch.ops.encoding import COMPLEMENT_TABLE, RANK2_TABLE, RANK_TABLE
from genome_kmers_tpu_torch.ops.filters import (
    FilterContext,
    GcContentFilter,
    HomopolymerFilter,
    LengthFilter,
    NoAmbiguousBasesFilter,
    flag_plane,
)
from genome_kmers_tpu_torch.ops.keys import (
    compute_valid_len,
    expand_strided2,
    expand_strided4,
    pack_rank2_words,
    pack_rank_words,
    widen_u32,
)
from genome_kmers_tpu_torch.ops.large import (
    decode_strided_np,
    pack_rank2_strided_np,
    pack_rank_strided_np,
    split64,
)
from genome_kmers_tpu_torch.ops.query import encode_query_words
from genome_kmers_tpu_torch.ops import hybrid
from genome_kmers_tpu_torch.ops.chunked import sort_positions_chunked
from genome_kmers_tpu_torch.ops.groups import lanes_sizes_digest
from genome_kmers_tpu_torch.ops.keys import cap_lengths
from genome_kmers_tpu_torch.ops.sort import sort_lanes, sort_positions, sort_positions_dense
from genome_kmers_tpu_torch.parallel import collectives
from genome_kmers_tpu_torch.sequence_collection import _DeviceCache
from genome_kmers_tpu_torch.parallel import (
    distributed_group_size_histogram_ragged,
    distributed_sort_positions,
    load_kmers_sharded,
    make_mesh,
    make_mesh2,
    sample_sort_positions,
    sample_sort_positions_ragged,
    sample_sort_positions_unbounded,
    save_kmers_sharded,
)
from genome_kmers_tpu_torch.parallel.distributed import _SPEC_HIST_BINS as SPEC_HIST_BINS
from genome_kmers_tpu_torch.parallel.sample_sort import ragged_rows

DEVICE = "cuda"
SEED = 20261016
MAIN_BP = 1 << 27
GENERAL_BP = 1 << 24
GATHER_BP = 1 << 22
ORACLE_BP = 1 << 20
SMALL_ORACLE_BP = 6000  # suffix mode and strands against whole-record strings
WINDOW_ROUNDS_BP = 1 << 24
REVCOMP_BP = 1 << 24
BOTH_BP = 1 << 26
FILTER_RAISE_BP = 1 << 22
INIT_FILTER_BP = 1 << 24
QUERY_SAMPLES = 1 << 16  # count queries at seeded genome positions
QUERY_RANDOM = 4096  # random k-mers, most of them absent
QUERY_WITH_N = 1024  # k-mers with an N, on the IUPAC genome
MESH_SHARDS = 4  # phase 15: shards of one card
MESH_QUERIES = 1 << 14
RETRY_BP = 1 << 16
# phase 17: IUPAC suffix mode on the mesh, sizes tried in turn while a sort
# stays within about 30 s (its rounds number the longest N stretch / 32)
MESH_SUFFIX4_BPS = (1 << 20, 1 << 22, 1 << 24, 1 << 26)
MESH2_SUFFIX_BP = 1 << 24  # phase 17: suffix mode on the 2-D mesh against the 1-D one
EXPORT_BP = 1 << 20  # phase 16: full arrays and to_csv against a NumPy oracle
LARGE_SUFFIX_BP = 1 << 24  # phase 18a: LargeKmers suffix mode against the Kmers suffix sort
LARGE_BP = (1 << 32) + (1 << 27)  # phase 18b: two segments past 2^32, as a strided pack
LARGE_SEG_A = (1 << 31) + (1 << 26)  # the first segment's bases; then '$' and the second
LARGE_POSITIONS = 1 << 27  # phase 18b: 31-mer starts sorted, 30% past 2^32
LARGE_SUFFIX_POSITIONS = 1 << 22  # phase 18b: suffixes sorted
LARGE_TAIL = 256  # phase 18b: bases the two segments share at their ends
LARGE_QUERIES = 1 << 16
LARGE_PLANTS = 4096  # phase 18b: word ranges copied to 1-7 places each
ROW_LOOP_BP = 1 << 18  # phase 16: to_csv against its row loop (17 us a row on a host core)
# end to end of phases 4 and 5 when the FASTA went through the NumPy parser
# (H100 80GB HBM3 at 700 W)
EARLIER_END_TO_END = "2.58 s (ACGT), 2.50-2.83 s (IUPAC)"
HIST_ROWS = (100_000_000, 250_000_000)  # phase 3b: the build cells' rows (C. elegans, chr1)
HIST_BINS = (1, 35, 1000000)  # phase 3b: LargeKmers' count paths, A4's 35, the default
FLAGS_ROWS = {"4-bit": 248956422, "2-bit": 100000000}  # phase 3c: chr1's 31-mers; C. elegans-like
FLAGS_ROUTE_BP = 1 << 24  # phase 3c: the genome of the route launch counts
MASK_ROWS = 4096
MAIN_RECORDS = 24
ROUTE_SAMPLES = 3  # the upload routes: samples of each, their median reported
STRAND_C7_BP = 1 << 24  # phase 12: tracked strands below the sorted length, against an oracle
MAIN_LANES = 6  # the 4-bit k=31 sort: invalid, four words, position
LANE_SORT_EARLIER_MS = 173.66  # the bitonic tile_pass design, same shape, H100 80GB HBM3 at 700 W
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores
_INT32_MIN = -(1 << 31)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC_CODES = np.frombuffer(b"RYSWKMBDHVN", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------- #
# synthetic genomes
# --------------------------------------------------------------------------- #


def synthetic_records(rng, total_bp: int, n_records: int, short_lens=(), iupac: bool = False):
    """Seeded records of uneven length summing to ``total_bp``: random ACGT
    bases with segments copied to many places (groups of size > 1), one
    all-'T' record, and records of the given short lengths. With ``iupac``
    also six long N runs (2% of the bases together) and sparse IUPAC codes
    (one base in 4096), as a reference assembly has them."""
    genome = ACGT[rng.integers(0, 4, size=total_bp, dtype=np.uint8)]
    for _ in range(max(total_bp >> 20, 8)):
        length = int(rng.integers(40, 2000))
        src = int(rng.integers(0, total_bp - length))
        for dst in rng.integers(0, total_bp - length, size=int(rng.integers(2, 40))):
            genome[dst : dst + length] = genome[src : src + length]
    if iupac:
        run = total_bp // 300
        for start in rng.integers(0, total_bp - run, size=6):
            genome[start : start + run] = ord("N")
        where = rng.integers(0, total_bp, size=total_bp >> 12)
        genome[where] = IUPAC_CODES[rng.integers(0, len(IUPAC_CODES), size=len(where))]
    fixed = [100] + list(short_lens)  # the all-'T' record, then the short ones
    n_long = n_records - len(fixed)
    weights = rng.uniform(0.2, 3.0, n_long)
    lens = np.floor(weights / weights.sum() * (total_bp - sum(fixed))).astype(np.int64)
    lens[-1] += total_bp - sum(fixed) - int(lens.sum())
    cuts = np.concatenate([[0], np.cumsum(np.concatenate([lens, fixed]))])
    records = [genome[cuts[i] : cuts[i + 1]] for i in range(n_records)]
    records[n_long][:] = ord("T")
    return [(f"rec{i:02d}", r) for i, r in enumerate(records)]


def write_fasta(path: Path, records) -> None:
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b" synthetic\n")
            full = len(seq) // 80 * 80
            lines = np.empty((full // 80, 81), dtype=np.uint8)
            lines[:, :80] = seq[:full].reshape(-1, 80)
            lines[:, 80] = ord("\n")
            f.write(lines.tobytes())
            if len(seq) > full:
                f.write(seq[full:].tobytes() + b"\n")


def collection_of(records, strands: str = "forward"):
    seq_list = [(name, seq.tobytes().decode()) for name, seq in records]
    return gkt.SequenceCollection(sequence_list=seq_list, strands_to_load=strands, device=DEVICE)


def index_of(sc, min_kmer_len, max_kmer_len, track: bool = False):
    """The index of the collection's loaded strand(s)."""
    if sc.strands_loaded() == "forward":
        return gkt.Kmers(sc, min_kmer_len, max_kmer_len)
    return gkt.Kmers.from_strand(sc, min_kmer_len, max_kmer_len,
                                 source_strand=sc.strands_loaded(), track_strands_separately=track)


def records_of(sc):
    return [(name, sc.forward_sba[s : e + 1]) for name, s, e in sc.iter_records()]


# --------------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------------- #


def valid_starts(records, min_kmer_len: int) -> np.ndarray:
    """SBA index of every k-mer start with at least min_kmer_len bases left
    in its record, from the record lengths alone."""
    starts, s = [], 0
    for _, seq in records:
        starts.append(np.arange(s, s + len(seq) - min_kmer_len + 1, dtype=np.int64))
        s += len(seq) + 1
    return np.concatenate(starts)


def index_sba(sc, km=None):
    """(SBA bytes, int64 segment starts) the index ``km`` is built on: the
    forward SBA (also for ``km`` None), the reverse complement's, or the
    concatenation of the two."""
    strand = "forward" if km is None else km.kmer_source_strand
    if strand == "both":
        sba, seg_starts = sc.both_concat_arrays()
        return sba, seg_starts.astype(np.int64)
    sba = sc.forward_sba if strand == "forward" else sc.revcomp_sba
    return sba, np.array(sorted(s for _, s, _ in sc.iter_records(strand)), dtype=np.int64)


def bases_left(sc, pos: np.ndarray, km=None) -> np.ndarray:
    """Bases from each SBA position to the end of its record."""
    sba, seg_starts = index_sba(sc, km)
    ends = np.concatenate([seg_starts[1:] - 1, [len(sba)]])  # one past each record
    return ends[np.searchsorted(seg_starts, pos, side="right") - 1] - pos


def kmer_windows(sc, pos: np.ndarray, k: int, km=None) -> np.ndarray:
    """(len(pos), k) uint8: the bases of the k-mer at each SBA position, 0
    from the end of its record on. The SBA is the forward one, or the one
    the index ``km`` is built on (reverse complement, both strands)."""
    sba = index_sba(sc, km)[0]
    cap = np.minimum(bases_left(sc, pos, km), k)
    padded = np.concatenate([sba, np.zeros(k, dtype=np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, k)[pos]
    return np.where(np.arange(k) < cap[:, None], win, 0).astype(np.uint8)


def valid_starts_of(sc, km) -> np.ndarray:
    """Every k-mer start of the SBA the index is built on (forward, reverse
    complement or concatenated), from its segment table alone."""
    sba, seg_starts = index_sba(sc, km)
    ends = np.concatenate([seg_starts[1:] - 1, [len(sba)]])  # one past each segment
    return np.concatenate([
        np.arange(s, e - km.min_kmer_len + 1, dtype=np.int64) for s, e in zip(seg_starts, ends)
    ])


def as_strings(win: np.ndarray, k: int) -> np.ndarray:
    """The first k columns of a window matrix as byte strings (numpy
    compares them like the k-mers: a shorter equal prefix is smaller)."""
    return np.ascontiguousarray(win[:, :k]).view(f"S{k}").ravel()


def unsigned(lane: torch.Tensor) -> torch.Tensor:
    """A key lane in either form (ops/keys.py) as int64 uint32 values."""
    return widen_u32(lane) if lane.dtype == torch.int32 else lane


def check_histogram(km, k: int, label: str, max_counts_bin: int = 1000000):
    """Histogram, total, count and index length agree; the top bin (sizes
    >= max_counts_bin) is held against the count of those groups."""
    counts, total = km.get_kmer_group_counts(k, max_counts_bin=max_counts_bin)
    below = int((np.arange(max_counts_bin, dtype=np.int64) * counts[:-1]).sum())
    top = km.get_kmer_count(k, min_group_size=max_counts_bin)
    if not below + top == total == len(km) == km.get_kmer_count(k):
        raise AssertionError(
            f"{label}: sum(s*counts[s])={below}, top bin {top}, total={total}, len={len(km)}"
        )
    return counts


def check_sorted_index(km, expected_positions: np.ndarray, label: str) -> None:
    """Keys non-decreasing with ties by position, positions = the expected
    set, histogram consistent with the total and the index length."""
    pos = km._pos_dev
    lanes = km._lanes_cache
    if pos.device.type != DEVICE or any(w.device.type != DEVICE for w in lanes["words"]):
        raise AssertionError(f"{label}: the sorted index does not live on the card")
    keys = list(lanes["words"]) + ([] if lanes["cap"] is None else [lanes["cap"]]) + [pos]
    lt = torch.zeros(pos.shape[0] - 1, dtype=torch.bool, device=pos.device)
    eq = torch.ones_like(lt)
    for lane in keys:
        lane = unsigned(lane)
        a, b = lane[:-1], lane[1:]
        lt |= eq & (a < b)
        eq &= a == b
        del lane, a, b
    if not bool(lt.all()):
        raise AssertionError(f"{label}: sorted keys decrease (or positions tie) somewhere")
    expected = torch.from_numpy(np.sort(expected_positions)).to(pos.device)
    if not torch.equal(torch.sort(pos).values, expected):
        raise AssertionError(f"{label}: sorted positions are not the expected k-mer starts")
    counts = check_histogram(km, km.max_kmer_len, label)
    log(f"{label}: invariants hold ({len(km)} k-mers, {int(counts[2:].sum())} groups of size > 1, "
        f"largest bin {int(np.flatnonzero(counts)[-1])})")
    return counts


def check_refined_index(km, sc, rng, label: str, n_sample: int = 4096, width: int = 4096) -> None:
    """An index sorted by refinement rounds keeps no key lanes to look at,
    so: its positions are the valid starts; sampled neighbours are in the
    order of the genome's bytes (compared over max_kmer_len bases, or over
    ``width`` bases in suffix mode, where a pair is conclusive when it
    differs within them or both records end within them), ties by position;
    the run ids the sort kept are equal exactly where the strings are; and
    the histogram at the sort's identity agrees with the total and the
    index length."""
    pos = km._pos_dev
    if pos.device.type != DEVICE:
        raise AssertionError(f"{label}: the sorted index does not live on the card")
    expected = torch.from_numpy(valid_starts_of(sc, km)).to(pos.device)
    if not torch.equal(torch.sort(pos).values, expected):
        raise AssertionError(f"{label}: sorted positions are not the expected k-mer starts")
    del expected
    k = km.max_kmer_len
    width = width if k is None else min(width, k)
    rows = torch.from_numpy(rng.integers(0, len(km) - 1, size=n_sample)).to(pos.device)
    p, q = pos[rows].cpu().numpy(), pos[rows + 1].cpu().numpy()
    both = np.concatenate([as_strings(kmer_windows(sc, x, width, km), width) for x in (p, q)])
    rank = np.unique(both, return_inverse=True)[1]  # byte-string order, shorter prefix first
    a, b = rank[:n_sample], rank[n_sample:]
    conclusive = np.ones(n_sample, dtype=bool)
    if k is None or k > width:
        fits = [bases_left(sc, x, km) <= width for x in (p, q)]
        conclusive = (a != b) | (fits[0] & fits[1])
    ordered = (a < b) | ((a == b) & (p < q))
    if not ordered[conclusive].all():
        raise AssertionError(f"{label}: sampled neighbours are out of order")
    gid = km.suffix_run_ids
    if gid is not None:
        same = (gid[rows] == gid[rows + 1]).cpu().numpy()
        if not np.array_equal(same[conclusive], (a == b)[conclusive]):
            raise AssertionError(f"{label}: run ids disagree with string equality")
    counts = check_histogram(km, k, label)
    log(f"{label}: positions, {int(conclusive.sum())} of {n_sample} sampled neighbours "
        f"({int((a == b)[conclusive].sum())} equal pairs) and run ids agree with the genome; "
        f"{len(km)} k-mers, {int(counts[2:].sum())} groups of size > 1")


class RoundLog:
    """Times the refinement rounds of a sort: pass it as ``on_round`` to
    ``Kmers.sort``, which calls it with the round's name when the round has
    finished on the card, so the host clock between two calls is one round
    (the first from the start of ``sort()``; after a folded 2-bit first
    round the second also rebuilds the caps). Counts each round's launches
    of the multi-lane sort kernel."""

    def __init__(self):
        self.rounds = []  # (function name, seconds, lane sort launches)
        torch.cuda.synchronize()
        self._t, self._launches = time.perf_counter(), sort_lanes_cuda.launches

    def __call__(self, name: str) -> None:
        now, launches = time.perf_counter(), sort_lanes_cuda.launches
        self.rounds.append((name, now - self._t, launches - self._launches))
        self._t, self._launches = now, launches

    def summary(self) -> str:
        first, later = self.rounds[0], self.rounds[1:]
        text = f"{len(self.rounds)} rounds: {first[0]} {first[1]:.4f} s ({first[2]} lane sort launches)"
        if later:
            times = [t for _, t, _ in later]
            names = sorted({name for name, _, _ in later})
            shown = ", ".join(f"{t:.4f}" for t in times) if len(times) <= 12 else (
                f"min {min(times):.4f}, mean {sum(times) / len(times):.4f}, max {max(times):.4f}")
            text += (f"; then {len(later)} x {'/'.join(names)} (s): {shown} "
                     f"({sum(n for _, _, n in later)} lane sort launches)")
        return text


def timed_sort(km):
    """``km.sort()`` to its end on the card: (its rounds, seconds)."""
    rounds = RoundLog()
    _, seconds = sync_time(lambda: km.sort(on_round=rounds))
    return rounds, seconds


def check_words_against_genome(km, sc, rng, label: str, n_sample: int = 65536) -> None:
    """The retained words of sampled sorted rows equal the 2-bit or 4-bit
    code of the genome's bases at their positions, zero from the cap on."""
    lanes = km._lanes_cache
    per_word, bits, table = (16, 2, RANK2_TABLE) if lanes["two_bit"] else (8, 4, RANK_TABLE)
    rows = torch.from_numpy(rng.integers(0, len(km), size=n_sample)).to(km._pos_dev.device)
    pos = km._pos_dev[rows].cpu().numpy()
    ranks = table.astype(np.int64)[kmer_windows(sc, pos, km.max_kmer_len, km)]
    for w, word in enumerate(lanes["words"]):
        fields = ranks[:, per_word * w : per_word * (w + 1)]
        code = np.zeros(n_sample, dtype=np.int64)
        for j in range(fields.shape[1]):
            code |= fields[:, j] << (bits * (per_word - 1 - j))
        if not np.array_equal(unsigned(word[rows]).cpu().numpy(), code):
            raise AssertionError(f"{label}: sorted key word {w} disagrees with the genome")
    log(f"{label}: sorted {bits}-bit key words match the genome on {n_sample} sampled rows")


def oracle_check(records, min_kmer_len: int, max_kmer_len, descending: bool = False,
                 strands: str = "forward", track: bool = False) -> None:
    """Positions and statistics against a NumPy oracle: every k-mer as the
    byte string of its first min(bases left, max_kmer_len) bases (all of
    them for max_kmer_len None), stable byte-string sort (shorter prefix
    first), np.unique for the groups. With ``descending`` the index is
    assigned in descending order first, so the sort takes the gather path.
    ``strands`` other than "forward" checks the index of
    ``Kmers.from_strand`` against the strings of its own SBA; with ``track``
    the strand is part of a group's identity, which holds at the sort's own
    compare length."""
    sc = collection_of(records, strands)
    km = index_of(sc, min_kmer_len, max_kmer_len, track)
    if descending:
        km.kmer_sba_start_indices = km.kmer_sba_start_indices[::-1].copy()
    km.sort()
    starts = valid_starts_of(sc, km)
    sba = index_sba(sc, km)[0]
    width = max(len(seq) for _, seq in records) if max_kmer_len is None else max_kmer_len
    win = kmer_windows(sc, starts, width, km)
    order = np.argsort(as_strings(win, width), kind="stable")
    label = (f"oracle ({min_kmer_len}, {max_kmer_len}{', descending input' if descending else ''}"
             f"{'' if strands == 'forward' else ', ' + strands}{', strands apart' if track else ''})")
    if not np.array_equal(km.kmer_sba_start_indices.astype(np.int64), starts[order]):
        raise AssertionError(f"{label}: sorted positions differ")
    # the reverse-complement half of a concatenated SBA follows the joining '$'
    is_rc = starts > len(sc.forward_sba) if strands == "both" else np.zeros(len(starts), dtype=bool)
    lens = [width] if track else sorted({min_kmer_len, (min_kmer_len + min(width, 64)) // 2, width})
    for k in lens:
        strings = as_strings(win, k)
        halves = (strings[~is_rc], strings[is_rc]) if track else (strings,)
        sizes = np.concatenate([np.unique(h, return_counts=True)[1] for h in halves])
        kmer_len = None if max_kmer_len is None and k == width else k
        for mcb in (30, 1000):
            expected = np.bincount(np.minimum(sizes, mcb), minlength=mcb + 1)
            counts, total = km.get_kmer_group_counts(kmer_len, max_counts_bin=mcb)
            if not (np.array_equal(counts, expected) and total == len(starts)):
                raise AssertionError(f"{label} k={kmer_len}: histogram differs")
        if km.get_kmer_count(kmer_len, min_group_size=2) != int(sizes[sizes >= 2].sum()):
            raise AssertionError(f"{label} k={kmer_len}: count differs")
    two_bit = bool(np.isin(sba, np.frombuffer(b"ACGT$", dtype=np.uint8)).all())
    log(f"{label} at {len(sba)} bytes, {'2' if two_bit else '4'}-bit keys: "
        f"positions and statistics agree")


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    builds = [lambda: build.build(PACK2_SOURCE), lambda: build.build(LANE_SORT_SOURCE),
              lambda: build.build(GROUP_HIST_SOURCE), lambda: build.build(LANES_FLAGS_SOURCE),
              native.build_library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc each and the g++, side by side
        libs = list(pool.map(lambda fn: fn(), builds))
    log(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.3f} s")
    for lib in libs:
        log_file = lib.with_suffix(".log")
        if log_file.exists():
            for line in log_file.read_text().splitlines():
                if "Compiling entry" in line or "Used" in line or "spill" in line:
                    log(f"  nvcc: {line.strip()}")
    log("lane sort, (block-sort, merge) blocks an SM holds by lane count: "
        + ", ".join(f"{nl}: {blocks_resident(nl)}" for nl in (1, 2, 3, 6, 8)))


def phase_pack_kernel(rng) -> dict:
    dev = torch.device(DEVICE)
    alphabet = np.frombuffer(b"ACGT$N", dtype=np.uint8)
    max_err = 0
    cases = [(4099, np.arange(256, dtype=np.uint8))]
    cases += [(n, alphabet) for n in (1, 15, 16, 17, 4099, (1 << 20) + 7, MAIN_BP)]
    for n, symbols in cases:
        sba = torch.from_numpy(rng.choice(symbols, size=n)).to(dev)
        got, want = pack_rank2_words_cuda(sba), pack_rank2_words(sba)
        torch.cuda.synchronize()
        err = int((widen_u32(got) - widen_u32(want)).abs().max())
        max_err = max(max_err, err)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"pack2 kernel differs from its plain version at n={n}")
        log(f"pack2 n={n} ({len(symbols)} symbols): bitwise equal to the plain version")
    # sba is now the 2^27-byte input of the last case
    n = sba.shape[0]
    ms = cuda_ms(lambda: pack_rank2_words_cuda(sba))
    plain_ms = cuda_ms(lambda: pack_rank2_words(sba), reps=5)
    bytes_ms = 5 * n / HBM_BYTES_PER_S * 1e3  # n bytes read, 4n written
    ops_ms = 32 * n / FP32_OPS_PER_S * 1e3  # 16 shift-or pairs an output word
    bound_ms = max(bytes_ms, ops_ms)
    log(f"pack2 at n=2^27: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"5n-byte bound {bound_ms:.4f} ms at 3.35 TB/s = {bound_ms / ms:.1%} of it")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}


def tied_lanes(rng, n_lanes: int, n: int, dev):
    """Key lanes with heavy ties (40 and 3 distinct values, a quarter of them
    mirrored to the top of the uint32 range, 0xFFFFFFFF included) and a
    permutation as the last lane, as int32 bit patterns on ``dev``."""
    lanes = []
    for lane in range(n_lanes - 1):
        vals = rng.integers(0, 40 if lane == 0 else 3, size=n).astype(np.uint32)
        high = rng.random(n) < 0.25
        lanes.append(np.where(high, np.uint32(0xFFFFFFFF) - vals, vals).astype(np.uint32))
    lanes.append(rng.permutation(n).astype(np.uint32))
    return tuple(torch.from_numpy(lane.view(np.int32)).to(dev) for lane in lanes)


def round_lanes(seed: int, n_lanes: int, n: int, dev, payload: bool = True):
    """The lanes of a refinement round, made on the card: heavily tied
    leading lanes (run id or invalid flag, then key words and, without a
    payload, the cap; a quarter of the values mirrored to the top of the
    uint32 range), a permutation (the position) and, with ``payload``,
    behind it a tied lane (the cap), as int32 bit patterns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lanes = []
    for lane in range(n_lanes - (2 if payload else 1)):
        vals = torch.randint(0, 40 if lane == 0 else 3, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
        high = torch.rand(n, device=dev, generator=gen) < 0.25
        lanes.append(torch.where(high, -1 - vals, vals))  # -1 - v is 0xFFFFFFFF - v
    lanes.append(torch.randperm(n, device=dev, generator=gen).to(torch.int32))
    if payload:
        lanes.append(torch.randint(0, 3, (n,), dtype=torch.int32, device=dev, generator=gen))
    return tuple(lanes)


def shaped_lanes(rng, shape: str, n_lanes: int, n: int, dev):
    """Inputs a merge can get wrong, from the tied lanes: already sorted,
    reverse-sorted, every key lane constant (only the last lane differs),
    and the sorted rows with their upper half first (at the pass that joins
    the halves, the right run lies wholly before the left one)."""
    lanes = tied_lanes(rng, n_lanes, n, dev)
    if shape == "constant keys":
        return tuple(torch.full_like(lane, _INT32_MIN + 1) for lane in lanes[:-1]) + lanes[-1:]
    ordered = sort_lanes(lanes)
    if shape == "sorted":
        return ordered
    if shape == "reversed":
        return tuple(lane.flip(0).contiguous() for lane in ordered)
    return tuple(torch.roll(lane, n // 2) for lane in ordered)


def check_lane_sort(lanes, label: str) -> int:
    """The kernel's rows equal the plain version's, as int32, and the input
    is unchanged; returns the largest difference seen (0)."""
    before = [lane.clone() for lane in lanes]
    got, want = sort_lanes_cuda(lanes), sort_lanes(lanes)
    torch.cuda.synchronize()
    err = 0
    for g, w, lane, b in zip(got, want, lanes, before):
        err = max(err, int((widen_u32(g) - widen_u32(w)).abs().max()))
        if g.dtype != torch.int32 or not torch.equal(g, w) or not torch.equal(lane, b):
            raise AssertionError(
                f"lane sort kernel differs from its plain version (or changed its input) at {label}"
            )
    n = lanes[0].shape[0]
    if lanes[0].is_cuda and n > 1 and sort_lanes_cuda.passes != 1 + len(pass_schedule(n)[1]):
        raise AssertionError(f"lane sort made {sort_lanes_cuda.passes} passes at {label}")
    return err


def phase_lane_sort_kernel(rng) -> dict:
    dev = torch.device(DEVICE)
    max_err = 0
    sizes = (1, 2, 127, 128, TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, 2 * TILE_ROWS + 1,
             3 * TILE_ROWS, (1 << 20) + 7, 1 << 24, (1 << 24) + 4097)
    shapes = ("sorted", "reversed", "constant keys", "upper half first")
    for n_lanes in (1, 2, 3, 4, 5, 6, 7, 8):
        for n in sizes:
            lanes = tied_lanes(rng, n_lanes, n, dev)
            max_err = max(max_err, check_lane_sort(lanes, f"{n_lanes} lanes, n={n}"))
        for shape in shapes:
            for n in (4 * TILE_ROWS, 5 * TILE_ROWS + 3):
                lanes = shaped_lanes(rng, shape, n_lanes, n, dev)
                max_err = max(max_err, check_lane_sort(lanes, f"{n_lanes} lanes, n={n}, {shape}"))
        log(f"lane sort, {n_lanes} lanes: bitwise equal to the plain version at n in {sizes} "
            f"and on {', '.join(shapes)} inputs")
        del lanes
    # the shape of a refinement round: tied keys, the position, then a cap
    # that rides behind it; the rows differ in the position, so the cap
    # never decides and the kernel equals the stable plain version
    for n_lanes in (4, 5, 6, 7):
        for n in (TILE_ROWS + 1, (1 << 20) + 7, 1 << 24):
            lanes = tied_lanes(rng, n_lanes - 1, n, dev)
            lanes += (torch.from_numpy(rng.integers(0, 3, size=n).astype(np.int32)).to(dev),)
            max_err = max(max_err, check_lane_sort(lanes, f"{n_lanes} lanes with a payload, n={n}"))
        del lanes
    log("lane sort, 4 to 7 lanes with a tied payload lane behind the position: bitwise equal "
        "to the plain version")
    torch.cuda.empty_cache()
    # the same at the shapes the full-width rounds give the kernel: 2^27
    # rows of 7 lanes (the 4-bit rounds: invalid flag or run id, four words,
    # position, cap) and of 6 lanes (the 2-bit window rounds: run id, two
    # words, in-window cap, position, cap); and the mesh's: 2^27 rows of 5
    # lanes (a 2-bit refinement round once every row sits on shard 0: run
    # id, two words, cap, position) and 2^25 rows of 4 lanes (a shard of
    # the ACGT canonical mesh sort: invalid flag, two words, position)
    for n_lanes, n, payload in ((7, MAIN_BP, True), (6, MAIN_BP, True),
                                (5, MAIN_BP, False), (4, MAIN_BP // MESH_SHARDS, False)):
        lanes = round_lanes(SEED + n_lanes, n_lanes, n, dev, payload)
        what = f"2^{n.bit_length() - 1} rows x {n_lanes} lanes"
        behind = ", tied payload behind it" if payload else " last"
        (_, seconds) = sync_time(lambda: check_lane_sort(lanes, what))
        log(f"lane sort, {what}, tied keys, position{behind}: bitwise equal to the plain version "
            f"(checked in {seconds:.2f} s)")
        del lanes
        torch.cuda.empty_cache()
    # the large regime's one-window sort (LargeKmers, phase 18): two key
    # words, the cap, then the position as two lanes, hi then lo; the lo
    # lane repeats (rows differ in the pair) and holds values >= 2^31
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    n = MAIN_BP
    pos = torch.randperm(n, device=dev, generator=gen).to(torch.int64) * 64 + 7
    lanes = tuple(torch.randint(0, 3, (n,), dtype=torch.int32, device=dev, generator=gen) - 1
                  for _ in range(2))
    lanes += (torch.randint(29, 32, (n,), dtype=torch.int32, device=dev, generator=gen),)
    lanes += split64(pos)
    del pos
    if int(torch.unique(lanes[-1]).numel()) == n or not bool((lanes[-1] < 0).any()):
        raise AssertionError("the large-position lanes do not repeat their lo lane")
    (_, seconds) = sync_time(lambda: check_lane_sort(lanes, "2^27 rows x 5 lanes, 64-bit positions"))
    log(f"lane sort, 2^27 rows x 5 lanes (two words, cap, position hi and lo; the lo lane repeats "
        f"and holds values >= 2^31): bitwise equal to the plain version (checked in {seconds:.2f} s)")
    del lanes
    torch.cuda.empty_cache()
    # the main path's shape: 2^27 rows of (invalid, four words, position)
    n = MAIN_BP
    lanes = (torch.randint(0, 2, (n,), dtype=torch.int32, device=dev),)
    lanes += tuple(
        torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=dev)
        for _ in range(MAIN_LANES - 2)
    )
    lanes += (torch.randperm(n, device=dev).to(torch.int32),)
    got, want = sort_lanes_cuda(lanes), sort_lanes(lanes)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("lane sort kernel differs from its plain version at 2^27 x 6 lanes")
    passes = sort_lanes_cuda.passes
    del want
    ms = cuda_ms(lambda: sort_lanes_cuda(lanes), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: sort_lanes(lanes), reps=3, warmup=1)
    # the one PyTorch call that computes the same function: the last lane is
    # unique, so the sorted unique rows of the (n, lanes) matrix are the
    # sorted rows (sign bit flipped: torch compares int32 as signed). It is
    # a yardstick only; the package never calls it.
    rows = torch.stack(lanes, dim=1) ^ _INT32_MIN
    if not torch.equal(torch.unique(rows, dim=0) ^ _INT32_MIN, torch.stack(got, dim=1)):
        raise AssertionError("torch.unique(dim=0) and the lane sort kernel disagree at 2^27 x 6 lanes")
    del got
    library_ms = cuda_ms(lambda: torch.unique(rows, dim=0), reps=2, warmup=0)
    del rows
    bytes_ms = 2 * 4 * MAIN_LANES * n / HBM_BYTES_PER_S * 1e3  # every lane read and written once
    # n log2 n comparisons of up to MAIN_LANES words, at the fp32 rate
    # outside the tensor cores (the data sheet gives no int32 rate)
    ops_ms = n * math.log2(n) * MAIN_LANES / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"lane sort at 2^27 rows x {MAIN_LANES} lanes: kernel {ms:.3f} ms in {passes} passes over "
        f"the lanes (the earlier design {LANE_SORT_EARLIER_MS} ms in 40), plain (chained "
        f"torch.sort) {plain_ms:.3f} ms, torch.unique(dim=0) {library_ms:.3f} ms, "
        f"read-once/write-once bound {bound_ms:.4f} ms at 3.35 TB/s = {bound_ms / ms:.2%} of it")
    if passes > 17:
        raise AssertionError(f"lane sort made {passes} passes at 2^27 rows, more than 17")
    # one row more than a power of two: one tile more, not twice the work
    lanes = tuple(torch.cat([lane, lane[:1]]) for lane in lanes[:-1]) + (
        torch.cat([lanes[-1], torch.tensor([n], dtype=torch.int32, device=dev)]),)
    max_err = max(max_err, check_lane_sort(lanes, "2^27+1 rows x 6 lanes"))
    ms_one_more = cuda_ms(lambda: sort_lanes_cuda(lanes), reps=5, warmup=1)
    log(f"lane sort at 2^27+1 rows x {MAIN_LANES} lanes: kernel {ms_one_more:.3f} ms in "
        f"{sort_lanes_cuda.passes} passes = {ms_one_more / ms:.3f} x the time at 2^27 rows")
    if ms_one_more > 1.2 * ms:
        raise AssertionError("one row over a power of two costs more than 1.2 x the power of two")
    del lanes
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": library_ms,
            "passes": passes, "ms_one_row_more": ms_one_more}


def hist_sizes(km, k: int = 31):
    """The (size, qualifies) that ``get_kmer_group_counts(k)`` histograms on
    a sorted index's retained lanes (the lanes route, no filter)."""
    route, lanes, _ = km._stats_route(k, gkt.kmer_filter_keep_all)
    if route != "lanes":
        raise AssertionError(f"get_kmer_group_counts({k}) takes the {route} route, not the lanes")
    size, qualifies, _ = lanes_sizes_digest(lanes["words"], lanes["cap"], k, 1, None,
                                            lanes["two_bit"])
    return size, qualifies


def split_hist(size, qualifies, max_counts_bin: int):
    """ROADMAP A4's plain-ops split, a yardstick the port never calls: the
    size-1 groups by one reduction, one ``torch.bincount`` of the rest."""
    ones = (qualifies & (size == 1)).sum()
    rest = qualifies & (size != 1)
    counts = torch.bincount(torch.clamp_max(size[rest], max_counts_bin),
                            minlength=max_counts_bin + 1)
    counts[1] += ones
    return counts


def hist_launches(sc, km, counts: np.ndarray, label: str) -> dict:
    """On the sorted index ``km`` of ``sc``: one ``get_kmer_group_counts(31)``
    (whose histogram must be ``counts``) and one canonical call launch the
    histogram kernel once each; on a mesh of MESH_SHARDS shards of the card,
    the same call launches it once a shard and gives the same histogram."""
    calls = {"get_kmer_group_counts(31)": lambda: km.get_kmer_group_counts(31),
             "get_canonical_kmer_group_counts(31)": lambda: km.get_canonical_kmer_group_counts(31)}
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    mesh_km = gkt.Kmers(sc, 31, 31)
    mesh_km.sort(mesh=m4)
    calls[f"the mesh of {MESH_SHARDS} shards"] = lambda: mesh_km.get_kmer_group_counts(31, mesh=m4)
    out = {}
    for name, fn in calls.items():
        group_size_hist_cuda.launches = 0
        got = fn()
        out[f"{label}: {name}"] = group_size_hist_cuda.launches
        want = MESH_SHARDS if "mesh" in name else 1
        if out[f"{label}: {name}"] != want:
            raise AssertionError(f"{label}: {name} launched the histogram kernel "
                                 f"{out[f'{label}: {name}']} times, not {want}")
        if "canonical" not in name and not np.array_equal(got[0], counts):
            raise AssertionError(f"{label}: {name} gave another histogram than the kernel's")
    return out


def phase_group_hist_kernel(rng, smi: str) -> dict:
    """Phase 3b: the group-size histogram kernel against its plain version
    on the sizes of sorted repeat genomes of HIST_ROWS bases (31-mers; the
    larger with N runs, so large N groups), at each of HIST_BINS; its time
    beside its byte bound, the plain version's, and the yardsticks
    ``torch.bincount`` alone and A4's split; the launches of the
    statistics paths. Returns the kernel's figures at the main path's
    ``max_counts_bin`` (10^6) by rows, and the launches."""
    t0 = time.perf_counter()
    timing, launches = {}, {}
    for total_bp, iupac in zip(HIST_ROWS, (False, True)):
        sc = collection_of(synthetic_records(rng, total_bp, MAIN_RECORDS, iupac=iupac))
        km = gkt.Kmers(sc, 31, 31)
        km.sort()
        size, qualifies = hist_sizes(km)
        n = size.shape[0]
        n_q = int(qualifies.sum())
        label = f"group_hist at {n} rows ({'IUPAC' if iupac else 'ACGT'}, {n_q} groups)"
        for bins in HIST_BINS:
            got = group_size_hist_cuda(size, qualifies, bins)
            torch.cuda.synchronize()
            want = group_size_hist(size, qualifies, bins)
            if not (got.dtype == torch.int64 and torch.equal(got, want)
                    and torch.equal(split_hist(size, qualifies, bins), want)):
                raise AssertionError(f"{label}: the kernel, its plain version or A4's split "
                                     f"differ at max_counts_bin={bins}")
            ms = cuda_ms(lambda: group_size_hist_cuda(size, qualifies, bins))
            plain_ms = cuda_ms(lambda: group_size_hist(size, qualifies, bins), reps=3, warmup=1)
            selected = torch.clamp_max(size, bins)[qualifies]
            library_ms = cuda_ms(lambda: torch.bincount(selected, minlength=bins + 1), reps=3,
                                 warmup=1)
            split_ms = cuda_ms(lambda: split_hist(size, qualifies, bins), reps=3, warmup=1)
            del selected
            bound_ms = (9 * n + 8 * (bins + 1)) / HBM_BYTES_PER_S * 1e3
            hot = int(want.argmax())
            log(f"{label}, max_counts_bin={bins}: bitwise equal to the plain version and A4's "
                f"split; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms (9 B a row + 8 B a bin at "
                f"3.35 TB/s) = {bound_ms / ms:.1%} of it; plain {plain_ms:.3f} ms, torch.bincount "
                f"alone {library_ms:.3f} ms, A4's split {split_ms:.3f} ms; hot bin {hot} holds "
                f"{int(want[hot]) / max(n_q, 1):.1%} of the groups [{smi}]")
        timing[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "library_ms": library_ms, "split_ms": split_ms}
        del size, qualifies
        torch.cuda.empty_cache()
        if not iupac:
            launches = hist_launches(sc, km, got.cpu().numpy(), "group_hist launches")
            log(f"group_hist launches: {launches}")
        del km, sc, got, want
        torch.cuda.empty_cache()
    log(f"group_hist phase: {time.perf_counter() - t0:.1f} s")
    return {"timing": timing, "launches": launches}


def flag_filters(two_bit: bool):
    """The library filters whose lanes flags the lanes-flags kernel computes
    (the no-ambiguous filter's 2-bit form is two compares, no kernel)."""
    return library_filters()[:2 if two_bit else 3]


def flags_bytes(lanes: dict, kind: str, params, n: int) -> int:
    """The bytes the kernel has to move for ``kind``: the words ``k_f``
    reaches, the positions where the filter has an overflow condition, the
    cap lane where a 2-bit index keeps one, one byte a row for each
    output (the survivor flag and each raise condition)."""
    per = 16 if lanes["two_bit"] else 8
    words = lanes["words"][: -(-int(params[0]) // per)]
    row = sum(w.element_size() for w in words)
    row += 0 if kind.startswith("gc") else 8
    row += 8 if lanes["two_bit"] and lanes["cap"] is not None else 0
    row += 3 if kind == "noamb4" else 2
    return row * n


def sorted_index(rows: int, iupac: bool, rng):
    """A sorted (31, 31) index of exactly ``rows`` k-mers: one long record
    and the all-'T' record of 100 bases (``synthetic_records``)."""
    sc = collection_of(synthetic_records(rng, rows + 2 * 30, 2, iupac=iupac))
    km = gkt.Kmers(sc, 31, 31)
    km.sort()
    if len(km) != rows:
        raise AssertionError(f"an index of {len(km)} rows, not {rows}")
    return sc, km


def flag_route_launches(rng) -> dict:
    """Launches of the lanes-flags kernel, counted from 0 on each route, of
    one filtered get_kmer_group_counts(31) a filter on a FLAGS_ROUTE_BP
    genome, ACGT (2-bit lanes; the mesh and LargeKmers pass int32 words and
    caps recomputed from the segments) and with N runs (4-bit lanes): one
    card 1 a call, the mesh of MESH_SHARDS shards of the card 1 a shard,
    LargeKmers on one shard and on MESH_SHARDS; 0 for the 2-bit
    no-ambiguous filter, whose flags are two compares; every route's
    histogram equal to the one card's."""
    m1 = make_mesh(1, devices=[f"{DEVICE}:0"])
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    out = {}
    for iupac in (False, True):
        width = "4-bit" if iupac else "2-bit"
        sc = collection_of(synthetic_records(rng, FLAGS_ROUTE_BP, MAIN_RECORDS, iupac=iupac))
        km = gkt.Kmers(sc, 31, 31)
        km.sort()
        if km._lanes_cache["two_bit"] == iupac:
            raise AssertionError(f"lanes flags routes: the {width} genome gave other lanes")
        mesh_km = gkt.Kmers(sc, 31, 31)
        mesh_km.sort(mesh=m4)
        lk1 = gkt.LargeKmers.from_sequence_collection(sc, 31, 31)
        lk1.sort(m1)
        lk4 = gkt.LargeKmers.from_sequence_collection(sc, 31, 31)
        lk4.sort(m4)
        for name, f in library_filters()[:3]:
            kernel = iupac or not isinstance(f, NoAmbiguousBasesFilter)
            routes = [("one card", 1, lambda: km.get_kmer_group_counts(31, kmer_filter_func=f)),
                      (f"the mesh of {MESH_SHARDS} shards", MESH_SHARDS,
                       lambda: mesh_km.get_kmer_group_counts(31, kmer_filter_func=f, mesh=m4)),
                      ("LargeKmers, 1 shard", 1, lambda: lk1.get_kmer_group_counts(31, f)),
                      (f"LargeKmers, {MESH_SHARDS} shards", MESH_SHARDS,
                       lambda: lk4.get_kmer_group_counts(31, f))]
            want = None
            for route, shards, call in routes:
                expected = shards if kernel else 0
                reset_launches()
                counts, total = call()
                got = lanes_flags_cuda.launches
                label = f"lanes flags, {width}, {name}: {route}"
                out[label] = got
                if got != expected:
                    raise AssertionError(f"{label}: {got} launches, not {expected}")
                counts = np.asarray(counts).astype(np.int64)
                if want is None:
                    want = (counts, int(total))
                elif not (np.array_equal(counts, want[0]) and int(total) == want[1]):
                    raise AssertionError(f"{label}: another histogram than the one card's")
        del km, mesh_km, lk1, lk4, sc
        torch.cuda.empty_cache()
    return out


def phase_lanes_flags_kernel(rng, smi: str) -> dict:
    """Phase 3c: the lanes-flags kernel against its plain versions (the
    torch ops of ``ops/filters.py``, run on the card) on the sorted lanes of
    FLAGS_ROWS k-mers, bit for bit; its time beside its byte bound
    (``flags_bytes`` at 3.35 TB/s) and the plain chain's; the launches of
    each route (``flag_route_launches``). Returns the figures by filter
    and the launches."""
    t0 = time.perf_counter()
    timing = {}
    for width, rows in FLAGS_ROWS.items():
        two_bit = width == "2-bit"
        sc, km = sorted_index(rows, not two_bit, rng)
        lanes = km._lanes_cache
        if lanes["two_bit"] != two_bit:
            raise AssertionError(f"lanes flags: the {width} genome gave other lanes")
        words, cap, pos = lanes["words"], lanes["cap"], km._pos_dev
        sba_len = sc.forward_sba.shape[0]
        for name, f in flag_filters(two_bit):
            fn, params, _ = f.lanes_spec(lanes, sba_len, km.min_kmer_len)
            kind = fn.kind
            label = f"lanes flags {kind} at {rows} rows ({width}, {name})"
            lanes_flags_cuda.launches = 0
            got = fn(words, cap, pos, params)
            torch.cuda.synchronize()
            if lanes_flags_cuda.launches != 1:
                raise AssertionError(f"{label}: {lanes_flags_cuda.launches} launches, not 1")
            want = fn.__wrapped__(words, cap, pos, params)
            if not all(torch.equal(g, w) for g, w in zip((got[0], *got[1]), (want[0], *want[1]))):
                raise AssertionError(f"{label}: the kernel and the plain chain differ")
            del want
            ms = cuda_ms(lambda: fn(words, cap, pos, params))
            plain_ms = cuda_ms(lambda: fn.__wrapped__(words, cap, pos, params), reps=3, warmup=1)
            bound_ms = flags_bytes(lanes, kind, params, rows) / HBM_BYTES_PER_S * 1e3
            n_kernels, _ = device_kernels(lambda: fn.__wrapped__(words, cap, pos, params), reps=1)
            log(f"{label}: bitwise equal to the plain chain; kernel {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({flags_bytes(lanes, kind, params, 1)} B a row at 3.35 TB/s) "
                f"= {bound_ms / ms:.1%} of it; plain chain {plain_ms:.3f} ms in {n_kernels:g} "
                f"kernels; {int(got[0].sum())} rows pass [{smi}]")
            timing[f"{kind} at {rows} rows"] = {"ms": ms, "bound_ms": bound_ms,
                                                "plain_ms": plain_ms, "plain_kernels": n_kernels}
            del got
        del sc, km, lanes, words, cap, pos
        torch.cuda.empty_cache()
    launches = flag_route_launches(rng)
    log(f"lanes flags launches: {launches}")
    log(f"lanes flags phase: {time.perf_counter() - t0:.1f} s")
    return {"timing": timing, "launches": launches}


def reset_launches() -> None:
    pack_rank2_words_cuda.launches = 0
    sort_lanes_cuda.launches = 0
    group_size_hist_cuda.launches = 0
    lanes_flags_cuda.launches = 0


def launches_now() -> dict:
    return {"pack_rank2_words_cuda": pack_rank2_words_cuda.launches,
            "sort_lanes_cuda": sort_lanes_cuda.launches,
            "group_size_hist_cuda": group_size_hist_cuda.launches,
            "lanes_flags_cuda": lanes_flags_cuda.launches}


def run_main_calls(fasta: Path):
    """The main path's calls, each timed to its end on the card. Returns
    (collection, index, times in seconds)."""
    times = {}
    t_all = time.perf_counter()
    sc, times["parse"] = sync_time(lambda: gkt.SequenceCollection(fasta_file_path=fasta, device=DEVICE))
    km = gkt.Kmers(sc, 31, 31)
    dc = sc.device_cache("forward")
    _, times["upload"] = sync_time(lambda: dc.sba)
    # the pack is the first step of sort(), timed alone
    _, times["pack"] = sync_time(lambda: dc.packed2 if dc.is_acgt_only else dc.packed)
    _, times["sort"] = sync_time(km.sort)
    (_, total), times["group counts"] = sync_time(lambda: km.get_kmer_group_counts(31))
    count, times["count"] = sync_time(lambda: km.get_kmer_count(31))
    times["end to end"] = time.perf_counter() - t_all
    if count != total:
        raise AssertionError(f"get_kmer_count ({count}) != histogram total ({total})")
    return sc, km, times


def phase_main_path(rng, tmp: Path, iupac: bool, profile_dir):
    """One main path at 2^27 SBA bytes; returns (its kernel's launches, the
    histogram kernel's launches, the collection, the k=31 histogram, the
    sorted positions on the host)."""
    label = "IUPAC main path (31, 31)" if iupac else "ACGT main path (31, 31)"
    # the SBA joins the records with one '$' each: exactly 2^27 bytes
    records = synthetic_records(rng, MAIN_BP - (MAIN_RECORDS - 1), MAIN_RECORDS, iupac=iupac)
    fasta = tmp / ("iupac.fa" if iupac else "acgt.fa")
    write_fasta(fasta, records)
    log(f"{label}: wrote {fasta.stat().st_size} bytes of FASTA ({len(records)} records)")
    del records

    kernel = sort_lanes_cuda if iupac else pack_rank2_words_cuda
    reset_launches()
    parse_fasta_bytes_native.runs = 0
    torch.cuda.reset_peak_memory_stats()
    sc, km, times = run_main_calls(fasta)
    launches, hist_launches = kernel.launches, group_size_hist_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if parse_fasta_bytes_native.runs != 1 or parse_fasta_bytes_native.chunks < 2:
        raise AssertionError(f"{label}: the native parser did not run, multithreaded, once "
                             f"(runs {parse_fasta_bytes_native.runs}, "
                             f"chunks {parse_fasta_bytes_native.chunks})")
    log(f"{label} times (s): " + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
    log(f"{label}: end to end {times['end to end']:.4f} s (earlier, with the NumPy parse: "
        f"{EARLIER_END_TO_END}); the FASTA went through the native parser in "
        f"{parse_fasta_bytes_native.chunks} threads")
    check_native_parse(fasta, sc, label, compare_plain=not iupac)
    log(f"{label}: SBA {len(sc.forward_sba)} bytes, {len(km)} k-mers, "
        f"sort {len(km) / times['sort'] / 1e6:.1f} M k-mers/s, "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if len(sc.forward_sba) != MAIN_BP:
        raise AssertionError(f"{label}: the SBA holds {len(sc.forward_sba)} bytes, not 2^27")
    if launches < 1:
        raise AssertionError(f"{label} did not launch {kernel.__name__}")
    if hist_launches != 1:
        raise AssertionError(f"{label}: one get_kmer_group_counts(31) launched the histogram "
                             f"kernel {hist_launches} times, not once")
    if km._lanes_cache["two_bit"] == iupac:
        raise AssertionError(f"{label} took the wrong key encoding")
    counts = check_sorted_index(km, valid_starts(records_of(sc), 31), label)
    check_words_against_genome(km, sc, rng, label)
    positions = km.kmer_sba_start_indices.copy()  # the mesh phase's reference
    MAIN_SORTS["IUPAC" if iupac else "ACGT"] = (times["sort"], len(km))
    del km
    if iupac and profile_dir is not None:
        profile_main_calls(fasta, Path(profile_dir))  # warm: the allocator keeps the memory
    return launches, hist_launches, sc, counts, positions


def check_native_parse(fasta: Path, sc, label: str, compare_plain: bool) -> None:
    """The native parse alone and the alphabet check alone, timed; with
    ``compare_plain`` also the NumPy parse of the same file, which must give
    the collection's (sba, seg_starts, names) byte for byte."""
    data = fasta.read_bytes()
    (sba, seg_starts, names), t_native = sync_time(lambda: _parse_fasta_dispatch(data))
    _, t_alpha = sync_time(lambda: sc._validate_alphabet(sba))
    text = (f"{label}: native parse alone {t_native:.4f} s = {len(sba) / t_native / 1e6:.1f} Mbp/s "
            f"({len(data)} bytes of FASTA, {parse_fasta_bytes_native.chunks} threads), alphabet "
            f"check alone {t_alpha:.4f} s")
    if compare_plain:
        (p_sba, p_starts, p_names), t_plain = sync_time(lambda: parse_fasta_bytes(data))
        if not (np.array_equal(p_sba, sc.forward_sba) and np.array_equal(p_starts, sc._forward_sba_seg_starts)
                and p_names == sc.forward_record_names and p_sba.dtype == sc.forward_sba.dtype
                and p_starts.dtype == sc._forward_sba_seg_starts.dtype):
            raise AssertionError(f"{label}: the native parse differs from the NumPy parse")
        text += (f"; NumPy parse (the plain version) {t_plain:.4f} s = "
                 f"{len(p_sba) / t_plain / 1e6:.1f} Mbp/s, byte for byte equal")
    log(text)


def route_build(sba: np.ndarray, bits: int, route: str):
    """One build of the ``bits`` pack of ``sba`` on the card by ``route``,
    each step timed to its end: "bytes" (the bytes' upload, the device
    bincount that answered the alphabet before the host scan did, the pack:
    the kernel at 2 bits, tensor ops at 4), "strided" (the native strided
    pack on the host, its upload, the expansion) or "pinned", for the record
    only (pinning the bytes, then their upload). Returns (the pack or None,
    seconds by step, bytes uploaded, peak device memory above the start)."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t, pack = {}, None
    if route == "bytes":
        dev, t["upload"] = sync_time(lambda: torch.from_numpy(sba).to(DEVICE))
        _, t["device bincount"] = sync_time(lambda: torch.bincount(dev, minlength=256).cpu())
        pack, t["pack"] = sync_time(
            lambda: pack_rank2_words_cuda(dev) if bits == 2 else pack_rank_words(dev))
        sent = sba.nbytes
    elif route == "strided":
        host_pack = pack_rank2_strided_np if bits == 2 else pack_rank_strided_np
        strided, t["host strided pack"] = sync_time(lambda: host_pack(sba))
        dev, t["upload"] = sync_time(lambda: torch.from_numpy(strided.view(np.int32)).to(DEVICE))
        expand = expand_strided2 if bits == 2 else expand_strided4
        pack, t["expansion"] = sync_time(lambda: expand(dev, len(sba)))
        sent = strided.nbytes
    else:
        pinned, t["pin"] = sync_time(lambda: torch.from_numpy(sba).pin_memory())
        _, t["upload"] = sync_time(lambda: pinned.to(DEVICE, non_blocking=True))
        sent = sba.nbytes
    return pack, t, sent, torch.cuda.max_memory_allocated() - base


def route_total(t: dict, route: str) -> float:
    """A route's seconds: the bytes route without its device bincount (the
    alphabet answer now comes from the host scan on both routes)."""
    return sum(v for k, v in t.items() if not (route == "bytes" and k == "device bincount"))


def route_path(host_sc, bits: int, route: str, counts31: np.ndarray):
    """The main path's sort and statistics on a collection of its own whose
    pack took ``route`` ("bytes": the bytes uploaded first, the default;
    "strided": ``_build_from_strided``): (sort seconds, peak device
    memory of the path above its start). The histogram must be
    ``counts31``."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sba, seg_starts = index_sba(host_sc)
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    dc = sc.device_cache("forward")
    if route == "bytes":
        dc.sba
    elif bits == 2:
        dc._packed2 = dc._build_from_strided(2)
    else:
        dc._packed = dc._build_from_strided(4)
    _, t_sort = sync_time(km.sort)
    counts, _ = km.get_kmer_group_counts(31)
    if not np.array_equal(counts, counts31) or (dc._sba_dev is None) != (route == "strided"):
        raise AssertionError(f"the main path by the {route} route differs from phase 4's or 5's")
    return t_sort, torch.cuda.max_memory_allocated() - base


def phase_upload_routes(host_acgt, host_iupac, counts: dict) -> dict:
    """5b. The two routes of a pack at 2^27 SBA bytes, on the main paths'
    genomes (the 2-bit pack of the ACGT genome, the 4-bit pack of the
    IUPAC one): ``ROUTE_SAMPLES`` samples of each, interleaved, and their
    medians; both routes' packs held bitwise against each other (the
    2-bit byte route is the pack kernel), and the collection's own builds
    (``_DeviceCache``: its default, the bytes, which launches the pack
    kernel at 2 bits, and ``_build_from_strided``, which leaves the bytes
    on the host) against them. The alphabet answer of a collection whose
    bytes arrive unscanned (a load, interop) is timed by both means: the
    native host scan, on one thread and on its default threads, and the
    device bincount of the uploaded bytes it replaced. Then the main path's
    sort and statistics by each route, with its peak device memory
    (``route_path``). Returns the medians by genome."""
    out = {}
    dev = torch.device(DEVICE)
    for host_sc, bits, name in ((host_acgt, 2, "ACGT"), (host_iupac, 4, "IUPAC")):
        sba, seg_starts = index_sba(host_sc)
        n = len(sba)
        label = f"upload routes, {name} genome, {bits}-bit pack of {n} bytes"
        samples = {"bytes": [], "strided": [], "pinned": []}
        scans = {"one thread": [], "threads": []}
        for i in range(ROUTE_SAMPLES):
            reference = None
            for route in samples:
                pack, t, sent, peak = route_build(sba, bits, route)
                samples[route].append((t, sent, peak))
                if route == "bytes":
                    reference = pack
                elif pack is not None and not torch.equal(pack, reference):
                    raise AssertionError(f"{label}: the {route} route's pack differs from the "
                                         f"{'pack kernel' if bits == 2 else 'byte route'}'s")
                del pack
            for key, n_threads in (("one thread", 1), ("threads", None)):
                (_, acgt), t_scan = sync_time(
                    lambda: native.scan_alphabet_native(sba, native.ALL_BYTES, n_threads=n_threads))
                scans[key].append(t_scan)
                if acgt != (bits == 2):
                    raise AssertionError(f"{label}: the host alphabet scan answers {acgt}")
            if i == 0:
                reset_launches()
                default = _DeviceCache(sba, seg_starts.astype(np.uint32), dev)
                got = default.packed2 if bits == 2 else default.packed
                if not torch.equal(got, reference) or default._sba_dev is None or (
                        bits == 2 and pack_rank2_words_cuda.launches != 1):
                    raise AssertionError(f"{label}: the collection's default build differs")
                del got, default
                strided = _DeviceCache(sba, seg_starts.astype(np.uint32), dev)
                got = strided._build_from_strided(bits)
                if not torch.equal(got, reference) or strided._sba_dev is not None:
                    raise AssertionError(f"{label}: the collection's strided build differs")
                del got, strided
            del reference
        med = {}
        for route, runs in samples.items():
            steps = {k: float(np.median([t[k] for t, _, _ in runs])) for k in runs[0][0]}
            med[route] = {"total": float(np.median([route_total(t, route) for t, _, _ in runs])),
                          "steps": steps, "sent": runs[0][1],
                          "peak": int(max(p for _, _, p in runs))}
        scan_ms = {k: float(np.median(v)) * 1e3 for k, v in scans.items()}
        strided_dev = torch.from_numpy(
            (pack_rank2_strided_np if bits == 2 else pack_rank_strided_np)(sba).view(np.int32)).to(dev)
        expand = expand_strided2 if bits == 2 else expand_strided4
        expand_ms = cuda_ms(lambda: expand(strided_dev, n), reps=10, warmup=2)
        bound_ms = (strided_dev.numel() * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3
        del strided_dev
        torch.cuda.empty_cache()
        byte_total = med["bytes"]["total"]
        strided_total = med["strided"]["total"]
        for route, m in med.items():
            log(f"{label}: {route} route median of {ROUTE_SAMPLES}: {m['total'] * 1e3:.3f} ms (samples "
                + ", ".join(f"{route_total(t, route) * 1e3:.3f}" for t, _, _ in samples[route])
                + "; step medians " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in m["steps"].items())
                + f" ms), {m['sent']} bytes uploaded, build peak {m['peak']} bytes "
                f"({m['peak'] / 2**20:.1f} MiB)")
        log(f"{label}: expansion alone {expand_ms:.4f} ms of device time (CUDA events) against its bound "
            f"{bound_ms:.4f} ms (n/{32 // bits} bytes read, 4n written at 3.35 TB/s); bytes route with "
            f"its device bincount {(byte_total + med['bytes']['steps']['device bincount']) * 1e3:.3f} ms; "
            f"pinned upload with its pinning {med['pinned']['total'] * 1e3:.3f} ms (for the record)")
        log(f"{label}: alphabet answer of unscanned bytes, medians of {ROUTE_SAMPLES}: host scan "
            f"{scan_ms['one thread']:.3f} ms on one thread, {scan_ms['threads']:.3f} ms on its threads "
            f"(samples " + ", ".join(f"{t * 1e3:.3f}" for t in scans["threads"]) + "); device bincount "
            f"of the uploaded bytes {med['bytes']['steps']['device bincount'] * 1e3:.3f} ms")
        log(f"{label}: the strided route is {'faster' if strided_total < byte_total else 'slower'} "
            f"here ({strided_total * 1e3:.3f} against {byte_total * 1e3:.3f} ms); the collection "
            f"packs the bytes at both widths; packs bitwise equal")
        paths = {route: route_path(host_sc, bits, route, counts[name]) for route in ("bytes", "strided")}
        log(f"{label}: the main path's sort and statistics by route: "
            + ", ".join(f"{route} sort {t:.4f} s, path peak {p} bytes ({p / 2**30:.3f} GiB)"
                        for route, (t, p) in paths.items())
            + f"; the strided route's peak is {(paths['bytes'][1] - paths['strided'][1]) / 2**20:.1f} "
            "MiB lower")
        out[name] = {"bytes_ms": byte_total * 1e3, "strided_ms": strided_total * 1e3,
                     "pinned_ms": med["pinned"]["total"] * 1e3, "expand_ms": expand_ms,
                     "expand_bound_ms": bound_ms, "scan_ms": scan_ms}
    return out


def profile_main_calls(fasta: Path, out_dir: Path) -> None:
    """A warm second run of the main path's calls under torch.profiler: the
    device time by kernel, as a table in ``out_dir`` and its head here."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, times = run_main_calls(fasta)
    log("profiled warm run times (s): " + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
    write_profile(prof, out_dir / "main_path_4bit_kernels.txt")


def write_profile(prof, path: Path) -> None:
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40,
                                      max_name_column_width=70)
    path.write_text(table)
    for line in table.splitlines()[:24]:
        log(f"  profile: {line}")


def phase_general(rng) -> None:
    records = synthetic_records(rng, GENERAL_BP, 24, short_lens=(20, 33, 47))
    km = gkt.Kmers(collection_of(records), 20, 48)
    _, t_sort = sync_time(km.sort)
    log(f"general sort (20, 48) at {GENERAL_BP} bp: {t_sort:.4f} s")
    check_sorted_index(km, valid_starts(records, 20), "general (20, 48)")


def same_lanes(a: dict, b: dict) -> bool:
    """Two retained-lane dicts hold the same values (in either form)."""
    if a["two_bit"] != b["two_bit"] or (a["cap"] is None) != (b["cap"] is None):
        return False
    pairs = list(zip(a["words"], b["words"]))
    if a["cap"] is not None:
        pairs.append((a["cap"], b["cap"]))
    return all(torch.equal(unsigned(x), unsigned(y)) for x, y in pairs)


def phase_gather_path(rng) -> None:
    """The sort of indexes that are not the fresh one, and statistics from
    gathered keys, on 2-bit keys (ACGT genome) and 4-bit keys (IUPAC)."""
    for iupac, mn, mx, k_above in ((False, 20, 48, 56), (True, 12, 24, 32)):
        label = f"gather path, {'4' if iupac else '2'}-bit keys ({mn}, {mx})"
        records = synthetic_records(rng, GATHER_BP, 12, short_lens=(20, 33, 47), iupac=iupac)
        sc = collection_of(records)
        starts = valid_starts(records, mn)
        reset_launches()

        km = gkt.Kmers(sc, mn, mx)
        km.sort()  # the fresh, dense sort: what the gather sorts must equal
        fresh_pos, fresh_lanes = km._pos_dev, km._lanes_cache
        _, t_resort = sync_time(km.sort)  # a re-sort of the sorted index
        if not (torch.equal(km._pos_dev, fresh_pos) and same_lanes(km._lanes_cache, fresh_lanes)):
            raise AssertionError(f"{label}: the re-sort differs from the fresh sort")
        check_sorted_index(km, starts, f"{label}, re-sort")

        km2 = gkt.Kmers(sc, mn, mx)
        km2.kmer_sba_start_indices = km2.kmer_sba_start_indices[::-1].copy()
        if km2.get_kmer_count(mx) != len(starts):
            raise AssertionError(f"{label}: the unsorted count is not the index length")
        km2.sort()
        if not (torch.equal(km2._pos_dev, fresh_pos) and same_lanes(km2._lanes_cache, fresh_lanes)):
            raise AssertionError(f"{label}: the sort of a descending index differs")

        subset = starts[rng.random(len(starts)) < 0.3][::-1].astype(np.uint32)
        km3 = gkt.Kmers(sc, mn, mx)
        km3.kmer_sba_start_indices = subset.copy()
        km3.sort()
        keep = torch.isin(fresh_pos, torch.from_numpy(subset.astype(np.int64)).to(DEVICE))
        if not torch.equal(km3._pos_dev, fresh_pos[keep]):
            raise AssertionError(f"{label}: the sort of a subset index differs")
        check_sorted_index(km3, subset.astype(np.int64), f"{label}, subset index")

        # statistics above the built lanes: gathered keys, adjacent compare
        strings = as_strings(kmer_windows(sc, km.kmer_sba_start_indices.astype(np.int64), k_above), k_above)
        first = np.flatnonzero(np.concatenate([[True], strings[1:] != strings[:-1]]))
        sizes = np.diff(np.concatenate([first, [len(strings)]]))
        expected = np.bincount(np.minimum(sizes, 1000), minlength=1001)
        counts, total = km.get_kmer_group_counts(k_above, max_counts_bin=1000)
        if not (np.array_equal(counts, expected) and total == len(starts)):
            raise AssertionError(f"{label}: histogram at kmer_len {k_above} (above the lanes) differs")
        if km.get_kmer_count(k_above, min_group_size=2) != int(sizes[sizes >= 2].sum()):
            raise AssertionError(f"{label}: count at kmer_len {k_above} (above the lanes) differs")

        nums, pos, yielded, size = km.get_kmers_arrays(mx, min_group_size=2, yield_first_n=1)
        counts, total = km.get_kmer_group_counts(mx, min_group_size=2, max_counts_bin=1000)
        ok = (len(nums) == int(counts.sum()) and int(size.sum()) == total and (yielded == 1).all()
              and np.array_equal(pos, km.kmer_sba_start_indices[nums]))
        if not ok:
            raise AssertionError(f"{label}: get_kmers_arrays disagrees with the histogram")

        if sort_lanes_cuda.launches < 3 or (not iupac and pack_rank2_words_cuda.launches < 1):
            raise AssertionError(f"{label}: a kernel of the path did not launch")
        log(f"{label} at {GATHER_BP} bp: re-sort {t_resort:.4f} s, descending and subset indexes, "
            f"statistics at kmer_len {k_above} and get_kmers_arrays agree "
            f"({sort_lanes_cuda.launches} lane sort launches)")


def phase_oracle(rng) -> None:
    acgt = synthetic_records(rng, ORACLE_BP, 12, short_lens=(31, 40, 47))
    iupac_large = synthetic_records(rng, ORACLE_BP, 12, short_lens=(31, 40, 47), iupac=True)
    for descending in (False, True):
        oracle_check(acgt, 31, 31, descending)
        oracle_check(acgt, 20, 48, descending)
        oracle_check(iupac_large, 31, 31, descending)
        oracle_check(iupac_large, 12, 32, descending)
    # whole-record strings: suffix mode, beyond one window, the other strands
    acgt1 = synthetic_records(rng, SMALL_ORACLE_BP, 6, short_lens=(1, 5, 71))
    acgt5 = synthetic_records(rng, SMALL_ORACLE_BP, 6, short_lens=(5, 40, 71))
    iupac = synthetic_records(rng, SMALL_ORACLE_BP, 6, short_lens=(3, 40, 47), iupac=True)
    for descending in (False, True):
        oracle_check(acgt1, 1, None, descending)
        oracle_check(acgt5, 5, 70, descending)
        oracle_check(iupac, 3, None, descending)
        oracle_check(iupac, 3, 40, descending)
        for records, mn, mx in ((acgt5, 5, 31), (acgt1, 1, None), (iupac, 3, 40)):
            oracle_check(records, mn, mx, descending, strands="reverse_complement")
            oracle_check(records, mn, mx, descending, strands="both")
            oracle_check(records, mn, mx, descending, strands="both", track=True)
    # queries on a random stream of their own: the later phases keep their genomes
    query_rng = np.random.default_rng(SEED + 8)
    canonical_oracle(acgt, "canonical oracle (20, 31), ACGT", query_rng)
    canonical_oracle(iupac_large, "canonical oracle (20, 31), IUPAC", query_rng)


def revcomp_rows(win: np.ndarray) -> np.ndarray:
    """The reverse complement of each row of a (n, k) byte matrix."""
    return np.ascontiguousarray(COMPLEMENT_TABLE[win[:, ::-1]])


def canonical_strings(win: np.ndarray, k: int) -> np.ndarray:
    """min(kmer, revcomp(kmer)) of each row, as byte strings."""
    fwd, rc = as_strings(win, k), as_strings(revcomp_rows(win[:, :k]), k)
    return np.where(rc < fwd, rc, fwd)


def as_queries(win: np.ndarray) -> list:
    return [row.tobytes().decode() for row in win]


def canonical_oracle(records, label: str, rng) -> None:
    """``Kmers(sc, 20, 31)``: canonical histograms at k = 31 and 20 on the
    fresh index (dense route) and the sorted one (gather route) against
    np.unique of min(kmer, revcomp(kmer)) byte strings, then count_queries
    and count_queries_canonical against a dictionary of the forward counts,
    for sampled, random and (on an IUPAC genome) N-holding queries."""
    sc = collection_of(records)
    km = gkt.Kmers(sc, 20, 31)
    starts = valid_starts(records, 20)
    left = bases_left(sc, starts)
    win = kmer_windows(sc, starts, 31)
    for route in ("dense", "gather"):
        if route == "gather":
            km.sort()
        for k in (31, 20):
            full = win[left >= k, :k]
            sizes = np.unique(canonical_strings(full, k), return_counts=True)[1]
            expected = np.bincount(np.minimum(sizes, 1000), minlength=1001)
            counts, total = km.get_canonical_kmer_group_counts(k, max_counts_bin=1000)
            if not (np.array_equal(counts, expected) and total == len(full)):
                raise AssertionError(f"{label}, {route} route, k={k}: canonical histogram differs")
    iupac = not bool(np.isin(sc.forward_sba, np.frombuffer(b"ACGT$", dtype=np.uint8)).all())
    n_queries = 0
    for k in (31, 20):
        full = win[left >= k, :k]
        keys, counts = np.unique(as_strings(full, k), return_counts=True)
        qwin = [full[rng.integers(0, len(full), size=2000)], ACGT[rng.integers(0, 4, size=(200, k))]]
        if iupac:
            with_n = full[rng.integers(0, len(full), size=100)].copy()
            with_n[np.arange(100), rng.integers(0, k, size=100)] = ord("N")
            qwin.append(with_n)
        qwin = np.concatenate(qwin)

        def lookup(strings):
            at = np.minimum(np.searchsorted(keys, strings), len(keys) - 1)
            return np.where(keys[at] == strings, counts[at], 0)

        fwd = lookup(as_strings(qwin, k))
        rc_strings = as_strings(revcomp_rows(qwin), k)
        canon = fwd + np.where(rc_strings == as_strings(qwin, k), 0, lookup(rc_strings))
        queries = as_queries(qwin)
        if not np.array_equal(km.count_queries(queries, k), fwd):
            raise AssertionError(f"{label}, k={k}: count_queries differs from the oracle")
        if not np.array_equal(km.count_queries_canonical(queries, k), canon):
            raise AssertionError(f"{label}, k={k}: count_queries_canonical differs from the oracle")
        n_queries += len(queries)
    log(f"{label} at {len(sc.forward_sba)} bytes: canonical histograms at k = 31 and 20 on the "
        f"dense and the gather route, and {n_queries} queries (plain and canonical), agree")


def short_tail_counts(sc, k: int, max_counts_bin: int = 1000000) -> np.ndarray:
    """Histogram of the groups among the k-mers with fewer than ``k`` bases
    left in their record (k - 1 of them a record), at ``k`` bases identity:
    such a k-mer equals only another of the same string. An index of
    min_kmer_len 1 holds them beside the k-mers of an index of
    min_kmer_len k."""
    tails = [sc.forward_sba[max(s, e - k + 2) + i : e + 1].tobytes()
             for _, s, e in sc.iter_records() for i in range(min(k - 1, e - s + 1))]
    sizes = np.unique(np.array(tails, dtype=f"S{k}"), return_counts=True)[1]
    return np.bincount(np.minimum(sizes, max_counts_bin), minlength=max_counts_bin + 1)


def run_suffix_calls(host_sc):
    """The suffix main path's calls, each timed to its end on the card, on
    a collection rebuilt from ``host_sc``'s host arrays: no second parse,
    but its own upload and pack. Returns (collection, index, rounds, times,
    histogram at None, histogram at 31)."""
    times = {}
    sba, seg_starts = index_sba(host_sc)
    (sc, km), times["collection"] = sync_time(lambda: from_numpy_state(
        sba, seg_starts, host_sc.forward_record_names,
        1, None, device=DEVICE))  # (1, None), the defaults of Kmers(sc): every suffix
    dc = sc.device_cache("forward")
    _, times["upload"] = sync_time(lambda: dc.sba)
    _, times["pack"] = sync_time(lambda: dc.packed2 if dc.is_acgt_only else dc.packed)
    rounds, times["sort"] = timed_sort(km)
    (counts, total), times["group counts (None)"] = sync_time(lambda: km.get_kmer_group_counts(None))
    count, times["count (None)"] = sync_time(lambda: km.get_kmer_count(None))
    (counts31, total31), times["group counts (31)"] = sync_time(lambda: km.get_kmer_group_counts(31))
    if not count == total == total31 == len(km):
        raise AssertionError(f"suffix main path: count {count}, totals {total} and {total31}, "
                             f"index length {len(km)}")
    return sc, km, rounds, times, counts, counts31


def phase_suffix_main(host_sc, main_counts31, rng, profile_dir):
    """Suffix mode at full width on a main path's genome; returns the
    launches of both kernels in it, and the sorted positions, the
    histograms at None and at 31 and the seconds of the sort (phase 17's
    reference). The ACGT genome's rounds all have
    64-bit keys (a folded first round, then prefix doubling) and take
    torch.sort, so of the two kernels that path launches the pack alone;
    the IUPAC genome's first round is seven lanes through the multi-lane
    sort kernel. The path gets a collection of its own, so its upload and
    its pack are in its times; the memory held before it begins (the main
    paths' collections) is taken off the peak."""
    two_bit = host_sc.device_cache("forward").is_acgt_only
    label = f"suffix main path (1, None), {'ACGT' if two_bit else 'IUPAC'} genome"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    sc, km, rounds, times, counts, counts31 = run_suffix_calls(host_sc)
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} times (s): " + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
    log(f"{label}: {rounds.summary()}")
    log(f"{label}: SBA {len(sc.forward_sba)} bytes, {len(km)} suffixes, "
        f"sort {len(km) / times['sort'] / 1e6:.1f} M suffixes/s, "
        f"{launches['pack_rank2_words_cuda']} pack and {launches['sort_lanes_cuda']} lane sort "
        f"launches, peak device memory {peak} bytes ({peak / 2**30:.3f} GiB), of which "
        f"{held_before} bytes were held before the path began: the path's own "
        f"{(peak - held_before) / 2**30:.3f} GiB")
    if km._lanes_cache is not None or km.suffix_run_ids is None:
        raise AssertionError(f"{label}: the sort kept lanes, or no run ids")
    names = [r[0] for r in rounds.rounds]
    first = "_first_round_dense2" if two_bit else "_first_round_dense"
    if names[0] != first or set(names[1:]) != {"_double_round2"} or len(names) < 4:
        raise AssertionError(f"{label}: unexpected rounds {names}")
    if launches != {"pack_rank2_words_cuda": int(two_bit), "sort_lanes_cuda": int(not two_bit),
                    "group_size_hist_cuda": 2, "lanes_flags_cuda": 0}:
        raise AssertionError(f"{label}: unexpected kernel launches {launches}")
    if not np.array_equal(counts31, main_counts31 + short_tail_counts(sc, 31)):
        raise AssertionError(f"{label}: the k=31 histogram is not the main path's plus the "
                             "records' short tails")
    log(f"{label}: get_kmer_group_counts(31) over gathered keys equals the (31, 31) main "
        "path's histogram plus the 30 shorter k-mers at each record's end")
    check_refined_index(km, sc, rng, label)
    reference = {"positions": km.kmer_sba_start_indices.copy(), "counts": counts,
                 "counts31": counts31, "seconds": times["sort"]}
    if two_bit:  # what every round pays for its run ids
        mask = km.suffix_run_ids > 1
        ms = cuda_ms(lambda: torch.cumsum(mask, dim=0), reps=5, warmup=1)
        log(f"torch.cumsum of {mask.shape[0]} bool rows to int64: {ms:.3f} ms")
        del mask
    # a second fresh index on the same collection: the first sort paid the
    # allocator's growth, this one finds the memory held
    km = gkt.Kmers(sc)
    rounds, seconds = timed_sort(km)
    log(f"{label}, a second fresh sort (allocator warm): {seconds:.4f} s, "
        f"{len(km) / seconds / 1e6:.1f} M suffixes/s; {rounds.summary()}")
    del km, sc
    torch.cuda.empty_cache()
    if two_bit and profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, rounds, times, _, _ = run_suffix_calls(host_sc)
        log(f"{label}, profiled warm run times (s): "
            + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
        log(f"{label}, profiled warm run: {rounds.summary()}")
        write_profile(prof, Path(profile_dir) / "suffix_main_path_kernels.txt")
    return launches, reference


def phase_beyond_window(sc_acgt, sc_iupac, rng):
    """Bounded k-mers longer than one compare window at full width: window
    rounds through the multi-lane sort kernel. Returns its launches, and
    for each genome the sorted positions and the histograms at the built
    length and at a second length beyond one window (phase 17's
    reference)."""
    launches, reference = {}, {}
    for sc, k, second, first, later, max_rounds in (
        (sc_acgt, 100, 80, "_first_round_dense2", "_sort_round2", 4),
        (sc_iupac, 48, 40, "_first_round_dense", "_sort_round", 2),
    ):
        label = f"beyond one window ({k}, {k}), {'2' if later[-1] == '2' else '4'}-bit keys"
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        km = gkt.Kmers(sc, k, k)
        rounds, t_sort = timed_sort(km)
        (counts, total), t_hist = sync_time(lambda: km.get_kmer_group_counts(k))
        launches[label] = sort_lanes_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        log(f"{label}: sort {t_sort:.4f} s ({len(km) / t_sort / 1e6:.1f} M k-mers/s), group counts "
            f"from the run ids {t_hist:.4f} s, {sort_lanes_cuda.launches} lane sort launches, "
            f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
        log(f"{label}: {rounds.summary()}")
        names = [r[0] for r in rounds.rounds]
        if names[0] != first or set(names[1:]) != {later} or len(names) > max_rounds:
            raise AssertionError(f"{label}: unexpected rounds {names}")
        on_kernel = [r for r in rounds.rounds if r[0] != "_first_round_dense2"]
        if any(n != 1 for _, _, n in on_kernel) or sort_lanes_cuda.launches != len(on_kernel):
            raise AssertionError(f"{label}: a window round did not launch the lane sort kernel once")
        if total != len(km):
            raise AssertionError(f"{label}: histogram total {total}, index length {len(km)}")
        check_refined_index(km, sc, rng, label)
        reference["IUPAC" if later == "_sort_round" else "ACGT"] = {
            "k": k, "second": second, "positions": km.kmer_sba_start_indices.copy(),
            "counts": counts, "counts_second": km.get_kmer_group_counts(second)[0],
        }
        del km
        torch.cuda.empty_cache()
    return launches, reference


def phase_window_rounds(rng) -> int:
    """Suffix mode without doubling (min_kmer_len > 1): as many window
    rounds as the longest repeat has windows, each over every row."""
    label = "unbounded window rounds (20, None)"
    records = synthetic_records(rng, WINDOW_ROUNDS_BP, 24, short_lens=(20, 33, 47))
    sc = collection_of(records)
    del records
    reset_launches()
    km = gkt.Kmers(sc, 20, None)
    rounds, t_sort = timed_sort(km)
    log(f"{label} at {WINDOW_ROUNDS_BP} bp (not 2^27: the rounds number the longest repeat, "
        f"at most 2000 bases here, over 32, and each sorts every row): sort {t_sort:.4f} s "
        f"({len(km) / t_sort / 1e6:.1f} M suffixes/s), {sort_lanes_cuda.launches} lane sort launches")
    log(f"{label}: {rounds.summary()}")
    later = rounds.rounds[1:]
    if len(later) < 10 or any(name != "_sort_round2" or n != 1 for name, _, n in later):
        raise AssertionError(f"{label}: expected ten or more 2-bit window rounds, one lane sort "
                             f"launch each, got {[(name, n) for name, _, n in later][:12]}")
    check_refined_index(km, sc, rng, label)
    return sort_lanes_cuda.launches


def phase_strands(rng) -> dict:
    """Reverse-complement and both-strand indexes at (31, 31). Reverse
    complementing is a bijection of the 31-mers, so the reverse-complement
    index has the forward index's histogram, and a both-strand index with
    the strands tracked apart has the sum of the two."""
    launches = {}
    for total_bp, modes in ((REVCOMP_BP, ("reverse_complement",)),
                            (BOTH_BP, ("reverse_complement", "both"))):
        records = synthetic_records(rng, total_bp, 24, short_lens=(31, 40))
        reset_launches()
        hists, times = {}, {}
        for strands, track in [("forward", False)] + [(m, False) for m in modes] + (
                [("both", True)] if "both" in modes else []):
            name = strands + (", strands apart" if track else "")
            label = f"strands ({name}) (31, 31) at {total_bp} bp"
            sc = collection_of(records, strands)
            km = index_of(sc, 31, 31, track)
            _, times[name] = sync_time(km.sort)
            if track:  # the strand splits groups: no lanes-only statistics
                hists[name] = check_histogram(km, 31, label)
            else:
                hists[name] = check_sorted_index(km, valid_starts_of(sc, km), label)
                check_words_against_genome(km, sc, rng, label)
            del sc, km
            torch.cuda.empty_cache()
        if not np.array_equal(hists["reverse_complement"], hists["forward"]):
            raise AssertionError("the reverse-complement histogram differs from the forward one")
        if "both" in modes:
            if not np.array_equal(hists["both, strands apart"],
                                  hists["forward"] + hists["reverse_complement"]):
                raise AssertionError("the both-strand histogram with strands tracked apart is not "
                                     "the sum of the forward and the reverse-complement ones")
            joint, apart = hists["both"], hists["both, strands apart"]
            sizes = np.arange(len(joint), dtype=np.int64)
            if int((sizes * joint).sum()) != int((sizes * apart).sum()) or joint.sum() > apart.sum():
                raise AssertionError("the joint both-strand histogram does not hold the same "
                                     "k-mers in fewer groups")
        launches[total_bp] = pack_rank2_words_cuda.launches
        log(f"strands at {total_bp} bp, sort times (s): "
            + ", ".join(f"{name} {t:.4f}" for name, t in times.items())
            + f"; histograms agree across the strands ({pack_rank2_words_cuda.launches} pack launches)")
    strands_tracked_below_the_sort(rng)
    return launches


def strands_tracked_below_the_sort(rng) -> None:
    """A both-strand index with the strands tracked apart, sorted at (20,
    31), statistics at 20 and at 12 (ROADMAP.md §C7): every group is a
    (k-mer, strand) pair, held against a NumPy oracle (np.unique of each
    row's 2-bit k-mer code and its strand bit)."""
    records = synthetic_records(rng, STRAND_C7_BP, 24, short_lens=(31, 40))
    sc = collection_of(records, "both")
    km = index_of(sc, 20, 31, True)
    _, t_sort = sync_time(km.sort)
    pos = km.kmer_sba_start_indices.astype(np.int64)
    win = kmer_windows(sc, pos, 20, km)
    is_rc = pos >= km._revcomp_offset()
    for k in (20, 12):
        label = f"strands tracked apart, (20, 31) at {STRAND_C7_BP} bp, statistics at {k}"
        (counts, total), t_stats = sync_time(lambda: km.get_kmer_group_counts(k))
        count2 = km.get_kmer_count(k, min_group_size=2)
        code = np.zeros(len(pos), dtype=np.uint64)
        for j in range(k):
            code = (code << np.uint64(2)) | RANK2_TABLE[win[:, j]].astype(np.uint64)
        _, sizes = np.unique((code << np.uint64(1)) | is_rc.astype(np.uint64), return_counts=True)
        want = np.bincount(np.minimum(sizes, 1000000), minlength=1000001)
        if not (np.array_equal(counts, want) and total == len(km)
                and count2 == int(sizes[sizes >= 2].sum())):
            raise AssertionError(f"{label}: the statistics differ from the (string, strand) oracle")
        # the JAX package's rule: a cut at every strand change in sorted order
        cut = np.concatenate([[True], (code[1:] != code[:-1]) | (is_rc[1:] != is_rc[:-1])])
        log(f"{label}: sort {t_sort:.4f} s, statistics {t_stats:.4f} s; {len(sizes)} groups and "
            f"{int(sizes[sizes >= 2].sum())} k-mers in groups of 2 or more, equal to the oracle "
            f"(a cut at every strand change would give {int(cut.sum())} groups)")


def library_filters():
    return [("GC (0.3, 0.7, 31)", GcContentFilter(0.3, 0.7, 31)),
            ("homopolymer (5, 31)", HomopolymerFilter(5, 31)),
            ("no ambiguous (31)", NoAmbiguousBasesFilter(31)),
            ("length (31)", LengthFilter(31)),
            ("CRISPR NGG", gkt.crispr_ngg_pam_filter)]


def on_plane_route(km, fn):
    """``fn()`` with the index's lanes dropped and their rebuild switched
    off, so that filtered queries take the flag plane (the JAX package's
    switch for this); the lanes are put back after."""
    lanes = km._lanes_cache
    km._lanes_cache, km._lanes_rebuild = None, False
    out = fn()
    km._lanes_cache, km._lanes_rebuild = lanes, True
    return out


def device_kernels(fn, reps: int = 3):
    """(kernels launched, their device ms) by one call of ``fn``: the mean
    over ``reps`` calls under torch.profiler; copies and fills are not
    counted as kernels. A profile of calls that launch one to three small
    kernels has come back with none of them (one call of a single kernel
    once; in phase 13 the one-compare length flags three calls running):
    such a profile is taken again over four times the calls, twice at
    most, each retry logged, before this fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
        log(f"device_kernels: the profile of {reps} calls saw no kernel; profiling "
            f"{reps * 4} calls")
        reps *= 4
    else:
        raise AssertionError("torch.profiler saw no kernel of a call that launches some")
    device_us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total for e in kernels)
    return sum(e.count for e in kernels) / reps, device_us / 1e3 / reps


def expect_value_error(fn, message: str, label: str) -> None:
    """``fn()`` must raise ValueError(message)."""
    try:
        fn()
    except ValueError as e:
        if str(e) != message:
            raise AssertionError(f"{label}: raised {str(e)!r}, expected {message!r}") from e
        return
    raise AssertionError(f"{label}: did not raise {message!r}")


def filters_on_sorted_index(km, sc, label: str, rng, masks: bool) -> None:
    """Each library filter through the sorted lanes and through the flag
    plane: counts and histograms equal; the ms of each route, the build of
    each plane, the kernels of the lanes flags; with ``masks`` each mask on
    MASK_ROWS seeded rows against the scalar filter on the host bytes.
    Launches of the lanes-flags kernel are counted from 0 around each
    filtered call: 1 on the lanes route for the GC, homopolymer and (on
    4-bit lanes) no-ambiguous filters, 0 for the others and on the plane
    route. Returns them by path."""
    dc = sc.device_cache("forward")
    sba = sc.forward_sba
    lanes = km._lanes_cache
    width = "2-bit" if lanes["two_bit"] else "4-bit"
    launches = {}
    for name, f in library_filters():
        kernel = isinstance(f, (GcContentFilter, HomopolymerFilter)) or (
            isinstance(f, NoAmbiguousBasesFilter) and not lanes["two_bit"])
        route, _, lanes_spec = km._stats_route(31, f)
        if route != "lanes_filtered":
            raise AssertionError(f"{label}, {name}: the lanes route does not take the filter")
        spec = f._plane_spec()
        build_ms = None
        if spec is not None:
            _, build_s = sync_time(lambda: flag_plane(dc, spec[0], spec[1]))
            build_ms = build_s * 1e3
        by_route = {}
        for route, run in (("lanes", lambda fn: fn()), ("plane", lambda fn: on_plane_route(km, fn))):
            expected = int(kernel and route == "lanes")
            for call in ("get_kmer_count", "get_kmer_group_counts"):
                reset_launches()
                got = run(lambda: getattr(km, call)(31, kmer_filter_func=f))
                n = lanes_flags_cuda.launches
                path = f"{label}, {width}, {name}: {call}(31), {route} route"
                launches[path] = n
                if n != expected:
                    raise AssertionError(f"{path}: {n} lanes-flags launches, not {expected}")
                if call == "get_kmer_count":
                    count = got
                else:
                    counts, total = got
            ms = run(lambda: cuda_ms(lambda: km.get_kmer_group_counts(31, kmer_filter_func=f),
                                     reps=3, warmup=0))
            by_route[route] = (count, counts, total, ms)
        (c_l, h_l, t_l, ms_l), (c_p, h_p, t_p, ms_p) = by_route["lanes"], by_route["plane"]
        if not (c_l == c_p == t_l == t_p and np.array_equal(h_l, h_p)):
            raise AssertionError(f"{label}, {name}: the lanes and the plane route disagree "
                                 f"(counts {c_l} / {c_p}, totals {t_l} / {t_p})")
        if spec is not None and spec[0] not in dc.filter_flags:
            raise AssertionError(f"{label}, {name}: the plane route built no plane")
        flags_fn, params, _ = lanes_spec
        flags = lambda: flags_fn(lanes["words"], lanes["cap"], km._pos_dev, params)  # noqa: E731
        flags_ms = cuda_ms(flags, reps=5, warmup=1)
        reset_launches()
        flags()
        if lanes_flags_cuda.launches:
            # the lanes-flags kernel, one launch a call: its counter, not a
            # profile of one kernel alone, which can come back empty
            n_flags, dev_flags = lanes_flags_cuda.launches, flags_ms
        else:
            n_flags, dev_flags = device_kernels(flags)
        n_query, dev_query = device_kernels(lambda: km.get_kmer_count(31, kmer_filter_func=f))
        log(f"{label}, {name}: survivors {t_l} of {len(km)}, histogram equal on both routes; "
            f"group counts lanes {ms_l:.3f} ms, plane {ms_p:.3f} ms"
            + ("" if build_ms is None else f" (plane built in {build_ms:.3f} ms)")
            + f"; lanes flags {flags_fn.__name__} {flags_ms:.3f} ms in {n_flags:g} kernels "
            f"({dev_flags:.3f} device ms); the filtered count {n_query:g} kernels "
            f"({dev_query:.3f} device ms)")
        if masks:
            rows = torch.from_numpy(rng.integers(0, len(km), size=MASK_ROWS)).to(km._pos_dev.device)
            pos = km._pos_dev[rows]
            cap = None if lanes["cap"] is None else lanes["cap"][rows]
            mask_l, errs = flags_fn(tuple(w[rows] for w in lanes["words"]), cap, pos, params)
            ctx = FilterContext(sba, pos, compute_valid_len(pos, dc.seg_starts, dc.seg_ends),
                                sba_dev=lambda: dc.sba, scans=dc)
            mask_p = f.batch_mask(ctx)
            want = np.array([f(sba, "forward", int(p)) for p in pos.cpu().numpy()])
            if not (np.array_equal(mask_l.cpu().numpy(), want)
                    and np.array_equal(mask_p.cpu().numpy(), want)):
                raise AssertionError(f"{label}, {name}: a mask differs from the scalar filter")
            if any(bool(e.any()) for e in errs):
                raise AssertionError(f"{label}, {name}: a raise condition holds on a sampled row")
            log(f"{label}, {name}: lanes and plane masks equal the scalar filter on {MASK_ROWS} "
                f"seeded rows ({int(want.sum())} pass)")
    log(f"{label}: lanes-flags launches from 0 by call: {launches}")
    return launches


def filters_acgt(host_sc, rng) -> tuple:
    """The ACGT genome of phase 4 at (31, 31): the bench's filtered track
    and the five filters on both routes. Returns (pack launches, the
    collection, the lanes-flags launches by path)."""
    label = "filters, ACGT (31, 31)"
    sba, seg_starts = index_sba(host_sc)
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    dc = sc.device_cache("forward")
    _, t_sort = sync_time(km.sort)
    launches = pack_rank2_words_cuda.launches
    scans = {}
    for name in ("valid_len_genome", "is_dollar", "gc_cumsum", "run_len", "next_amb"):
        _, scans[name] = sync_time(lambda: getattr(dc, name))
    log(f"{label}: sort {t_sort:.4f} s, {launches} pack launches; genome scans built (ms): "
        + ", ".join(f"{name} {t * 1e3:.3f}" for name, t in scans.items()))
    gc = GcContentFilter(0.3, 0.7, 31)
    if km._stats_route(31, gc)[0] != "lanes_filtered":
        raise AssertionError(f"{label}: the bench's filtered track does not take the lanes")
    track = lambda: km.get_kmer_group_counts(31, kmer_filter_func=gc)  # noqa: E731
    (counts, total), cold = sync_time(track)
    _, warm = sync_time(track)
    timed = sorted(sync_time(track)[1] for _ in range(3))
    median = timed[1]
    log(f"{label}: bench filtered track get_kmer_group_counts(31, GcContentFilter(0.3, 0.7, 31)): "
        f"cold {cold:.4f} s, warm {warm:.4f} s, timed {', '.join(f'{t:.4f}' for t in timed)} s, "
        f"median {median:.4f} s = {len(km) / median / 1e6:.1f} M k-mers/s; {total} survivors in "
        f"{int(counts.sum())} groups")
    flag_launches = filters_on_sorted_index(km, sc, label, rng, masks=True)
    if launches < 1:
        raise AssertionError(f"{label}: the pack kernel did not launch")
    return launches, sc, flag_launches


def filters_iupac(host_sc, rng) -> int:
    """The IUPAC genome of phase 5 at (31, 31), 4-bit lanes: the five
    filters on both routes. Returns the lane sort's launches and the
    lanes-flags launches by path."""
    label = "filters, IUPAC (31, 31)"
    sba, seg_starts = index_sba(host_sc)
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    _, t_sort = sync_time(km.sort)
    launches = sort_lanes_cuda.launches
    if km._lanes_cache["two_bit"] or launches < 1:
        raise AssertionError(f"{label}: not 4-bit lanes, or the lane sort did not launch")
    log(f"{label}: sort {t_sort:.4f} s, {launches} lane sort launches")
    return launches, filters_on_sorted_index(km, sc, label, rng, masks=False)


def filters_suffix(sc, counts31) -> None:
    """The suffix index of the ACGT genome: filtered queries take the plane
    and window route. LengthFilter(31) keeps exactly the k-mers of the
    (31, 31) index; the GC filter raises at the first row in sorted order
    whose record ends within 31 bases with at most 21 G/C before it."""
    label = "filters, suffix index (1, None)"
    km = gkt.Kmers(sc)
    _, t_sort = sync_time(km.sort)
    length = LengthFilter(31)
    if km._stats_route(31, length)[0] == "lanes_filtered":
        raise AssertionError(f"{label}: a suffix index took the lanes route")
    (counts, _), t_len = sync_time(lambda: km.get_kmer_group_counts(31, kmer_filter_func=length))
    if not np.array_equal(counts, counts31):
        raise AssertionError(f"{label}: LengthFilter(31) is not the (31, 31) histogram")
    # the rows with fewer than 31 bases left, in sorted order, and the first
    # of them whose G/C count stays at or under the maximum
    sba, seg_starts = index_sba(sc)
    ends = np.concatenate([seg_starts[1:] - 1, [len(sba)]])
    short = np.concatenate([np.arange(max(s, e - 30), e) for s, e in zip(seg_starts, ends)])
    rows = torch.nonzero(torch.isin(km._pos_dev, torch.from_numpy(short).to(km._pos_dev.device)))
    in_order = km._pos_dev[rows.flatten()].cpu().numpy()
    gc_cum = np.concatenate([[0], np.cumsum((sba == ord("G")) | (sba == ord("C")))])
    stop = ends[np.searchsorted(seg_starts, in_order, side="right") - 1]
    gc = GcContentFilter(0.3, 0.7, 31)
    raises = gc_cum[stop] - gc_cum[in_order] <= gc.max_allowed_gc_count
    first = int(in_order[np.flatnonzero(raises)[0]])
    message = f"The kmer_len (31) requested is too larger for kmer_sba_start_idx ({first})"
    _, t_gc = sync_time(lambda: expect_value_error(
        lambda: km.get_kmer_group_counts(31, kmer_filter_func=gc), message, label))
    log(f"{label}: sort {t_sort:.4f} s; get_kmer_group_counts(31, LengthFilter(31)) {t_len:.4f} s "
        f"equals the (31, 31) histogram; GcContentFilter(0.3, 0.7, 31) raises at position {first}, "
        f"row {int(rows[np.flatnonzero(raises)[0]])} of {len(km)} in sorted order, as the oracle "
        f"says ({len(in_order)} short rows, {int(raises.sum())} of them raising; {t_gc:.4f} s "
        "with the plane build)")


def filters_raise_parity(rng) -> int:
    """Kmers(sc, 20, 48) at 2^22 bp with records as short as 20 bp: GC and
    homopolymer filters raise the message and position of a NumPy oracle
    of the reference's walk, on the lanes and on the plane route. The first
    record ends in 47 A's: its truncated rows sort first and the
    homopolymer preemption saves them. Returns the pack launches."""
    label = f"filters, raise parity (20, 48) at {FILTER_RAISE_BP} bp"
    records = synthetic_records(rng, FILTER_RAISE_BP, 12, short_lens=(20, 33, 47))
    records[0][1][-47:] = ord("A")
    reset_launches()
    sc = collection_of(records)
    km = gkt.Kmers(sc, 20, 48)
    km.sort()
    launches = pack_rank2_words_cuda.launches
    sba, seg_starts = index_sba(sc)
    n, k = len(sba), 48
    pos = km._pos_dev.cpu().numpy()
    ends = np.concatenate([seg_starts[1:] - 1, [n]])
    vl = ends[np.searchsorted(seg_starts, pos, side="right") - 1] - pos
    d = np.minimum(vl, k)
    trunc = vl < k
    gc_cum = np.concatenate([[0], np.cumsum((sba == ord("G")) | (sba == ord("C")))])
    gc = GcContentFilter(0.3, 0.7, k)
    gc_raises = trunc & (gc_cum[pos + d] - gc_cum[pos] <= gc.max_allowed_gc_count)
    max_h = 3
    changed = np.ones(n, dtype=bool)
    changed[1:] = sba[1:] != sba[:-1]
    run_len = np.arange(n) - np.flatnonzero(changed)[np.cumsum(changed) - 1] + 1
    bad_cum = np.concatenate([[0], np.cumsum(run_len > max_h)])
    preempted = bad_cum[pos + d] - bad_cum[np.minimum(pos + max_h, pos + d)] > 0
    hp_raises = (pos + k - 1 >= n) | (trunc & ~preempted)
    first_gc, first_hp = np.flatnonzero(gc_raises)[0], np.flatnonzero(hp_raises)[0]
    saved = trunc[:first_hp] & preempted[:first_hp]
    if not saved.any():
        raise AssertionError(f"{label}: no row before the first raise is saved by a run")
    cases = ((gc, f"The kmer_len ({k}) requested is too larger for kmer_sba_start_idx ({pos[first_gc]})"),
             (HomopolymerFilter(max_h, k),
              f"The kmer_len ({k}) requested is too large for kmer_sba_start_idx ({pos[first_hp]})"))
    for f, message in cases:
        if km._stats_route(k, f)[0] != "lanes_filtered":
            raise AssertionError(f"{label}: {type(f).__name__} does not take the lanes")
        for route, run in (("lanes", lambda fn: fn()), ("plane", lambda fn: on_plane_route(km, fn))):
            for call in (lambda: km.get_kmer_group_counts(k, kmer_filter_func=f),
                         lambda: km.get_kmer_count(k, kmer_filter_func=f)):
                run(lambda: expect_value_error(call, message, f"{label}, {type(f).__name__}, {route}"))
    log(f"{label}: GcContentFilter(0.3, 0.7, 48) raises at row {first_gc} (position {pos[first_gc]}) "
        f"and HomopolymerFilter(3, 48) at row {first_hp} (position {pos[first_hp]}) on the lanes and "
        f"the plane route, as the oracle says; {int(saved.sum())} truncated rows before it are saved "
        f"by a longer run, {int(trunc.sum())} rows truncated in all; {launches} pack launches")
    if launches < 1:
        raise AssertionError(f"{label}: the pack kernel did not launch")
    return launches


def filters_init_time(rng) -> int:
    """Init-time filters on both strands of a 2^24 bp IUPAC genome, in both
    methods, against sliding-window sums over the concatenated SBA; then
    sort() of the filtered (assigned) index through the lane sort, and its
    histogram against a NumPy oracle. Returns the lane sort's launches."""
    label = f"filters, init-time, IUPAC both strands at {INIT_FILTER_BP} bp (31, 31)"
    records = synthetic_records(rng, INIT_FILTER_BP, 24, short_lens=(31, 40), iupac=True)
    sc = collection_of(records, "both")
    del records
    filters = [NoAmbiguousBasesFilter(31), GcContentFilter(0.2, 0.8, 31)]
    times, positions = {}, {}
    for method in ("single_pass", "double_pass"):
        km, times[method] = sync_time(lambda: gkt.Kmers.from_strand(
            sc, 31, 31, source_strand="both", method=method, kmer_filters=filters))
        positions[method] = km.kmer_sba_start_indices.astype(np.int64)
    if not np.array_equal(positions["single_pass"], positions["double_pass"]):
        raise AssertionError(f"{label}: single_pass and double_pass keep different positions")
    sba = index_sba(sc, km)[0]
    starts = valid_starts_of(sc, km)
    acgt_cum = np.concatenate([[0], np.cumsum(np.isin(sba, ACGT))])
    gc_cum = np.concatenate([[0], np.cumsum((sba == ord("G")) | (sba == ord("C")))])
    gc_count = gc_cum[starts + 31] - gc_cum[starts]
    keep = (acgt_cum[starts + 31] - acgt_cum[starts] == 31) & (gc_count >= 7) & (gc_count <= 24)
    expected = starts[keep]
    if not np.array_equal(positions["single_pass"], expected):
        raise AssertionError(f"{label}: the filtered positions differ from the sliding-window oracle")
    km = gkt.Kmers.from_strand(sc, 31, 31, source_strand="both", kmer_filters=filters)
    reset_launches()
    _, t_sort = sync_time(km.sort)
    launches = sort_lanes_cuda.launches
    if launches < 1:
        raise AssertionError(f"{label}: the sort of the filtered index did not launch the lane sort")
    ranks = RANK2_TABLE.astype(np.int64)
    key = np.zeros(len(expected), dtype=np.int64)
    for j in range(31):
        key = (key << 2) | ranks[sba[expected + j]]
    sizes = np.unique(key, return_counts=True)[1]
    counts, total = km.get_kmer_group_counts(31, max_counts_bin=1000)
    if not (np.array_equal(counts, np.bincount(np.minimum(sizes, 1000), minlength=1001))
            and total == len(expected)):
        raise AssertionError(f"{label}: the histogram of the filtered index differs from the oracle")
    log(f"{label}: single_pass {times['single_pass']:.4f} s, double_pass {times['double_pass']:.4f} s "
        f"keep {len(expected)} of {len(starts)} starts, equal to the oracle; sort {t_sort:.4f} s "
        f"({launches} lane sort launches), histogram equal to the oracle ({len(sizes)} groups)")
    return launches


def log_peak(label: str, held_before: int) -> None:
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: peak device memory {peak} bytes ({peak / 2**30:.3f} GiB), of which {held_before} "
        f"bytes were held before it began: its own {(peak - held_before) / 2**30:.3f} GiB")


def phase_filters(host_acgt, host_iupac, counts31) -> dict:
    """Phase 13, on a random stream of its own (the later phases keep their
    genomes); returns the launches of the pack, lane sort and lanes-flags
    kernels by path."""
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pack_launches, sc_acgt, flags_acgt = filters_acgt(host_acgt, rng)
    log_peak("filters, ACGT (31, 31)", held_before)
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sort_launches, flags_iupac = filters_iupac(host_iupac, rng)
    log_peak("filters, IUPAC (31, 31)", held_before)
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    filters_suffix(sc_acgt, counts31)
    log_peak("filters, suffix index (1, None)", held_before)
    del sc_acgt
    torch.cuda.empty_cache()
    raise_launches = filters_raise_parity(rng)
    init_launches = filters_init_time(rng)
    log(f"filters phase: {time.perf_counter() - t0:.1f} s")
    return {
        "pack_rank2_words_cuda": {"filters, ACGT 2^27 (31, 31)": pack_launches,
                                  f"filters, raise parity at {FILTER_RAISE_BP} bp": raise_launches},
        "sort_lanes_cuda": {"filters, IUPAC 2^27 (31, 31)": sort_launches,
                            f"filters, init-time filtered index at {INIT_FILTER_BP} bp":
                                init_launches},
        "lanes_flags_cuda": {**flags_acgt, **flags_iupac},
    }


def fused_keys(lanes: dict):
    """The sorted (31, 31) index's words as int64 keys, independent of the
    query code: one 62-bit key a row on 2-bit lanes; on 4-bit lanes (124
    bits) a (63-bit, 61-bit) pair, ranked to one key below."""
    w = [unsigned(x) for x in lanes["words"]]
    if lanes["two_bit"]:
        return ((w[0] << 30) | (w[1] >> 2),)
    n15 = w[1] & 0xF
    hi = (((w[0] << 28) | (w[1] >> 4)) << 3) | (n15 >> 1)
    lo = ((n15 & 1) << 60) | (w[2] << 28) | (w[3] >> 4)
    return hi, lo


def fused_query_keys(win: np.ndarray, two_bit: bool, dev):
    """``fused_keys`` of query strings of 31 bases, from their bytes."""
    if two_bit:
        r = RANK2_TABLE.astype(np.int64)[win]
        key = np.zeros(len(win), dtype=np.int64)
        for j in range(31):
            key = (key << 2) | r[:, j]
        return (torch.from_numpy(key).to(dev),)
    r = RANK_TABLE.astype(np.int64)[win]
    a = np.zeros(len(win), dtype=np.int64)
    b = np.zeros(len(win), dtype=np.int64)
    for j in range(15):
        a = (a << 4) | r[:, j]
        b = (b << 4) | r[:, 16 + j]
    hi = (a << 3) | (r[:, 15] >> 1)
    lo = ((r[:, 15] & 1) << 60) | b
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


def searchsorted_counts(keys: tuple, qkeys: tuple) -> np.ndarray:
    """Occurrences of each query key among the sorted row keys, by
    torch.searchsorted. A (hi, lo) pair is first ranked into one key: the
    rank of hi among the distinct hi values times their count plus the rank
    of lo among the distinct lo values, an order-preserving map."""
    if len(keys) == 2:
        (hi, lo), (qhi, qlo) = keys, qkeys
        uh, ul = torch.unique(hi), torch.unique(lo)
        rh, rl = torch.searchsorted(uh, qhi), torch.searchsorted(ul, qlo)
        present = ((uh[torch.clamp_max(rh, len(uh) - 1)] == qhi)
                   & (ul[torch.clamp_max(rl, len(ul) - 1)] == qlo))
        keys = (torch.searchsorted(uh, hi) * len(ul) + torch.searchsorted(ul, lo),)
        qkeys = (torch.where(present, rh * len(ul) + rl, -1),)
    (key,), (qkey,) = keys, qkeys
    n = torch.searchsorted(key, qkey, right=True) - torch.searchsorted(key, qkey)
    return n.cpu().numpy()


def queries_on(km, sc, two_bit: bool, label: str, rng, profile_dir) -> None:
    """count_queries and count_queries_canonical on the sorted (31, 31)
    index for QUERY_SAMPLES k-mers at seeded genome positions, QUERY_RANDOM
    random k-mers and on an IUPAC genome QUERY_WITH_N k-mers with an N,
    held against the sizes of their groups read by torch.searchsorted over
    the index's fused keys."""
    starts = valid_starts(records_of(sc), 31)
    sampled = kmer_windows(sc, starts[rng.integers(0, len(starts), size=QUERY_SAMPLES)], 31)
    parts = [sampled, ACGT[rng.integers(0, 4, size=(QUERY_RANDOM, 31))]]
    if not two_bit:
        with_n = sampled[:QUERY_WITH_N].copy()
        with_n[np.arange(QUERY_WITH_N), rng.integers(0, 31, size=QUERY_WITH_N)] = ord("N")
        parts.append(with_n)
    qwin = np.concatenate(parts)
    queries = as_queries(qwin)
    dev = km._pos_dev.device
    keys = fused_keys(km._lanes_cache)
    expected = searchsorted_counts(keys, fused_query_keys(qwin, two_bit, dev))
    rc_win = revcomp_rows(qwin)
    palindrome = np.all(rc_win == qwin, axis=1)
    expected_rc = searchsorted_counts(keys, fused_query_keys(rc_win, two_bit, dev))
    expected_canon = expected + np.where(palindrome, 0, expected_rc)
    del keys
    got, t_cold = sync_time(lambda: km.count_queries(queries, 31))
    _, t_warm = sync_time(lambda: km.count_queries(queries, 31))
    canon, t_canon = sync_time(lambda: km.count_queries_canonical(queries, 31))
    _, t_encode = sync_time(lambda: encode_query_words(queries, 31))
    if not np.array_equal(got, expected):
        bad = np.flatnonzero(got != expected)
        raise AssertionError(f"{label}: count_queries differs from torch.searchsorted on {len(bad)} "
                             f"queries, e.g. {queries[bad[0]]}: {got[bad[0]]} vs {expected[bad[0]]}")
    if not np.array_equal(canon, expected_canon):
        raise AssertionError(f"{label}: count_queries_canonical differs from the searchsorted sums")
    REFERENCES[f"queries {'ACGT' if two_bit else 'IUPAC'}"] = (queries, got, canon)
    nq = len(queries)
    log(f"{label}: count_queries of {nq} queries ({len(sampled)} sampled, {QUERY_RANDOM} random"
        + ("" if two_bit else f", {QUERY_WITH_N} with an N") + f"; {int((got > 0).sum())} present, "
        f"largest count {int(got.max())}) {t_cold:.4f} s cold (the 4-bit pack built on first use), "
        f"{t_warm:.4f} s warm = {nq / t_warm / 1e6:.3f} M queries/s; count_queries_canonical "
        f"{t_canon:.4f} s ({int(palindrome.sum())} palindromes); both equal torch.searchsorted "
        f"over the fused keys; the host encoding of the queries alone {t_encode:.4f} s")
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            km.count_queries(queries, 31)
            torch.cuda.synchronize()
        write_profile(prof, Path(profile_dir) / f"queries_{'acgt' if two_bit else 'iupac'}.txt")


def phase_queries_canonical(host_acgt, host_iupac, profile_dir) -> dict:
    """Phase 14: on collections of their own rebuilt from the main paths'
    host arrays (own upload and pack), canonical statistics at k = 31 on the
    fresh (31, 31) index (dense route) and on the sorted one (gather route),
    then the queries. Returns the launches of the path's kernel by path and
    each genome's canonical histogram and total (phase 17's reference)."""
    rng = np.random.default_rng(SEED + 14)
    launches, canonical = {}, {}
    for host_sc in (host_acgt, host_iupac):
        two_bit = host_sc.device_cache("forward").is_acgt_only
        label = f"queries and canonical statistics, {'ACGT' if two_bit else 'IUPAC'} 2^27 (31, 31)"
        kernel = pack_rank2_words_cuda if two_bit else sort_lanes_cuda
        sba, seg_starts = index_sba(host_sc)
        held_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
        (dense, total), t_cold = sync_time(lambda: km.get_canonical_kmer_group_counts(31))
        dense_launches = kernel.launches
        (dense2, _), t_warm = sync_time(lambda: km.get_canonical_kmer_group_counts(31))
        if not np.array_equal(dense, dense2) or total != len(km):
            raise AssertionError(f"{label}: the dense route's total {total} is not the "
                                 f"{len(km)} full-length k-mers, or two calls differ")
        _, t_sort = sync_time(km.sort)
        before = kernel.launches
        (gather, total_g), t_gather = sync_time(lambda: km.get_canonical_kmer_group_counts(31))
        gather_launches = kernel.launches - before
        if not (np.array_equal(dense, gather) and total_g == total):
            raise AssertionError(f"{label}: the dense and the gather route differ")
        if dense_launches < 1 or (not two_bit and gather_launches < 1):
            raise AssertionError(f"{label}: {kernel.__name__} did not launch on the canonical path")
        sizes = np.arange(len(dense), dtype=np.int64)
        log(f"{label}: get_canonical_kmer_group_counts(31) dense route {t_cold:.4f} s cold (upload "
            f"and pack included), {t_warm:.4f} s warm = {len(km) / t_warm / 1e6:.1f} M k-mers/s; "
            f"sort {t_sort:.4f} s; gather route {t_gather:.4f} s; equal histograms, {total} k-mers "
            f"in {int(dense.sum())} canonical groups ({int(dense[2:].sum())} of size > 1, "
            f"sum(s * counts[s]) {int((sizes * dense).sum())}); {kernel.__name__} launches: dense "
            f"{dense_launches}, gather {gather_launches}")
        canonical["ACGT" if two_bit else "IUPAC"] = (dense, total)
        queries_on(km, sc, two_bit, label, rng, profile_dir)
        launches[label] = kernel.launches
        log_peak(label, held_before)
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            fresh = gkt.Kmers(sc, 31, 31)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fresh.get_canonical_kmer_group_counts(31)
                torch.cuda.synchronize()
            write_profile(prof, Path(profile_dir) / f"canonical_{'acgt' if two_bit else 'iupac'}.txt")
            del fresh
        del sc, km
        torch.cuda.empty_cache()
    return launches, canonical


# --------------------------------------------------------------------------- #
# phase 15: the sorted index on a mesh; phase 16: persistence and export
# --------------------------------------------------------------------------- #


class StepLog:
    """``on_step`` callback of ``Kmers.sort(mesh=...)``: synchronises and
    adds the seconds since the previous step (or ``start``) to the step's
    name."""

    def __init__(self):
        self.steps = {}
        self.t = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.steps[name] = self.steps.get(name, 0.0) + now - self.t
        self.t = now


def mesh_sort(km, mesh, expected: np.ndarray, label: str):
    """``km.sort(mesh=mesh)`` timed step by step; the real rows of its
    ragged layout in shard order must be ``expected``. Returns (seconds,
    seconds by step, the sample sort's info)."""
    steps, info = StepLog(), {}
    steps.start()
    t0 = steps.t
    km.sort(mesh=mesh, on_step=steps, mesh_info=info)
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t0
    if any(p.device.type != DEVICE for p in km._dist_cache.positions):
        raise AssertionError(f"{label}: the mesh layout does not live on the card")
    if not np.array_equal(km.kmer_sba_start_indices, expected):
        raise AssertionError(f"{label}: the mesh layout's rows are not the single-card sorted positions")
    return t_sort, steps.steps, info


def mesh_queries(sc, rng) -> list:
    """MESH_QUERIES k-mers at seeded genome positions and 1024 random ones."""
    starts = valid_starts(records_of(sc), 31)
    sampled = kmer_windows(sc, starts[rng.integers(0, len(starts), size=MESH_QUERIES)], 31)
    return as_queries(np.concatenate([sampled, ACGT[rng.integers(0, 4, size=(1024, 31))]]))


def mesh_main(host_sc, expected: np.ndarray, counts31: np.ndarray, m4, m1, rng):
    """Phase 15 on one genome at 2^27 SBA bytes; returns (pack launches,
    lane sort launches, histogram launches of one get_kmer_group_counts(31))
    of its mesh path."""
    two_bit = host_sc.device_cache("forward").is_acgt_only
    label = f"mesh of {MESH_SHARDS} shards on one card, {'ACGT' if two_bit else 'IUPAC'} 2^27 (31, 31)"
    sba, seg_starts = index_sba(host_sc)
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    t_sort, steps, info = mesh_sort(km, m4, expected, label)
    REFERENCES[f"mesh layout {'ACGT' if two_bit else 'IUPAC'}"] = layout_digests(km._dist_cache.positions,
                                                                                   km._dist_cache.is_pad)
    km.get_kmer_group_counts(31, mesh=m4)  # cold: the allocator grows
    t_sort_warm, steps_warm, _ = mesh_sort(gkt.Kmers(sc, 31, 31), m4, expected, label)
    group_size_hist_cuda.launches = 0
    (counts, total), t_stats = sync_time(lambda: km.get_kmer_group_counts(31, mesh=m4))
    hist_l = group_size_hist_cuda.launches
    if hist_l != MESH_SHARDS:
        raise AssertionError(f"{label}: get_kmer_group_counts(31, mesh) launched the histogram "
                             f"kernel {hist_l} times, not once a shard")
    count, t_count = sync_time(lambda: km.get_kmer_count(31, mesh=m4))
    if not (np.array_equal(counts, counts31) and total == count == len(expected)):
        raise AssertionError(f"{label}: the mesh histogram or count differs from the main path's")
    pack_l, sort_l = pack_rank2_words_cuda.launches, sort_lanes_cuda.launches
    if (two_bit and pack_l < 1) or sort_l < 3 * MESH_SHARDS:
        raise AssertionError(f"{label}: a kernel of the mesh path did not launch "
                             f"(pack {pack_l}, lane sort {sort_l})")
    peak = torch.cuda.max_memory_allocated()
    # the bench's GC filter and the queries against the single-card index
    single = gkt.Kmers(sc, 31, 31)
    single.sort()
    gc = GcContentFilter(0.3, 0.7, 31)
    (fcounts, ftotal), t_filter = sync_time(lambda: km.get_kmer_group_counts(31, gc, mesh=m4))
    want = single.get_kmer_group_counts(31, gc)
    if not (np.array_equal(fcounts, want[0]) and ftotal == want[1]):
        raise AssertionError(f"{label}: the GC-filtered mesh histogram differs from one card's")
    REFERENCES[f"gc {'ACGT' if two_bit else 'IUPAC'}"] = ftotal
    queries = mesh_queries(sc, rng)
    got, t_q = sync_time(lambda: km.count_queries(queries, 31, mesh=m4))
    canon = km.count_queries_canonical(queries, 31, mesh=m4)
    if not (np.array_equal(got, single.count_queries(queries, 31))
            and np.array_equal(canon, single.count_queries_canonical(queries, 31))):
        raise AssertionError(f"{label}: mesh count queries differ from one card's")
    del single
    km1 = gkt.Kmers(sc, 31, 31)
    t_one, _, info1 = mesh_sort(km1, m1, expected, f"{label}, one shard")
    counts1, _ = km1.get_kmer_group_counts(31, mesh=m1)
    if not np.array_equal(counts1, counts31):
        raise AssertionError(f"{label}: the one-shard mesh histogram differs")
    log(f"{label}: sort(mesh) {t_sort:.4f} s cold, {t_sort_warm:.4f} s warm = "
        f"{len(expected) / t_sort_warm / 1e6:.1f} M k-mers/s; real rows by shard {info['rows']} "
        f"(layout {info['capacity'] * MESH_SHARDS} rows a shard), capacity factor "
        f"{info['capacity_factor']} after {info['retries']} retries; seconds by step (warm) "
        + ", ".join(f"{k} {v:.4f}" for k, v in steps_warm.items())
        + f" (cold: " + ", ".join(f"{k} {v:.4f}" for k, v in steps.items()) + ")")
    log(f"{label}: get_kmer_group_counts(31, mesh) {t_stats:.4f} s, get_kmer_count(31, mesh) "
        f"{t_count:.4f} s, both equal to the main path's; GC filter (0.3, 0.7, 31) {t_filter:.4f} s "
        f"({ftotal} k-mers), equal to one card's; count_queries of {len(queries)} queries "
        f"{t_q:.4f} s, equal to one card's (canonical too); one-shard mesh sort {t_one:.4f} s "
        f"(capacity factor {info1['capacity_factor']}); launches: pack {pack_l}, lane sort {sort_l}, "
        f"histogram {hist_l}")
    log(f"{label}: peak device memory of the sort and statistics {peak} bytes ({peak / 2**30:.3f} "
        f"GiB), {held_before} held before: its own {(peak - held_before) / 2**30:.3f} GiB")
    del km, km1, sc
    torch.cuda.empty_cache()
    return pack_l, sort_l, hist_l


def check_identical_rows(rng, n: int = 1 << 22, n_lanes: int = 7) -> None:
    """The lane sort kernel on rows of which 40% are all-ones in every lane
    (identical rows, the shape of a ragged layout's pads), against its plain
    version: the same bytes. The kernel's contract asks for a unique last
    lane; the mesh path keeps to it (it sorts real rows only), and this
    shows what the kernel does where a caller does not."""
    dev = torch.device(DEVICE)
    lanes = [torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev) for _ in range(n_lanes)]
    ones = torch.from_numpy(rng.random(n) < 0.4).to(dev)
    lanes = [torch.where(ones, -1, lane) for lane in lanes]
    got, want = sort_lanes_cuda(lanes), sort_lanes(lanes)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("lane sort: rows identical in every lane do not sort as the plain version")
    log(f"lane sort with {int(ones.sum())} identical all-ones rows of {n} x {n_lanes} lanes: "
        f"bitwise equal to the plain version")


def phase_mesh(host_acgt, host_iupac, positions, counts, rng_seed: int) -> dict:
    """Phase 15: the mesh at full width on both genomes, then the gather
    path at 2^22 bp and an all-'A' genome that makes the exchange retry.
    Returns the launches of both kernels by path."""
    rng = np.random.default_rng(rng_seed)
    t0 = time.perf_counter()
    check_identical_rows(rng)
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    m1 = make_mesh(1)
    out = {"pack_rank2_words_cuda": {}, "sort_lanes_cuda": {}, "group_size_hist_cuda": {}}
    for host_sc, key in ((host_acgt, "ACGT"), (host_iupac, "IUPAC")):
        pack_l, sort_l, hist_l = mesh_main(host_sc, positions[key], counts[key], m4, m1, rng)
        out["pack_rank2_words_cuda"][f"mesh of {MESH_SHARDS}, {key} 2^27 (31, 31)"] = pack_l
        out["sort_lanes_cuda"][f"mesh of {MESH_SHARDS}, {key} 2^27 (31, 31)"] = sort_l
        out["group_size_hist_cuda"][
            f"mesh of {MESH_SHARDS}, {key} 2^27 get_kmer_group_counts(31)"] = hist_l
    # the gather path: an assigned descending index, 2-bit and 4-bit keys
    for iupac, mn, mx in ((False, 20, 48), (True, 12, 24)):
        label = f"mesh gather path at {GATHER_BP} bp, {'4' if iupac else '2'}-bit keys ({mn}, {mx})"
        sc = collection_of(synthetic_records(rng, GATHER_BP, 12, short_lens=(20, 33), iupac=iupac))
        single = gkt.Kmers(sc, mn, mx)
        single.kmer_sba_start_indices = single.kmer_sba_start_indices[::-1].copy()
        single.sort()
        reset_launches()
        km = gkt.Kmers(sc, mn, mx)
        km.kmer_sba_start_indices = km.kmer_sba_start_indices[::-1].copy()
        t_sort, _, info = mesh_sort(km, m4, single.kmer_sba_start_indices, label)
        want = single.get_kmer_group_counts(mx, max_counts_bin=1000)
        got = km.get_kmer_group_counts(mx, max_counts_bin=1000, mesh=m4)
        if not (np.array_equal(got[0], want[0]) and got[1] == want[1]):
            raise AssertionError(f"{label}: the mesh histogram differs from one card's")
        if sort_lanes_cuda.launches < 3 * MESH_SHARDS:
            raise AssertionError(f"{label}: the lane sort did not launch on every shard")
        out["sort_lanes_cuda"][label] = sort_lanes_cuda.launches
        log(f"{label}: sort(mesh) {t_sort:.4f} s, rows by shard {info['rows']}, equal to one card's "
            f"sort and histogram; lane sort launches {sort_lanes_cuda.launches}")
    # an all-'A' record: the first exchange capacity overflows
    records = synthetic_records(rng, RETRY_BP, 4)
    records.append(("allA", np.full(RETRY_BP, ord("A"), dtype=np.uint8)))
    sc = collection_of(records)
    single = gkt.Kmers(sc, 31, 31)
    single.sort()
    km = gkt.Kmers(sc, 31, 31)
    _, _, info = mesh_sort(km, m4, single.kmer_sba_start_indices, "mesh retry")
    if info["retries"] < 1:
        raise AssertionError(f"mesh retry: an all-'A' record took no retry ({info})")
    got, want = km.get_kmer_group_counts(31, mesh=m4), single.get_kmer_group_counts(31)
    if not (np.array_equal(got[0], want[0]) and got[1] == want[1]):
        raise AssertionError("mesh retry: the histogram differs from one card's")
    log(f"mesh retry at {2 * RETRY_BP} bp with an all-'A' record: {info['retries']} retries, capacity "
        f"factor {info['capacity_factor']}, rows by shard {info['rows']}; equal to one card's")
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return out


def refuse_sort(*args, **kwargs):
    raise AssertionError("the loaded index was sorted again")


def _files_bytes(path: Path) -> int:
    """Bytes of the file ``path`` or of the files a shelve made from it."""
    return sum(f.stat().st_size for f in path.parent.glob(path.name + "*"))


def phase_persistence(host_acgt, positions, counts31, tmp: Path, rng_seed: int) -> dict:
    """Phase 16: save and load of the sorted 2^27 ACGT index with its
    collection (shelve; hdf5 where h5py imports), the sharded checkpoint of
    its mesh index, and at EXPORT_BP the full arrays and to_csv against a
    NumPy oracle (and to_csv against its row loop at ROW_LOOP_BP). Returns
    the pack launches of the loaded indexes."""
    rng = np.random.default_rng(rng_seed)
    t0 = time.perf_counter()
    formats = ["shelve"]
    try:
        import h5py  # noqa: F401
        formats.append("hdf5")
    except ImportError:
        pass
    writer = None
    for name in ("pyarrow", "pandas"):
        try:
            __import__(name)
            writer = name
            break
        except ImportError:
            continue
    log(f"persistence: formats {formats}; CSV writer {writer or 'none (to_csv not run)'}")
    sba, seg_starts = index_sba(host_acgt)
    sc, km = from_numpy_state(sba, seg_starts, host_acgt.forward_record_names, 31, 31, device=DEVICE)
    km.sort()
    launches = {}
    real_sort = gkt.Kmers.sort
    for fmt in formats:
        path = tmp / f"index_{fmt}"
        _, t_save = sync_time(lambda: km.save(str(path), include_sequence_collection=True, format=fmt))
        size = _files_bytes(path)
        reset_launches()
        loaded = gkt.Kmers()
        _, t_load = sync_time(lambda: loaded.load(str(path), format=fmt, device=DEVICE))
        gkt.Kmers.sort = refuse_sort
        try:
            (counts, total), t_stats = sync_time(lambda: loaded.get_kmer_group_counts(31))
            count = loaded.get_kmer_count(31)
        finally:
            gkt.Kmers.sort = real_sort
        if not (loaded._is_sorted and np.array_equal(counts, counts31) and total == count == len(positions)
                and np.array_equal(loaded.kmer_sba_start_indices, positions)):
            raise AssertionError(f"persistence ({fmt}): the loaded index differs from phase 4's")
        if sort_lanes_cuda.launches or pack_rank2_words_cuda.launches < 1:
            raise AssertionError(f"persistence ({fmt}): a sort launched, or the pack did not")
        launches[f"loaded index ({fmt}), ACGT 2^27"] = pack_rank2_words_cuda.launches
        log(f"persistence ({fmt}): save {t_save:.4f} s = {size / t_save / 1e6:.1f} MB/s, load "
            f"{t_load:.4f} s = {size / t_load / 1e6:.1f} MB/s ({size} bytes, index and collection); "
            f"statistics of the loaded index on the card {t_stats:.4f} s, equal to phase 4's, no sort")
        del loaded
        torch.cuda.empty_cache()
    # the sharded checkpoint of the 4-shard mesh index
    mesh = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    km4 = gkt.Kmers(sc, 31, 31)
    km4.sort(mesh=mesh)
    ckpt = tmp / "ckpt"
    _, t_save = sync_time(lambda: save_kmers_sharded(km4, ckpt))
    size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    fresh = gkt.Kmers(sc, 31, 31)
    _, t_load = sync_time(lambda: load_kmers_sharded(fresh, ckpt, mesh=mesh))
    counts, total = fresh.get_kmer_group_counts(31)
    if not (np.array_equal(fresh.kmer_sba_start_indices, positions) and np.array_equal(counts, counts31)):
        raise AssertionError("sharded checkpoint: the restored index differs")
    log(f"sharded checkpoint of the {MESH_SHARDS}-shard mesh index: save {t_save:.4f} s = "
        f"{size / t_save / 1e6:.1f} MB/s, load {t_load:.4f} s = {size / t_load / 1e6:.1f} MB/s "
        f"({size} bytes); the restored index equals phase 4's")
    del km, km4, fresh, sc
    torch.cuda.empty_cache()
    export_checks(rng, tmp, writer)
    if importlib.util.find_spec("pandas") is None:
        log("profiling: pandas does not import, the sweeps (DataFrames) not run")
    else:
        frame = profiling.profile_kmers_sort([EXPORT_BP], [31], num_iterations=1, device=DEVICE)
        log("profiling.profile_kmers_sort at 2^20 bp, k = 31, on the card: "
            + frame.to_string(index=False).replace("\n", "; "))
    log(f"persistence phase: {time.perf_counter() - t0:.1f} s")
    return launches


def export_checks(rng, tmp: Path, writer) -> None:
    """get_kmers_full_arrays and to_csv of a sorted (31, 31) index at
    EXPORT_BP against a NumPy oracle (byte strings sorted stably, np.unique
    group sizes), and to_csv against its row loop at ROW_LOOP_BP."""
    records = synthetic_records(rng, EXPORT_BP, 12, short_lens=(31, 40, 47))
    sc = collection_of(records)
    km = gkt.Kmers(sc, 31, 31)
    km.sort()
    starts = valid_starts(records, 31)
    strings = as_strings(kmer_windows(sc, starts, 31), 31)
    order = np.argsort(strings, kind="stable")  # ties by position: starts ascend
    pos, strs = starts[order], strings[order]
    _, inverse, sizes = np.unique(strs, return_inverse=True, return_counts=True)
    rec_starts = np.array([s for _, s, _ in sc.iter_records()], dtype=np.int64)
    rec = np.searchsorted(rec_starts, pos, side="right") - 1
    want = {
        "kmer_num": np.arange(len(pos), dtype=np.int64), "record_num": rec,
        "strand": np.full(len(pos), "+", dtype="U1"), "seq_start_idx": pos - rec_starts[rec] + 1,
        "kmer_len": np.full(len(pos), 31, dtype=np.int64),
        "group_size_yielded": sizes[inverse], "group_size_total": sizes[inverse],
    }
    full, t_full = sync_time(lambda: km.get_kmers_full_arrays(31, one_based_seq_index=True))
    for name, values in want.items():
        if not np.array_equal(full[name], values):
            raise AssertionError(f"export: get_kmers_full_arrays()[{name!r}] differs from the oracle")
    log(f"export at {EXPORT_BP} bp: get_kmers_full_arrays(31) {t_full:.4f} s, equal to a NumPy oracle "
        f"({len(pos)} rows)")
    if writer is None:
        return
    fields = ["kmer", "kmer_num", "chrom", "start", "strand", "group_size"]
    names = np.array([name for name, _ in records])
    lines = [",".join(fields)]
    lines += [f"{s.decode()},{i},{names[r]},{st},+,{g}" for i, (s, r, st, g) in enumerate(
        zip(strs, rec, pos - rec_starts[rec], sizes[inverse]))]
    oracle = ("\n".join(lines) + "\n").encode()
    path = tmp / "export.csv"
    _, t_csv = sync_time(lambda: km.to_csv(31, str(path), fields))
    if path.read_bytes() != oracle:
        raise AssertionError("export: to_csv differs from the NumPy oracle's bytes")
    log(f"export at {EXPORT_BP} bp: to_csv(31, 6 fields) {t_csv:.4f} s = "
        f"{len(oracle) / t_csv / 1e6:.1f} MB/s ({writer}), equal to the oracle's bytes")
    small = collection_of(synthetic_records(rng, ROW_LOOP_BP, 6, short_lens=(31, 40)))
    km = gkt.Kmers(small, 31, 48)
    km.sort()
    for k, flds in ((31, fields), (None, ["kmer_num", "kmer", "group_size"])):
        _, t_bulk = sync_time(lambda: km.to_csv(k, str(tmp / "bulk.csv"), flds))
        t_loop = time.perf_counter()
        km._to_csv_row_loop(k, str(tmp / "loop.csv"), flds)
        t_loop = time.perf_counter() - t_loop
        if (tmp / "bulk.csv").read_bytes() != (tmp / "loop.csv").read_bytes():
            raise AssertionError(f"export: to_csv({k}) differs from its row loop")
        log(f"export at {ROW_LOOP_BP} bp, (31, 48), kmer_len {k}: to_csv {t_bulk:.4f} s, row loop "
            f"{t_loop:.4f} s, equal bytes")


# --------------------------------------------------------------------------- #
# phase 17: the mesh beyond one compare window, canonical statistics on a
# mesh, the 2-D mesh
# --------------------------------------------------------------------------- #


class CallCount:
    """Wraps a function of a module and counts its calls (``calls``)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.real = module, name, getattr(module, name)
        self.calls = 0
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


def step_summary(steps: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in steps.items())


def mesh_refined_sort(km, mesh):
    """``km.sort(mesh=mesh)`` to its end on the card, timed round by round
    and step by step: (its rounds, seconds, seconds by step, info)."""
    rounds, steps, info = RoundLog(), StepLog(), {}
    steps.start()
    (_, seconds) = sync_time(lambda: km.sort(mesh=mesh, on_round=rounds, on_step=steps,
                                             mesh_info=info))
    return rounds, seconds, steps.steps, info


def check_layouts_equal(a, b, label: str) -> None:
    """Two kept mesh layouts, byte for byte: positions, pads, lanes, run ids."""
    for name in ("positions", "is_pad", "lanes", "gid_full"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None):
            raise AssertionError(f"{label}: only one layout keeps {name}")
        if x is None:
            continue
        if name == "lanes":
            x, y = [w for sh in x for w in sh], [w for sh in y for w in sh]
        if len(x) != len(y) or not all(torch.equal(p, q) for p, q in zip(x, y)):
            raise AssertionError(f"{label}: the 2-D layout's {name} differ from the 1-D layout's")


def mesh_suffix_acgt(host_sc, reference, m4, adjacent) -> dict:
    """ACGT suffix mode (1, None) at 2^27 bp on the 4-shard mesh against
    phase 9's single-card sort and histograms; returns the launches."""
    label = f"mesh of {MESH_SHARDS} beyond one window: ACGT suffix mode (1, None) 2^27"
    sba, seg_starts = index_sba(host_sc)
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 1, None, device=DEVICE)
    rounds, t_sort, steps, info = mesh_refined_sort(km, m4)
    if not np.array_equal(km.kmer_sba_start_indices, reference["positions"]):
        raise AssertionError(f"{label}: the real rows are not phase 9's sorted suffixes")
    if km._dist_cache.gid_full is None or any(p.device.type != DEVICE for p in km._dist_cache.positions):
        raise AssertionError(f"{label}: the layout keeps no run ids, or is not on the card")
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    before, adjacent.calls = sort_lanes_cuda.launches, 0
    (counts, total), t_none = sync_time(lambda: km.get_kmer_group_counts(None, mesh=m4))
    if adjacent.calls or sort_lanes_cuda.launches != before:
        raise AssertionError(f"{label}: the statistics at None ran a refinement round or a sort")
    if not (np.array_equal(counts, reference["counts"]) and total == len(km)):
        raise AssertionError(f"{label}: the histogram at None differs from phase 9's")
    (counts31, _), t_31 = sync_time(lambda: km.get_kmer_group_counts(31, mesh=m4))
    if not np.array_equal(counts31, reference["counts31"]):
        raise AssertionError(f"{label}: the histogram at 31 differs from phase 9's (phase 4's "
                             "plus the records' short tails)")
    names = [r[0] for r in rounds.rounds]
    if names[0] != "sample_sort_positions_ragged" or set(names[1:]) != {"_refine_round"}:
        raise AssertionError(f"{label}: unexpected rounds {names[:4]}...")
    if launches["pack_rank2_words_cuda"] < 1 or any(n < 1 for _, _, n in rounds.rounds):
        raise AssertionError(f"{label}: a kernel did not launch ({launches}; lane sort launches "
                             f"by round {[n for _, _, n in rounds.rounds][:8]}...)")
    later = [t for _, t, _ in rounds.rounds[1:]]
    log(f"{label}: {check_balance(info['round_rows'], len(km), label)}")
    log(f"{label}: sort(mesh) {t_sort:.4f} s = {len(km) / t_sort / 1e6:.1f} M suffixes/s "
        f"(one card, phase 9: {reference['seconds']:.4f} s = "
        f"{len(km) / reference['seconds'] / 1e6:.1f} M suffixes/s; {t_sort / reference['seconds']:.1f}x); "
        f"{rounds.summary()}")
    log(f"{label}: {len(names)} rounds, {np.mean(later):.4f} s a round after the first (median "
        f"{np.median(later):.4f}); seconds by step over all rounds: {step_summary(steps)}; "
        f"capacity factors {sorted(set(info['capacity_factors']))}, {info['retries']} retries; real "
        f"rows by shard at the end {info['rows']}")
    log(f"{label}: get_kmer_group_counts(None, mesh) {t_none:.4f} s from the kept run ids (no "
        f"round, no sort), equal to phase 9's; get_kmer_group_counts(31, mesh) {t_31:.4f} s, equal "
        f"to phase 9's; launches: pack {launches['pack_rank2_words_cuda']}, lane sort "
        f"{launches['sort_lanes_cuda']}; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB), "
        f"{held_before} held before: its own {(peak - held_before) / 2**30:.3f} GiB")
    del km
    km = gkt.Kmers(sc)
    rounds, t_warm, steps, _ = mesh_refined_sort(km, m4)
    log(f"{label}, a second sort (allocator warm): {t_warm:.4f} s = "
        f"{len(km) / t_warm / 1e6:.1f} M suffixes/s; {rounds.summary()}; seconds by step: "
        f"{step_summary(steps)}")
    del km, sc
    torch.cuda.empty_cache()
    return launches


def mesh_beyond_bounded(host_sc, reference, m4, adjacent) -> int:
    """(100, 100) or (48, 48) at 2^27 SBA bytes on the 4-shard mesh
    against phase 10's single-card sort and histograms, at the built length
    (kept run ids) and at a second length beyond one window (run structure
    over the kept layout, no re-sort); returns the lane sort launches."""
    two_bit = host_sc.device_cache("forward").is_acgt_only
    k, second = reference["k"], reference["second"]
    label = f"mesh of {MESH_SHARDS} beyond one window: ({k}, {k}), {'2' if two_bit else '4'}-bit keys"
    sba, seg_starts = index_sba(host_sc)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, k, k, device=DEVICE)
    rounds, t_sort, steps, info = mesh_refined_sort(km, m4)
    if not np.array_equal(km.kmer_sba_start_indices, reference["positions"]):
        raise AssertionError(f"{label}: the real rows are not phase 10's sorted positions")
    launches = sort_lanes_cuda.launches
    adjacent.calls = 0
    (counts, _), t_k = sync_time(lambda: km.get_kmer_group_counts(k, mesh=m4))
    calls_k = adjacent.calls
    (counts2, _), t_2 = sync_time(lambda: km.get_kmer_group_counts(second, mesh=m4))
    if sort_lanes_cuda.launches != launches or calls_k != 0 or adjacent.calls != 1:
        raise AssertionError(f"{label}: the statistics re-sorted, or took the wrong run ids")
    if not (np.array_equal(counts, reference["counts"])
            and np.array_equal(counts2, reference["counts_second"])):
        raise AssertionError(f"{label}: a histogram differs from phase 10's")
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: sort(mesh) {t_sort:.4f} s = {len(km) / t_sort / 1e6:.1f} M k-mers/s; "
        f"{rounds.summary()}; seconds by step: {step_summary(steps)}; capacity factors "
        f"{info['capacity_factors']}, {info['retries']} retries; histograms at {k} (kept run ids) "
        f"{t_k:.4f} s and at {second} (run structure over the layout, no sort) {t_2:.4f} s, equal "
        f"to phase 10's; {launches} lane sort launches; own peak "
        f"{(peak - held_before) / 2**30:.3f} GiB")
    del km, sc
    torch.cuda.empty_cache()
    return launches


def mesh_suffix_iupac(rng, m4) -> dict:
    """IUPAC suffix mode on the mesh against one card at growing sizes, up
    to the largest that stays within about 30 s: window rounds advance 32
    bases a round, and an N stretch between two IUPAC codes ties its
    suffixes for as many bases. Returns the lane sort launches by size."""
    launches = {}
    for bp in MESH_SUFFIX4_BPS:
        label = f"mesh of {MESH_SHARDS} beyond one window: IUPAC suffix mode (1, None) at {bp} bp"
        sc = collection_of(synthetic_records(rng, bp, 12, iupac=True))
        single = gkt.Kmers(sc)
        single_rounds, t_single = timed_sort(single)
        reset_launches()
        km = gkt.Kmers(sc)
        rounds, t_sort, steps, info = mesh_refined_sort(km, m4)
        launches[f"mesh of {MESH_SHARDS}, IUPAC suffix mode at {bp} bp"] = sort_lanes_cuda.launches
        if not np.array_equal(km.kmer_sba_start_indices, single.kmer_sba_start_indices):
            raise AssertionError(f"{label}: the mesh sort differs from one card's")
        got, want = km.get_kmer_group_counts(None, mesh=m4), single.get_kmer_group_counts(None)
        if not (np.array_equal(got[0], want[0]) and got[1] == want[1]):
            raise AssertionError(f"{label}: the histogram at None differs from one card's")
        log(f"{label}: {len(rounds.rounds)} rounds, sort(mesh) {t_sort:.4f} s = "
            f"{len(km) / t_sort / 1e6:.1f} M suffixes/s; one card {t_single:.4f} s in "
            f"{len(single_rounds.rounds)} rounds (prefix doubling); {rounds.summary()}; seconds by "
            f"step: {step_summary(steps)}; {info['retries']} retries; equal sorts and histograms")
        del km, single, sc
        torch.cuda.empty_cache()
        if t_sort * 4.5 > 30:  # the next size (4x the rows, more rounds) would pass 30 s
            break
    return launches


def mesh_canonical(host_sc, reference, m4) -> dict:
    """Canonical statistics at k = 31 on the 4-shard mesh, dense and gather
    route, against phase 14's single-card counts; returns the lane sort
    launches of each route."""
    two_bit = host_sc.device_cache("forward").is_acgt_only
    label = f"mesh of {MESH_SHARDS}: canonical statistics (31), {'ACGT' if two_bit else 'IUPAC'} 2^27"
    sba, seg_starts = index_sba(host_sc)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    reset_launches()
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    sc.device_cache("forward")  # the upload and the pack, outside the counted window
    reset_launches()
    (dense, total), t_dense = sync_time(lambda: km.get_canonical_kmer_group_counts(31, mesh=m4))
    launches = {"dense": sort_lanes_cuda.launches}
    km.sort()
    reset_launches()
    (gather, total_g), t_gather = sync_time(lambda: km.get_canonical_kmer_group_counts(31, mesh=m4))
    launches["gather"] = sort_lanes_cuda.launches
    want, want_total = reference
    if not (np.array_equal(dense, want) and np.array_equal(gather, want)
            and total == total_g == want_total):
        raise AssertionError(f"{label}: a route differs from phase 14's single-card counts")
    if min(launches.values()) < 3 * MESH_SHARDS:
        raise AssertionError(f"{label}: the lane sort did not launch on every shard: {launches}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: dense route {t_dense:.4f} s (cold), gather route {t_gather:.4f} s, both equal to "
        f"phase 14's; lane sort launches: dense {launches['dense']}, gather {launches['gather']}; "
        f"own peak {(peak - held_before) / 2**30:.3f} GiB")
    del km, sc
    torch.cuda.empty_cache()
    return launches


def mesh_2d(host_sc, expected: np.ndarray, m4, m22, rng) -> dict:
    """make_mesh2(2, 2) on one card: (31, 31) at 2^27 bp and suffix mode at
    MESH2_SUFFIX_BP, each layout byte for byte the 1-D mesh's; returns the
    lane sort launches of the 2-D sorts."""
    label = "2-D mesh (2, 2) on one card"
    sba, seg_starts = index_sba(host_sc)
    sc, km1 = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    mesh_sort(km1, m4, expected, f"{label}: the 1-D reference")  # cold: the allocator grows
    km2 = gkt.Kmers(sc, 31, 31)
    reset_launches()
    t_2d, steps, _ = mesh_sort(km2, m22, expected, label)
    launches = {"2-D mesh (2, 2), ACGT 2^27 (31, 31)": sort_lanes_cuda.launches}
    check_layouts_equal(km1._dist_cache, km2._dist_cache, f"{label}, (31, 31) 2^27")
    REFERENCES["mesh2 layout ACGT"] = layout_digests(km2._dist_cache.positions, km2._dist_cache.is_pad)
    counts = km2.get_kmer_group_counts(31, mesh=m22)
    if not np.array_equal(counts[0], km1.get_kmer_group_counts(31, mesh=m4)[0]):
        raise AssertionError(f"{label}: the histograms differ")
    del km1  # its memory stays with the allocator: the next 1-D sort finds it, as the 2-D sort did
    t_flat, _, _ = mesh_sort(gkt.Kmers(sc, 31, 31), m4, expected, f"{label}: the 1-D mesh, warm")
    del km2, sc
    torch.cuda.empty_cache()
    sc = collection_of(synthetic_records(rng, MESH2_SUFFIX_BP, 12))
    flat, two = gkt.Kmers(sc), gkt.Kmers(sc)
    _, t_flat_sfx, _, _ = mesh_refined_sort(flat, m4)
    reset_launches()
    rounds, t_2d_sfx, _, _ = mesh_refined_sort(two, m22)
    launches[f"2-D mesh (2, 2), ACGT suffix mode at {MESH2_SUFFIX_BP} bp"] = sort_lanes_cuda.launches
    check_layouts_equal(flat._dist_cache, two._dist_cache, f"{label}, suffix mode {MESH2_SUFFIX_BP} bp")
    log(f"{label}: (31, 31) at 2^27 bp sort(mesh2) {t_2d:.4f} s against {t_flat:.4f} s on the 1-D "
        f"mesh (both warm), the same layout byte for byte (positions, pads, lanes); seconds by step: "
        f"{step_summary(steps)}; suffix mode at {MESH2_SUFFIX_BP} bp {t_2d_sfx:.4f} s against "
        f"{t_flat_sfx:.4f} s in {len(rounds.rounds)} rounds, the same layout and run ids")
    del flat, two, sc
    torch.cuda.empty_cache()
    return launches


def mesh_retry(rng, m4) -> int:
    """The refinement rounds' overflow retry on a repeat-heavy genome:
    n_samples=4 and capacity_factor=0.05, on 2-bit and 4-bit keys, against
    one card's suffix sort. Returns the lane sort launches."""
    unit = ACGT[rng.integers(0, 4, 80)]
    sba = np.concatenate([np.tile(unit, 25), ACGT[rng.integers(0, 4, RETRY_BP - 2000)]])
    sc = collection_of([("repeats", sba)])
    single = gkt.Kmers(sc)
    single.sort()
    dc = sc.device_cache("forward")
    positions = torch.arange(len(sba), dtype=torch.int64, device=DEVICE)
    reset_launches()
    for two_bit in (True, False):
        info = {}
        got, t = sync_time(lambda: sample_sort_positions_unbounded(
            None if two_bit else dc.packed, positions, dc.seg_starts, dc.seg_ends, m4,
            packed2=dc.packed2 if two_bit else None, n_samples=4, capacity_factor=0.05, info=info))
        if not np.array_equal(got.cpu().numpy().astype(np.uint32), single.kmer_sba_start_indices):
            raise AssertionError(f"mesh refinement retry ({two_bit=}): differs from one card's sort")
        if info["retries"] < 1:
            raise AssertionError(f"mesh refinement retry: no retry in {info['rounds']} rounds")
        log(f"mesh refinement retry at {len(sba)} bp, {'2' if two_bit else '4'}-bit keys, 4 samples "
            f"a shard, capacity factor 0.05: {info['rounds']} rounds, {info['retries']} retries, "
            f"factors up to {max(info['capacity_factors'])}, {t:.4f} s; equal to one card's sort")
    return sort_lanes_cuda.launches


def phase_mesh_beyond_window(host_acgt, host_iupac, pos_acgt, suffix_ref, beyond_ref,
                             canonical_ref, rng_seed: int) -> dict:
    """Phase 17: on the mesh of phase 15, suffix mode and beyond one window
    on both genomes, canonical statistics, the 2-D mesh and the refinement
    retry. Returns the launches of both kernels by path."""
    rng = np.random.default_rng(rng_seed)
    t0 = time.perf_counter()
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    m22 = make_mesh2(2, 2, devices=[f"{DEVICE}:0"] * 4)
    adjacent = CallCount(gkt.kmers, "distributed_adjacent_gids")
    out = {"pack_rank2_words_cuda": {}, "sort_lanes_cuda": {}}
    try:
        got = mesh_suffix_acgt(host_acgt, suffix_ref, m4, adjacent)
        key = f"mesh of {MESH_SHARDS}, ACGT suffix mode 2^27"
        out["pack_rank2_words_cuda"][key] = got["pack_rank2_words_cuda"]
        out["sort_lanes_cuda"][key] = got["sort_lanes_cuda"]
        for host_sc, name in ((host_acgt, "ACGT"), (host_iupac, "IUPAC")):
            ref = beyond_ref[name]
            out["sort_lanes_cuda"][f"mesh of {MESH_SHARDS}, {name} ({ref['k']}, {ref['k']})"] = (
                mesh_beyond_bounded(host_sc, ref, m4, adjacent))
    finally:
        adjacent.restore()
    out["sort_lanes_cuda"].update(mesh_suffix_iupac(rng, m4))
    for host_sc, name in ((host_acgt, "ACGT"), (host_iupac, "IUPAC")):
        by_route = mesh_canonical(host_sc, canonical_ref[name], m4)
        for route, n in by_route.items():
            out["sort_lanes_cuda"][f"mesh of {MESH_SHARDS}, canonical (31) {route} route, {name} 2^27"] = n
    out["sort_lanes_cuda"].update(mesh_2d(host_acgt, pos_acgt, m4, m22, rng))
    out["sort_lanes_cuda"][f"mesh refinement retry at {RETRY_BP} bp"] = mesh_retry(rng, m4)
    if any(n < 1 for launches in out.values() for n in launches.values()):
        raise AssertionError(f"phase 17: a kernel did not launch on a path: {out}")
    log(f"mesh beyond one window phase: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 18: LargeKmers, the 64-bit regime
# --------------------------------------------------------------------------- #


def large_sort(lk, mesh, label: str, **kwargs):
    """``lk.sort(mesh)`` to its end on the card, its lane sort launches
    counted from 0: (seconds, launches, the sort's info)."""
    info = {}
    reset_launches()
    rounds = RoundLog()
    (_, seconds) = sync_time(lambda: lk.sort(mesh, on_round=rounds, info=info, **kwargs))
    if sort_lanes_cuda.launches < 1:
        raise AssertionError(f"{label}: the lane sort did not launch")
    if any(p.device.type != DEVICE for p in lk._sorted[0]):
        raise AssertionError(f"{label}: the sorted layout does not live on the card")
    info["rounds_log"] = rounds
    return seconds, sort_lanes_cuda.launches, info


def large_main(host_sc, name: str, expected: np.ndarray, counts31: np.ndarray, canonical, m1, m4):
    """18a on one genome at 2^27 bp: LargeKmers (31, 31) from the collection,
    sorted on one shard and on four, held to the main path's positions,
    histogram and total and to phase 14's canonical counts; Kmers on the same
    genome timed beside it. Returns the lane sort's launches by path and
    the histogram kernel's of one get_kmer_group_counts(31) by path."""
    label = f"LargeKmers, {name} 2^27 (31, 31)"
    launches, hist = {}, {}
    lk, t_build = sync_time(lambda: gkt.LargeKmers.from_sequence_collection(host_sc, 31, 31))
    log(f"{label}: from_sequence_collection {t_build:.3f} s (strided {'2' if lk.two_bit else '4'}-bit "
        f"pack of {lk.packed_words.nbytes} bytes, {len(lk)} k-mers)")
    sba, seg_starts = index_sba(host_sc)
    sc, km = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    km.sort()  # cold; the timed sorts below are warm, as the large ones
    _, t_kmers = sync_time(gkt.Kmers(sc, 31, 31).sort)
    gkt.Kmers(sc, 31, 31).sort(mesh=m4)
    _, t_kmers4 = sync_time(lambda: gkt.Kmers(sc, 31, 31).sort(mesh=m4))
    del sc, km
    for mesh, shards in ((m1, 1), (m4, MESH_SHARDS)):
        where = f"{label}, {shards} shard{'s' if shards > 1 else ''}"
        held_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_cold, _, _ = large_sort(lk, mesh, where)
        t_sort, n_launch, info = large_sort(lk, mesh, where)
        launches[where] = n_launch
        if not np.array_equal(lk.sorted_positions(), expected.astype(np.uint64)):
            raise AssertionError(f"{where}: the sorted positions are not the main path's")
        group_size_hist_cuda.launches = 0
        (got, total), t_counts = sync_time(lambda: lk.get_kmer_group_counts(31))
        hist[f"{where}, get_kmer_group_counts(31)"] = group_size_hist_cuda.launches
        if group_size_hist_cuda.launches != shards:
            raise AssertionError(f"{where}: get_kmer_group_counts(31) launched the histogram "
                                 f"kernel {group_size_hist_cuda.launches} times, not once a shard")
        count, t_count = sync_time(lambda: lk.get_kmer_count(31))
        if not (np.array_equal(got.astype(np.int64), counts31) and total == count == len(lk)):
            raise AssertionError(f"{where}: the histogram or the total is not the main path's")
        kmers_t = t_kmers if shards == 1 else t_kmers4
        log(f"{where}: sort {t_cold:.4f} s cold, {t_sort:.4f} s warm = {len(lk) / t_sort / 1e6:.1f} M "
            f"k-mers/s, {t_sort / kmers_t:.2f}x Kmers on the same genome ({kmers_t:.4f} s, "
            f"{'one card' if shards == 1 else f'mesh of {MESH_SHARDS}'}); rows by shard "
            f"{info['rows']}; get_kmer_group_counts(31) {t_counts:.4f} s, get_kmer_count(31) "
            f"{t_count:.4f} s; equal to the main path's positions, histogram and total; lane sort "
            f"launches {n_launch}")
        log_peak(where, held_before)
    reset_launches()
    (got, total), t_can = sync_time(lambda: lk.get_canonical_kmer_group_counts(31, mesh=m1))
    if not (np.array_equal(got.astype(np.int64), canonical[0]) and total == canonical[1]):
        raise AssertionError(f"{label}: canonical counts differ from phase 14's")
    if sort_lanes_cuda.launches < 1:
        raise AssertionError(f"{label}: the canonical sort did not launch the lane sort")
    launches[f"{label}, canonical (31), one shard"] = sort_lanes_cuda.launches
    log(f"{label}: get_canonical_kmer_group_counts(31) {t_can:.4f} s, equal to phase 14's; lane "
        f"sort launches {sort_lanes_cuda.launches}")
    return launches, hist


def large_suffix_small(rng, m1) -> dict:
    """18a, suffix mode at 2^24 bp: LargeKmers (1, None) against the Kmers
    suffix sort of the same collection."""
    label = f"LargeKmers suffix mode (1, None), ACGT {LARGE_SUFFIX_BP} bp"
    sc = collection_of(synthetic_records(rng, LARGE_SUFFIX_BP, 12, short_lens=(40,)))
    km = gkt.Kmers(sc)
    _, t_kmers = sync_time(km.sort)
    want = km.get_kmer_group_counts(None)
    lk = gkt.LargeKmers.from_sequence_collection(sc, 1, None)
    t_sort, n_launch, info = large_sort(lk, m1, label)
    if not np.array_equal(lk.sorted_positions(), km.kmer_sba_start_indices.astype(np.uint64)):
        raise AssertionError(f"{label}: the sorted suffixes are not the Kmers suffix sort's")
    (got, total), t_counts = sync_time(lambda: lk.get_kmer_group_counts(None))
    if not (np.array_equal(got.astype(np.int64), want[0]) and total == want[1]):
        raise AssertionError(f"{label}: the histogram differs from the Kmers suffix sort's")
    log(f"{label}: sort {t_sort:.4f} s in {info['rounds_log'].summary()}; Kmers suffix sort "
        f"{t_kmers:.4f} s ({t_sort / t_kmers:.1f}x); get_kmer_group_counts(None) {t_counts:.4f} s "
        f"from the kept run ids; equal positions and histogram; lane sort launches {n_launch}")
    return {label: n_launch}


def _set_ranks2(words: np.ndarray, start: int, ranks: np.ndarray) -> None:
    """Write 2-bit ranks at bases ``start ..`` of a strided pack."""
    p = np.arange(start, start + len(ranks), dtype=np.uint64)
    w = (p >> np.uint64(4)).astype(np.int64)
    sh = ((np.uint64(15) - (p & np.uint64(15))) * np.uint64(2)).astype(np.uint32)
    for i in range(len(ranks)):  # a few hundred bases
        words[w[i]] = (words[w[i]] & ~(np.uint32(3) << sh[i])) | (np.uint32(ranks[i]) << sh[i])


def _ranks2(words: np.ndarray, start: int, n: int) -> np.ndarray:
    p = np.arange(start, start + n, dtype=np.uint64)
    sh = ((np.uint64(15) - (p & np.uint64(15))) * np.uint64(2)).astype(np.uint32)
    return (words[(p >> np.uint64(4)).astype(np.int64)] >> sh) & np.uint32(3)


def _windows64(words: np.ndarray, pos: np.ndarray, offset: int = 0) -> np.ndarray:
    """The 32 bases from ``pos + offset`` of a strided 2-bit pack as one
    uint64 (first base in the top field); reads past the pack are 0."""
    p = pos + np.uint64(offset)
    w = (p >> np.uint64(4)).astype(np.int64)
    s = (p & np.uint64(15)) * np.uint64(2)
    last = len(words) - 1
    w0 = words[np.minimum(w, last)].astype(np.uint64)
    w1 = words[np.minimum(w + 1, last)].astype(np.uint64)
    w2 = words[np.minimum(w + 2, last)].astype(np.uint64)
    return (((w0 << np.uint64(32)) | w1) << s) | (w2 >> (np.uint64(32) - s))


def large_genome(rng, plants: bool):
    """(strided 2-bit pack of LARGE_BP bases in two segments, seg_starts,
    seg_ends, plant positions): random words made from the seed; with
    ``plants``, LARGE_PLANTS word ranges of 1024 bases copied to 1-7 places each,
    half of them past 2^32, so that k-mers come in groups of 2 to 8 across
    2^32, else the last LARGE_TAIL bases of the two segments made equal."""
    n_words = LARGE_BP // 16
    words = rng.integers(0, 1 << 32, size=n_words + 8, dtype=np.uint32)
    words[n_words:] = 0
    seg_a = LARGE_SEG_A
    starts = np.array([0, seg_a + 1], dtype=np.uint64)
    ends = np.array([seg_a - 1, LARGE_BP - 1], dtype=np.uint64)
    planted = np.zeros(0, dtype=np.uint64)
    if plants:
        span = 64  # words: 1024 bases
        hi_word = (1 << 32) // 16
        src = rng.choice(seg_a // 16 - span, size=LARGE_PLANTS, replace=False)
        chunks = []
        for i, s in enumerate(src):
            n_dst = int(rng.integers(1, 8))
            lo_dst = rng.integers(0, seg_a // 16 - span, size=n_dst // 2)
            hi_dst = rng.integers(hi_word, n_words - span, size=n_dst - n_dst // 2)
            dsts = np.concatenate([lo_dst, hi_dst])
            for d in dsts:
                words[d : d + span] = words[s : s + span]
            offs = 1 + 2 * rng.integers(0, (span * 16 - 32) // 2, size=4)  # odd, inside the range
            for w in np.concatenate([[s], dsts]):
                chunks.append(np.uint64(16 * int(w)) + offs.astype(np.uint64))
        planted = np.unique(np.concatenate(chunks))
    else:
        tail = _ranks2(words, seg_a - LARGE_TAIL, LARGE_TAIL)
        _set_ranks2(words, LARGE_BP - LARGE_TAIL, tail)
    return words, starts, ends, planted


def _even_sample(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` distinct even numbers in [lo, hi) (``lo`` even), ascending, from
    geometric gaps: no sort and no set of the range."""
    slots = (hi - lo) // 2
    p = min(1.0, n / (0.98 * slots))
    idx = np.cumsum(rng.geometric(p, size=n).astype(np.int64)) - 1
    if idx[-1] >= slots:
        raise AssertionError(f"large positions: {n} even starts do not fit in [{lo}, {hi})")
    return np.uint64(lo) + np.uint64(2) * idx.astype(np.uint64)


def large_positions(rng, planted: np.ndarray, n: int) -> np.ndarray:
    """``n`` distinct full-length 31-mer starts in ascending order: the
    planted ones (odd) and even random ones, 30% of all at or past 2^32."""
    n_high = int(0.3 * n)
    n_low = n - n_high - len(planted)
    seg_b = LARGE_SEG_A + 2  # even, past the '$'
    len_a, len_b = LARGE_SEG_A - 32, (1 << 32) - seg_b
    n_a = n_low * len_a // (len_a + len_b)
    pos = np.concatenate([
        _even_sample(rng, 0, LARGE_SEG_A - 32, n_a),
        _even_sample(rng, seg_b, 1 << 32, n_low - n_a),
        _even_sample(rng, 1 << 32, LARGE_BP - 32, n_high),
    ])
    return np.insert(pos, np.searchsorted(pos, planted), planted)


def large_past_ceiling(rng, m1, m4) -> dict:
    """18b: a genome of two segments and LARGE_BP bases (past 2^32) as a
    strided pack, never an SBA; LARGE_POSITIONS 31-mer starts, 30% past
    2^32, sorted on one shard and on four and held to a host oracle
    (np.lexsort of the 62-bit keys and the positions): sorted positions,
    histogram, total and count_queries of LARGE_QUERIES strings."""
    label = f"LargeKmers past 2^32: {LARGE_BP} bp, {LARGE_POSITIONS} positions (31, 31)"
    t0 = time.perf_counter()
    words, starts, ends, planted = large_genome(rng, plants=True)
    pos = large_positions(rng, planted, LARGE_POSITIONS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    key = _windows64(words, pos) >> np.uint64(2)
    # the positions ascend, so a stable sort by the key alone is the
    # lexsort of (key, position)
    order = np.lexsort((key,))
    want_pos, ks = pos[order], key[order]
    del key, order
    shuffled = rng.permutation(pos)  # the sort's input, in no order
    bnd = np.concatenate([[True], ks[1:] != ks[:-1]])
    sizes = np.diff(np.concatenate([np.flatnonzero(bnd), [len(ks)]]))
    del bnd
    want_counts = np.bincount(np.minimum(sizes, 1000000), minlength=1000001).astype(np.uint64)
    t_oracle = time.perf_counter() - t0
    n_past = int(np.sum(pos >= (1 << 32)))
    log(f"{label}: pack of {words.nbytes} bytes and positions made from the seed in {t_gen:.1f} s "
        f"({n_past} positions at or past 2^32, {len(planted)} planted, largest position "
        f"{int(pos.max())}); host oracle (keys, np.lexsort) {t_oracle:.1f} s: {len(sizes)} groups, "
        f"largest {int(sizes.max())}, {int(np.sum(sizes >= 2))} of 2 or more")
    # queries: k-mers of sorted rows and random ones; their oracle counts
    sample = want_pos[rng.integers(0, len(want_pos), size=LARGE_QUERIES // 2)]
    q_win = decode_strided_np(words, sample, 31, True)
    q_rand = ACGT[rng.integers(0, 4, size=(LARGE_QUERIES // 2, 31))]
    q_all = np.concatenate([q_win, q_rand])
    queries = as_queries(q_all)
    q_key = np.zeros(len(q_all), dtype=np.uint64)
    for j in range(31):
        q_key = (q_key << np.uint64(2)) | RANK2_TABLE[q_all[:, j]].astype(np.uint64)
    oracle = dict(zip(q_key.tolist(), (np.searchsorted(ks, q_key, side="right")
                                       - np.searchsorted(ks, q_key, side="left")).tolist()))
    want_q = np.array([oracle[k] for k in q_key.tolist()], dtype=np.uint64)
    del ks
    launches = {}
    lk = gkt.LargeKmers(words, starts, ends, 31, 31)
    _, t_upload = sync_time(lambda: lk._packed(m1))
    log(f"{label}: the pack's upload to the card {t_upload:.4f} s "
        f"({words.nbytes / t_upload / 1e9:.2f} GB/s)")
    for mesh, shards in ((m1, 1), (m4, MESH_SHARDS)):
        where = f"{label}, {shards} shard{'s' if shards > 1 else ''}"
        held_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_sort, n_launch, info = large_sort(lk, mesh, where, positions=shuffled)
        launches[where] = n_launch
        if not np.array_equal(lk.sorted_positions(), want_pos):
            raise AssertionError(f"{where}: the sorted positions differ from the host oracle")
        (got, total), t_counts = sync_time(lambda: lk.get_kmer_group_counts(31))
        count, t_count = sync_time(lambda: lk.get_kmer_count(31, min_group_size=2))
        if not (np.array_equal(got, want_counts) and total == len(pos)
                and count == int(np.sum(sizes[sizes >= 2]))):
            raise AssertionError(f"{where}: the histogram or the totals differ from the host oracle")
        got_q, t_q = sync_time(lambda: lk.count_queries(queries))
        if not np.array_equal(got_q, want_q):
            raise AssertionError(f"{where}: count_queries differs from the oracle's counts")
        log(f"{where}: sort {t_sort:.4f} s = {len(pos) / t_sort / 1e6:.1f} M k-mers/s, rows by "
            f"shard {info['rows']}; "
            f"get_kmer_group_counts(31) {t_counts:.4f} s, get_kmer_count(31, min_group_size=2) "
            f"{t_count:.4f} s, count_queries of {len(queries)} {t_q:.4f} s "
            f"({int(np.count_nonzero(got_q))} found); equal to the host oracle; lane sort launches "
            f"{n_launch}")
        log_peak(where, held_before)
    del lk, words, pos, shuffled, want_pos
    torch.cuda.empty_cache()
    return launches


def large_suffix_past_ceiling(rng, m1) -> dict:
    """18b, suffix mode (1, None) at LARGE_SUFFIX_POSITIONS positions of a
    genome past 2^32 whose two segments end in the same LARGE_TAIL bases,
    with 120 mirrored pairs in the shared tails, against a host oracle of
    320-base prefixes capped at each segment's end."""
    label = f"LargeKmers suffix mode past 2^32: {LARGE_BP} bp, {LARGE_SUFFIX_POSITIONS} positions"
    words, starts, ends, _ = large_genome(rng, plants=False)
    seg_a, L = LARGE_SEG_A, LARGE_BP
    n_pairs = 120
    n_rand = LARGE_SUFFIX_POSITIONS - 2 * n_pairs
    pos_a = rng.choice(seg_a - LARGE_TAIL - 64, size=n_rand // 2, replace=False).astype(np.uint64)
    pos_b = np.uint64(seg_a + 1) + rng.choice(L - seg_a - 1 - LARGE_TAIL - 64, size=n_rand - n_rand // 2,
                                              replace=False).astype(np.uint64)
    depths = rng.choice(np.arange(1, LARGE_TAIL + 1), size=n_pairs, replace=False).astype(np.uint64)
    pos = np.concatenate([pos_a, pos_b, np.uint64(seg_a) - depths, np.uint64(L) - depths])
    rng.shuffle(pos)
    # oracle: ten 32-base words of each suffix, zero past its end, then its
    # capped length and the position (a byte-string order)
    nat = (ends[(pos > np.uint64(seg_a)).astype(np.int64)] - pos + np.uint64(1)).astype(np.int64)
    cols = []
    for j in range(10):
        keep = np.clip(nat - 32 * j, 0, 32).astype(np.uint64)
        mask = np.where(keep == 0, np.uint64(0),
                        ~np.uint64(0) << (np.uint64(64) - np.uint64(2) * np.maximum(keep, 1)))
        cols.append(_windows64(words, pos, 32 * j) & mask)
    capped = np.minimum(nat, 320)
    order = np.lexsort([pos, capped] + cols[::-1])
    want_pos = pos[order]
    ident = np.stack([c[order] for c in cols] + [nat[order].astype(np.uint64)], axis=1)
    bnd = np.concatenate([[True], (ident[1:] != ident[:-1]).any(axis=1)])
    sizes = np.diff(np.concatenate([np.flatnonzero(bnd), [len(pos)]]))
    want_counts = np.bincount(np.minimum(sizes, 10), minlength=11).astype(np.uint64)
    if want_counts[2] != n_pairs:
        raise AssertionError(f"{label}: the oracle finds {want_counts[2]} pairs, not {n_pairs}")
    w31 = cols[0][order] >> np.uint64(2)
    c31 = np.minimum(nat[order], 31).astype(np.uint64)
    s31 = np.lexsort((c31, w31))
    b31 = np.concatenate([[True], (w31[s31][1:] != w31[s31][:-1]) | (c31[s31][1:] != c31[s31][:-1])])
    sizes31 = np.diff(np.concatenate([np.flatnonzero(b31), [len(pos)]]))
    want31 = np.bincount(np.minimum(sizes31, 10), minlength=11).astype(np.uint64)
    lk = gkt.LargeKmers(words, starts, ends, 1, None)
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_sort, n_launch, info = large_sort(lk, m1, label, positions=pos)
    if not np.array_equal(lk.sorted_positions(), want_pos):
        raise AssertionError(f"{label}: the sorted suffixes differ from the host oracle")
    (got, total), t_counts = sync_time(lambda: lk.get_kmer_group_counts(None, max_counts_bin=10))
    (got31, total31), t_31 = sync_time(lambda: lk.get_kmer_group_counts(31, max_counts_bin=10))
    if not (np.array_equal(got, want_counts) and total == len(pos)
            and np.array_equal(got31, want31) and total31 == len(pos)):
        raise AssertionError(f"{label}: the histograms differ from the host oracle")
    log(f"{label}: sort {t_sort:.4f} s in {info['rounds_log'].summary()} ({info['rounds']} rounds); "
        f"get_kmer_group_counts(None) {t_counts:.4f} s from the kept run ids ({n_pairs} mirrored "
        f"pairs found), at 31 {t_31:.4f} s; equal to the host oracle; lane sort launches {n_launch}")
    log_peak(label, held_before)
    del lk, words
    torch.cuda.empty_cache()
    return {label: n_launch}


def phase_large(host_acgt, host_iupac, positions, counts, canonical_ref, rng_seed: int) -> dict:
    """Phase 18: LargeKmers at full width (18a: the main path's genomes
    through the large regime; 18b: a genome past 2^32 bases). Returns the
    lane sort's launches by path, and the histogram kernel's (18a)."""
    rng = np.random.default_rng(rng_seed)
    t0 = time.perf_counter()
    m1 = make_mesh(1)
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    out, hist = {}, {}
    for host_sc, name in ((host_acgt, "ACGT"), (host_iupac, "IUPAC")):
        sort_l, hist_l = large_main(host_sc, name, positions[name], counts[name],
                                    canonical_ref[name], m1, m4)
        out.update(sort_l)
        hist.update(hist_l)
        torch.cuda.empty_cache()
    out.update(large_suffix_small(rng, m1))
    t_a = time.perf_counter() - t0
    out.update(large_past_ceiling(rng, m1, m4))
    out.update(large_suffix_past_ceiling(rng, m1))
    if any(n < 1 for n in out.values()):
        raise AssertionError(f"phase 18: the lane sort did not launch on a path: {out}")
    log(f"LargeKmers phase: 18a {t_a:.1f} s, 18b {time.perf_counter() - t0 - t_a:.1f} s")
    return {"sort_lanes_cuda": out, "group_size_hist_cuda": hist}


# --------------------------------------------------------------------------- #
# phase 19: meshes that span processes
# --------------------------------------------------------------------------- #

# what phase 19 is held to, filled in by the earlier phases: the 4-shard
# mesh layouts of phase 15 and the 2-D layout of phase 17 (digests), phase
# 15's GC-filtered totals and phase 14's queries with their counts
REFERENCES = {}
RANK_COMMAND = [sys.executable, str(Path(__file__).resolve()), "--rank"]
RANK_TIMEOUT = 420  # seconds a launch of ranks may take before the phase fails
PROCESS_SUFFIX_BP = 1 << 24  # phase 19 (d)
BALANCE = 2.0  # a refinement round leaves no shard more than twice the mean rows


def digest(a: np.ndarray) -> str:
    return hashlib.blake2b(memoryview(np.ascontiguousarray(a)).cast("B"), digest_size=16).hexdigest()


def layout_digests(positions: list, is_pad: list) -> list:
    """Per shard, digests of its positions (uint32) and its pad flags."""
    return [(digest(p.cpu().numpy().astype(np.uint32)), digest(d.cpu().numpy().view(np.uint8)))
            for p, d in zip(positions, is_pad)]


def check_balance(round_rows: list, n_rows: int, label: str) -> str:
    """Each refinement round's largest shard against the mean; raises past
    ``BALANCE`` times the mean. Returns the per-round shares for the log."""
    shares = [max(rows) / max(sum(rows), 1) for rows in round_rows]
    n_shards = len(round_rows[0])
    for r, rows in enumerate(round_rows[1:], start=1):
        if max(rows) > BALANCE * -(-n_rows // n_shards):
            raise AssertionError(f"{label}: round {r} leaves {max(rows)} of {n_rows} rows on one "
                                 f"of {n_shards} shards")
    shown = ", ".join(f"{x:.4f}" for x in shares)
    return (f"largest shard's share of the real rows by round (round 0 first; mean "
            f"{1 / n_shards:.4f}, bound {BALANCE / n_shards:.4f}): {shown}")


class RankSteps:
    """``on_step`` of a rank: per step name, the seconds (after a
    synchronise), the peak device memory of the rank and its kernel
    launches, summed over calls."""

    def __init__(self):
        self.steps = {}
        torch.cuda.synchronize()
        self.t = time.perf_counter()
        self.launches = pack_rank2_words_cuda.launches + sort_lanes_cuda.launches

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        launches = pack_rank2_words_cuda.launches + sort_lanes_cuda.launches
        s, peak, n = self.steps.get(name, (0.0, 0, 0))
        self.steps[name] = (s + now - self.t, max(peak, torch.cuda.max_memory_allocated()),
                            n + launches - self.launches)
        self.t, self.launches = now, launches


def rank_collection(tmp: Path, key: str, k_min, k_max):
    """A rank's own collection (own upload and pack) from the host arrays
    the parent wrote, and its Kmers."""
    names = json.loads((tmp / f"{key}-names.json").read_text())
    return from_numpy_state(np.load(tmp / f"{key}-sba.npy"), np.load(tmp / f"{key}-starts.npy"),
                            names, k_min, k_max, device=f"{DEVICE}:0")


def rank_sort(sc, km, mesh, out: dict, label: str) -> None:
    """``km.sort(mesh=mesh)`` on a rank, step by step, with its launches
    counted from 0 (the upload and the pack included); records the seconds,
    steps, launches, staging and the layout's digests in ``out[label]``."""
    reset_launches()
    collectives.reset_traffic()
    torch.cuda.reset_peak_memory_stats()
    steps, info = RankSteps(), {}
    (_, seconds) = sync_time(lambda: km.sort(mesh=mesh, on_step=steps, mesh_info=info))
    out[label] = {
        "seconds": seconds, "steps": steps.steps, "info": info,
        "launches": launches_now(),
        "traffic": dict(collectives.TRAFFIC), "peak": torch.cuda.max_memory_allocated(),
        "layout": layout_digests(km._dist_cache.positions, km._dist_cache.is_pad),
        "on_card": all(p.device.type == DEVICE for p in km._dist_cache.positions),
    }


def rank_index(km, mesh, out: dict, label: str) -> None:
    """The mesh statistics of a sorted index on a rank."""
    (counts, total), t_stats = sync_time(lambda: km.get_kmer_group_counts(31, mesh=mesh))
    count, t_count = sync_time(lambda: km.get_kmer_count(31, mesh=mesh))
    out[label].update(counts=counts, total=total, count=count, t_stats=t_stats, t_count=t_count)


def rank_run_nccl(rank: int, world: int, tmp: Path) -> dict:
    """(a): one rank over NCCL, the 4 local shards of phase 15 on the card."""
    mesh = make_mesh(devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    out = {}
    for key in ("ACGT", "IUPAC"):
        sc, km = rank_collection(tmp, key, 31, 31)
        rank_sort(sc, km, mesh, out, key)
        rank_index(km, mesh, out, key)
        out[key]["index"] = digest(km.kmer_sba_start_indices)
        del sc, km
        torch.cuda.empty_cache()
    return out


def rank_oddeven(sc, mesh, out: dict) -> None:
    """The odd-even merge sort of every (31, 31) start of a rank's ACGT
    collection over the process mesh; records the seconds, the rows'
    digest, the launches, the staging and the peak in ``out["oddeven"]``."""
    dc = sc.device_cache("forward")
    pos = torch.from_numpy(gkt.Kmers(sc, 31, 31).kmer_sba_start_indices.astype(np.int64)).to(dc.device)
    reset_launches()
    collectives.reset_traffic()
    torch.cuda.reset_peak_memory_stats()
    got, seconds = sync_time(lambda: distributed_sort_positions(
        None, pos, dc.seg_starts, dc.seg_ends, 31, mesh, packed2=dc.packed2))
    out["oddeven"] = {
        "seconds": seconds, "rows": digest(got.cpu().numpy().astype(np.uint32)),
        "launches": launches_now(),
        "traffic": dict(collectives.TRAFFIC), "peak": torch.cuda.max_memory_allocated(),
    }


def rank_run_gloo4(rank: int, world: int, tmp: Path) -> dict:
    """(b) and (d): 4 ranks over Gloo, one shard of the card each."""
    mesh = make_mesh(devices=[f"{DEVICE}:0"])
    out = {}
    for key in ("ACGT", "IUPAC"):
        sc, km = rank_collection(tmp, key, 31, 31)
        rank_sort(sc, km, mesh, out, key)
        rank_index(km, mesh, out, key)
        gc = GcContentFilter(0.3, 0.7, 31)
        out[key]["gc"], out[key]["t_gc"] = sync_time(
            lambda: km.get_kmer_count(31, kmer_filter_func=gc, mesh=mesh))
        with open(tmp / f"{key}-queries.pkl", "rb") as f:
            queries = pickle.load(f)
        got, out[key]["t_queries"] = sync_time(lambda: km.count_queries(queries, 31, mesh=mesh))
        canon = km.count_queries_canonical(queries, 31, mesh=mesh)
        out[key]["queries"] = (digest(got), digest(canon))
        out[key]["index"] = digest(km.kmer_sba_start_indices)
        del km
        # LargeKmers (31, 31) on the same ranks
        lk = gkt.LargeKmers.from_sequence_collection(sc, 31, 31)
        reset_launches()
        steps = RankSteps()
        (_, t_large) = sync_time(lambda: lk.sort(mesh, on_step=steps))
        out[f"{key} large"] = {
            "seconds": t_large, "steps": steps.steps, "launches": launches_now(),
            "rows": digest(lk.sorted_positions().astype(np.uint32)),
            "counts": lk.get_kmer_group_counts(31)[0].astype(np.int64)}
        del lk
        if key == "ACGT":  # the odd-even merge sort over the same ranks (phase 20 (d))
            rank_oddeven(sc, mesh, out)
        del sc
        torch.cuda.empty_cache()
    # (d) suffix mode at PROCESS_SUFFIX_BP, the refinement rounds balanced
    sc, km = rank_collection(tmp, "suffix", 1, None)
    rounds = RoundLog()
    reset_launches()
    collectives.reset_traffic()
    torch.cuda.reset_peak_memory_stats()
    steps, info = RankSteps(), {}
    (_, seconds) = sync_time(lambda: km.sort(mesh=mesh, on_round=rounds, on_step=steps,
                                             mesh_info=info))
    counts, total = km.get_kmer_group_counts(None, mesh=mesh)
    index = km.kmer_sba_start_indices
    if rank == 0:
        np.save(tmp / "suffix-index.npy", index)
    out["suffix"] = {
        "seconds": seconds, "steps": steps.steps, "info": info, "rounds": len(rounds.rounds),
        "round_seconds": [t for _, t, _ in rounds.rounds],
        "launches": launches_now(),
        "traffic": dict(collectives.TRAFFIC), "peak": torch.cuda.max_memory_allocated(),
        "counts": counts, "total": total,
    }
    return out


def rank_run_gloo2x2(rank: int, world: int, tmp: Path) -> dict:
    """(c): 2 ranks over Gloo as make_mesh2(2, 2), a node a rank, then a
    sharded checkpoint loaded onto one shard a rank."""
    mesh2 = make_mesh2(2, 2, devices=[f"{DEVICE}:0"] * 2)
    out = {}
    sc, km = rank_collection(tmp, "ACGT", 31, 31)
    rank_sort(sc, km, mesh2, out, "ACGT")
    rank_index(km, mesh2, out, "ACGT")
    path = tmp / "c-checkpoint"
    (_, t_save) = sync_time(lambda: save_kmers_sharded(km, path))
    km2 = gkt.Kmers(sc, 31, 31)
    mesh1 = make_mesh(devices=[f"{DEVICE}:0"])
    (_, t_load) = sync_time(lambda: load_kmers_sharded(km2, path, mesh=mesh1))
    counts, _ = km2.get_kmer_group_counts(31, mesh=mesh1)
    out["checkpoint"] = {"rows": digest(km2.kmer_sba_start_indices), "counts": counts,
                         "t_save": t_save, "t_load": t_load}
    return out


RANK_RUNS = {"a": ("nccl", rank_run_nccl), "b": ("gloo", rank_run_gloo4),
             "c": ("gloo", rank_run_gloo2x2)}


def rank_main(argv: list) -> None:
    """One rank of phase 19: ``chip_smoke.py --rank RUN RANK WORLD PORT DIR``.
    Writes its results to DIR/RUN-rankRANK.pkl; any failure exits 1."""
    import torch.distributed as dist

    run, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), Path(argv[4])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: CUDA is not available")
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    backend, body = RANK_RUNS[run]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        out = body(rank, world, tmp)
    finally:
        dist.destroy_process_group()
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("a rank imported jax")
    with open(tmp / f"{run}-rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(run: str, world: int, tmp: Path) -> list:
    """Start ``world`` fresh rank processes of ``run``, wait for all of them
    (at most RANK_TIMEOUT seconds), kill any left, and return their
    results; a rank that fails or hangs fails the phase."""
    port = free_port()
    procs = []
    for rank in range(world):
        log_file = open(tmp / f"{run}-rank{rank}.log", "wb")
        procs.append((subprocess.Popen(RANK_COMMAND + [run, str(rank), str(world), str(port), str(tmp)],
                                       stdout=log_file, stderr=subprocess.STDOUT), log_file))
    t0 = time.perf_counter()
    codes = []
    try:
        for proc, _ in procs:
            codes.append(proc.wait(timeout=max(RANK_TIMEOUT - (time.perf_counter() - t0), 1)))
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for proc, log_file in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} ---\n"
                          + (tmp / f"{run}-rank{r}.log").read_text(errors="replace")[-4000:]
                          for r in range(world))
        raise AssertionError(f"phase 19 ({run}): rank exit codes {codes} (None: a rank passed "
                             f"{RANK_TIMEOUT} s)\n{tails}")
    log(f"phase 19 ({run}): {world} rank{'s' if world > 1 else ''} done in "
        f"{time.perf_counter() - t0:.1f} s (process start, CUDA context and the rank's own collections included)")
    results = []
    for rank in range(world):
        with open(tmp / f"{run}-rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def write_host_arrays(tmp: Path, key: str, host_sc) -> None:
    sba, seg_starts = index_sba(host_sc)
    np.save(tmp / f"{key}-sba.npy", sba)
    np.save(tmp / f"{key}-starts.npy", seg_starts)
    (tmp / f"{key}-names.json").write_text(json.dumps(list(host_sc.forward_record_names)))


def step_log(steps: dict) -> str:
    return ", ".join(f"{name} {s:.4f} s (peak {peak / 2**30:.2f} GiB, {n} launches)"
                     for name, (s, peak, n) in steps.items())


def sum_launches(results: list, key: str) -> dict:
    return {name: sum(r[key]["launches"][name] for r in results)
            for name in ("pack_rank2_words_cuda", "sort_lanes_cuda")}


def check_sorted_run(results: list, key: str, layout: list, positions, counts31, label: str) -> None:
    """A process-mesh sort: every shard's layout against ``layout`` (digests
    in global shard order), the host index against ``positions``, the
    histogram, total and count against ``counts31`` on every rank."""
    got = [d for r in results for d in r[key]["layout"]]
    if got != layout:
        raise AssertionError(f"{label}: the shards' layouts differ from the single-process mesh's")
    for r in results:
        res = r[key]
        if res["index"] != digest(positions):
            raise AssertionError(f"{label}: the host index is not the sorted positions")
        if not (np.array_equal(res["counts"], counts31) and res["total"] == res["count"] == len(positions)):
            raise AssertionError(f"{label}: the histogram or the count differs from the main path's")
        if not res["on_card"]:
            raise AssertionError(f"{label}: the layout does not live on the card")


def log_rank_sort(results: list, key: str, label: str) -> None:
    for rank, r in enumerate(results):
        res = r[key]
        traffic = res["traffic"]
        log(f"{label}, rank {rank}: sort(mesh) {res['seconds']:.4f} s, real rows by shard "
            f"{res['info']['rows']}; steps: {step_log(res['steps'])}; collectives {traffic['collectives']}, "
            f"{traffic['device_bytes']} bytes from card tensors, {traffic['host_bytes']} from host "
            f"tensors, {traffic['staged_bytes']} bytes staged between card and host in "
            f"{traffic['staging_seconds']:.4f} s; statistics {res['t_stats']:.4f} s, count "
            f"{res['t_count']:.4f} s; peak {res['peak'] / 2**30:.3f} GiB; launches {res['launches']}")


def phase_process_mesh(host_acgt, host_iupac, positions, counts, rng_seed: int) -> dict:
    """Phase 19: the mesh across processes on one card. (a) NCCL, one rank
    of 4 local shards; (b) Gloo, 4 ranks of one shard: (31, 31) on both
    genomes, the GC-filtered count, queries, LargeKmers; (c) Gloo, 2 ranks
    of 2 shards as make_mesh2(2, 2), a sharded checkpoint loaded onto one
    shard a rank; (d) suffix mode at PROCESS_SUFFIX_BP on the ranks of (b).
    Returns the launches of both kernels by path."""
    rng = np.random.default_rng(rng_seed)
    t0 = time.perf_counter()
    out = {"pack_rank2_words_cuda": {}, "sort_lanes_cuda": {}}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        for key, host_sc in (("ACGT", host_acgt), ("IUPAC", host_iupac)):
            write_host_arrays(tmp, key, host_sc)
            queries, _, _ = REFERENCES[f"queries {key}"]
            with open(tmp / f"{key}-queries.pkl", "wb") as f:
                pickle.dump(queries, f)
        suffix_sc = collection_of(synthetic_records(rng, PROCESS_SUFFIX_BP, 12))
        write_host_arrays(tmp, "suffix", suffix_sc)
        single = gkt.Kmers(suffix_sc)
        single_rounds, t_single = timed_sort(single)
        suffix_ref = (single.kmer_sba_start_indices.copy(), single.get_kmer_group_counts(None))
        del single, suffix_sc
        torch.cuda.empty_cache()
        log(f"phase 19: host arrays written, suffix reference at {PROCESS_SUFFIX_BP} bp sorted on one "
            f"card in {t_single:.4f} s ({len(single_rounds.rounds)} rounds), {time.perf_counter() - t0:.1f} s")

        # (a) NCCL, one rank, 4 local shards
        results = launch_ranks("a", 1, tmp)
        for key in ("ACGT", "IUPAC"):
            label = f"process mesh (a) NCCL 1 rank x {MESH_SHARDS} shards, {key} 2^27 (31, 31)"
            check_sorted_run(results, key, REFERENCES[f"mesh layout {key}"], positions[key],
                             counts[key], label)
            traffic = results[0][key]["traffic"]
            if DEVICE == "cuda" and (traffic["device_bytes"] < 1 or traffic["host_bytes"]
                                     or traffic["staged_bytes"]):
                raise AssertionError(f"{label}: the NCCL collectives moved host tensors ({traffic})")
            log_rank_sort(results, key, label)
            for name, n in sum_launches(results, key).items():
                out[name][label] = n
        # (b) and (d): Gloo, 4 ranks of one shard
        results = launch_ranks("b", MESH_SHARDS, tmp)
        for key in ("ACGT", "IUPAC"):
            label = f"process mesh (b) Gloo {MESH_SHARDS} ranks x 1 shard, {key} 2^27 (31, 31)"
            check_sorted_run(results, key, REFERENCES[f"mesh layout {key}"], positions[key],
                             counts[key], label)
            _, q_counts, q_canon = REFERENCES[f"queries {key}"]
            for r in results:
                res = r[key]
                if res["gc"] != REFERENCES[f"gc {key}"]:
                    raise AssertionError(f"{label}: the GC-filtered count differs from phase 15's")
                if res["queries"] != (digest(q_counts), digest(q_canon)):
                    raise AssertionError(f"{label}: count_queries differ from phase 14's counts")
                large = r[f"{key} large"]
                if large["rows"] != digest(positions[key]) or not np.array_equal(large["counts"], counts[key]):
                    raise AssertionError(f"{label}: LargeKmers' rows or histogram differ from phase 18a's")
                traffic = res["traffic"]
                if DEVICE == "cuda" and (traffic["staged_bytes"] < 1 or traffic["device_bytes"]):
                    raise AssertionError(f"{label}: Gloo moved card tensors unstaged ({traffic})")
            log_rank_sort(results, key, label)
            log(f"{label}: GC-filtered count {results[0][key]['gc']} ({results[0][key]['t_gc']:.4f} s), "
                f"count_queries of {len(q_counts)} {results[0][key]['t_queries']:.4f} s, both equal to "
                f"phases 15 and 14; LargeKmers (31, 31) sort " + ", ".join(
                    f"rank {i} {r[f'{key} large']['seconds']:.4f} s" for i, r in enumerate(results))
                + " equal to phase 18a's rows and histogram; steps of rank 0: "
                + step_log(results[0][f"{key} large"]["steps"]))
            for name, n in sum_launches(results, key).items():
                out[name][label] = n
            out["sort_lanes_cuda"][f"{label}, LargeKmers"] = sum_launches(
                results, f"{key} large")["sort_lanes_cuda"]
        label = f"odd-even merge sort (phase 20 (d)), Gloo {MESH_SHARDS} ranks x 1 shard, ACGT 2^27 (31, 31)"
        for rank, r in enumerate(results):
            res = r["oddeven"]
            if res["rows"] != digest(positions["ACGT"]):
                raise AssertionError(f"{label}: rank {rank}'s positions differ from phase 4's")
            log(f"{label}, rank {rank}: {res['seconds']:.4f} s, equal to phase 4's positions; "
                f"collectives {res['traffic']['collectives']}, {res['traffic']['staged_bytes']} bytes "
                f"staged between card and host in {res['traffic']['staging_seconds']:.4f} s; peak "
                f"{res['peak'] / 2**30:.3f} GiB; launches {res['launches']}")
        out["sort_lanes_cuda"][label] = sum(r["oddeven"]["launches"]["sort_lanes_cuda"] for r in results)
        label = f"process mesh (d) Gloo {MESH_SHARDS} ranks, ACGT suffix mode at {PROCESS_SUFFIX_BP} bp"
        want_index, (want_counts, want_total) = suffix_ref
        if not np.array_equal(np.load(tmp / "suffix-index.npy"), want_index):
            raise AssertionError(f"{label}: the positions differ from one card's sort")
        for rank, r in enumerate(results):
            res = r["suffix"]
            if not (np.array_equal(res["counts"], want_counts) and res["total"] == want_total):
                raise AssertionError(f"{label}: the histogram at None differs from one card's")
            later = res["round_seconds"][1:]
            log(f"{label}, rank {rank}: sort(mesh) {res['seconds']:.4f} s in {res['rounds']} rounds "
                f"({np.mean(later):.4f} s a round after the first) against one card's {t_single:.4f} s; "
                f"steps: {step_log(res['steps'])}; {res['traffic']['staged_bytes']} bytes staged in "
                f"{res['traffic']['staging_seconds']:.4f} s; peak {res['peak'] / 2**30:.3f} GiB")
        log(f"{label}: {check_balance(results[0]['suffix']['info']['round_rows'], len(want_index), label)}; "
            "positions and the histogram at None equal one card's")
        for name, n in sum_launches(results, "suffix").items():
            out[name][label] = n
        # (c) Gloo, 2 ranks of 2 shards as make_mesh2(2, 2)
        results = launch_ranks("c", 2, tmp)
        label = "process mesh (c) Gloo make_mesh2(2, 2), a node a rank, ACGT 2^27 (31, 31)"
        got = [d for r in results for d in r["ACGT"]["layout"]]
        if got != REFERENCES["mesh2 layout ACGT"]:
            raise AssertionError(f"{label}: the layouts differ from phase 17's make_mesh2(2, 2) layouts")
        for r in results:
            res = r["ACGT"]
            if not (np.array_equal(res["counts"], counts["ACGT"]) and res["total"] == res["count"]):
                raise AssertionError(f"{label}: the histogram differs from phase 4's")
            ckpt = r["checkpoint"]
            if ckpt["rows"] != digest(positions["ACGT"]) or not np.array_equal(ckpt["counts"], counts["ACGT"]):
                raise AssertionError(f"{label}: the checkpoint loaded onto 2 ranks x 1 shard differs")
        log_rank_sort(results, "ACGT", label)
        log(f"{label}: sharded checkpoint saved in {results[0]['checkpoint']['t_save']:.4f} s, loaded onto "
            f"2 ranks x 1 shard in {results[0]['checkpoint']['t_load']:.4f} s, the rows and histogram equal")
        for name, n in sum_launches(results, "ACGT").items():
            out[name][label] = n
    if any(n < 1 for n in out["sort_lanes_cuda"].values()) or any(
            n < 1 for label, n in out["pack_rank2_words_cuda"].items() if "ACGT" in label):
        raise AssertionError(f"phase 19: a kernel did not launch on a path: {out}")
    log(f"process mesh phase: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 20: the opt-in sorts
# --------------------------------------------------------------------------- #

OPT_IN_REPS = 3  # warm calls of each timed sort; their median is reported


def warm_median(fn, reps: int = OPT_IN_REPS):
    """(the last output, the median seconds of ``reps`` calls), host clock
    after a synchronise."""
    times, out = [], None
    for _ in range(reps):
        out = None  # the previous call's output is not held during the next
        out, t = sync_time(fn)
        times.append(t)
    return out, float(np.median(times))


def warm_median_peak(fn, reps: int = OPT_IN_REPS):
    """``warm_median`` and the peak device memory of those calls above what
    was held before them."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, t = warm_median(fn, reps)
    return out, t, torch.cuda.max_memory_allocated() - held


def starts_of(sc) -> torch.Tensor:
    """Every (31, 31) start of the collection, ascending, int64 on the card."""
    pos = gkt.Kmers(sc, 31, 31).kmer_sba_start_indices
    return torch.from_numpy(pos.astype(np.int64)).to(DEVICE)


def check_positions(got: torch.Tensor, want: np.ndarray, label: str) -> None:
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError(f"{label}: the sorted positions differ from the main path's")


def fresh_collection(host_sc):
    """A collection of its own (its own upload and pack to come) from the
    host arrays."""
    sba, seg_starts = index_sba(host_sc)
    sc, _ = from_numpy_state(sba, seg_starts, host_sc.forward_record_names, 31, 31, device=DEVICE)
    return sc


def opt_in_hybrid(host_iupac, expected: np.ndarray) -> dict:
    """(a): the hybrid sort of every (31, 31) start of the IUPAC main path,
    its steps, and the 4-bit routes; returns the launches of its path."""
    label = "hybrid sort, IUPAC main path 2^27 (31, 31)"
    dc = host_iupac.device_cache("forward")
    pos = starts_of(host_iupac)
    caps = lambda p: hybrid._caps_of(p, dc.seg_starts, dc.seg_ends, 31)  # noqa: E731

    def run():  # packed2_any is built on the first call, by the pack kernel
        return hybrid.hybrid_sort_positions(dc.packed, dc.packed2_any, pos, dc.seg_starts,
                                            dc.seg_ends, 31, dc.next_amb, uniform_cap=True)

    _ = dc.packed, dc.next_amb  # the main path's, built before
    reset_launches()
    got, t_cold = sync_time(run)
    launches = launches_now()
    check_positions(got, expected, label)
    if launches["pack_rank2_words_cuda"] != 1 or launches["sort_lanes_cuda"] != 2:
        raise AssertionError(f"{label}: expected one pack and two lane sorts, got {launches}")
    _, t_warm, peak = warm_median_peak(run)
    # step by step
    (m_pos, a_pos), t_split = warm_median(
        lambda: hybrid._split(pos, hybrid.ambiguity_mask(dc.next_amb, pos, caps(pos))))
    m_sorted, t_major = warm_median(lambda: sort_positions(
        None, m_pos, caps(m_pos), 31, packed2=dc.packed2_any, uniform_cap=True))
    a_sorted, t_minor = warm_median(lambda: sort_positions(dc.packed, a_pos, caps(a_pos), 31))
    ins, t_ins = warm_median(lambda: hybrid._insertion_ranks_impl(
        dc.packed, m_sorted, caps(m_sorted), a_sorted, caps(a_sorted), 4))
    merged, t_inter = warm_median(lambda: hybrid._interleave(m_sorted, a_sorted, ins))
    check_positions(merged, expected, f"{label}, step by step")
    share = a_pos.shape[0] / pos.shape[0]
    del m_pos, a_pos, m_sorted, a_sorted, ins, merged
    # the 4-bit routes: the gather sort of the same positions, and Kmers.sort()
    four, t_four = warm_median(lambda: sort_positions(dc.packed, pos, caps(pos), 31))
    check_positions(four, expected, f"{label}, 4-bit gather sort")
    del four

    def kmers_sort():
        km = gkt.Kmers(host_iupac, 31, 31)
        km.sort()
        return km

    km, t_kmers = warm_median(kmers_sort)
    if not np.array_equal(km.kmer_sba_start_indices, expected):
        raise AssertionError(f"{label}: Kmers.sort() differs from the main path's")
    del km, pos
    torch.cuda.empty_cache()
    log(f"{label}: ambiguous windows {share:.6f} of {len(expected)}; hybrid_sort_positions "
        f"{t_cold * 1e3:.3f} ms cold (packed2_any built in it), {t_warm * 1e3:.3f} ms warm "
        f"(median of {OPT_IN_REPS}), equal to phase 5's positions; steps (warm medians, ms): split "
        f"{t_split * 1e3:.3f}, majority 2-bit sort {t_major * 1e3:.3f}, minority 4-bit sort "
        f"{t_minor * 1e3:.3f}, insertion ranks {t_ins * 1e3:.3f}, interleave {t_inter * 1e3:.3f}; "
        f"4-bit sort_positions of the same positions {t_four * 1e3:.3f} ms, Kmers.sort() "
        f"{t_kmers * 1e3:.3f} ms; launches {launches}; peak device memory of the warm calls "
        f"{peak / 2**30:.3f} GiB above the collection and the positions")
    return launches


def opt_in_chunked(dc, pos: torch.Tensor, expected: np.ndarray, key: str) -> dict:
    """(b): the chunked sort at the default chunk_rows, beside one sort of
    the same positions; returns the launches counted since the caller set
    them to 0 (the collection's own pack, on 2-bit keys, included)."""
    label = f"chunked sort, {key} 2^27 (31, 31), chunk_rows 2^24"
    two_bit = dc.is_acgt_only
    packed, packed2 = (None, dc.packed2) if two_bit else (dc.packed, None)
    cap_fn = lambda p: cap_lengths(compute_valid_len(p, dc.seg_starts, dc.seg_ends), 31)  # noqa: E731

    def chunked():
        return sort_positions_chunked(packed, pos, cap_fn, 31, packed2=packed2, uniform_cap=two_bit)

    def one_sort():
        return sort_positions(packed, pos, cap_fn(pos), 31, packed2=packed2, uniform_cap=two_bit)

    got, t_cold = sync_time(chunked)
    launches = launches_now()
    check_positions(got, expected, label)
    n_chunks = -(-pos.shape[0] // (1 << 24))
    if launches["sort_lanes_cuda"] < 2 * n_chunks + 1 or (two_bit and launches["pack_rank2_words_cuda"] < 1):
        raise AssertionError(f"{label}: a kernel of the path did not launch ({launches})")
    del got
    _, t_warm, peak = warm_median_peak(chunked)
    one, t_one_cold = sync_time(one_sort)
    check_positions(one, expected, f"{label}, one sort")
    del one
    _, t_one, peak_one = warm_median_peak(one_sort)
    log(f"{label}: {n_chunks} chunks; sort_positions_chunked {t_cold * 1e3:.3f} ms cold, "
        f"{t_warm * 1e3:.3f} ms warm (median of {OPT_IN_REPS}), peak device memory "
        f"{peak / 2**30:.3f} GiB above the collection and the positions; one sort_positions of "
        f"the same positions {t_one * 1e3:.3f} ms warm ({t_one_cold * 1e3:.3f} ms cold), peak "
        f"{peak_one / 2**30:.3f} GiB; both equal to the main path's positions; launches {launches}")
    return launches


def opt_in_oddeven(dc, pos: torch.Tensor, expected: np.ndarray, key: str, mesh,
                   mesh_name: str) -> dict:
    """(c): the odd-even merge sort, beside the sample sort of the same
    positions on the same mesh; returns the launches of its sort."""
    label = f"odd-even merge sort, {mesh_name}, {key} 2^27 (31, 31)"
    two_bit = dc.is_acgt_only
    packed, packed2 = (None, dc.packed2) if two_bit else (dc.packed, None)

    def oddeven():
        return distributed_sort_positions(packed, pos, dc.seg_starts, dc.seg_ends, 31, mesh,
                                          packed2=packed2)

    def sample():  # the sample sort's layout on the shards, as Kmers.sort(mesh=) keeps it
        return sample_sort_positions_ragged(packed, pos, dc.seg_starts, dc.seg_ends, 31, mesh,
                                            packed2=packed2, uniform_cap=two_bit)

    reset_launches()
    got, t_cold = sync_time(oddeven)
    launches = launches_now()
    check_positions(got, expected, label)
    n_dev = mesh.n_shards
    merges = sum(2 * (n_dev // 2) if phase % 2 == 0 else 2 * ((n_dev - 1) // 2)
                 for phase in range(n_dev))
    if launches["sort_lanes_cuda"] != n_dev + merges:
        raise AssertionError(f"{label}: expected {n_dev} local sorts and {merges} merges through "
                             f"the lane sort, got {launches}")
    del got
    _, t_warm, peak = warm_median_peak(oddeven)
    (rag_pos, rag_pad), t_sample_cold = sync_time(sample)
    if not np.array_equal(ragged_rows(rag_pos, rag_pad), expected):
        raise AssertionError(f"{label}, sample sort: the real rows differ from the main path's")
    del rag_pos, rag_pad
    _, t_sample, peak_sample = warm_median_peak(sample)
    log(f"{label}: distributed_sort_positions {t_cold * 1e3:.3f} ms cold, {t_warm * 1e3:.3f} ms "
        f"warm (median of {OPT_IN_REPS}), peak {peak / 2**30:.3f} GiB above the collection and "
        f"the positions, equal to the main path's positions; the sample sort (phase 15's route) "
        f"of the same positions to its layout on the shards {t_sample * 1e3:.3f} ms warm "
        f"({t_sample_cold * 1e3:.3f} ms cold), peak {peak_sample / 2**30:.3f} GiB; launches {launches}")
    return launches


def phase_opt_in_sorts(host_acgt, host_iupac, positions: dict) -> dict:
    """Phase 20: the hybrid sort on the IUPAC main path, the chunked sort
    and the odd-even merge sort on both main-path genomes at 2^27, each
    held against phases 4's and 5's positions. Returns the launches of both
    kernels by path."""
    t0 = time.perf_counter()
    out = {"pack_rank2_words_cuda": {}, "sort_lanes_cuda": {}}

    def record(label: str, launches: dict, pack_too: bool) -> None:
        out["sort_lanes_cuda"][label] = launches["sort_lanes_cuda"]
        if pack_too:
            out["pack_rank2_words_cuda"][label] = launches["pack_rank2_words_cuda"]

    record("hybrid sort, IUPAC 2^27 (31, 31)", opt_in_hybrid(host_iupac, positions["IUPAC"]), True)
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    m1 = make_mesh(1)
    for key, host_sc in (("ACGT", host_acgt), ("IUPAC", host_iupac)):
        # a collection of its own: the chunked path counts its upload and pack
        reset_launches()
        sc = fresh_collection(host_sc)
        dc = sc.device_cache("forward")
        pos = starts_of(sc)
        record(f"chunked sort, {key} 2^27 (31, 31)",
               opt_in_chunked(dc, pos, positions[key], key), key == "ACGT")
        for mesh, name in ((m4, f"make_mesh({MESH_SHARDS}) of one card"), (m1, "make_mesh(1)")):
            record(f"odd-even sort, {name}, {key} 2^27 (31, 31)",
                   opt_in_oddeven(dc, pos, positions[key], key, mesh, name), False)
        del sc, dc, pos
        torch.cuda.empty_cache()
    log(f"opt-in sorts phase: {time.perf_counter() - t0:.1f} s")
    return out

# --------------------------------------------------------------------------- #
# phase 21: the repo's entry points on the card
# --------------------------------------------------------------------------- #

TOOLS = Path(__file__).resolve().parent / "tools"
ENTRY_SOAK_CASES = {"oracle": 150, "mesh": 40, "filtered": 60}  # tools/run_soak.py's defaults
ENTRY_APPS_BP = 4_600_000  # unique_vs_k at the E. coli scale
ENTRY_KS = [8, 12, 16, 21, 25, 31, 41, 55]
ENTRY_GSD_BP = 46_000_000  # group_size_dist at the chr21 scale (docs/applications.md)
ENTRY_GSD_K = 31
ENTRY_NRUN_WARM = 5  # warm samples of each N-run sort in (c)
ENTRY_E2E_SCALES = ("ecoli", "chr21")
MAIN_SORTS = {}  # phases 4 and 5: (sort() seconds, k-mers) of the main path, by genome


def load_tool(name: str):
    """A script of ``tools/`` (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_launched(launches: dict, kernels, label: str) -> None:
    for name in kernels:
        if launches[name] < 1:
            raise AssertionError(f"{label}: {name} did not launch ({launches})")


def window_keys2(seq: np.ndarray, k: int) -> np.ndarray:
    """The 2k-bit key (uint64) of every k-base window of an ACGT genome."""
    codes = RANK2_TABLE[seq].astype(np.uint64)
    n = len(seq) - k + 1
    keys = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        keys <<= np.uint64(2)
        keys |= codes[j : j + n]
    return keys


def window_group_sizes(seq: np.ndarray, k: int) -> np.ndarray:
    """The size of every group of equal k-base windows (NumPy oracle)."""
    return np.unique(window_keys2(seq, k), return_counts=True)[1]


def entry_soak(soak) -> dict:
    """(a): the three sweeps of tools/torch_run_soak.py at its defaults; any
    failing case fails the phase. Returns the launches of each sweep."""
    out = {}
    sweeps = (("oracle", soak.oracle_soak, {}),
              ("mesh", soak.mesh_soak, {}),
              ("filtered", soak.filtered_soak, {}))
    for name, sweep, kwargs in sweeps:
        n = ENTRY_SOAK_CASES[name]
        reset_launches()
        t0 = time.perf_counter()
        fails = sweep(n, DEVICE, **kwargs)
        dt = time.perf_counter() - t0
        launches = launches_now()
        label = f"{name} soak ({n} cases)"
        if fails:
            raise AssertionError(f"{label}: {len(fails)} failing cases: {fails}")
        log(f"{label}: {n}/{n} ok in {dt:.2f} s; launches: pack {launches['pack_rank2_words_cuda']}, "
            f"lane sort {launches['sort_lanes_cuda']}")
        check_launched(launches, ("pack_rank2_words_cuda", "sort_lanes_cuda"), label)
        out[label] = launches
    return out


def entry_unique_vs_k(apps, tmp: Path) -> dict:
    """(b): unique_vs_k at the E. coli scale, sorted once and per k, the
    rows equal to each other and at k <= 31 to a NumPy oracle."""
    seq = apps.uniform_genome(ENTRY_APPS_BP)
    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    out = {}
    reset_launches()
    once, t_sort = apps.unique_vs_k(seq, ENTRY_KS, DEVICE)
    out[f"unique_vs_k sorted once, {ENTRY_APPS_BP} bp"] = launches_now()
    reset_launches()
    per_k, _ = apps.unique_vs_k(seq, ENTRY_KS, DEVICE, per_k_sort=True)
    out[f"unique_vs_k sorted per k, {ENTRY_APPS_BP} bp"] = launches_now()
    label = f"unique_vs_k at {ENTRY_APPS_BP} bp, ks {ENTRY_KS}"
    if [r[:5] for r in once] != [r[:5] for r in per_k]:
        raise AssertionError(f"{label}: the rows sorted once differ from those sorted per k")
    for row in once:
        k = row[0]
        if k > 31:
            continue
        sizes = window_group_sizes(seq_arr, k)
        total = int(sizes.sum())
        unique = int((sizes == 1).sum())
        want = (k, total, len(sizes), unique, round(unique / total, 6))
        if tuple(row[:5]) != want:
            raise AssertionError(f"{label}: row {row[:5]} differs from the NumPy oracle's {want}")
    apps.write_csv(str(tmp / "unique_vs_k.csv"), apps.UNIQUE_VS_K_COLUMNS, once)
    for path_label, launches in out.items():
        check_launched(launches, ["pack_rank2_words_cuda"], path_label)
    log(f"{label}: sort (8, 55) once {t_sort:.4f} s; statistics a k (s): "
        + ", ".join(f"{r[0]} {r[5]:.3f}" for r in once)
        + "; sort + statistics per k (s): " + ", ".join(f"{r[0]} {r[5]:.3f}" for r in per_k)
        + f"; rows equal, and at k <= 31 equal to the NumPy oracle; launches {out}")
    return out


def bincount_device_ms(fn) -> str:
    """The device ms of the ``torch.bincount`` kernels of one call of
    ``fn``, from torch.profiler, or "not measured" where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    def device_us(e) -> float:
        us = getattr(e, "device_time_total", None)
        return e.cuda_time_total if us is None else us

    events = prof.key_averages()
    us = sum(device_us(e) for e in events if e.key == "aten::bincount")
    if us:
        return f"{us / 1e3:.3f}"
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -device_us(e))
    log("  no device time under aten::bincount; kernels: " + ", ".join(e.key[:60] for e in kernels[:8]))
    return "not measured"


def entry_group_size_dist(apps, tmp: Path) -> dict:
    """(c): group_size_dist at the chr21 scale and k=31 with the script's
    defaults, held to a NumPy oracle; then the same genome with N runs
    sorted through the lane sort beside a control of the same size and N
    runs without the repeat families."""
    args = apps.parse_args(["--app", "group_size_dist", "--bp", str(ENTRY_GSD_BP),
                            "--ks", str(ENTRY_GSD_K)])  # the script's defaults otherwise
    seq, planted = apps.make_repeat_genome(args.bp, args.repeat_families, args.repeat_copies_max,
                                           args.repeat_elem_len, args.mutation_rate, seed=args.bp)
    label = (f"group_size_dist at {ENTRY_GSD_BP} bp, k={ENTRY_GSD_K}, {len(planted)} families "
             f"(copies {min(planted)}-{max(planted)}), cold and warm")
    out = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # twice, each a collection of its own: the first sort and statistics of
    # this size in the process pay a first-use cost that the second does not
    cold = apps.group_size_dist(seq, ENTRY_GSD_K, args.max_counts_bin, DEVICE)
    del cold["kmers"]
    res = apps.group_size_dist(seq, ENTRY_GSD_K, args.max_counts_bin, DEVICE)
    out[label] = launches_now()
    peak = torch.cuda.max_memory_allocated() - held
    check_launched(out[label], ["pack_rank2_words_cuda"], label)
    apps.write_csv(str(tmp / "group_size_dist.csv"), apps.GROUP_SIZE_COLUMNS, res["rows"])
    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    del seq
    sizes = window_group_sizes(seq_arr, ENTRY_GSD_K)
    want = np.bincount(np.minimum(sizes, args.max_counts_bin), minlength=args.max_counts_bin + 1)
    for run in (cold, res):
        if not (np.array_equal(run["hist"], want) and run["total"] == int(sizes.sum())):
            raise AssertionError(f"{label}: the histogram or total differs from the NumPy oracle")
    km = res["kmers"]
    bincount_ms = bincount_device_ms(
        lambda: km.get_kmer_group_counts(ENTRY_GSD_K, max_counts_bin=args.max_counts_bin))
    log(f"{label}: sort cold {cold['sort_seconds']:.4f} s, warm {res['sort_seconds']:.4f} s; "
        f"get_kmer_group_counts cold {cold['stats_seconds']:.4f} s, warm {res['stats_seconds']:.4f} s "
        f"(torch.bincount {bincount_ms} device ms), peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB); {int(want[2:].sum())} groups of size > 1, largest "
        f"{int(sizes.max())}; equal to the NumPy oracle")
    del km, res, cold, sizes
    torch.cuda.empty_cache()

    # the same genome with six N runs (2% of the bases, as phase 5's): 4-bit
    # keys of a repeat-heavy genome through the lane sort, beside a control of
    # the same size: the same background and N runs without the families
    background, _ = apps.make_repeat_genome(args.bp, 0, args.repeat_copies_max,
                                            args.repeat_elem_len, args.mutation_rate, seed=args.bp)
    genomes = {"repeat families": seq_arr.copy(),
               "control, no families": np.frombuffer(background.encode(), dtype=np.uint8).copy()}
    del background
    run = ENTRY_GSD_BP // 300
    rng = np.random.default_rng(ENTRY_GSD_BP)
    for start in rng.integers(0, ENTRY_GSD_BP - run, size=6):
        for genome in genomes.values():
            genome[start : start + run] = ord("N")
    labels = {name: f"N-run sort of the group_size_dist genome, {name}, {ENTRY_GSD_BP} bp (31, 31), "
              "6 lanes" for name in genomes}
    collections = {name: collection_of([("chr1", genome)]) for name, genome in genomes.items()}
    for sc in collections.values():
        sc.device_cache("forward").packed
    times = {name: [] for name in genomes}
    launches = {name: dict.fromkeys(launches_now(), 0) for name in genomes}
    indexes = {}
    # one cold sort and ENTRY_NRUN_WARM warm ones of each, taken in turn
    for _ in range(1 + ENTRY_NRUN_WARM):
        for name, sc in collections.items():
            reset_launches()
            km = gkt.Kmers(sc, ENTRY_GSD_K, ENTRY_GSD_K)
            _, t = sync_time(km.sort)
            times[name].append(t)
            for kernel, n in launches_now().items():
                launches[name][kernel] += n
            indexes[name] = km
            del km
    for name, sc in collections.items():
        km, label = indexes[name], labels[name]
        out[label] = launches[name]
        check_launched(out[label], ["sort_lanes_cuda"], label)
        if km._lanes_cache["two_bit"]:
            raise AssertionError(f"{label}: took 2-bit keys")
        check_sorted_index(km, valid_starts(records_of(sc), ENTRY_GSD_K), label)
        warm = times[name][1:]
        log(f"{label}: sort cold {times[name][0]:.4f} s, warm median {statistics.median(warm):.4f} s = "
            f"{len(km) / statistics.median(warm) / 1e6:.1f} M k-mers/s (warm samples "
            + ", ".join(f"{t:.4f}" for t in warm) + f"); launches {out[label]}")
    t5, n5 = MAIN_SORTS["IUPAC"]
    ratio = statistics.median(times["repeat families"][1:]) / statistics.median(
        times["control, no families"][1:])
    log(f"N-run sorts at {ENTRY_GSD_BP} bp: repeat families / control warm median {ratio:.4f}; "
        f"phase 5's IUPAC sort (2^27 bytes, no repeat families) {t5:.4f} s = "
        f"{n5 / t5 / 1e6:.1f} M k-mers/s")
    del km, sc, indexes, collections, genomes
    torch.cuda.empty_cache()
    return out


def entry_e2e(e2e) -> dict:
    """(d): the end-to-end validation at the E. coli and chr21 scales."""
    out = {}
    for scale in ENTRY_E2E_SCALES:
        n_bp, k = e2e.SCALES[scale]
        reset_launches()
        res = e2e.run_e2e(n_bp, k, DEVICE)
        label = f"E2E {scale} ({n_bp} bp, k={k})"
        sizes = window_group_sizes(e2e.synthetic_genome(n_bp), k)
        if (res["distinct"], res["unique"]) != (len(sizes), int((sizes == 1).sum())):
            raise AssertionError(f"{label}: distinct {res['distinct']}, unique {res['unique']} differ "
                                 f"from the NumPy oracle's {len(sizes)}, {int((sizes == 1).sum())}")
        del sizes
        out[label] = launches_now()
        check_launched(out[label], ["pack_rank2_words_cuda"], label)
        log(f"{label}: ingest {n_bp / res['ingest_seconds'] / 1e6:.1f} Mbp/s "
            f"({res['ingest_seconds']:.4f} s), sort + statistics cold {res['cold_seconds']:.4f} s, "
            f"warm {res['warm_seconds']:.4f} s = {res['n_kmers'] / res['warm_seconds'] / 1e6:.1f} M "
            f"k-mers/s end to end; queries {res['query_seconds']:.4f} s, counts {res['query_counts']} "
            f"equal to NumPy's; total {res['total']}, distinct {res['distinct']}, unique "
            f"{res['unique']}, equal to the NumPy oracle; launches {out[label]}")
        torch.cuda.empty_cache()
    return out


def phase_entry_points() -> dict:
    """Phase 21: tools/torch_run_soak.py, torch_run_applications.py and
    torch_run_e2e_validation.py in-process on the card. Returns the
    launches of both kernels by path."""
    t0 = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths.update(entry_soak(load_tool("torch_run_soak")))
        apps = load_tool("torch_run_applications")
        paths.update(entry_unique_vs_k(apps, Path(tmp)))
        paths.update(entry_group_size_dist(apps, Path(tmp)))
    paths.update(entry_e2e(load_tool("torch_run_e2e_validation")))
    log(f"entry points phase: {time.perf_counter() - t0:.1f} s")
    return {name: {label: launches[name] for label, launches in paths.items()}
            for name in ("pack_rank2_words_cuda", "sort_lanes_cuda")}


# --------------------------------------------------------------------------- #
# phase 22: the JAX package's call contracts on the card
# --------------------------------------------------------------------------- #


def event_ms(fn):
    """(``fn``'s output, the device ms of that one call from CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def one_launch(fn, label: str):
    """``event_ms(fn)``, failing unless the call launched the lane sort
    exactly once."""
    before = sort_lanes_cuda.launches
    out, ms = event_ms(fn)
    if sort_lanes_cuda.launches != before + 1:
        raise AssertionError(f"{label}: {sort_lanes_cuda.launches - before} lane sort launches, "
                             f"not 1")
    return out, ms


def contract_dense(host_iupac, expected: np.ndarray, smi: str) -> None:
    """(a): ``sort_positions_dense`` by the JAX defaults (4-bit pack, no
    lanes) on phase 5's IUPAC pack, against the lanes call and Kmers.sort()."""
    label = "contracts (a), IUPAC 2^27 (31, 31) sort_positions_dense"
    dc = host_iupac.device_cache("forward")
    args = (dc.packed, dc.seg_starts, dc.seg_ends, len(expected), 31, 31)
    alone, ms_alone = one_launch(lambda: sort_positions_dense(*args), f"{label}, JAX defaults")
    (pos, lanes), ms_lanes = one_launch(
        lambda: sort_positions_dense(*args, return_lanes=True),
        f"{label}, return_lanes=True")
    km = gkt.Kmers(host_iupac, 31, 31)
    _, ms_kmers = one_launch(km.sort, f"{label}, Kmers.sort()")
    if not isinstance(alone, torch.Tensor) or alone.dtype != torch.int64:
        raise AssertionError(f"{label}: the JAX defaults did not return int64 positions alone")
    if not (torch.equal(alone, pos) and torch.equal(alone, km._pos_dev)
            and same_lanes(lanes, km._lanes_cache)):
        raise AssertionError(f"{label}: the positions or lanes differ between the calls")
    check_positions(alone, expected, label)
    log(f"{label}, JAX defaults (two_bit=False, return_lanes=False): {ms_alone:.3f} ms, "
        f"1 lane sort launch, int64 positions equal to phase 5's [{smi}]")
    log(f"{label}, return_lanes=True: {ms_lanes:.3f} ms, 1 lane sort launch, positions "
        f"bitwise equal to the defaults' [{smi}]")
    log(f"{label}: Kmers.sort() {ms_kmers:.3f} ms, 1 lane sort launch, index and kept lanes "
        f"bitwise equal [{smi}]")


def contract_gather(host_sc, expected: np.ndarray, key: str, smi: str) -> None:
    """(b): ``sort_positions`` without and with lanes on the gather path:
    the starts below GATHER_BP of a main-path genome, descending."""
    label = f"contracts (b), gather path {key} (31, 31) at {GATHER_BP} bp sort_positions"
    dc = host_sc.device_cache("forward")
    want = expected[expected < GATHER_BP]
    inp = torch.from_numpy(np.sort(want)[::-1].astype(np.int64)).to(DEVICE)
    cap = cap_lengths(compute_valid_len(inp, dc.seg_starts, dc.seg_ends), 31)
    packs = (None, dc.packed2) if key == "ACGT" else (dc.packed, None)

    def call(lanes: bool):
        return sort_positions(packs[0], inp, cap, 31, packed2=packs[1], uniform_cap=True,
                              return_lanes=lanes)

    alone, ms_alone = one_launch(lambda: call(False), f"{label}, return_lanes=False")
    (pos, _), ms_lanes = one_launch(lambda: call(True), f"{label}, return_lanes=True")
    if not (isinstance(alone, torch.Tensor) and torch.equal(alone, pos)):
        raise AssertionError(f"{label}: return_lanes=False differs from the lanes call")
    check_positions(alone, want, label)
    log(f"{label}: {len(want)} rows, return_lanes=False {ms_alone:.3f} ms, return_lanes=True "
        f"{ms_lanes:.3f} ms, 1 lane sort launch each, positions bitwise equal to each other "
        f"and to phase {4 if key == 'ACGT' else 5}'s [{smi}]")


def contract_digest(host_sc, key: str, counts31: np.ndarray, mesh, smi: str) -> int:
    """(c): ``distributed_group_size_histogram_ragged(return_digest=True)``
    over the 4-shard layout of ``Kmers.sort(mesh=)``; returns the sort's
    lane sort launches."""
    label = f"contracts (c), mesh of {MESH_SHARDS} {key} 2^27 (31, 31) return_digest"
    before = sort_lanes_cuda.launches
    km = gkt.Kmers(host_sc, 31, 31)
    km.sort(mesh=mesh)
    launches = sort_lanes_cuda.launches - before
    if launches < MESH_SHARDS:
        raise AssertionError(f"{label}: the mesh sort launched the lane sort {launches} times")
    dist, dc = km._dist_cache, host_sc.device_cache("forward")
    two_bit = dc.packed2 is not None
    args = (None if two_bit else dc.packed, dist.positions, dist.is_pad, dc.seg_starts,
            dc.seg_ends, 31, mesh)
    kwargs = {"packed2": dc.packed2 if two_bit else None, "sorted_words": dist.lanes}
    (counts, total), ms_plain = event_ms(
        lambda: distributed_group_size_histogram_ragged(*args, **kwargs))
    (d_counts, d_total, hi), ms_digest = event_ms(
        lambda: distributed_group_size_histogram_ragged(*args, return_digest=True, **kwargs))
    nonzero = torch.nonzero(counts).flatten()
    last = int(nonzero[-1]) if nonzero.numel() else 0
    if not (torch.equal(d_counts, counts) and d_total == total):
        raise AssertionError(f"{label}: counts or total differ from the call without the digest")
    if not (hi.dim() == 0 and hi.dtype == torch.int64 and hi.device == mesh.devices[0]):
        raise AssertionError(f"{label}: hi is not a 0-dim int64 tensor on the mesh's first device")
    if int(hi) != last:
        raise AssertionError(f"{label}: hi {int(hi)} is not the last nonzero bin {last}")
    if not (np.array_equal(counts.cpu().numpy(), counts31) and total == km._dist_cache.n_real):
        raise AssertionError(f"{label}: the histogram differs from the main path's")
    clip = max(last // 2, 1)
    (c_counts, _, c_hi), ms_clip = event_ms(lambda: distributed_group_size_histogram_ragged(
        *args, max_counts_bin=clip, return_digest=True, **kwargs))
    folded = counts31[: clip + 1].copy()
    folded[clip] += counts31[clip + 1 :].sum()
    if int(c_hi) != min(last, clip) or not np.array_equal(c_counts.cpu().numpy(), folded):
        raise AssertionError(f"{label}: at max_counts_bin={clip} hi or the counts are wrong")
    (_, _, digest), ms_sizes = event_ms(lambda: distributed_group_size_histogram_ragged(
        *args, return_sizes=True, **kwargs))
    digest = digest.cpu().numpy()
    spec = counts31[: SPEC_HIST_BINS + 1].copy()
    spec[SPEC_HIST_BINS] += counts31[SPEC_HIST_BINS + 1 :].sum()
    largest_ok = digest[1] >= last if last == len(counts31) - 1 else digest[1] == last
    if not (digest[0] == total and largest_ok and np.array_equal(digest[2:], spec)):
        raise AssertionError(f"{label}: the return_sizes digest is not [total, largest size, "
                             f"the counts folded at {SPEC_HIST_BINS}]")
    log(f"{label}: counts and total equal to the call without it ({ms_plain:.3f} ms) and to "
        f"phase {4 if two_bit else 5}'s, hi {int(hi)} = the last nonzero bin, {ms_digest:.3f} ms; "
        f"at max_counts_bin={clip} hi {int(c_hi)} and the folded counts, {ms_clip:.3f} ms; "
        f"return_sizes digest [total, largest size {int(digest[1])}, the counts folded at "
        f"{SPEC_HIST_BINS}], {ms_sizes:.3f} ms [{smi}]")
    del km
    return launches


def phase_api_contracts(host_acgt, host_iupac, positions: dict, counts: dict, smi: str) -> dict:
    """Phase 22: the JAX package's call contracts that the port took in,
    on phases 4's and 5's collections. Returns the lane sort's launches by
    path."""
    t0 = time.perf_counter()
    reset_launches()
    contract_dense(host_iupac, positions["IUPAC"], smi)
    for key, host_sc in (("ACGT", host_acgt), ("IUPAC", host_iupac)):
        contract_gather(host_sc, positions[key], key, smi)
    out = {"API contracts: sort_positions_dense and sort_positions": sort_lanes_cuda.launches}
    m4 = make_mesh(MESH_SHARDS, devices=[f"{DEVICE}:0"] * MESH_SHARDS)
    for key, host_sc in (("ACGT", host_acgt), ("IUPAC", host_iupac)):
        out[f"API contracts: mesh sort of {key} 2^27 for return_digest"] = contract_digest(
            host_sc, key, counts[key], m4, smi)
    torch.cuda.empty_cache()
    log(f"API contracts phase: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile warm runs of the IUPAC and the suffix main path into DIR")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    pack_timing = phase_pack_kernel(rng)
    sort_timing = phase_lane_sort_kernel(rng)
    hist = phase_group_hist_kernel(np.random.default_rng(SEED + 3), smi)
    flags = phase_lanes_flags_kernel(np.random.default_rng(SEED + 4), smi)
    with tempfile.TemporaryDirectory() as tmp:
        pack_launches, hist_acgt, sc_acgt, counts31, pos_acgt = phase_main_path(
            rng, Path(tmp), False, None)
        torch.cuda.empty_cache()
        sort_launches, hist_iupac, sc_iupac, counts31_iupac, pos_iupac = phase_main_path(
            rng, Path(tmp), True, args.profile)
    torch.cuda.empty_cache()
    phase_upload_routes(sc_acgt, sc_iupac, {"ACGT": counts31, "IUPAC": counts31_iupac})
    phase_general(rng)
    phase_gather_path(rng)
    phase_oracle(rng)
    suffix_launches, suffix_ref = phase_suffix_main(sc_acgt, counts31, rng, args.profile)
    suffix4_launches, _ = phase_suffix_main(sc_iupac, counts31_iupac, rng, None)
    beyond_launches, beyond_ref = phase_beyond_window(sc_acgt, sc_iupac, rng)
    filter_launches = phase_filters(sc_acgt, sc_iupac, counts31)
    query_launches, canonical_ref = phase_queries_canonical(sc_acgt, sc_iupac, args.profile)
    mesh_launches = phase_mesh(sc_acgt, sc_iupac, {"ACGT": pos_acgt, "IUPAC": pos_iupac},
                               {"ACGT": counts31, "IUPAC": counts31_iupac}, SEED + 15)
    with tempfile.TemporaryDirectory() as tmp:
        persistence_launches = phase_persistence(sc_acgt, pos_acgt, counts31, Path(tmp), SEED + 16)
    mesh17_launches = phase_mesh_beyond_window(
        sc_acgt, sc_iupac, pos_acgt, suffix_ref, beyond_ref, canonical_ref, SEED + 17)
    large_launches = phase_large(sc_acgt, sc_iupac, {"ACGT": pos_acgt, "IUPAC": pos_iupac},
                                 {"ACGT": counts31, "IUPAC": counts31_iupac}, canonical_ref,
                                 SEED + 18)
    torch.cuda.empty_cache()
    process_launches = phase_process_mesh(sc_acgt, sc_iupac, {"ACGT": pos_acgt, "IUPAC": pos_iupac},
                                          {"ACGT": counts31, "IUPAC": counts31_iupac}, SEED + 19)
    torch.cuda.empty_cache()
    opt_in_launches = phase_opt_in_sorts(sc_acgt, sc_iupac, {"ACGT": pos_acgt, "IUPAC": pos_iupac})
    contract_launches = phase_api_contracts(sc_acgt, sc_iupac, {"ACGT": pos_acgt, "IUPAC": pos_iupac},
                                            {"ACGT": counts31, "IUPAC": counts31_iupac}, smi)
    del sc_acgt, sc_iupac, pos_acgt, pos_iupac, suffix_ref, beyond_ref
    torch.cuda.empty_cache()
    window_launches = phase_window_rounds(rng)
    strand_launches = phase_strands(rng)
    torch.cuda.empty_cache()
    entry_launches = phase_entry_points()
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    log(f"card: {smi}")
    print(json.dumps({"kernels": [
        {
            "name": "pack_rank2_words_cuda",
            "route": "cuda",
            "source": "genome_kmers_tpu_torch/csrc/pack2.cu",
            "replaces": "genome_kmers_tpu/ops/pallas_kernels.py:87",
            "launches": pack_launches,
            "launches_by_path": {"ACGT main path": pack_launches,
                                 "suffix main path, ACGT genome":
                                     suffix_launches["pack_rank2_words_cuda"],
                                 **{f"strands at {bp} bp": n for bp, n in strand_launches.items()},
                                 **filter_launches["pack_rank2_words_cuda"],
                                 **{k: v for k, v in query_launches.items() if "ACGT" in k},
                                 **mesh_launches["pack_rank2_words_cuda"],
                                 **persistence_launches,
                                 **mesh17_launches["pack_rank2_words_cuda"],
                                 **process_launches["pack_rank2_words_cuda"],
                                 **opt_in_launches["pack_rank2_words_cuda"],
                                 **entry_launches["pack_rank2_words_cuda"]},
            **pack_timing,
        },
        {
            "name": "sort_lanes_cuda",
            "route": "cuda",
            "source": "genome_kmers_tpu_torch/csrc/lane_sort.cu",
            "replaces": "genome_kmers_tpu/ops/pallas_sort.py:110",
            "launches": sort_launches,
            "launches_by_path": {"IUPAC main path": sort_launches,
                                 "suffix main path, IUPAC genome":
                                     suffix4_launches["sort_lanes_cuda"],
                                 **beyond_launches,
                                 "unbounded window rounds (20, None)": window_launches,
                                 **filter_launches["sort_lanes_cuda"],
                                 **{k: v for k, v in query_launches.items() if "IUPAC" in k},
                                 **mesh_launches["sort_lanes_cuda"],
                                 **mesh17_launches["sort_lanes_cuda"],
                                 **large_launches["sort_lanes_cuda"],
                                 **process_launches["sort_lanes_cuda"],
                                 **opt_in_launches["sort_lanes_cuda"],
                                 **contract_launches,
                                 **entry_launches["sort_lanes_cuda"]},
            **sort_timing,
        },
        {
            "name": "group_size_hist_cuda",
            "route": "cuda",
            "source": "genome_kmers_tpu_torch/csrc/group_hist.cu",
            "replaces": None,
            "launches": hist_acgt,
            "launches_by_path": {"ACGT main path": hist_acgt,
                                 "IUPAC main path": hist_iupac,
                                 "suffix main path, ACGT genome":
                                     suffix_launches["group_size_hist_cuda"],
                                 "suffix main path, IUPAC genome":
                                     suffix4_launches["group_size_hist_cuda"],
                                 **mesh_launches["group_size_hist_cuda"],
                                 **large_launches["group_size_hist_cuda"],
                                 **hist["launches"]},
            "by_rows": hist["timing"],
        },
        {
            "name": "lanes_flags_cuda",
            "route": "cuda",
            "source": "genome_kmers_tpu_torch/csrc/lanes_flags.cu",
            "replaces": None,
            "launches_by_path": {**flags["launches"], **filter_launches["lanes_flags_cuda"]},
            "by_filter": flags["timing"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
