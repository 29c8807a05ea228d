"""Smoke run of genome_kmers_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises (exit code 1) on failure:

1. Require CUDA; print the card's name and power limit (nvidia-smi), and
   the torch and CUDA versions.
2. Build both kernels from ``genome_kmers_tpu_torch/csrc/``, one nvcc each,
   started together; print the build time and nvcc's register and
   shared-memory report.
3. Hold each kernel against its plain PyTorch version on the card, bitwise:
   the 2-bit pack on seeded random bytes from "ACGT$N" (and all 256 byte
   values) at n in {1, 15, 16, 17, 4099, 2^20+7, 2^27}; the multi-lane sort
   on 1, 2, 3, 6 and 8 lanes at n in {1, 2, 127, 128, T-1, T, T+1, 2T+1, 3T,
   2^20+7, 2^24, 2^24+4097} (T the kernel's tile), heavily tied keys that
   include 0xFFFFFFFF and values >= 2^31, the last lane a permutation, and
   on inputs already sorted, reverse-sorted, with every key lane constant,
   and with a run that lies wholly before its left partner. Time each kernel
   and its plain version at the main path's shape (2^27 bytes; 2^27 rows x
   6 lanes) beside the least time the card could take and, for the sort,
   beside the one PyTorch call that computes the same rows,
   torch.unique(dim=0), and at 2^27+1 rows, which must not cost 1.2 times
   what 2^27 rows cost.
4. ACGT main path at 2^27 bp: a seeded synthetic FASTA of 24 uneven
   records with copied segments -> SequenceCollection(device="cuda") ->
   Kmers(sc, 31, 31) -> sort() -> get_kmer_group_counts(31) ->
   get_kmer_count(31), with each phase's time and the peak device memory.
   Checks that the pack kernel ran, that the sorted keys do not decrease
   (ties by position), that the positions are the valid starts, that a
   sample of the sorted key words matches the genome, and that the
   histogram, the total and the index length agree.
5. IUPAC main path (4-bit keys) at an SBA of exactly 2^27 bytes: the same
   genome with long N runs (2% of the bases) and sparse IUPAC codes,
   through the same calls and checks; the sort must go through the
   multi-lane sort kernel.
6. The general 2-bit sort (cap lane, multi-key chain) with Kmers(sc, 20, 48)
   at 2^24 bp under the same checks.
7. The gather path at 2^22 bp, on 2-bit and on 4-bit keys: a re-sort of a
   sorted index, an assigned descending index, an assigned subset index,
   an unsorted count, statistics at a kmer_len above the built lanes held
   against a NumPy adjacent compare, and get_kmers_arrays held against the
   histogram. Both kernels must have launched.
8. A NumPy oracle (byte-string sort and unique) at 2^20 bp: ACGT genome at
   (31, 31) and (20, 48), IUPAC genome at (31, 31) and (12, 32), and both
   again from an assigned descending index (the gather path).

``--profile DIR`` adds a warm second run of phase 5's calls under
torch.profiler and writes the device time by kernel to DIR.

The next-to-last line of output is a JSON object describing each kernel of
the paths; the last is {"ok": true, "device": {...}}. No JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import genome_kmers_tpu_torch as gkt
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.lane_sort import SOURCE as LANE_SORT_SOURCE
from genome_kmers_tpu_torch.kernels.lane_sort import (
    TILE_ROWS,
    blocks_resident,
    pass_schedule,
    sort_lanes_cuda,
)
from genome_kmers_tpu_torch.kernels.pack2 import SOURCE as PACK2_SOURCE
from genome_kmers_tpu_torch.kernels.pack2 import pack_rank2_words_cuda
from genome_kmers_tpu_torch.ops.encoding import RANK2_TABLE, RANK_TABLE
from genome_kmers_tpu_torch.ops.keys import pack_rank2_words, widen_u32
from genome_kmers_tpu_torch.ops.sort import sort_lanes

DEVICE = "cuda"
SEED = 20261016
MAIN_BP = 1 << 27
GENERAL_BP = 1 << 24
GATHER_BP = 1 << 22
ORACLE_BP = 1 << 20
MAIN_RECORDS = 24
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


def collection_of(records):
    seq_list = [(name, seq.tobytes().decode()) for name, seq in records]
    return gkt.SequenceCollection(sequence_list=seq_list, device=DEVICE)


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


def kmer_windows(sc, pos: np.ndarray, k: int) -> np.ndarray:
    """(len(pos), k) uint8: the bases of the k-mer at each SBA position, 0
    from the end of its record on."""
    sba = sc.forward_sba
    seg_starts = sc._forward_sba_seg_starts.astype(np.int64)
    ends = np.concatenate([seg_starts[1:] - 1, [len(sba)]])  # one past each record
    cap = np.minimum(ends[np.searchsorted(seg_starts, pos, side="right") - 1] - pos, k)
    padded = np.concatenate([sba, np.zeros(k, dtype=np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, k)[pos]
    return np.where(np.arange(k) < cap[:, None], win, 0).astype(np.uint8)


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


def check_words_against_genome(km, sc, rng, label: str, n_sample: int = 65536) -> None:
    """The retained words of sampled sorted rows equal the 2-bit or 4-bit
    code of the genome's bases at their positions, zero from the cap on."""
    lanes = km._lanes_cache
    per_word, bits, table = (16, 2, RANK2_TABLE) if lanes["two_bit"] else (8, 4, RANK_TABLE)
    rows = torch.from_numpy(rng.integers(0, len(km), size=n_sample)).to(km._pos_dev.device)
    pos = km._pos_dev[rows].cpu().numpy()
    ranks = table.astype(np.int64)[kmer_windows(sc, pos, km.max_kmer_len)]
    for w, word in enumerate(lanes["words"]):
        fields = ranks[:, per_word * w : per_word * (w + 1)]
        code = np.zeros(n_sample, dtype=np.int64)
        for j in range(fields.shape[1]):
            code |= fields[:, j] << (bits * (per_word - 1 - j))
        if not np.array_equal(unsigned(word[rows]).cpu().numpy(), code):
            raise AssertionError(f"{label}: sorted key word {w} disagrees with the genome")
    log(f"{label}: sorted {bits}-bit key words match the genome on {n_sample} sampled rows")


def oracle_check(records, min_kmer_len: int, max_kmer_len: int, descending: bool = False) -> None:
    """Positions and statistics against a NumPy oracle: every k-mer as the
    byte string of its first min(bases left, max_kmer_len) bases, stable
    byte-string sort (shorter prefix first), np.unique for the groups. With
    ``descending`` the index is assigned in descending order first, so the
    sort takes the gather path."""
    sc = collection_of(records)
    km = gkt.Kmers(sc, min_kmer_len, max_kmer_len)
    if descending:
        km.kmer_sba_start_indices = km.kmer_sba_start_indices[::-1].copy()
    km.sort()
    starts = valid_starts(records, min_kmer_len)
    win = kmer_windows(sc, starts, max_kmer_len)
    order = np.argsort(as_strings(win, max_kmer_len), kind="stable")
    label = f"oracle ({min_kmer_len}, {max_kmer_len}{', descending input' if descending else ''})"
    if not np.array_equal(km.kmer_sba_start_indices.astype(np.int64), starts[order]):
        raise AssertionError(f"{label}: sorted positions differ")
    for k in sorted({min_kmer_len, (min_kmer_len + max_kmer_len) // 2, max_kmer_len}):
        sizes = np.unique(as_strings(win, k), return_counts=True)[1]
        for mcb in (30, 1000):
            expected = np.bincount(np.minimum(sizes, mcb), minlength=mcb + 1)
            counts, total = km.get_kmer_group_counts(k, max_counts_bin=mcb)
            if not (np.array_equal(counts, expected) and total == len(starts)):
                raise AssertionError(f"{label} k={k}: histogram differs")
        if km.get_kmer_count(k, min_group_size=2) != int(sizes[sizes >= 2].sum()):
            raise AssertionError(f"{label} k={k}: count differs")
    log(f"{label} at {len(sc.forward_sba)} bytes, "
        f"{'2' if km._lanes_cache['two_bit'] else '4'}-bit keys: positions and statistics agree")


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
    sources = (PACK2_SOURCE, LANE_SORT_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, side by side
        libs = list(pool.map(build.build, sources))
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
    for n_lanes in (1, 2, 3, 6, 8):
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


def reset_launches() -> None:
    pack_rank2_words_cuda.launches = 0
    sort_lanes_cuda.launches = 0


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


def phase_main_path(rng, tmp: Path, iupac: bool, profile_dir) -> int:
    """One main path at 2^27 SBA bytes; returns its kernel's launches."""
    label = "IUPAC main path (31, 31)" if iupac else "ACGT main path (31, 31)"
    # the SBA joins the records with one '$' each: exactly 2^27 bytes
    records = synthetic_records(rng, MAIN_BP - (MAIN_RECORDS - 1), MAIN_RECORDS, iupac=iupac)
    fasta = tmp / ("iupac.fa" if iupac else "acgt.fa")
    write_fasta(fasta, records)
    log(f"{label}: wrote {fasta.stat().st_size} bytes of FASTA ({len(records)} records)")
    del records

    kernel = sort_lanes_cuda if iupac else pack_rank2_words_cuda
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sc, km, times = run_main_calls(fasta)
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} times (s): " + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
    log(f"{label}: SBA {len(sc.forward_sba)} bytes, {len(km)} k-mers, "
        f"sort {len(km) / times['sort'] / 1e6:.1f} M k-mers/s, "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if len(sc.forward_sba) != MAIN_BP:
        raise AssertionError(f"{label}: the SBA holds {len(sc.forward_sba)} bytes, not 2^27")
    if launches < 1:
        raise AssertionError(f"{label} did not launch {kernel.__name__}")
    if km._lanes_cache["two_bit"] == iupac:
        raise AssertionError(f"{label} took the wrong key encoding")
    check_sorted_index(km, valid_starts(records_of(sc), 31), label)
    check_words_against_genome(km, sc, rng, label)
    if iupac and profile_dir is not None:
        del sc, km  # their memory stays with the allocator: the profiled run is warm
        profile_main_calls(fasta, Path(profile_dir))
    return launches


def profile_main_calls(fasta: Path, out_dir: Path) -> None:
    """A warm second run of the main path's calls under torch.profiler: the
    device time by kernel, as a table in ``out_dir`` and its head here."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, times = run_main_calls(fasta)
    log("profiled warm run times (s): " + ", ".join(f"{name} {t:.4f}" for name, t in times.items()))
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40,
                                      max_name_column_width=70)
    (out_dir / "main_path_4bit_kernels.txt").write_text(table)
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
    iupac = synthetic_records(rng, ORACLE_BP, 12, short_lens=(31, 40, 47), iupac=True)
    for descending in (False, True):
        oracle_check(acgt, 31, 31, descending)
        oracle_check(acgt, 20, 48, descending)
        oracle_check(iupac, 31, 31, descending)
        oracle_check(iupac, 12, 32, descending)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile a warm run of the IUPAC main path into DIR")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    pack_timing = phase_pack_kernel(rng)
    sort_timing = phase_lane_sort_kernel(rng)
    with tempfile.TemporaryDirectory() as tmp:
        pack_launches = phase_main_path(rng, Path(tmp), False, None)
        torch.cuda.empty_cache()
        sort_launches = phase_main_path(rng, Path(tmp), True, args.profile)
    torch.cuda.empty_cache()
    phase_general(rng)
    phase_gather_path(rng)
    phase_oracle(rng)
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
            **pack_timing,
        },
        {
            "name": "sort_lanes_cuda",
            "route": "cuda",
            "source": "genome_kmers_tpu_torch/csrc/lane_sort.cu",
            "replaces": "genome_kmers_tpu/ops/pallas_sort.py:110",
            "launches": sort_launches,
            **sort_timing,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
