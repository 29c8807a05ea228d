"""Smoke run of genome_kmers_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Require CUDA; print the card's name and power limit (nvidia-smi), and
   the torch and CUDA versions.
2. Build the 2-bit pack kernel from ``genome_kmers_tpu_torch/csrc/`` and
   print the build time and nvcc's register/shared-memory report.
3. Hold the kernel against its plain PyTorch version on the card, bitwise,
   on seeded random bytes from "ACGT$N" (and all 256 byte values) at
   n in {1, 15, 16, 17, 4099, 2^20+7, 2^27}; time both at 2^27.
4. Main path at 2^27 bp: a seeded synthetic ACGT FASTA of 24 uneven
   records with copied segments -> SequenceCollection(device="cuda") ->
   Kmers(sc, 31, 31) -> sort() -> get_kmer_group_counts(31) ->
   get_kmer_count(31), with each phase's time and the peak device memory.
   Checks that the pack kernel ran, that the sorted keys do not decrease
   (ties by position), that the positions are the valid starts, that a
   sample of the sorted key words matches the genome, and that
   sum(s * counts[s]) == total == len(kmers).
5. The general sort (cap lane, multi-key chain) with Kmers(sc, 20, 48) at
   2^24 bp under the same checks, and both (31, 31) and (20, 48) at 2^20 bp
   against a NumPy oracle (byte-string sort and unique).

The next-to-last line of output is a JSON object describing each kernel of
the path; the last is {"ok": true, "device": {...}}. No JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import genome_kmers_tpu_torch as gkt
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.pack2 import SOURCE as PACK2_SOURCE
from genome_kmers_tpu_torch.kernels.pack2 import pack_rank2_words_cuda
from genome_kmers_tpu_torch.ops.keys import pack_rank2_words, widen_u32

DEVICE = "cuda"
SEED = 20261016
MAIN_BP = 1 << 27
GENERAL_BP = 1 << 24
ORACLE_BP = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


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


def synthetic_records(rng, total_bp: int, n_records: int, short_lens=()):
    """Seeded ACGT records of uneven length summing to ``total_bp``: random
    bases with segments copied to many places (groups of size > 1), one
    all-'T' record, and records of the given short lengths."""
    genome = ACGT[rng.integers(0, 4, size=total_bp, dtype=np.uint8)]
    for _ in range(max(total_bp >> 20, 8)):
        length = int(rng.integers(40, 2000))
        src = int(rng.integers(0, total_bp - length))
        for dst in rng.integers(0, total_bp - length, size=int(rng.integers(2, 40))):
            genome[dst : dst + length] = genome[src : src + length]
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


# --------------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------------- #


def valid_starts(records, min_kmer_len: int):
    """SBA index of every k-mer start with at least min_kmer_len bases left
    in its record, and the index one past its record's end, from the record
    lengths alone."""
    starts, ends, s = [], [], 0
    for _, seq in records:
        starts.append(np.arange(s, s + len(seq) - min_kmer_len + 1, dtype=np.int64))
        ends.append(np.full(len(starts[-1]), s + len(seq), dtype=np.int64))
        s += len(seq) + 1
    return np.concatenate(starts), np.concatenate(ends)


def check_sorted_index(km, records, label: str) -> None:
    """Keys non-decreasing with ties by position, positions = valid starts,
    histogram consistent with the total and the index length."""
    pos = km._pos_dev
    lanes = km._lanes_cache
    if pos.device.type != DEVICE or any(w.device.type != DEVICE for w in lanes["words"]):
        raise AssertionError(f"{label}: the sorted index does not live on the card")
    keys = list(lanes["words"]) + ([] if lanes["cap"] is None else [lanes["cap"]]) + [pos]
    lt = torch.zeros(pos.shape[0] - 1, dtype=torch.bool, device=pos.device)
    eq = torch.ones_like(lt)
    for lane in keys:
        a, b = lane[:-1], lane[1:]
        lt |= eq & (a < b)
        eq &= a == b
    if not bool(lt.all()):
        raise AssertionError(f"{label}: sorted keys decrease (or positions tie) somewhere")
    expected = torch.from_numpy(valid_starts(records, km.min_kmer_len)[0]).to(pos.device)
    if not torch.equal(torch.sort(pos).values, expected):
        raise AssertionError(f"{label}: sorted positions are not the valid k-mer starts")
    k = km.max_kmer_len
    counts, total = km.get_kmer_group_counts(k)
    weighted = int((np.arange(len(counts), dtype=np.int64) * counts).sum())
    if counts[-1] != 0 or not weighted == total == len(km) == km.get_kmer_count(k):
        raise AssertionError(
            f"{label}: sum(s*counts[s])={weighted}, total={total}, len={len(km)}"
        )
    log(f"{label}: invariants hold ({len(km)} k-mers, {int(counts[2:].sum())} groups of size > 1, "
        f"largest group {int(np.flatnonzero(counts)[-1])})")


def check_words_against_genome(km, sba: np.ndarray, rng, n_sample: int = 65536) -> None:
    """The retained words of sampled sorted rows equal the 2-bit code of the
    genome's bases at their positions (uniform cap: every row has k bases)."""
    k = km.max_kmer_len
    rows = torch.from_numpy(rng.integers(0, len(km), size=n_sample)).to(km._pos_dev.device)
    pos = km._pos_dev[rows].cpu().numpy()
    rank = np.zeros(256, dtype=np.int64)
    rank[ACGT] = np.arange(4)
    windows = rank[sba[pos[:, None] + np.arange(k)]]
    for w, word in enumerate(km._lanes_cache["words"]):
        fields = windows[:, 16 * w : 16 * w + 16]
        code = np.zeros(n_sample, dtype=np.int64)
        for j in range(fields.shape[1]):
            code |= fields[:, j] << (2 * (15 - j))
        if not np.array_equal(word[rows].cpu().numpy(), code):
            raise AssertionError(f"sorted key word {w} disagrees with the genome")
    log(f"sorted key words match the genome on {n_sample} sampled rows")


def oracle_check(records, min_kmer_len: int, max_kmer_len: int) -> None:
    """Positions and statistics against a NumPy oracle: every k-mer as the
    byte string of its first min(bases left, max_kmer_len) bases, stable
    byte-string sort (shorter prefix first), np.unique for the groups."""
    seq_list = [(name, seq.tobytes().decode()) for name, seq in records]
    sc = gkt.SequenceCollection(sequence_list=seq_list, device=DEVICE)
    km = gkt.Kmers(sc, min_kmer_len, max_kmer_len)
    km.sort()
    sba = sc.forward_sba
    starts, ends = valid_starts(records, min_kmer_len)
    cap = np.minimum(ends - starts, max_kmer_len)
    padded = np.concatenate([sba, np.zeros(max_kmer_len, dtype=np.uint8)])
    win = np.lib.stride_tricks.sliding_window_view(padded, max_kmer_len)[starts]
    win = np.where(np.arange(max_kmer_len) < cap[:, None], win, 0).astype(np.uint8)
    strings = np.ascontiguousarray(win).view(f"S{max_kmer_len}").ravel()
    order = np.argsort(strings, kind="stable")
    if not np.array_equal(km.kmer_sba_start_indices.astype(np.int64), starts[order]):
        raise AssertionError(f"oracle ({min_kmer_len}, {max_kmer_len}): sorted positions differ")
    for k in sorted({min_kmer_len, (min_kmer_len + max_kmer_len) // 2, max_kmer_len}):
        prefixes = np.ascontiguousarray(win[:, :k]).view(f"S{k}").ravel()
        sizes = np.unique(prefixes, return_counts=True)[1]
        for mcb in (30, 1000):
            expected = np.bincount(np.minimum(sizes, mcb), minlength=mcb + 1)
            counts, total = km.get_kmer_group_counts(k, max_counts_bin=mcb)
            if not (np.array_equal(counts, expected) and total == len(starts)):
                raise AssertionError(f"oracle ({min_kmer_len}, {max_kmer_len}) k={k}: histogram differs")
        if km.get_kmer_count(k, min_group_size=2) != int(sizes[sizes >= 2].sum()):
            raise AssertionError(f"oracle ({min_kmer_len}, {max_kmer_len}) k={k}: count differs")
    log(f"oracle ({min_kmer_len}, {max_kmer_len}) at {len(sba)} bytes: positions and statistics agree")


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
    t0 = time.perf_counter()
    lib = build.build(PACK2_SOURCE)
    log(f"built {lib.name} in {time.perf_counter() - t0:.3f} s")
    log_file = lib.with_suffix(".log")
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            log(f"  nvcc: {line}")


def phase_kernel(rng) -> dict:
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
    ms = cuda_ms(lambda: pack_rank2_words_cuda(sba))
    plain_ms = cuda_ms(lambda: pack_rank2_words(sba), reps=5)
    bound_ms = 5 * sba.shape[0] / HBM_BYTES_PER_S * 1e3
    log(f"pack2 at n=2^27: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"5n-byte bound {bound_ms:.4f} ms at 3.35 TB/s = {bound_ms / ms:.1%} of it")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_main_path(rng, tmp: Path) -> int:
    records = synthetic_records(rng, MAIN_BP, 24)
    fasta = tmp / "main.fa"
    write_fasta(fasta, records)
    log(f"main path: wrote {fasta.stat().st_size} bytes of FASTA ({MAIN_BP} bp, {len(records)} records)")
    del records

    pack_rank2_words_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    sc, t_parse = sync_time(lambda: gkt.SequenceCollection(fasta_file_path=fasta, device=DEVICE))
    km = gkt.Kmers(sc, 31, 31)
    dc = sc.device_cache("forward")
    _, t_upload = sync_time(lambda: dc.sba)
    _, t_pack = sync_time(lambda: dc.packed2)  # the first step of sort(), timed alone
    _, t_sort = sync_time(km.sort)
    (counts, total), t_hist = sync_time(lambda: km.get_kmer_group_counts(31))
    count, t_count = sync_time(lambda: km.get_kmer_count(31))
    t_all = time.perf_counter() - t_all
    launches = pack_rank2_words_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    log(f"main path times (s): parse {t_parse:.4f}, upload {t_upload:.4f}, pack {t_pack:.4f}, "
        f"sort {t_sort:.4f}, group counts {t_hist:.4f}, count {t_count:.4f}, end to end {t_all:.4f}")
    log(f"main path: {len(km)} k-mers, sort {len(km) / t_sort / 1e6:.1f} M k-mers/s, "
        f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    if launches < 1:
        raise AssertionError("the main path did not launch the pack2 kernel")
    if count != total:
        raise AssertionError(f"get_kmer_count ({count}) != histogram total ({total})")
    recs = [(name, sc.forward_sba[s : e + 1]) for name, s, e in sc.iter_records()]
    check_sorted_index(km, recs, "main path (31, 31)")
    check_words_against_genome(km, sc.forward_sba, rng)
    return launches


def phase_general(rng) -> None:
    records = synthetic_records(rng, GENERAL_BP, 24, short_lens=(20, 33, 47))
    seq_list = [(name, seq.tobytes().decode()) for name, seq in records]
    sc = gkt.SequenceCollection(sequence_list=seq_list, device=DEVICE)
    km = gkt.Kmers(sc, 20, 48)
    _, t_sort = sync_time(km.sort)
    log(f"general sort (20, 48) at {GENERAL_BP} bp: {t_sort:.4f} s")
    check_sorted_index(km, records, "general (20, 48)")
    small = synthetic_records(rng, ORACLE_BP, 12, short_lens=(31, 40, 47))
    oracle_check(small, 31, 31)
    oracle_check(small, 20, 48)


def main() -> None:
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    timing = phase_kernel(rng)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(rng, Path(tmp))
    torch.cuda.empty_cache()
    phase_general(rng)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    log(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "pack_rank2_words_cuda",
        "route": "cuda",
        "source": "genome_kmers_tpu_torch/csrc/pack2.cu",
        "replaces": "genome_kmers_tpu/ops/pallas_kernels.py:87",
        "launches": launches,
        **timing,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
