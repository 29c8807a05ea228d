#!/usr/bin/env python
"""End-to-end validation of the PyTorch port (genome_kmers_tpu_torch) at
the E. coli and chr21 scales, through the public API, with the flags and
output of tools/run_e2e_validation.py: synthetic genome -> FASTA ->
SequenceCollection (the native parser) -> Kmers(k, k) -> sort -> group
statistics -> count_queries, timed cold and warm.

    python3 tools/torch_run_e2e_validation.py [--scale {ecoli,chr21,custom}]
        [--bp N] [--k K] [--device cuda|cpu]

It asserts that the total is n_bp - k + 1 and that the query counts equal a
NumPy count of the same windows, then prints ``E2E OK``. ``--device`` is
cuda by default (it raises without CUDA) and cpu for a dry run.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from genome_kmers_tpu_torch import Kmers, SequenceCollection  # noqa: E402
from genome_kmers_tpu_torch.sequence_collection import resolve_device  # noqa: E402

SCALES = {"ecoli": (4_600_000, 31), "chr21": (46_000_000, 31)}


def synthetic_genome(n_bp: int) -> np.ndarray:
    """Uniform-random ACGT bytes seeded by the length (the draw of
    tools/run_e2e_validation.py)."""
    rng = np.random.default_rng(n_bp)
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n_bp)


def write_fasta(path: str, seq_arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">synthetic\n")
        for i in range(0, len(seq_arr), 1 << 20):
            f.write(bytes(seq_arr[i : i + (1 << 20)]) + b"\n")


def count_windows(seq_arr: np.ndarray, query: str) -> int:
    """Occurrences of ``query`` among the windows of ``seq_arr``, narrowing
    the candidate starts one base at a time."""
    q = np.frombuffer(query.encode(), dtype=np.uint8)
    cand = np.flatnonzero(seq_arr[: len(seq_arr) - len(q) + 1] == q[0])
    for j in range(1, len(q)):
        cand = cand[seq_arr[cand + j] == q[j]]
    return len(cand)


def _synced(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def run_e2e(n_bp: int, k: int, device: str = "cuda") -> dict:
    """The validation at ``n_bp`` bases of ``synthetic_genome(n_bp)``. Returns a dict of what it prints: seconds
    of the ingest, the cold and warm sort + statistics and the queries,
    the k-mer count, total, distinct, unique and the query counts beside
    their NumPy counts."""
    resolve_device(device)
    seq_arr = synthetic_genome(n_bp)
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "synthetic.fasta")
        write_fasta(fasta, seq_arr)
        t0 = _synced(device)
        sc = SequenceCollection(fasta_file_path=fasta, device=device)
        t_ingest = _synced(device) - t0
    print(f"ingest {n_bp/1e6:.1f}Mbp: {t_ingest:.2f}s ({n_bp/t_ingest/1e6:.0f} Mbp/s)", flush=True)

    def pipeline():
        km = Kmers(sc, min_kmer_len=k, max_kmer_len=k)
        km.sort()
        hist, total = km.get_kmer_group_counts(k, max_counts_bin=100)
        return km, hist, total

    t0 = _synced(device)
    km, hist, total = pipeline()  # cold: the kernels' first use builds them
    t_cold = _synced(device) - t0
    print(f"sort+stats cold (incl. compile): {t_cold:.1f}s", flush=True)
    t0 = _synced(device)
    km, hist, total = pipeline()
    t_warm = _synced(device) - t0
    print(f"sort+stats warm: {t_warm:.2f}s ({len(km)/t_warm/1e6:.1f}M kmers/s end-to-end)", flush=True)
    print(f"total={total} distinct={int(hist.sum())} unique={int(hist[1])}")

    queries = [bytes(seq_arr[1000 : 1000 + k]).decode(), "A" * k]
    t0 = _synced(device)
    counts = km.count_queries(queries)
    t_query = _synced(device) - t0
    print(f"queries: {t_query:.2f}s -> {list(map(int, counts))}")
    expected = [count_windows(seq_arr, q) for q in queries]
    assert total == n_bp - k + 1, (total, n_bp - k + 1)
    assert list(map(int, counts)) == expected, (list(map(int, counts)), expected)
    return {"ingest_seconds": t_ingest, "cold_seconds": t_cold, "warm_seconds": t_warm,
            "query_seconds": t_query, "n_kmers": len(km), "total": int(total),
            "distinct": int(hist.sum()), "unique": int(hist[1]),
            "query_counts": [int(c) for c in counts], "expected_counts": expected}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=[*SCALES, "custom"], default="ecoli")
    ap.add_argument("--bp", type=int, default=None)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--device", default="cuda",
                    help="device of the collection and index (cuda, or cpu for a dry run)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)
    if args.scale != "custom":
        n_bp, k = SCALES[args.scale]
    else:
        n_bp, k = args.bp or 10**6, args.k
    run_e2e(n_bp, k, args.device)
    print("E2E OK")


if __name__ == "__main__":
    main()
