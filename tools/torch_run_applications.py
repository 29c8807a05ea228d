#!/usr/bin/env python
"""The reference's two showcased applications on the PyTorch port
(genome_kmers_tpu_torch), with the flags and output of
tools/run_applications.py.

    python3 tools/torch_run_applications.py [--app unique_vs_k|group_size_dist]
        [--bp N] [--ks 8,12,16,21,31] [--output-base PATH] [--per-k-sort]
        [--device cuda|cpu]

unique_vs_k sorts once at (min ks, max ks) and takes one
``LengthFilter(k)`` statistics call a k over the same index; with
``--per-k-sort`` a fresh index a k, the reference's workflow. Both give
the same rows: (k, total, distinct, unique, frac_unique, seconds).
group_size_dist plants mutated repeat families in a random background
(``make_repeat_genome``) and gives the group-size histogram at the first
of ``--ks``. ``--device`` is cuda by default (it raises without CUDA) and
cpu for a dry run.
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from genome_kmers_tpu_torch import Kmers, SequenceCollection  # noqa: E402
from genome_kmers_tpu_torch.ops.filters import LengthFilter  # noqa: E402
from genome_kmers_tpu_torch.sequence_collection import resolve_device  # noqa: E402

UNIQUE_VS_K_COLUMNS = ["k", "total_kmers", "distinct", "unique", "frac_unique", "seconds"]
GROUP_SIZE_COLUMNS = ["group_size", "num_groups"]


def make_repeat_genome(bp, families, max_copies, elem_len, mut_rate, seed):
    """Random ACGT background with planted repeat families (the generator of
    tools/run_applications.py: the same genome from the same seed).

    Family copy numbers are log-uniform in [2, max_copies]; every copy
    carries independent per-base substitutions at ``mut_rate``, so family
    members share long exact windows but are not identical. Returns (the
    genome as a str, the copies of each family)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, 4, bp).astype(np.uint8)
    planted = []
    for _ in range(families):
        copies = int(round(2 * (max_copies / 2) ** rng.random()))
        elem = rng.integers(0, 4, elem_len).astype(np.uint8)
        starts = rng.integers(0, bp - elem_len, copies)
        for s in starts:
            copy = elem.copy()
            m = rng.random(elem_len) < mut_rate
            copy[m] = (copy[m] + rng.integers(1, 4, int(m.sum()))) % 4
            ranks[s : s + elem_len] = copy
        planted.append(copies)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bases[ranks].tobytes().decode("ascii"), planted


def uniform_genome(bp: int) -> str:
    """The uniform-random ACGT genome of unique_vs_k, seeded by its length
    (the draw of tools/run_applications.py)."""
    rng = np.random.default_rng(bp)
    return rng.choice(list("ACGT"), size=bp).astype("S1").tobytes().decode("ascii")


def _timed(fn, device):
    """(fn's result, seconds to its end on the device)."""
    sync = torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _row(k, hist, total, seconds):
    unique, distinct = int(hist[1]), int(hist.sum())
    return (k, total, distinct, unique, round(unique / total, 6), round(seconds, 3))


def unique_vs_k(seq: str, ks, device: str = "cuda", per_k_sort: bool = False):
    """Unique k-mers against k on a one-record genome. Returns (rows, the
    seconds of the one sort, None with ``per_k_sort``); a row's seconds are
    its statistics call's, or its sort and statistics with ``per_k_sort``."""
    resolve_device(device)
    sc = SequenceCollection(sequence_list=[("chr1", seq)], strands_to_load="forward",
                            device=device)
    rows = []
    if per_k_sort:
        for k in ks:
            km = Kmers(sc, min_kmer_len=k, max_kmer_len=k)

            def sort_and_count(km=km, k=k):
                km.sort()
                return km.get_kmer_group_counts(k, max_counts_bin=100)

            (hist, total), dt = _timed(sort_and_count, device)
            rows.append(_row(k, hist, total, dt))
            print(f"k={k:3d}: total={total} distinct={rows[-1][2]} unique={rows[-1][3]} "
                  f"frac_unique={rows[-1][3] / total:.4f} ({dt:.2f}s)", flush=True)
        return rows, None
    k_min, k_max = min(ks), max(ks)
    km = Kmers(sc, min_kmer_len=k_min, max_kmer_len=k_max)
    _, t_sort = _timed(km.sort, device)
    print(f"sorted once at k_max={k_max} ({t_sort:.2f}s)", flush=True)
    for k in sorted(ks):
        # survivors with >= k bases, grouped by k-base identity: the per-k
        # index's statistics exactly
        (hist, total), dt = _timed(lambda k=k: km.get_kmer_group_counts(
            k, kmer_filter_func=LengthFilter(k), max_counts_bin=100), device)
        rows.append(_row(k, hist, total, dt))
        print(f"k={k:3d}: total={total} distinct={rows[-1][2]} unique={rows[-1][3]} "
              f"frac_unique={rows[-1][3] / total:.4f} ({dt:.2f}s stats)", flush=True)
    return rows, t_sort


def group_size_dist(seq: str, k: int, max_counts_bin: int, device: str = "cuda") -> dict:
    """The group-size histogram of a one-record genome at k. Returns a dict:
    the index (``kmers``), ``hist``, ``total``, ``rows`` (group size, groups)
    for every non-empty size, and the seconds of the sort and of the
    statistics call."""
    resolve_device(device)
    sc = SequenceCollection(sequence_list=[("chr1", seq)], strands_to_load="forward",
                            device=device)
    km = Kmers(sc, min_kmer_len=k, max_kmer_len=k)
    _, t_sort = _timed(km.sort, device)
    (hist, total), t_stats = _timed(
        lambda: km.get_kmer_group_counts(k, max_counts_bin=max_counts_bin), device)
    hist = np.asarray(hist)
    sizes = np.flatnonzero(hist)
    print(f"sort+stats {t_sort + t_stats:.2f}s; total={total} distinct={hist.sum()} "
          f"unique={hist[1] if len(hist) > 1 else 0} max_group={sizes.max()}", flush=True)
    rows = [(int(s), int(hist[s])) for s in sizes if s > 0]
    for s, c in rows[:5] + rows[-5:]:
        print(f"  size {s}: {c} groups")
    return {"kmers": km, "hist": hist, "total": total, "rows": rows,
            "sort_seconds": t_sort, "stats_seconds": t_stats}


def write_csv(path: str, columns, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows(rows)
    print(f"wrote {path}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--app", choices=["unique_vs_k", "group_size_dist"], default="unique_vs_k")
    ap.add_argument("--bp", type=int, default=4_600_000)
    ap.add_argument("--ks", type=str, default="8,12,16,21,25,31,41,55")
    ap.add_argument("--output-base", type=str, default=None)
    ap.add_argument("--per-k-sort", action="store_true",
                    help="sort a fresh index per k (reference workflow)")
    ap.add_argument("--repeat-families", type=int, default=40)
    ap.add_argument("--repeat-copies-max", type=int, default=5000)
    ap.add_argument("--repeat-elem-len", type=int, default=300)
    ap.add_argument("--mutation-rate", type=float, default=0.02)
    ap.add_argument("--max-counts-bin", type=int, default=100000)
    ap.add_argument("--device", default="cuda",
                    help="device of the collection and index (cuda, or cpu for a dry run)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    resolve_device(args.device)
    ks = [int(x) for x in args.ks.split(",")]
    if args.app == "group_size_dist":
        k = ks[0]
        seq, planted = make_repeat_genome(
            args.bp, args.repeat_families, args.repeat_copies_max,
            args.repeat_elem_len, args.mutation_rate, seed=args.bp,
        )
        print(f"{args.bp} bp, {len(planted)} repeat families "
              f"(copies: min={min(planted)} max={max(planted)}), k={k}")
        out = group_size_dist(seq, k, args.max_counts_bin, args.device)
        if args.output_base:
            write_csv(f"{args.output_base}-group_size_dist.csv", GROUP_SIZE_COLUMNS, out["rows"])
        return
    rows, _ = unique_vs_k(uniform_genome(args.bp), ks, args.device, args.per_k_sort)
    if args.output_base:
        write_csv(f"{args.output_base}-unique_vs_k.csv", UNIQUE_VS_K_COLUMNS, rows)


if __name__ == "__main__":
    main()
