#!/usr/bin/env python
"""Stress soak of the PyTorch port (genome_kmers_tpu_torch): three sweeps of
random genomes and parameters against the string oracle, as
tools/run_soak.py runs them for the JAX package.

    python3 tools/torch_run_soak.py [n_oracle] [n_dist] [n_filt] [--device cuda|cpu]

Defaults 150 / 40 / 60 cases; run from the repo root. The oracle sweep
sorts ``Kmers(sc, min_k, max_k)`` and holds the sorted start indices to
``tests/oracle.expected_kmers``; the mesh sweep sorts the same positions
with ``parallel.sample_sort_positions`` on a mesh of 2..GKT_TEST_DEVICES
(default 8) shards of the one device against ``ops.sort.sort_positions``;
the filtered sweep holds ``get_kmer_group_counts`` under a GC, homopolymer
or no-ambiguity filter to ``tests/oracle.expected_hist`` over the filter
evaluated position by position on the host, the ``ValueError`` texts
equal where either side raises. ``--device`` is cuda by default (it raises
without CUDA) and cpu for a dry run. A failing case prints its seed; the
script exits with code 1 after the three summary lines if any case failed.
"""

import argparse
import os
import sys

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from genome_kmers_tpu_torch import Kmers, SequenceCollection  # noqa: E402
from genome_kmers_tpu_torch.ops.filters import (  # noqa: E402
    GcContentFilter,
    HomopolymerFilter,
    NoAmbiguousBasesFilter,
)
from genome_kmers_tpu_torch.ops.keys import cap_lengths, compute_valid_len  # noqa: E402
from genome_kmers_tpu_torch.ops.sort import sort_positions  # noqa: E402
from genome_kmers_tpu_torch.parallel import make_mesh, sample_sort_positions  # noqa: E402
from genome_kmers_tpu_torch.sequence_collection import resolve_device  # noqa: E402
from oracle import expected_hist, expected_kmers  # noqa: E402

ORACLE_SEED, MESH_SEED, FILTER_SEED = 224, 500, 900  # first seed of each sweep
MESH_SIZE_SEED = 77

# the case generator of tests/test_fuzz.py (which imports JAX): the same
# cases from the same seeds
ALPHABETS = ["ACGT", "ACGTN", "ACGTRYSWKMBDHVN"]


def random_case(seed):
    rng = np.random.default_rng(seed)
    alphabet = ALPHABETS[seed % len(ALPHABETS)]
    n_records = int(rng.integers(1, 5))
    seq_list = []
    for r in range(n_records):
        n = int(rng.integers(8, 200))
        seq_list.append((f"r{r}", "".join(rng.choice(list(alphabet), size=n))))
    shortest = min(len(s) for _, s in seq_list)
    min_k = int(rng.integers(1, shortest + 1))
    choice = seed % 3
    if choice == 0:
        max_k = None
    elif choice == 1:
        max_k = min_k
    else:
        max_k = int(rng.integers(min_k, max(shortest, min_k) + 1))
    return seq_list, min_k, max_k


def _collection(seq_list, device):
    return SequenceCollection(sequence_list=seq_list, strands_to_load="forward", device=device)


def oracle_soak(n_cases: int, device: str = "cuda") -> list:
    """``Kmers.sort()`` of each case against the string oracle; returns the
    failing cases as (seed, min_k, max_k)."""
    resolve_device(device)
    fails = []
    for seed in range(ORACLE_SEED, ORACLE_SEED + n_cases):
        seq_list, min_k, max_k = random_case(seed)
        km = Kmers(_collection(seq_list, device), min_kmer_len=min_k, max_kmer_len=max_k)
        km.sort()
        _, _, _, exp_idx = expected_kmers(seq_list, min_k, max_k)
        if km.kmer_sba_start_indices.tolist() != exp_idx:
            print("FAIL", seed, min_k, max_k, flush=True)
            fails.append((seed, min_k, max_k))
    return fails


def mesh_soak(n_cases: int, device: str = "cuda", max_shards: int = 8) -> list:
    """The sample sort on a mesh of 2..max_shards shards of ``device`` (one
    size a case, drawn from a seeded stream) against the one-device sort of
    the same positions; returns the failing cases as (seed, min_k, max_k,
    shards)."""
    resolve_device(device)
    fails = []
    mesh_rng = np.random.default_rng(MESH_SIZE_SEED)
    for seed in range(MESH_SEED, MESH_SEED + n_cases):
        shards = int(mesh_rng.integers(2, max_shards + 1))
        mesh = make_mesh(devices=[device] * shards)
        seq_list, min_k, max_k = random_case(seed)
        sc = _collection(seq_list, device)
        km = Kmers(sc, min_kmer_len=min_k, max_kmer_len=max_k)
        dc = sc.device_cache("forward")
        pos = torch.from_numpy(km.kmer_sba_start_indices.astype(np.int64)).to(dc.device)
        cap = cap_lengths(compute_valid_len(pos, dc.seg_starts, dc.seg_ends), max_k)
        truth = sort_positions(dc.packed, pos, cap, max_k,
                               packed2=dc.packed2 if (max_k and max_k <= 64) else None)
        got = sample_sort_positions(dc.packed, pos, dc.seg_starts, dc.seg_ends, max_k, mesh,
                                    packed2=dc.packed2)
        if not torch.equal(got.cpu(), truth.cpu()):
            print("DFAIL", seed, min_k, max_k, flush=True)
            fails.append((seed, min_k, max_k, shards))
    return fails


def random_filter(seed, min_k, max_k, seq_list):
    """(filter, k) of a filtered case: one of three library filters at a
    length drawn from the case's range, by the seed."""
    rng = np.random.default_rng(seed * 7 + 1)
    hi = max_k if max_k is not None else min(len(s) for _, s in seq_list)
    k = int(rng.integers(min_k, hi + 1))
    which = seed % 3
    if which == 0:
        lo_f, hi_f = sorted(rng.random(2))
        return GcContentFilter(float(lo_f), float(hi_f), k), k
    if which == 1:
        return HomopolymerFilter(int(rng.integers(1, k + 2)), k), k
    return NoAmbiguousBasesFilter(k), k


def filtered_soak(n_cases: int, device: str = "cuda") -> list:
    """Filtered group counts of each case against the oracle over the scalar
    filter; returns the failing cases as (seed, filter name, k, the
    oracle's error, the port's error)."""
    resolve_device(device)
    fails = []
    for seed in range(FILTER_SEED, FILTER_SEED + n_cases):
        seq_list, min_k, max_k = random_case(seed)
        km = Kmers(_collection(seq_list, device), min_kmer_len=min_k, max_kmer_len=max_k)
        km.sort()
        filt, k = random_filter(seed, min_k, max_k, seq_list)
        sba = km._host_sba()
        _, _, sorted_kmers, _ = expected_kmers(seq_list, min_k, max_k)
        exp_err = got_err = exp = got = None
        try:
            # the scalar filter at every sorted position; truncation raises
            # exactly where the reference's walk would
            keep_mask = [bool(filt(sba, "+", int(p))) for p in km.kmer_sba_start_indices]
            exp = expected_hist(sorted_kmers, k, keep=lambda i: keep_mask[i])
        except ValueError as e:
            exp_err = str(e)
        try:
            got = km.get_kmer_group_counts(k, kmer_filter_func=filt)
        except ValueError as e:
            got_err = str(e)
        if exp_err or got_err:
            ok = exp_err == got_err
        else:
            ok = np.array_equal(np.asarray(got[0], dtype=np.int64), exp[0]) and int(got[1]) == int(exp[1])
        if not ok:
            print("FFAIL", seed, type(filt).__name__, k, exp_err, got_err, flush=True)
            fails.append((seed, type(filt).__name__, k, exp_err, got_err))
    return fails


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_oracle", nargs="?", type=int, default=150)
    ap.add_argument("n_dist", nargs="?", type=int, default=40)
    ap.add_argument("n_filt", nargs="?", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="device of the collections and meshes (cuda, or cpu for a dry run)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    max_shards = int(os.environ.get("GKT_TEST_DEVICES", "8"))
    fails = oracle_soak(args.n_oracle, args.device)
    print(f"oracle soak: {args.n_oracle - len(fails)}/{args.n_oracle} ok", flush=True)
    dfails = mesh_soak(args.n_dist, args.device, max_shards)
    print(f"distributed soak (incl. suffix/long-k): {args.n_dist - len(dfails)}/{args.n_dist} ok",
          flush=True)
    ffails = filtered_soak(args.n_filt, args.device)
    print(f"filtered soak: {args.n_filt - len(ffails)}/{args.n_filt} ok", flush=True)
    return 1 if (fails or dfails or ffails) else 0


if __name__ == "__main__":
    sys.exit(main())
