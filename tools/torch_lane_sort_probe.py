"""Probe of the multi-lane sort kernels on one CUDA card.

    python3 tools/torch_lane_sort_probe.py [--lanes 6] [--rows 134217728]
        [--keys random|constant|repeats]

Builds ``genome_kmers_tpu_torch/csrc/lane_sort.cu``, prints nvcc's register,
shared-memory and spill report and the blocks an SM holds, checks the kernels
bitwise against the plain version ``ops/sort.py::sort_lanes`` on tied lanes at
sizes around the tile, then times one call at ``--rows`` x ``--lanes`` random
lanes (CUDA events, mean of 3 after a warm-up) beside the plain version and
prints the device time by kernel from torch.profiler. ``--keys constant``
makes every key lane constant, so that every compare runs to the last lane
(the worst case of the lane-by-lane compare); ``--keys repeats`` draws the
key rows from 1024 distinct rows, as a genome of repeats would.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels import lane_sort as ls
from genome_kmers_tpu_torch.ops.sort import sort_lanes


def tied_lanes(rng, n_lanes: int, n: int, dev):
    lanes = []
    for lane in range(n_lanes - 1):
        vals = rng.integers(0, 40 if lane == 0 else 3, size=n).astype(np.uint32)
        high = rng.random(n) < 0.25
        lanes.append(np.where(high, np.uint32(0xFFFFFFFF) - vals, vals).astype(np.uint32))
    lanes.append(rng.permutation(n).astype(np.uint32))
    return tuple(torch.from_numpy(lane.view(np.int32)).to(dev) for lane in lanes)


def random_lanes(n_lanes: int, n: int, dev, keys: str = "random"):
    """(0/1 lane, random words, permutation): the shape of the 4-bit key."""
    last = torch.randperm(n, device=dev).to(torch.int32)
    if keys == "constant":
        return tuple(torch.full((n,), 7, dtype=torch.int32, device=dev) for _ in range(n_lanes - 1)) + (last,)
    if keys == "repeats":
        which = torch.randint(0, 1024, (n,), device=dev)
        table = torch.randint(-(1 << 31), 1 << 31, (n_lanes - 1, 1024), dtype=torch.int32, device=dev)
        return tuple(table[lane][which] for lane in range(n_lanes - 1)) + (last,)
    lanes = ()
    if n_lanes > 2:
        lanes += (torch.randint(0, 2, (n,), dtype=torch.int32, device=dev),)
    lanes += tuple(
        torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=dev)
        for _ in range(n_lanes - 1 - len(lanes))
    )
    return lanes + (last,)


def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lanes", type=int, default=6)
    parser.add_argument("--rows", type=int, default=1 << 27)
    parser.add_argument("--keys", choices=("random", "constant", "repeats"), default="random")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_lane_sort_probe: CUDA is not available")
    lib = build.build(ls.SOURCE)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line or "warning" in line:
            print(line.strip()[:160])
    dev = torch.device("cuda")
    resident = {nl: ls.blocks_resident(nl) for nl in range(1, ls.MAX_LANES + 1)}
    rng = np.random.default_rng(1)
    tile = ls.TILE_ROWS
    for n_lanes in sorted({1, 2, 3, 6, 7, 8, args.lanes}):
        for n in (2, 127, tile - 1, tile, tile + 1, 2 * tile + 1, 3 * tile, 5 * tile + 17,
                  (1 << 20) + 7, 1 << 22):
            lanes = tied_lanes(rng, n_lanes, n, dev)
            got, want = ls.sort_lanes_cuda(lanes), sort_lanes(lanes)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"MISMATCH at {n_lanes} lanes, n={n}")
    lanes = random_lanes(args.lanes, args.rows, dev, args.keys)
    got, want = ls.sort_lanes_cuda(lanes), sort_lanes(lanes)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"MISMATCH at {args.lanes} lanes, n={args.rows}")
    del got, want
    ms = cuda_ms(lambda: ls.sort_lanes_cuda(lanes))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ls.sort_lanes_cuda(lanes)
        torch.cuda.synchronize()
    by_kernel = {}
    for event in prof.key_averages():
        for name in ("block_sort", "merge_tiles", "merge_partition"):
            if name in event.key:
                by_kernel[name] = (event.count, event.self_device_time_total / 1e3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    print(f"probe [{smi}] {args.rows} rows x {args.lanes} lanes, {args.keys} keys: bitwise equal, "
          f"passes {ls.sort_lanes_cuda.passes}, kernel {ms:.3f} ms; by kernel (launches, ms): "
          f"{by_kernel}; resident (sort, merge) blocks {resident[args.lanes]}", flush=True)
    print(f"resident (sort, merge) blocks an SM by lanes: {resident}")
    print(f"plain version {cuda_ms(lambda: sort_lanes(lanes)):.3f} ms")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
