#!/usr/bin/env python
"""Profiling CLI for the PyTorch port (genome_kmers_tpu_torch.profiling).

The flag surface of tools/run_profiling.py: --run-size
{small,medium,large}, --num-iter, --category
{all,seq_list_init,fasta_init,get_segment_num,kmers_sort,large_sort},
--output-base for CSV dumps; plus --device (default cuda; cpu for a dry run
on a machine without a card), and --n-devices, the mesh of large_sort
(LargeKmers; all visible cards by default, one CPU shard with --device
cpu). There is no compile cache to enable.

    python3 tools/torch_run_profiling.py -s small -c kmers_sort -n 2 -o out/prof
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from genome_kmers_tpu_torch import profiling  # noqa: E402

logger = logging.getLogger("torch_run_profiling")

RUN_SIZES = {
    "small": {
        "seq_list_lens": [10**6, 10**7],
        "fasta_lens": [10**6, 10**7],
        "segment_num_chroms": [1, 10, 100],
        "sort_lens": [10**6],
        "sort_ks": [31],
    },
    "medium": {
        "seq_list_lens": [10**6, 10**7, 10**8],
        "fasta_lens": [10**6, 10**7, 10**8],
        "segment_num_chroms": [1, 100, 10**4],
        "sort_lens": [10**6, 10**7],
        "sort_ks": [21, 31],
    },
    "large": {
        "seq_list_lens": [10**7, 10**8],
        "fasta_lens": [10**7, 10**8],
        "segment_num_chroms": [1, 100, 10**4, 10**6],
        "sort_lens": [10**7, 10**8, 2 * 10**8],
        "sort_ks": [21, 31, 55],
    },
}


def parse_args():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--run-size",
        "-s",
        type=str,
        default="small",
        choices=["small", "medium", "large"],
        help="size of the profiling run. 'small' is quick but incomplete; "
        "'large' is slower but more complete.",
    )
    parser.add_argument(
        "--num-iter",
        "-n",
        type=int,
        default=3,
        help="number of run times over which to average. Must be > 0.",
    )
    parser.add_argument(
        "--category",
        "-c",
        type=str,
        default="all",
        choices=["all", "seq_list_init", "fasta_init", "get_segment_num",
                 "kmers_sort", "large_sort"],
    )
    parser.add_argument(
        "--device",
        type=str,
        default="cuda",
        help="device of the collections and indexes (cuda, or cpu for a dry run)",
    )
    parser.add_argument(
        "--n-devices",
        type=int,
        default=None,
        help="mesh shards of large_sort (default: every visible card; 1 on the cpu)",
    )
    parser.add_argument(
        "--output-base",
        "-o",
        type=str,
        default=None,
        help="output file base used as the prefix for profiling CSV files",
    )
    args = parser.parse_args()

    if args.num_iter < 1:
        raise ValueError(f"number of iterations requested ({args.num_iter}) is < 1")
    if args.output_base is not None:
        dir_path, file_base = os.path.split(args.output_base)
        if dir_path != "" and not os.path.isdir(dir_path):
            raise ValueError(f"directory path ({dir_path}) does not exist")
        if len(file_base) < 1:
            raise ValueError(
                f"a file base is not present in the output_base argument ({args.output_base})"
            )
    return args


def _dump(df, output_base, name):
    logger.info("%s results:\n%s", name, df.to_string())
    if output_base is not None:
        path = f"{output_base}-{name}.csv"
        df.to_csv(path, index=False)
        logger.info("wrote %s", path)


def main():
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    args = parse_args()
    sizes = RUN_SIZES[args.run_size]

    if args.category in ("all", "seq_list_init"):
        df = profiling.profile_seq_list_init(
            sizes["seq_list_lens"], num_iterations=args.num_iter, device=args.device
        )
        _dump(df, args.output_base, "seq_list_init")

    if args.category in ("all", "fasta_init"):
        df = profiling.profile_fasta_init(
            sizes["fasta_lens"], num_iterations=args.num_iter, device=args.device
        )
        _dump(df, args.output_base, "fasta_init")

    if args.category in ("all", "get_segment_num"):
        df = profiling.profile_get_segment_num_from_sba_index(
            10**7, sizes["segment_num_chroms"], num_iterations=args.num_iter,
            device=args.device,
        )
        _dump(df, args.output_base, "get_segment_num")

    if args.category in ("all", "kmers_sort"):
        df = profiling.profile_kmers_sort(
            sizes["sort_lens"], sizes["sort_ks"], num_iterations=args.num_iter,
            device=args.device,
        )
        _dump(df, args.output_base, "kmers_sort")

    if args.category == "large_sort":
        # not in "all", as in tools/run_profiling.py
        df = profiling.profile_large_sort(
            sizes["sort_lens"], sizes["sort_ks"], num_iterations=args.num_iter,
            n_devices=args.n_devices, device=args.device,
        )
        _dump(df, args.output_base, "large_sort")


if __name__ == "__main__":
    main()
