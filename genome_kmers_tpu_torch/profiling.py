"""Benchmark harness: the reference's profiling layer, for the port.

Counterpart of ``genome_kmers_tpu/profiling.py``, with the same generators,
timed runners, sweeps and DataFrame columns: seeded random genomes, timed
runners, and sweeps returning pandas DataFrames with avg_run_time,
with the reference's discard-first-run hygiene (the first run pays the
kernels' build and the allocator's growth).

Every sweep and runner takes ``device`` (default "cuda", as every entry
point of the port). A timed call on a CUDA device ends in
``torch.cuda.synchronize()``, so it measures the work on the card and not
its enqueue. ``profile_large_sort`` sweeps the ``LargeKmers`` build over a
mesh of the device's shards.
"""

from __future__ import annotations

import logging
import tempfile
import time
from pathlib import Path
from typing import Callable, Union

import numpy as np
import torch

from .kmers import Kmers
from .sequence_collection import SequenceCollection

logger = logging.getLogger(__name__)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def get_random_seq(seq_len: int, seed: int = 42) -> str:
    """Seeded random ACGT sequence (reference profiling.py:12-30)."""
    rng = np.random.default_rng(seed)
    return bytearray(rng.choice(BASES, size=seq_len)).decode()


def get_random_seq_list(total_seq_len: int, num_chromosomes: int, seed: int = 42) -> list:
    """Split total_seq_len across num_chromosomes records (reference
    profiling.py:33-53)."""
    base_len = total_seq_len // num_chromosomes
    lens = [base_len] * num_chromosomes
    lens[-1] += total_seq_len - base_len * num_chromosomes
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        seq = bytearray(rng.choice(BASES, size=n)).decode()
        out.append((f"chr{i + 1}", seq))
    return out


def write_seq_list_to_file(seq_list, file_path=None) -> Path:
    """Write a seq_list as FASTA (reference profiling.py:275-298)."""
    if file_path is None:
        f = tempfile.NamedTemporaryFile(mode="w", suffix=".fasta", delete=False)
        file_path = Path(f.name)
        f.close()
    with open(file_path, "w") as fh:
        for name, seq in seq_list:
            fh.write(f">{name}\n{seq}\n")
    return Path(file_path)


def _finish(device) -> None:
    """Wait for the work queued on ``device``: a CUDA call returns before
    the card has finished it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def get_run_time(func: Callable) -> Callable:
    """Wall-clock decorator (reference profiling.py:56-67): the wrapped
    function returns (run_time_seconds, result). A ``device`` keyword of
    the call is passed on, and the clock stops once that device has
    finished the call's work."""

    def wrapper(*args, **kwargs):
        device = kwargs.get("device", "cuda")
        _finish(device)
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        _finish(device)
        run_time = time.perf_counter() - t0
        return run_time, result

    return wrapper


# --------------------------------------------------------------------------- #
# timed runners (reference profiling.py:70-107)
# --------------------------------------------------------------------------- #


@get_run_time
def run_seq_list_init(seq_list, strands_to_load="forward", device="cuda"):
    return SequenceCollection(
        sequence_list=seq_list, strands_to_load=strands_to_load, device=device
    )


@get_run_time
def run_fasta_init(fasta_file_path, strands_to_load="forward", device="cuda"):
    return SequenceCollection(
        fasta_file_path=fasta_file_path, strands_to_load=strands_to_load, device=device
    )


@get_run_time
def run_get_segment_num_from_sba_index(seq_coll, strand_to_test, sba_indices, device="cuda"):
    return [
        seq_coll.get_segment_num_from_sba_index(int(i), sba_strand=strand_to_test)
        for i in sba_indices
    ]


def get_sba_indices_to_test(
    seq_coll: SequenceCollection,
    num_lookups: int,
    strand: str,
    shuffle: bool = True,
    seed: Union[int, None] = None,
) -> np.ndarray:
    """SBA indices covering every chromosome on the requested strand
    (reference profiling.py:161-209): all segment starts first, then
    linearly spaced fill up to ``num_lookups``, optionally shuffled."""
    if num_lookups < 1:
        raise ValueError(f"num_lookups ({num_lookups}) < 1")
    if strand == "forward":
        seg_starts = seq_coll._forward_sba_seg_starts
        sba_len = len(seq_coll.forward_sba)
    elif strand == "reverse_complement":
        seg_starts = seq_coll._revcomp_sba_seg_starts
        sba_len = len(seq_coll.revcomp_sba)
    else:
        raise ValueError(f"strand ({strand}) not recognized")

    if len(seg_starts) >= num_lookups:
        sba_indices = np.asarray(seg_starts[:num_lookups], dtype=np.uint32)
    else:
        fill = np.linspace(0, sba_len - 1, num_lookups - len(seg_starts), dtype=np.uint32)
        sba_indices = np.concatenate((np.asarray(seg_starts, dtype=np.uint32), fill))
    if shuffle:
        np.random.default_rng(seed).shuffle(sba_indices)
    if len(sba_indices) != num_lookups:
        raise AssertionError("Logical error. len(sba_indices) != num_lookups")
    return sba_indices


@get_run_time
def run_kmers_sort(kmers: Kmers, device="cuda"):
    # sort() keeps the index on the device; the decorator waits for it
    kmers.sort()
    return kmers


# --------------------------------------------------------------------------- #
# sweeps (reference profiling.py:109-448)
# --------------------------------------------------------------------------- #


def _summarize(rows, columns):
    import pandas as pd

    return pd.DataFrame(rows, columns=columns)


def profile_seq_list_init(
    seq_lens: list[int],
    strands_to_load_list: list[str] = ["forward", "reverse_complement", "both"],
    num_iterations: int = 3,
    discard_first_run: bool = True,
    seed: int = 42,
    device="cuda",
):
    """Sweep SequenceCollection seq_list init times (reference
    profiling.py:109-158)."""
    rows = []
    for seq_len in seq_lens:
        seq_list = [("chr1", get_random_seq(seq_len, seed=seed))]
        for strands in strands_to_load_list:
            times = []
            n = num_iterations + (1 if discard_first_run else 0)
            for i in range(n):
                run_time, _ = run_seq_list_init(seq_list, strands, device=device)
                if discard_first_run and i == 0:
                    continue
                times.append(run_time)
            rows.append(
                [seq_len, strands, num_iterations, float(np.mean(times)), float(np.min(times))]
            )
            logger.info("seq_list_init len=%s strands=%s avg=%.4fs", seq_len, strands, rows[-1][3])
    return _summarize(
        rows, ["seq_len", "strands_to_load", "num_iterations", "avg_run_time", "min_run_time"]
    )


def profile_fasta_init(
    seq_lens: list[int],
    num_chromosomes: int = 10,
    num_iterations: int = 3,
    discard_first_run: bool = True,
    seed: int = 42,
    device="cuda",
):
    """Sweep FASTA-file init times (reference profiling.py:301-364)."""
    rows = []
    for seq_len in seq_lens:
        seq_list = get_random_seq_list(seq_len, num_chromosomes, seed=seed)
        fasta_path = write_seq_list_to_file(seq_list)
        try:
            times = []
            n = num_iterations + (1 if discard_first_run else 0)
            for i in range(n):
                run_time, _ = run_fasta_init(fasta_path, device=device)
                if discard_first_run and i == 0:
                    continue
                times.append(run_time)
            rows.append(
                [seq_len, num_chromosomes, num_iterations, float(np.mean(times)), float(np.min(times))]
            )
            logger.info("fasta_init len=%s avg=%.4fs", seq_len, rows[-1][3])
        finally:
            fasta_path.unlink(missing_ok=True)
    return _summarize(
        rows, ["seq_len", "num_chromosomes", "num_iterations", "avg_run_time", "min_run_time"]
    )


def profile_get_segment_num_from_sba_index(
    seq_len: int,
    num_chromosomes_list: list[int],
    num_lookups: int = 10000,
    num_iterations: int = 3,
    strand_to_load: str = "forward",
    discard_first_run: bool = True,
    seed: int = 42,
    device="cuda",
):
    """Sweep record-lookup times vs chromosome count (reference
    profiling.py:212-272), on the strand the load implies: forward/both
    genomes look up forward-strand indices, revcomp-only genomes look up
    revcomp-strand indices (reference profiling.py:243-247)."""
    if strand_to_load in ("forward", "both"):
        strand_to_test = "forward"
    else:
        strand_to_test = "reverse_complement"
    rows = []
    for num_chromosomes in num_chromosomes_list:
        seq_list = get_random_seq_list(seq_len, num_chromosomes, seed=seed)
        seq_coll = SequenceCollection(
            sequence_list=seq_list, strands_to_load=strand_to_load, device=device
        )
        sba_indices = get_sba_indices_to_test(
            seq_coll, num_lookups, strand_to_test, seed=seed
        )
        times = []
        n = num_iterations + (1 if discard_first_run else 0)
        for i in range(n):
            run_time, _ = run_get_segment_num_from_sba_index(
                seq_coll, strand_to_test, sba_indices, device=device
            )
            if discard_first_run and i == 0:
                continue
            times.append(run_time)
        rows.append(
            [
                seq_len,
                num_chromosomes,
                num_lookups,
                strand_to_test,
                num_iterations,
                float(np.mean(times)),
                float(np.min(times)),
            ]
        )
        logger.info(
            "get_segment_num chroms=%s strand=%s avg=%.4fs",
            num_chromosomes, strand_to_test, rows[-1][5],
        )
    return _summarize(
        rows,
        [
            "seq_len",
            "num_chromosomes",
            "num_lookups",
            "strand_to_test",
            "num_iterations",
            "avg_run_time",
            "min_run_time",
        ],
    )


def profile_large_sort(
    seq_lens: list[int],
    kmer_lens: list[Union[int, None]] = [31],
    num_iterations: int = 3,
    discard_first_run: bool = True,
    seed: int = 42,
    n_devices: Union[int, None] = None,
    device="cuda",
):
    """Sweep the sorted-index build of the 64-bit regime (``LargeKmers``
    over a mesh: strided pack, int64 positions; suffix mode with
    ``kmer_lens=[None]``), on genomes both engines hold, for the regime's
    overhead. The mesh takes ``n_devices`` CUDA cards (all visible ones
    where None); with ``device="cpu"`` it is ``n_devices`` (default 1)
    shards on the CPU."""
    from .large_kmers import LargeKmers
    from .parallel import make_mesh

    if torch.device(device).type == "cpu":
        mesh = make_mesh(devices=["cpu"] * (n_devices or 1))
    else:
        mesh = make_mesh(n_devices)
    rows = []
    for seq_len in seq_lens:
        for kmer_len in kmer_lens:
            records = [("chr1", get_random_seq(seq_len, seed=seed))]
            times = []
            n = num_iterations + (1 if discard_first_run else 0)
            for i in range(n):
                lk = LargeKmers.from_records(records, kmer_len if kmer_len else 1, kmer_len)
                for dev in set(mesh.devices):
                    _finish(dev)
                t0 = time.perf_counter()
                lk.sort(mesh)
                for dev in set(mesh.devices):
                    _finish(dev)
                run_time = time.perf_counter() - t0
                if discard_first_run and i == 0:
                    continue
                times.append(run_time)
            avg = float(np.mean(times))
            num_kmers = lk.num_kmers
            rows.append(
                [seq_len, kmer_len, num_kmers, num_iterations, avg, float(np.min(times)),
                 num_kmers / avg if avg > 0 else float("inf")]
            )
            logger.info(
                "large_sort len=%s k=%s avg=%.4fs (%.3g kmers/s)",
                seq_len, kmer_len, avg, rows[-1][6],
            )
    return _summarize(
        rows,
        [
            "seq_len",
            "kmer_len",
            "num_kmers",
            "num_iterations",
            "avg_run_time",
            "min_run_time",
            "kmers_per_s",
        ],
    )


def profile_kmers_sort(
    seq_lens: list[int],
    kmer_lens: list[Union[int, None]] = [31],
    num_iterations: int = 3,
    discard_first_run: bool = True,
    seed: int = 42,
    device="cuda",
):
    """Sweep the flagship sorted-index build (reference profiling.py:367-448),
    reporting kmers/s alongside wall-clock."""
    rows = []
    for seq_len in seq_lens:
        for kmer_len in kmer_lens:
            seq_list = [("chr1", get_random_seq(seq_len, seed=seed))]
            seq_coll = SequenceCollection(
                sequence_list=seq_list, strands_to_load="forward", device=device
            )
            times = []
            n = num_iterations + (1 if discard_first_run else 0)
            for i in range(n):
                kmers = Kmers(
                    seq_coll,
                    min_kmer_len=kmer_len if kmer_len else 1,
                    max_kmer_len=kmer_len,
                )
                run_time, _ = run_kmers_sort(kmers, device=device)
                if discard_first_run and i == 0:
                    continue
                times.append(run_time)
            avg = float(np.mean(times))
            num_kmers = len(kmers)
            rows.append(
                [seq_len, kmer_len, num_kmers, num_iterations, avg, float(np.min(times)),
                 num_kmers / avg if avg > 0 else float("inf")]
            )
            logger.info(
                "kmers_sort len=%s k=%s avg=%.4fs (%.3g kmers/s)",
                seq_len, kmer_len, avg, rows[-1][6],
            )
    return _summarize(
        rows,
        [
            "seq_len",
            "kmer_len",
            "num_kmers",
            "num_iterations",
            "avg_run_time",
            "min_run_time",
            "kmers_per_s",
        ],
    )
