"""The four-card cell ``chm13.mesh4`` at test size on four CPU shards: correct
through ``run_cell``, not correct with a planted fault or as the control;
and on two cards the counter of the copies from card to card."""

import numpy as np
import pytest
import torch
from kmerbench_helpers import tiny_config

import genome_kmers_tpu_torch as gk
from genome_kmers_tpu_torch.parallel import collectives, make_mesh
from kmerbench import catalog
from kmerbench.reference import blocked
from kmerbench.run import run_cell

BENCH = catalog.load_benchmark()
CELL = "chm13.mesh4"
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """Blocks that cut the tiny index in several places."""
    monkeypatch.setattr(blocked, "BLOCK_ROWS", 1000)
    monkeypatch.setattr(blocked, "CHUNK", 3000)


def _run(devices=CPU4, control=False, seconds=0.3):
    cell = catalog.cell(BENCH, CELL)
    config = tiny_config(catalog.config(BENCH, cell["config"]))
    return run_cell(BENCH, cell, config, catalog.mix(cell["traffic"]), 2**31 + 23, seconds,
                    False, devices, control=control)


def test_cell_correct_on_four_cpu_shards():
    result, notes = _run()
    assert result["correct"] is True, (result["checks"], notes["error"])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"index_kmers_per_s", "setup_s"}  # no device peak
    assert [op for op, _ in notes["setup"][2:6]] == ["collection", "upload", "pack", "mesh"]


def _drop_last_row(original):
    def sort(self, *args, **kwargs):
        """The mesh sort leaves its last real row out of the index."""
        original(self, *args, **kwargs)
        cache = self._dist_cache
        last = max(i for i, pad in enumerate(cache.is_pad) if bool((~pad).any()))
        pad = cache.is_pad[last].clone()
        pad[int((~pad).sum()) - 1] = True
        cache.is_pad[last] = pad
        cache.n_real -= 1
    return sort


def _altered_answer(original):
    def get_kmer_group_counts(self, *args, **kwargs):
        hist, total = original(self, *args, **kwargs)
        hist = hist.copy()
        hist[1] += 1
        return hist, total
    return get_kmer_group_counts


@pytest.mark.parametrize("method,make", [("sort", _drop_last_row),
                                         ("get_kmer_group_counts", _altered_answer)])
def test_planted_fault_is_not_correct(monkeypatch, method, make):
    monkeypatch.setattr(gk.Kmers, method, make(getattr(gk.Kmers, method)))
    result, notes = _run()
    assert result["correct"] is False, (method, result["checks"], notes["error"])


def test_control_is_not_correct():
    result, notes = _run(control=True)
    assert result["correct"] is True
    assert notes["control"]["correct"] is False
    assert notes["control"]["checks"]["index_bad_rows"]["value"] > 0


@pytest.mark.card
def test_peer_bytes_counted_between_two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    rng = np.random.default_rng(4)
    seq = "".join(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 50000)]
                  .tobytes().decode())
    sc = gk.SequenceCollection(sequence_list=[("chr1", seq)], strands_to_load="forward",
                               device="cuda:0")
    mesh = make_mesh(devices=["cuda:0", "cuda:1"])
    km = gk.Kmers(sc, 31, 31)
    collectives.reset_traffic()
    km.sort(mesh=mesh)
    moved = dict(collectives.TRAFFIC)
    # shard 1 receives its slice of the pack and half of the exchange at least
    assert moved["peer_copies"] > 0
    assert moved["peer_bytes"] >= 4 * (len(seq) // 2)
    assert moved["collectives"] == moved["device_bytes"] == moved["host_bytes"] == 0
    same = make_mesh(devices=["cuda:0", "cuda:0"])
    collectives.reset_traffic()
    gk.Kmers(sc, 31, 31).sort(mesh=same)
    assert collectives.TRAFFIC["peer_copies"] == collectives.TRAFFIC["peer_bytes"] == 0
