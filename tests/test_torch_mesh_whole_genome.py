"""The whole-genome mesh index on the CPU, at test sizes: the port's
``sort(mesh=)``, ``get_kmer_group_counts(31, mesh=)`` and
``get_kmer_count(31, mesh=)`` on four CPU shards against the blocked plain
reference of ``kmerbench/reference/blocked.py``; that reference against
``kmerbench/reference/kmers_ref.py``, sound and with planted faults; rows
whose positions straddle 2^31 through the plain path of the exchange; and
the ``gk:mesh.*`` spans, paired as the benchmark pairs them. A few seconds
in all."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import genome_kmers_tpu_torch as gk
from genome_kmers_tpu_torch import tracing
from genome_kmers_tpu_torch.ops.keys import u32_bits_as_int32
from genome_kmers_tpu_torch.parallel import collectives, make_mesh
from genome_kmers_tpu_torch.parallel.sample_sort import _exchange_merge, _padded, ragged_rows
from kmerbench import catalog, genome, program_spans
from kmerbench.reference import blocked
from kmerbench.reference import kmers_ref as ref

CONFIG = {
    "records": [["chr1", 3000], ["chr2", 2200], ["chrM", 300]],
    "gc_share": 0.409,
    "repeat_families": {"families": 4, "element_bp": 300, "copies_min": 2, "copies_max": 12,
                        "mutation_rate": 0.02},
    "n_runs": {"fixed": [], "placed": []},
}
SORT = ["gk:mesh.pack", "gk:mesh.keys", "gk:mesh.local_sort", "gk:mesh.splitters",
        "gk:mesh.bounds", "gk:mesh.exchange", "gk:mesh.merge", "gk:mesh.layout"]
STATS = ["gk:mesh.groups", "gk:mesh.histogram", "gk:mesh.readback"]


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks and chunks small enough that pairs and groups cross their
    edges, on the CPU."""
    monkeypatch.setattr(blocked, "BLOCK_ROWS", 317)
    monkeypatch.setattr(blocked, "CHUNK", 1000)
    monkeypatch.setattr(blocked, "DEVICES", ["cpu", "cpu"])


def _records(seed):
    return genome.make_records(CONFIG, seed)


def _mesh_index(records):
    seqs = [(name, b.tobytes().decode("ascii")) for name, b in records]
    sc = gk.SequenceCollection(sequence_list=seqs, strands_to_load="forward", device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    km = gk.Kmers(sc, 31, 31)
    km.sort(mesh=mesh)
    return km, mesh


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 9_000_000_011])
def test_port_mesh_equals_blocked_reference(small_blocks, seed):
    records = _records(seed)
    km, mesh = _mesh_index(records)
    pos = np.asarray(km.kmer_sba_start_indices)
    g = blocked.Genome(records)
    errs, ix = blocked.check_index(g, pos, 31, 31)
    assert errs == {"rows": g.kmer_count(31), "outside": 0, "too_short": 0, "duplicates": 0,
                    "missing": 0, "unordered_pairs": 0}
    hist, total = km.get_kmer_group_counts(31, mesh=mesh)
    want_hist, want_total = ix.group_counts(31)
    np.testing.assert_array_equal(hist, want_hist)
    assert total == want_total == km.get_kmer_count(31, mesh=mesh) == g.kmer_count(31)
    assert want_hist[2:].sum() > 0  # repeats: groups above one


def _faults(pos):
    swapped = pos.copy()
    swapped[[40, 41]] = swapped[[41, 40]]
    return {"sound": pos, "swapped_pair": swapped, "dropped_row": np.delete(pos, 700),
            "repeated_row": np.insert(pos, 318, pos[317])}


@pytest.mark.parametrize("max_len", [31, 12])
def test_blocked_reference_equals_kmers_ref(small_blocks, max_len):
    records = _records(77)
    g_ref, g = ref.Genome(records), blocked.Genome(records)
    want = np.flatnonzero(g_ref.vl.numpy() >= max_len).astype(np.uint32)
    ix0 = ref.Index(g_ref, want, max_len)
    keys = [ix0.prefix_words(o, max_len) for o in range(0, max_len, g_ref.B)]
    pos = want[np.lexsort([want] + [k.numpy() for k in reversed(keys)])]
    for name, p in _faults(pos).items():
        errs, ix = blocked.check_index(g, p, max_len, max_len)
        errs_ref, ix_ref = ref.check_index(g_ref, p, max_len, max_len)
        assert errs == errs_ref, name
        assert (sum(v for k, v in errs.items() if k != "rows") == 0) == (name == "sound"), name
        for k in {max_len, 9}:
            hist, total = ix.group_counts(k)
            hist_ref, total_ref = ref.group_counts(ix_ref, k)
            np.testing.assert_array_equal(hist, hist_ref)
            assert total == total_ref
    side = catalog.reference_step("mesh_group_counts")
    want = blocked.check_index(g, pos, max_len, max_len)[1].group_counts(max_len)
    got = ref.group_counts(ref.check_index(g_ref, pos, max_len, max_len)[1], max_len)
    assert side.matches(got, want)
    wrong = got[0].copy()
    wrong[1] += 1  # a wrong bin
    assert not side.matches((wrong, got[1]), want)


def test_blocked_control_equals_kmers_ref(small_blocks):
    records = _records(5)
    g_ref, g = ref.Genome(records), blocked.Genome(records)
    for bits in (8, 32):
        fp = blocked.control_index_fingerprint(g, 31, 31, bits)
        np.testing.assert_array_equal(fp, ref.control_index_fingerprint(g_ref, 31, 31, bits))
        errs, ix = blocked.check_index(g, fp, 31, 31)
        assert errs["unordered_pairs"] > 0 and errs["missing"] == errs["duplicates"] == 0
        _, ix_ref = ref.check_index(g_ref, fp, 31, 31)
        hist, total = blocked.control_group_counts(ix, 31, bits)
        hist_ref, total_ref = ref.control_group_counts(ix_ref, 31, None, bits)
        np.testing.assert_array_equal(hist, hist_ref)
        assert total == total_ref


def test_exchange_orders_positions_across_2_31():
    """Equal keys, positions on both sides of 2^31 (negative int32 bit
    patterns past it), dealt over four shards in any order: the plain path
    of the exchange and merge puts them in ascending unsigned order, and
    ``ragged_rows`` gives them back as uint32."""
    mesh = make_mesh(devices=["cpu"] * 4)
    rng = np.random.default_rng(31)
    base = 1 << 31
    pos = np.concatenate([np.arange(base - 60, base + 60), np.arange(2**32 - 40, 2**32 - 1)])
    rng.shuffle(pos)
    keys = rng.integers(0, 3, pos.shape[0])  # three groups of equal keys
    lanes = []
    for part, kpart in zip(np.array_split(pos, 4), np.array_split(keys, 4)):
        p = torch.from_numpy(part.astype(np.int64))
        word = torch.from_numpy(kpart.astype(np.int64)) << 30
        lanes.append((u32_bits_as_int32(word), torch.zeros_like(p, dtype=torch.int32),
                      u32_bits_as_int32(p)))
    rows = -(-pos.shape[0] // 4)
    merged, info = _exchange_merge(lanes, None, rows, mesh, 1.5, n_samples=16)
    out_pos, out_pad, _ = _padded(merged, info["shard_rows"])
    got = ragged_rows(out_pos, out_pad)
    assert got.dtype == np.uint32
    want = pos[np.lexsort([pos, keys])].astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _host_ranges(events):
    """The ``(start, end, label)`` arrays of the ops that the benchmark's
    ``kmerbench:<op>`` ranges call directly, as ``kmerbench/trace.py``
    reads them from a device trace."""
    children = sorted(
        ((e.time_range.start, e.time_range.end, f"{e.cpu_parent.name[10:]}/{e.name}")
         for e in events if e.cpu_parent is not None
         and e.cpu_parent.name.startswith("kmerbench:")),
        key=lambda t: t[0])
    return tuple(np.array([c[i] for c in children]) for i in range(2)) + (
        [c[2] for c in children],)


def test_mesh_spans_in_order_and_paired(monkeypatch):
    records = _records(11)
    seqs = [(name, b.tobytes().decode("ascii")) for name, b in records]
    sc = gk.SequenceCollection(sequence_list=seqs, strands_to_load="forward", device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    km = gk.Kmers(sc, 31, 31)
    tracing.take()
    collectives.reset_traffic()
    calls = [("mesh_sort", lambda: km.sort(mesh=mesh)),
             ("mesh_group_counts", lambda: km.get_kmer_group_counts(31, mesh=mesh)),
             ("mesh_count", lambda: km.get_kmer_count(31, mesh=mesh))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for op, fn in calls:
            with torch.profiler.record_function("kmerbench:" + op):
                fn()
    events = prof.events()
    ranges = sorted((e for e in events if e.name.startswith("gk:")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == SORT + STATS + STATS
    for a, b in zip(ranges, ranges[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)  # none nested
    monkeypatch.setattr(program_spans, "_paired", [0])
    run = SimpleNamespace(device=SimpleNamespace(host=_host_ranges(events)))
    ph = program_spans.phases(run)
    assert [p.name for p in ph] == SORT + STATS + STATS
    assert [p.call for p in ph] == [ph[0].call] * 8 + [ph[0].call + 1] * 3 + [ph[0].call + 2] * 3
    recs = tracing.take()
    assert all(r["device_ms"] is None and r["card_ms"] is None for r in recs)
    assert recs[0]["rows"] == len(sc.device_cache("forward").sba)  # the pack's slices
    # the CPU shards share one device: no copy from one card to another
    assert collectives.TRAFFIC["peer_bytes"] == collectives.TRAFFIC["peer_copies"] == 0
