"""Sharded checkpoints of the port (parallel/checkpoint.py) against the JAX
package's, on the CPU.

The port writes ``gkt_meta.json`` and its arrays as ``.npy`` files; the JAX
package writes the same metadata beside an orbax checkpoint. For the same
sorted index the two metadata files hold the same keys and values; the
port's round trip restores the index (on one device or cut into shards),
whose statistics then need no sort; the validation messages are the JAX
package's. Tolerance: exact equality.
"""

import json

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu import parallel as jp
from genome_kmers_tpu_torch import parallel as tp

SEQS = [
    ("chr1", "ACGTTGCAAGGCTTAACCGGTACGATCGAACGTTGCAAGGCTT" * 9),
    ("chr2", "GGGCCCAAATTTGGGCCCAAATAAAAAAAAAAAAAAAAAAAA"),
    ("chr3", "ACGTNACGTATTGACGTAACGTAC" * 5),
]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _pair(mn=10, mx=20, strand="forward"):
    scj = gj.SequenceCollection(sequence_list=SEQS, strands_to_load=strand)
    sct = gt.SequenceCollection(sequence_list=SEQS, strands_to_load=strand, device="cpu")
    if strand == "forward":
        return gj.Kmers(scj, mn, mx), gt.Kmers(sct, mn, mx)
    return (gj.Kmers.from_strand(scj, mn, mx, source_strand=strand),
            gt.Kmers.from_strand(sct, mn, mx, source_strand=strand))


@pytest.mark.parametrize("strand", ["forward", "reverse_complement"])
@pytest.mark.parametrize("include_genome", [False, True])
def test_meta_json_matches_jax(tmp_path, strand, include_genome):
    kj, kt = _pair(strand=strand)
    kj.sort()
    kt.sort(mesh=tp.make_mesh(devices=["cpu"] * 4))
    jp.save_kmers_sharded(kj, tmp_path / "jax", include_genome=include_genome)
    tp.save_kmers_sharded(kt, tmp_path / "port", include_genome=include_genome)
    want = json.loads((tmp_path / "jax" / "gkt_meta.json").read_text())
    got = json.loads((tmp_path / "port" / "gkt_meta.json").read_text())
    if include_genome:
        # the JAX package's 4-bit pack may be padded past the SBA: the
        # port's is exactly one word a byte
        got_g = got["__arrays__"].pop("packed_genome")
        want_g = want["__arrays__"].pop("packed_genome")
        assert got_g["dtype"] == want_g["dtype"] == "uint32"
        assert got_g["shape"] == [len(kt._host_sba())]
    assert got == want
    pos, genome, meta = tp.load_sharded_index(tmp_path / "port")
    assert pos.dtype == np.uint32 and len(pos) % 1024 == 0
    assert np.array_equal(pos[: meta["__n_real__"]], kj.kmer_sba_start_indices)
    assert np.all(pos[meta["__n_real__"] :] == 0xFFFFFFF0)
    if include_genome:
        assert np.array_equal(genome.view(np.int32), kt._dc().packed.numpy())


@pytest.mark.parametrize("mesh_size", [None, 2, 8])
def test_round_trip_restores_a_sorted_index(tmp_path, monkeypatch, mesh_size):
    _, kt = _pair()
    kt.sort(mesh=tp.make_mesh(devices=["cpu"] * 4))
    tp.save_kmers_sharded(kt, tmp_path / "ckpt")
    fresh = gt.Kmers(kt.seq_coll, 10, 20)
    mesh = None if mesh_size is None else tp.make_mesh(devices=["cpu"] * mesh_size)
    if mesh is not None:
        pos, _, meta = tp.load_sharded_index(tmp_path / "ckpt", mesh=mesh)
        assert len(pos) == mesh_size and all(isinstance(p, torch.Tensor) for p in pos)
    meta = tp.load_kmers_sharded(fresh, tmp_path / "ckpt", mesh=mesh)
    assert meta["num_kmers"] == len(kt) == len(fresh) and fresh._is_sorted
    assert np.array_equal(fresh.kmer_sba_start_indices, kt.kmer_sba_start_indices)
    monkeypatch.setattr(gt.Kmers, "sort", lambda *a, **k: pytest.fail("sorted again"))
    for k in (20, 12):
        got = fresh.get_kmer_group_counts(k, max_counts_bin=40)
        want = kt.get_kmer_group_counts(k, max_counts_bin=40, mesh=kt._dist_cache.mesh)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_checkpoint_validation_raises_as_jax(tmp_path):
    kj, kt = _pair()
    assert _outcome(lambda: tp.save_kmers_sharded(kt, tmp_path / "t")) == _outcome(
        lambda: jp.save_kmers_sharded(kj, tmp_path / "j"))
    kj.sort()
    kt.sort()
    jp.save_kmers_sharded(kj, tmp_path / "j")
    tp.save_kmers_sharded(kt, tmp_path / "t")
    for mn, mx in ((11, 20), (10, 21)):
        other_j, other_t = _pair(mn, mx)
        assert _outcome(lambda: tp.load_kmers_sharded(other_t, tmp_path / "t")) == _outcome(
            lambda: jp.load_kmers_sharded(other_j, tmp_path / "j"))
    shorter_j, shorter_t = _pair()
    shorter_j.kmer_sba_start_indices = shorter_j.kmer_sba_start_indices[:-3]
    shorter_t.kmer_sba_start_indices = shorter_t.kmer_sba_start_indices[:-3]
    want = _outcome(lambda: jp.load_kmers_sharded(shorter_j, tmp_path / "j"))
    assert want[0] is ValueError
    assert _outcome(lambda: tp.load_kmers_sharded(shorter_t, tmp_path / "t")) == want
