"""The 2-D hierarchical ``(node, local)`` mesh of the port, on the CPU.

Counterparts of ``tests/test_hier.py`` and ``tests/test_hier_integration.py``
(``test_large_suffix``'s ``LargeKmers`` on a 2-D mesh is held in
tests/test_torch_large_api.py):
``make_mesh2`` and the two-stage exchange of ``collectives.all_to_all``;
``sample_sort_positions_ragged_hier`` against the JAX package's at one
factorization and against the port's flat sort at every factorization of 8
shards; and every sort family through ``Kmers`` (the dense and the gather
sample sort, the refinement rounds, canonical statistics), the statistics,
filters and queries over a 2-D layout, a sharded checkpoint restored onto a
mesh of another shape, the rejection of a three-axis mesh and the (3, 2) and
(2, 3) shapes: each 2-D layout equals the flat mesh's byte for byte.

Tolerance: exact equality (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops.keys import pack_rank2_words as j_pack2
from genome_kmers_tpu.ops.keys import pack_rank_words as j_pack
from genome_kmers_tpu.parallel.hier import make_mesh2 as j_make_mesh2
from genome_kmers_tpu.parallel.hier import sample_sort_positions_ragged_hier as j_hier_sort
from genome_kmers_tpu_torch import parallel as tp
from genome_kmers_tpu_torch.ops.filters import GcContentFilter
from genome_kmers_tpu_torch.ops.keys import pack_rank2_words, pack_rank_words
from genome_kmers_tpu_torch.parallel import collectives


def _cpu(n: int) -> list:
    return ["cpu"] * n


def _flat(n: int):
    return tp.make_mesh(devices=_cpu(n))


def _mesh2(n_nodes: int, n_local: int):
    return tp.make_mesh2(n_nodes, n_local, devices=_cpu(n_nodes * n_local))


FACTORIZATIONS = [(1, 8), (2, 4), (4, 2), (8, 1)]


# --------------------------------------------------------------------------- #
# the mesh and the exchange
# --------------------------------------------------------------------------- #


def test_make_mesh2_shape_and_cuda(monkeypatch):
    m = _mesh2(2, 4)
    assert m.axis_names == ("node", "local") and m.shape == {"node": 2, "local": 4}
    assert tp.mesh_size(m) == 8 and m != _flat(8) and m == _mesh2(2, 4) and m != _mesh2(4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_mesh2(1, 2)


@pytest.mark.parametrize("shape", FACTORIZATIONS + [(3, 2), (2, 3)])
def test_two_stage_all_to_all_delivers_every_block(shape):
    """Shard (d, j) receives block d * n_local + j of every shard, in the
    JAX package's stage-B order: source local index major, node minor."""
    n_nodes, n_local = shape
    n = n_nodes * n_local
    blocks = [[torch.tensor([100 * p + b]) for b in range(n)] for p in range(n)]
    got = collectives.all_to_all(blocks, _mesh2(*shape))
    flat = collectives.all_to_all(blocks, _flat(n))
    for b in range(n):
        want = [100 * (nn * n_local + l) + b for l in range(n_local) for nn in range(n_nodes)]
        assert [int(x) for x in got[b]] == want
        assert sorted(int(x) for x in got[b]) == sorted(int(x) for x in flat[b])


# --------------------------------------------------------------------------- #
# the standalone hierarchical sort (tests/test_hier.py)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(0)
    n = 20_003
    sba = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)
    sba[8000] = ord("$")
    starts, ends = np.array([0, 8001]), np.array([7999, n - 1])
    positions = np.sort(rng.choice(n - 40, size=15_000, replace=False))
    positions = positions[positions != 8000]
    sba_t = torch.from_numpy(sba)
    return {
        "sba": sba, "starts": starts, "ends": ends, "positions": positions,
        "packed": pack_rank_words(sba_t), "packed2": pack_rank2_words(sba_t),
    }


def _t_args(g):
    return (g["packed"], torch.from_numpy(g["positions"].astype(np.int64)),
            torch.from_numpy(g["starts"]), torch.from_numpy(g["ends"]))


@pytest.mark.parametrize("two_bit", [True, False])
def test_hier_equals_flat_and_jax(genome, two_bit):
    k = 21
    packed, pos, ss, se = _t_args(genome)
    p2 = genome["packed2"] if two_bit else None
    flat_pos, flat_pad = tp.sample_sort_positions_ragged(packed, pos, ss, se, k, _flat(8), packed2=p2)
    for shape in FACTORIZATIONS:
        h_pos, h_pad = tp.sample_sort_positions_ragged_hier(
            packed, pos, ss, se, k, _mesh2(*shape), packed2=p2)
        assert all(torch.equal(a, b) for a, b in zip(flat_pos, h_pos))
        assert all(torch.equal(a, b) for a, b in zip(flat_pad, h_pad))
    sba_j = jnp.asarray(genome["sba"])
    j_pos, j_pad = j_hier_sort(
        j_pack(sba_j), jnp.asarray(genome["positions"].astype(np.uint32)),
        jnp.asarray(genome["starts"].astype(np.uint32)),
        jnp.asarray(genome["ends"].astype(np.uint32)), k, j_make_mesh2(2, 4),
        packed2=j_pack2(sba_j) if two_bit else None,
    )
    j_pos, j_pad = np.asarray(j_pos).reshape(8, -1), np.asarray(j_pad).reshape(8, -1)
    for s in range(8):
        assert np.array_equal(j_pos[s], h_pos[s].numpy().astype(np.uint32))
        assert np.array_equal(j_pad[s] != 0, h_pad[s].numpy())


def test_hier_feeds_ragged_stats(genome):
    """The 2-D layout is a ragged layout the statistics take unchanged, on
    the flat mesh too."""
    k = 21
    packed, pos, ss, se = _t_args(genome)
    p2 = genome["packed2"]
    flat = _flat(8)
    f_pos, f_pad = tp.sample_sort_positions_ragged(packed, pos, ss, se, k, flat, packed2=p2)
    want = tp.distributed_group_size_histogram_ragged(
        packed, f_pos, f_pad, ss, se, k, flat, max_counts_bin=30, packed2=p2)
    h_pos, h_pad = tp.sample_sort_positions_ragged_hier(packed, pos, ss, se, k, _mesh2(4, 2),
                                                        packed2=p2)
    for mesh in (flat, _mesh2(4, 2)):
        got = tp.distributed_group_size_histogram_ragged(
            packed, h_pos, h_pad, ss, se, k, mesh, max_counts_bin=30, packed2=p2)
        assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_hier_rejects_unbounded(genome):
    packed, pos, ss, se = _t_args(genome)
    with pytest.raises(NotImplementedError, match="bounded|<="):
        tp.sample_sort_positions_ragged_hier(packed, pos, ss, se, None, _mesh2(2, 2))


# --------------------------------------------------------------------------- #
# every sort family through Kmers (tests/test_hier_integration.py)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def collection():
    rng = np.random.default_rng(2)
    seqs = [
        ("a", "".join(rng.choice(list("ACGT"), 4000))),
        ("b", "".join(rng.choice(list("ACGT"), 3000))),
    ]
    return seqs, gt.SequenceCollection(sequence_list=seqs, device="cpu")


def _same_layout(km_f, km_h) -> None:
    cf, ch = km_f._dist_cache, km_h._dist_cache
    assert np.array_equal(km_f.kmer_sba_start_indices, km_h.kmer_sba_start_indices)
    for name in ("positions", "is_pad", "gid_full"):
        a, b = getattr(cf, name), getattr(ch, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
class TestHierByteIdentity:
    def test_dense_bounded(self, collection, shape):
        _, sc = collection
        km_f = gt.Kmers(sc, 8, 31)
        km_f.sort(mesh=_flat(8))
        km_h = gt.Kmers(sc, 8, 31)
        km_h.sort(mesh=_mesh2(*shape))
        _same_layout(km_f, km_h)
        assert all(all(torch.equal(x, y) for x, y in zip(a, b))
                   for a, b in zip(km_f._dist_cache.lanes, km_h._dist_cache.lanes))
        for f in (gt.kmer_filter_keep_all, GcContentFilter(0.3, 0.7, 8)):
            cf, tf = km_f.get_kmer_group_counts(8, f, max_counts_bin=30, mesh=_flat(8))
            ch, th = km_h.get_kmer_group_counts(8, f, max_counts_bin=30, mesh=_mesh2(*shape))
            assert np.array_equal(cf, ch) and tf == th
        qs = ["ACGTACGT", "TTTTTTTT"]
        assert np.array_equal(km_f.count_queries(qs, 8, mesh=_flat(8)),
                              km_h.count_queries(qs, 8, mesh=_mesh2(*shape)))

    def test_ragged_custom_positions(self, collection, shape):
        _, sc = collection
        rng = np.random.default_rng(9)
        pos = np.asarray(gt.Kmers(sc, 8, 31).kmer_sba_start_indices).copy()
        rng.shuffle(pos)
        km_f = gt.Kmers(sc, 8, 31)
        km_f.kmer_sba_start_indices = pos.copy()
        km_f.sort(mesh=_flat(8))
        km_h = gt.Kmers(sc, 8, 31)
        km_h.kmer_sba_start_indices = pos.copy()
        km_h.sort(mesh=_mesh2(*shape))
        _same_layout(km_f, km_h)

    def test_unbounded(self, collection, shape):
        _, sc = collection
        km_f = gt.Kmers(sc, 1, None)
        km_f.sort(mesh=_flat(8))
        km_h = gt.Kmers(sc, 1, None)
        km_h.sort(mesh=_mesh2(*shape))
        _same_layout(km_f, km_h)
        for k in (None, 70):
            cf, tf = km_f.get_kmer_group_counts(k, max_counts_bin=30, mesh=_flat(8))
            ch, th = km_h.get_kmer_group_counts(k, max_counts_bin=30, mesh=_mesh2(*shape))
            assert np.array_equal(cf, ch) and tf == th

    def test_canonical(self, collection, shape):
        _, sc = collection
        km = gt.Kmers(sc, 8, 31)
        for _ in range(2):  # the dense route, then the gather route
            cf, tf = km.get_canonical_kmer_group_counts(8, max_counts_bin=30, mesh=_flat(8))
            ch, th = km.get_canonical_kmer_group_counts(8, max_counts_bin=30,
                                                        mesh=_mesh2(*shape))
            assert np.array_equal(cf, ch) and tf == th
            km.sort()


def test_checkpoint_across_mesh_shapes(collection, tmp_path):
    """A layout sorted on a 2-D mesh checkpoints and restores onto a 1-D
    mesh and onto a 2-D mesh of another shape."""
    _, sc = collection
    km = gt.Kmers(sc, 4, 31)
    km.sort(mesh=_mesh2(2, 4))
    want = km.get_kmer_group_counts(31, max_counts_bin=30, mesh=_mesh2(2, 4))
    tp.save_kmers_sharded(km, tmp_path / "ck2d")
    for mesh in (_flat(4), _mesh2(4, 2)):
        pos, _, meta = tp.load_sharded_index(tmp_path / "ck2d", mesh=mesh)
        assert len(pos) == tp.mesh_size(mesh)
        km2 = gt.Kmers(sc, 4, 31)
        tp.load_kmers_sharded(km2, tmp_path / "ck2d", mesh=mesh)
        assert np.array_equal(km2.kmer_sba_start_indices, km.kmer_sba_start_indices)
        got = km2.get_kmer_group_counts(31, max_counts_bin=30, mesh=mesh)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_three_axis_mesh_rejected(collection):
    _, sc = collection
    mesh3 = tp.Mesh(_cpu(8), ("a", "b", "c"), (2, 2, 2))
    km = gt.Kmers(sc, 8, 31)
    with pytest.raises(NotImplementedError, match="1-D.*or 2-D"):
        km.sort(mesh=mesh3)


def test_non_pow2_2d_mesh(collection):
    """(3, 2) and (2, 3) node/local splits of 6 shards: byte identical to
    the flat 6-shard mesh."""
    _, sc = collection
    km_f = gt.Kmers(sc, 8, 31)
    km_f.sort(mesh=_flat(6))
    for shape in [(3, 2), (2, 3)]:
        km_h = gt.Kmers(sc, 8, 31)
        km_h.sort(mesh=_mesh2(*shape))
        _same_layout(km_f, km_h)
