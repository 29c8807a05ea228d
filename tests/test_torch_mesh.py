"""The sorted index on a one-dimensional mesh, the port against the JAX
package, on the CPU.

The port's mesh is ``make_mesh(P, devices=["cpu"] * P)``, the JAX
package's ``make_mesh(P)`` over XLA's virtual CPU devices (tests/conftest.py).
On the same seeded genomes (three random records with copied segments and an
all-'A' record, ACGT or with N and IUPAC codes):

* the dense and the gather sample sort: every shard's positions, pad flags
  and key-word lanes equal the JAX package's ``sample_sort_positions_dense_
  ragged`` / ``sample_sort_positions_ragged`` at mesh sizes 1, 2, 3 and 8
  and at (31, 31), (20, 48) and (12, 24) ((20, 32) on 4-bit keys); a
  genome of one long all-'A' record makes the exchange retry with a
  doubled capacity factor;
* ``compact_ragged`` and the stitched histogram over layouts with empty
  shards;
* ``Kmers.sort(mesh=)`` and the mesh statistics (``get_kmer_group_counts``
  / ``get_kmer_count`` with ``mesh=``) unfiltered, under each library
  filter (lanes, plane and window routes), a ``VectorizedFilter``, a plain
  callable and with ``track_strands_separately``, against the JAX
  package's mesh statistics and the port's single-device ones, raises
  included;
* ``count_queries`` / ``count_queries_canonical`` with ``mesh=``;
* the calls that once raised naming ROADMAP.md A11, against the JAX
  package (the mesh beyond one window, canonical statistics on a mesh and
  the 2-D mesh are held further in test_torch_mesh_unbounded.py and
  test_torch_hier.py).

Tolerance: exact equality (integer outputs); the JAX side is computed once
per module and shape where it can be.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu import parallel as jp
from genome_kmers_tpu.ops import filters as jf
from genome_kmers_tpu_torch import parallel as tp
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.parallel import sample_sort as tss

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYSWKMBDHVN", dtype=np.uint8)


def _seq_list(seed: int, iupac: bool):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate([700, 90, 400]):
        s = ACGT[rng.integers(0, 4, n)].copy()
        src = int(rng.integers(0, n - 60))
        for dst in rng.integers(0, n - 60, 3):
            s[dst : dst + 60] = s[src : src + 60]
        if iupac:
            s[rng.integers(0, n, n // 20)] = IUPAC[rng.integers(0, len(IUPAC), n // 20)]
            s[n // 3 : n // 3 + 12] = ord("N")
        out.append((f"r{i}", s.tobytes().decode()))
    out.append(("allA", "A" * 300))
    return out


def _meshes(p: int):
    assert len(jax.devices()) >= p
    return jp.make_mesh(p), tp.make_mesh(devices=["cpu"] * p)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _same(a, b) -> bool:
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], np.ndarray):
        return isinstance(b, tuple) and np.array_equal(a[0], b[0]) and a[1] == b[1] \
            and a[0].dtype == b[0].dtype
    return a == b


def _shards(x, p: int) -> np.ndarray:
    return np.asarray(x).reshape(p, -1)


# --------------------------------------------------------------------------- #
# the sample sort's per-shard layout
# --------------------------------------------------------------------------- #

OTHER_K = [(False, 3, (20, 48)), (False, 3, (12, 24)), (True, 3, (20, 32)), (True, 3, (12, 24))]
DENSE_CASES = [(iupac, p, (31, 31)) for iupac in (False, True) for p in (1, 2, 3, 8)] + OTHER_K
GATHER_CASES = [(iupac, 2, (31, 31)) for iupac in (False, True)] + OTHER_K


def _layout_ids(case):
    iupac, p, (mn, mx) = case
    return f"{'iupac' if iupac else 'acgt'}-P{p}-{mn}-{mx}"


def _collections(iupac, p):
    sl = _seq_list(p + 10 * iupac, iupac)
    scj = gj.SequenceCollection(sequence_list=sl)
    sct = gt.SequenceCollection(sequence_list=sl, device="cpu")
    return sl, scj, sct


def _assert_layout(j_out, t_out, p: int, n_words: int):
    j_pos, j_pad, j_lanes = j_out
    t_pos, t_pad, t_lanes = t_out
    assert len(t_pos) == len(t_pad) == len(t_lanes) == p
    for s in range(p):
        assert np.array_equal(_shards(j_pos, p)[s], t_pos[s].numpy().astype(np.uint32))
        assert np.array_equal(_shards(j_pad, p)[s] != 0, t_pad[s].numpy())
        assert len(t_lanes[s]) == len(j_lanes) == n_words
        for jl, tl in zip(j_lanes, t_lanes[s]):
            assert tl.dtype == torch.int32
            assert np.array_equal(_shards(jl, p)[s], tl.numpy().view(np.uint32))


@pytest.mark.parametrize("case", DENSE_CASES, ids=_layout_ids)
def test_dense_sample_sort_layout_matches_jax(case):
    iupac, p, (mn, mx) = case
    _, scj, sct = _collections(iupac, p)
    jm, tm = _meshes(p)
    two = not iupac
    n = len(gj.Kmers(scj, mn, mx))
    dj, dt = scj.device_cache("forward"), sct.device_cache("forward")
    j_out = jp.sample_sort_positions_dense_ragged(
        dj.packed2 if two else dj.packed, dj.seg_starts, dj.seg_ends, n, mn, mx, jm,
        two_bit=two, uniform_cap=mn == mx, return_lanes=True,
    )
    info = {}
    t_out = tp.sample_sort_positions_dense_ragged(
        dt.packed2 if two else dt.packed, dt.seg_starts, dt.seg_ends, n, mn, mx, tm,
        two_bit=two, uniform_cap=mn == mx, return_lanes=True, info=info,
    )
    _assert_layout(j_out, t_out, p, -(-mx // (16 if two else 8)))
    assert sum(info["rows"]) == n
    assert info["capacity_factor"] == 1.5 * 2 ** info["retries"]


@pytest.mark.parametrize("case", GATHER_CASES, ids=_layout_ids)
def test_gather_sample_sort_layout_matches_jax(case):
    """An assigned descending index (the position is a key, not a stable
    payload), through the gather sample sort."""
    iupac, p, (mn, mx) = case
    _, scj, sct = _collections(iupac, p)
    jm, tm = _meshes(p)
    two = not iupac
    pos = np.ascontiguousarray(gj.Kmers(scj, mn, mx).kmer_sba_start_indices[::-1])
    dj, dt = scj.device_cache("forward"), sct.device_cache("forward")
    j_out = jp.sample_sort_positions_ragged(
        None if two else dj.packed, jnp.asarray(pos), dj.seg_starts, dj.seg_ends, mx, jm,
        packed2=dj.packed2 if two else None, uniform_cap=mn == mx, return_lanes=True,
    )
    t_out = tp.sample_sort_positions_ragged(
        None if two else dt.packed, torch.from_numpy(pos.astype(np.int64)), dt.seg_starts,
        dt.seg_ends, mx, tm, packed2=dt.packed2 if two else None, uniform_cap=mn == mx,
        return_lanes=True,
    )
    _assert_layout(j_out, t_out, p, -(-mx // (16 if two else 8)))


def test_retry_of_an_all_a_genome():
    """One long all-'A' record: the first capacity overflows; the layout
    equals the JAX package's at the same mesh size and retry count, and the
    compacted rows equal the single-device sort."""
    sl = [("allA", "A" * 3000), ("x", "ACGTTGCA" * 40)]
    scj = gj.SequenceCollection(sequence_list=sl)
    sct = gt.SequenceCollection(sequence_list=sl, device="cpu")
    jm, tm = _meshes(4)
    n = len(gj.Kmers(scj, 20, 20))
    dj, dt = scj.device_cache("forward"), sct.device_cache("forward")
    j_out = jp.sample_sort_positions_dense_ragged(
        dj.packed2, dj.seg_starts, dj.seg_ends, n, 20, 20, jm, two_bit=True,
        uniform_cap=True, return_lanes=True,
    )
    info = {}
    t_out = tp.sample_sort_positions_dense_ragged(
        dt.packed2, dt.seg_starts, dt.seg_ends, n, 20, 20, tm, two_bit=True,
        uniform_cap=True, return_lanes=True, info=info,
    )
    _assert_layout(j_out, t_out, 4, 2)
    assert info["retries"] >= 1 and info["capacity_factor"] == 1.5 * 2 ** info["retries"]
    km = gt.Kmers(sct, 20, 20)
    km.sort()
    assert np.array_equal(tss.ragged_rows(t_out[0], t_out[1]), km.kmer_sba_start_indices)


def test_sample_sort_positions_compacts():
    sl = _seq_list(5, False)
    sct = gt.SequenceCollection(sequence_list=sl, device="cpu")
    km = gt.Kmers(sct, 31, 31)
    pos = torch.from_numpy(km.kmer_sba_start_indices[::-1].astype(np.int64))
    dt = sct.device_cache("forward")
    got = tp.sample_sort_positions(
        None, pos, dt.seg_starts, dt.seg_ends, 31, tp.make_mesh(devices=["cpu"] * 3),
        packed2=dt.packed2, uniform_cap=True,
    )
    km.sort()
    assert np.array_equal(got.numpy().astype(np.uint32), km.kmer_sba_start_indices)


# --------------------------------------------------------------------------- #
# compaction and the stitched histogram over hand-made layouts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("p", [2, 3, 8])
def test_compact_ragged_matches_jax(p):
    rng = np.random.default_rng(p)
    m = 37
    pos = rng.permutation(10**6)[: p * m].astype(np.uint32)
    pad = (rng.random(p * m) < 0.4).astype(np.uint32)
    pad[m : 2 * m] = 1  # a shard of pads only
    jm, tm = _meshes(p)
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(jp.AXIS))
    j_pos, j_pad = jp.compact_ragged(
        jax.device_put(jnp.asarray(pos), sharding), jax.device_put(jnp.asarray(pad), sharding), jm
    )
    t_pos, t_pad = tp.compact_ragged(
        list(torch.from_numpy(pos.astype(np.int64)).chunk(p)),
        list(torch.from_numpy(pad != 0).chunk(p)), tm,
    )
    for s in range(p):
        assert np.array_equal(_shards(j_pos, p)[s], t_pos[s].numpy().astype(np.uint32))
        assert np.array_equal(_shards(j_pad, p)[s] != 0, t_pad[s].numpy())


@pytest.mark.parametrize("p", [3, 8])
def test_stitched_histogram_over_empty_shards_matches_jax(p):
    """A sorted index laid out with whole shards of pads between the real
    rows: the halo stitch skips the empty shards, as the JAX package's."""
    sl = _seq_list(7, False)
    scj = gj.SequenceCollection(sequence_list=sl)
    km = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 12, 12)
    km.sort()
    sorted_pos = km.kmer_sba_start_indices
    m = len(sorted_pos)  # one shard could hold everything
    pos = np.full((p, m), 0xFFFFFFFF, dtype=np.uint32)
    pad = np.ones((p, m), dtype=np.uint32)
    cuts = np.linspace(0, m, (p + 1) // 2 + 1).astype(int)
    for i, s in enumerate(range(0, p, 2)):  # data on the even shards only
        rows = sorted_pos[cuts[i] : cuts[i + 1]]
        pos[s, : len(rows)] = rows
        pad[s, : len(rows)] = 0
    jm, tm = _meshes(p)
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(jp.AXIS))
    dj = scj.device_cache("forward")
    dt = km._dc()
    for min_gs, max_gs in ((1, None), (2, 5)):
        j_counts, j_total = jp.distributed_group_size_histogram_ragged(
            None, jax.device_put(jnp.asarray(pos.ravel()), sharding),
            jax.device_put(jnp.asarray(pad.ravel()), sharding), dj.seg_starts, dj.seg_ends,
            12, jm, min_group_size=min_gs, max_group_size=max_gs, max_counts_bin=40,
            packed2=dj.packed2,
        )
        t_counts, t_total = tp.distributed_group_size_histogram_ragged(
            None, list(torch.from_numpy(pos.astype(np.int64))), list(torch.from_numpy(pad != 0)),
            dt.seg_starts, dt.seg_ends, 12, tm, min_group_size=min_gs, max_group_size=max_gs,
            max_counts_bin=40, packed2=dt.packed2,
        )
        assert np.array_equal(np.asarray(j_counts), t_counts.numpy()) and int(j_total) == t_total
        want = km.get_kmer_group_counts(12, min_group_size=min_gs, max_group_size=max_gs,
                                        max_counts_bin=40)
        assert np.array_equal(want[0], t_counts.numpy()) and want[1] == t_total


def test_evenly_sharded_histogram_matches_single_device():
    sl = _seq_list(8, True)
    km = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 10, 24)
    km.sort()
    dc = km._dc()
    pos = torch.from_numpy(km.kmer_sba_start_indices.astype(np.int64))
    for k in (24, 9):
        got = tp.distributed_group_size_histogram(
            dc.packed, pos, dc.seg_starts, dc.seg_ends, k, tp.make_mesh(devices=["cpu"] * 3),
            max_counts_bin=30,
        )
        want = km.get_kmer_group_counts(k, max_counts_bin=30)
        assert np.array_equal(got[0].numpy(), want[0]) and got[1] == want[1]


# --------------------------------------------------------------------------- #
# Kmers on the mesh
# --------------------------------------------------------------------------- #

STATS_CONFIGS = {
    "acgt-P8-12-24": (False, 8, 12, 24),
    "iupac-P3-31-31": (True, 3, 31, 31),
}


@pytest.fixture(scope="module")
def mesh_indexes():
    """``get(config)``: (JAX mesh, port mesh, JAX index sorted on its mesh,
    port index sorted on its mesh, port index sorted on one device), built
    on first use in each test process."""
    built = {}

    def get(name):
        if name not in built:
            iupac, p, mn, mx = STATS_CONFIGS[name]
            sl = _seq_list(20 + p + iupac, iupac)
            jm, tm = _meshes(p)
            kj = gj.Kmers(gj.SequenceCollection(sequence_list=sl), mn, mx)
            kj.sort(mesh=jm)
            kt = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), mn, mx)
            kt.sort(mesh=tm)
            ks = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), mn, mx)
            ks.sort()
            built[name] = (jm, tm, kj, kt, ks)
        return built[name]

    return get


def _filters(mod, k_f):
    def scalar_at(sba, strand, i):
        return bool(sba[i] != ord("A"))

    vectorized = {
        jf: lambda: jf.VectorizedFilter(lambda sba, pos, vl: sba[pos] != ord("A")),
        tf: lambda: tf.VectorizedFilter(lambda sba, pos, vl: sba[pos] != ord("A")),
    }
    return {
        "keep_all": mod.kmer_filter_keep_all,
        "gc": mod.gen_kmer_gc_content_filter_func(0.3, 0.6, k_f),
        "homopolymer": mod.gen_kmer_homopolymer_filter_func(4, k_f),
        "no_ambiguous": mod.gen_no_ambiguous_bases_filter(k_f),
        "length": mod.gen_kmer_length_filter_func(k_f + 3),
        "crispr": mod.crispr_ngg_pam_filter,
        "gc_beyond_lanes": mod.gen_kmer_gc_content_filter_func(0.2, 0.8, 40),
        "vectorized": vectorized[mod](),
        "callable": scalar_at,
    }


LIBRARY_FILTERS = [f for f in _filters(tf, 12) if f != "callable"]


@pytest.mark.parametrize("config", list(STATS_CONFIGS))
def test_sort_mesh_keeps_layout_and_host_view(mesh_indexes, config):
    jm, tm, kj, kt, ks = mesh_indexes(config)
    cache = kt._dist_cache
    assert cache is not None and cache.mesh == tm and kt._pos_dev is None
    assert len(kt) == len(kj) == len(ks)
    assert np.array_equal(kt.kmer_sba_start_indices, kj.kmer_sba_start_indices)
    assert np.array_equal(kt.kmer_sba_start_indices, ks.kmer_sba_start_indices)
    p = len(tm.devices)
    for s in range(p):
        assert np.array_equal(_shards(kj._dist_cache.positions, p)[s],
                              cache.positions[s].numpy().astype(np.uint32))


def _stats_against_jax(config, fname, kj, kt, ks, jm, tm, ks_params):
    k_f = 20 if kj.max_kmer_len >= 20 else 12
    fj, ft = _filters(jf, k_f)[fname], _filters(tf, k_f)[fname]
    for k, min_gs, max_gs in ks_params(kj.max_kmer_len, k_f):
        want = _outcome(lambda: kj.get_kmer_group_counts(
            k, fj, min_gs, max_gs, max_counts_bin=30, mesh=jm))
        got = _outcome(lambda: kt.get_kmer_group_counts(
            k, ft, min_gs, max_gs, max_counts_bin=30, mesh=tm))
        single = _outcome(lambda: ks.get_kmer_group_counts(
            k, ft, min_gs, max_gs, max_counts_bin=30))
        assert _same(want, got), (config, fname, k, want, got)
        assert _same(single, got), (config, fname, k, single, got)
        got_n = _outcome(lambda: kt.get_kmer_count(k, ft, min_gs, max_gs, mesh=tm))
        assert got_n == (got[1] if isinstance(got[0], np.ndarray) else got)


@pytest.mark.parametrize("config", list(STATS_CONFIGS))
def test_mesh_statistics_match_jax_and_single_device(mesh_indexes, config):
    """Every library filter (and none): the kept layout's lanes route, or
    the plane route for a filter the lanes cannot express."""
    jm, tm, kj, kt, ks = mesh_indexes(config)
    for fname in LIBRARY_FILTERS:
        _stats_against_jax(
            config, fname, kj, kt, ks, jm, tm,
            lambda mx, k_f: ((mx, 1, None), (k_f, 2, 6)) if fname == "keep_all" else ((k_f, 2, 6),),
        )


def test_mesh_statistics_under_a_plain_callable():
    """A plain callable: survivors by the host loop, then a fresh sample
    sort over the mesh."""
    sl = [(name, seq[:150]) for name, seq in _seq_list(9, True)]
    jm, tm = _meshes(2)
    kj = gj.Kmers(gj.SequenceCollection(sequence_list=sl), 12, 12)
    kt = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 12, 12)
    ks = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 12, 12)
    kj.sort(mesh=jm)
    kt.sort(mesh=tm)
    ks.sort()
    _stats_against_jax("small-P2-12-12", "callable", kj, kt, ks, jm, tm,
                       lambda mx, k_f: ((mx, 1, None),))


@pytest.mark.parametrize("route", ["plane", "window"])
def test_mesh_filters_off_the_lanes_route(mesh_indexes, route):
    """Library filters without the sorted lanes (the layout's lanes
    dropped): the plane route, and with the planes off the window route;
    messages and offending rows those of the JAX package."""
    jm, tm, kj, kt, ks = mesh_indexes("acgt-P8-12-24")
    saved = kt._dist_cache.lanes
    kt._dist_cache.lanes = None
    flags = kt._dc().filter_flags
    if route == "window":
        kt._dc().filter_flags = None
    try:
        for fname in ("gc", "homopolymer", "no_ambiguous", "length", "crispr"):
            fj, ft = _filters(jf, 20)[fname], _filters(tf, 20)[fname]
            for k in (12,):
                want = _outcome(lambda: kj.get_kmer_group_counts(k, fj, max_counts_bin=30,
                                                                 mesh=jm))
                got = _outcome(lambda: kt.get_kmer_group_counts(k, ft, max_counts_bin=30,
                                                                mesh=tm))
                assert _same(want, got), (fname, k, want, got)
    finally:
        kt._dist_cache.lanes = saved
        kt._dc().filter_flags = flags


def test_mesh_filter_raises_at_the_jax_row(mesh_indexes):
    """Truncated rows (min_kmer_len 12 < the filter's 20): the GC filter
    raises on the mesh at the row the JAX package names."""
    jm, tm, kj, kt, _ = mesh_indexes("acgt-P8-12-24")
    fj, ft = jf.gen_kmer_gc_content_filter_func(0.0, 1.0, 20), tf.gen_kmer_gc_content_filter_func(
        0.0, 1.0, 20)
    want = _outcome(lambda: kj.get_kmer_count(20, fj, mesh=jm))
    got = _outcome(lambda: kt.get_kmer_count(20, ft, mesh=tm))
    assert want == got and want[0] is ValueError


def test_mesh_statistics_without_kept_layout(mesh_indexes):
    """A single-device sorted index queried with mesh=: the survivors are
    sample-sorted over the mesh afresh."""
    jm, tm, kj, _, ks = mesh_indexes("iupac-P3-31-31")
    ft = tf.gen_no_ambiguous_bases_filter(12)
    for f in (tf.kmer_filter_keep_all, ft):
        got = ks.get_kmer_group_counts(12, f, max_counts_bin=30, mesh=tm)
        want = ks.get_kmer_group_counts(12, f, max_counts_bin=30)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    other = tp.make_mesh(devices=["cpu"] * 2)
    _, _, _, kt, _ = mesh_indexes("iupac-P3-31-31")
    got = kt.get_kmer_group_counts(12, max_counts_bin=30, mesh=other)
    want = ks.get_kmer_group_counts(12, max_counts_bin=30)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("track", [False, True])
def test_both_strand_mesh_statistics(track):
    sl = _seq_list(31, False)
    jm, tm = _meshes(3)
    kj = gj.Kmers.from_strand(gj.SequenceCollection(sequence_list=sl, strands_to_load="both"),
                              16, 16, source_strand="both", track_strands_separately=track)
    kt = gt.Kmers.from_strand(
        gt.SequenceCollection(sequence_list=sl, strands_to_load="both", device="cpu"),
        16, 16, source_strand="both", track_strands_separately=track,
    )
    kj.sort(mesh=jm)
    kt.sort(mesh=tm)
    assert np.array_equal(kj.kmer_sba_start_indices, kt.kmer_sba_start_indices)
    for f_j, f_t in ((jf.kmer_filter_keep_all, tf.kmer_filter_keep_all),
                     (jf.gen_kmer_gc_content_filter_func(0.3, 0.7, 16),
                      tf.gen_kmer_gc_content_filter_func(0.3, 0.7, 16))):
        want = kj.get_kmer_group_counts(16, f_j, max_counts_bin=30, mesh=jm)
        got = kt.get_kmer_group_counts(16, f_t, max_counts_bin=30, mesh=tm)
        assert np.array_equal(want[0], got[0]) and want[1] == got[1]


@pytest.mark.parametrize("config", list(STATS_CONFIGS))
def test_mesh_count_queries(mesh_indexes, config):
    jm, tm, kj, kt, ks = mesh_indexes(config)
    sba = kt._host_sba().tobytes().decode()
    starts = np.random.default_rng(3).integers(0, len(sba) - 12, size=60)
    qs = [sba[s : s + 12] for s in starts if "$" not in sba[s : s + 12]]
    qs += ["ACGTACGTACGT", "A" * 12, "N" * 12]
    want = kj.count_queries(qs, 12, mesh=jm)
    got = kt.count_queries(qs, 12, mesh=tm)
    assert got.dtype == want.dtype == np.uint32 and np.array_equal(want, got)
    assert np.array_equal(got, ks.count_queries(qs, 12))
    # an index without a kept layout, cut into equal shards
    assert np.array_equal(ks.count_queries(qs, 12, mesh=tm), got)
    assert np.array_equal(kj.count_queries_canonical(qs, 12, mesh=jm),
                          kt.count_queries_canonical(qs, 12, mesh=tm))
    assert kt.count_queries([], mesh=tm).shape == (0,)


# --------------------------------------------------------------------------- #
# mesh objects, and what still raises
# --------------------------------------------------------------------------- #


def test_make_mesh_on_the_cpu_and_without_cuda(monkeypatch):
    m = tp.make_mesh(8, devices=["cpu"] * 8)
    assert tp.mesh_size(m) == 8 and m.axis_names == ("kmers",) and m.shape == {"kmers": 8}
    assert m == tp.make_mesh(devices=["cpu"] * 8) and m != tp.make_mesh(devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_mesh(devices=["cuda:0"])


def test_deferred_mesh_calls_raise_naming_a11():
    """The mesh calls this test once held to a NotImplementedError naming
    A11 are ported: each now equals the JAX package's single-device answer
    (tests/test_torch_mesh_unbounded.py and test_torch_hier.py hold them
    further); the 64-bit regime, which raised naming A12, is ported too
    (tests/test_torch_large*.py): its constructor now refuses a call without
    arguments as the JAX package's does."""
    sl = _seq_list(2, False)
    tm = tp.make_mesh(devices=["cpu"] * 2)
    sc = gt.SequenceCollection(sequence_list=sl, device="cpu")
    scj = gj.SequenceCollection(sequence_list=sl)

    def single(sc_j, mn, mx, descending=False):
        km = gj.Kmers(sc_j, mn, mx)
        if descending:
            km.kmer_sba_start_indices = km.kmer_sba_start_indices[::-1].copy()
        km.sort()
        return km

    # unbounded and beyond-window mesh sorts (fresh and assigned indexes)
    for mn, mx in ((20, None), (20, 70)):
        km = gt.Kmers(sc, mn, mx)
        km.sort(mesh=tm)
        assert np.array_equal(km.kmer_sba_start_indices, single(scj, mn, mx).kmer_sba_start_indices)
    km = gt.Kmers(sc, 20, None)
    km.kmer_sba_start_indices = km.kmer_sba_start_indices[::-1].copy()
    km.sort(mesh=tm)
    assert np.array_equal(km.kmer_sba_start_indices,
                          single(scj, 20, None, descending=True).kmer_sba_start_indices)
    sl4 = _seq_list(2, True)
    km = gt.Kmers(gt.SequenceCollection(sequence_list=sl4, device="cpu"), 20, 48)
    km.sort(mesh=tm)
    assert np.array_equal(km.kmer_sba_start_indices,
                          single(gj.SequenceCollection(sequence_list=sl4), 20, 48)
                          .kmer_sba_start_indices)
    # statistics that need run ids, canonical statistics, a 2-D mesh
    km = gt.Kmers(sc, 20, 31)
    km.sort(mesh=tm)
    kj = single(scj, 20, 31)
    got, want = km.get_kmer_group_counts(None, mesh=tm), kj.get_kmer_group_counts(None)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert km.get_kmer_count(70, mesh=tm) == kj.get_kmer_count(70)
    got = gt.Kmers(sc, 20, 31).get_canonical_kmer_group_counts(20, mesh=tm)
    want = gj.Kmers(scj, 20, 31).get_canonical_kmer_group_counts(20)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    m2 = tp.make_mesh2(2, 2, devices=["cpu"] * 4)
    assert m2.shape == dict(jp.make_mesh2(2, 2).shape)
    assert _outcome(lambda: gt.LargeKmers()) == _outcome(lambda: gj.LargeKmers())


def test_unsorted_mesh_statistics_raise_as_jax():
    sl = _seq_list(4, False)
    jm, tm = _meshes(2)
    kj = gj.Kmers(gj.SequenceCollection(sequence_list=sl), 20, 31)
    kt = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 20, 31)
    assert _outcome(lambda: kj.get_kmer_count(20, mesh=jm)) == _outcome(
        lambda: kt.get_kmer_count(20, mesh=tm))
    assert _outcome(lambda: kj.get_kmer_group_counts(20, mesh=jm)) == _outcome(
        lambda: kt.get_kmer_group_counts(20, mesh=tm))
    assert _outcome(lambda: kj.count_queries(["A" * 20], mesh=jm)) == _outcome(
        lambda: kt.count_queries(["A" * 20], mesh=tm))
