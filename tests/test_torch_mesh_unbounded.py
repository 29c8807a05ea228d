"""The sorted index on a mesh beyond one compare window, and canonical
statistics on a mesh: the port against the JAX package, on the CPU.

The port's mesh is ``make_mesh(P, devices=["cpu"] * P)``, the JAX package's
``make_mesh(P)`` over XLA's virtual CPU devices (tests/conftest.py). On
seeded genomes of a few hundred bases a record, ACGT or with N and IUPAC
codes, with copied segments (groups whose suffixes tie for several windows)
and a short all-'A' record:

* ``sample_sort_positions_unbounded(return_ragged=True)``: every shard's
  positions, pad flags and run ids, padded to ``info["shard_rows"]`` rows,
  equal the JAX package's at mesh sizes 1, 2, 3 and 8 on 2-bit and 4-bit
  keys, in suffix mode and beyond one window;
  ``distributed_adjacent_gids`` over that layout gives its run ids back;
* the checks of ``tests/test_unbounded_mesh.py``, each against the JAX
  package's single-device ``Kmers``: suffix statistics from the kept run ids
  (no refinement round), bounded statistics on the suffix layout, filtered
  suffix statistics, ``kmer_len`` None on a bounded layout, beyond-window
  lengths on 4-bit keys with and without the kept run ids, a single-device
  index counted on the mesh, ``get_kmer_count``; also every library filter
  and a plain callable at None, strands kept apart;
* the overflow retry with a tiny capacity factor, against the single-device
  sorts of both packages (not the JAX mesh, ROADMAP.md §C3);
* the canonical sample sorts' layouts against the JAX package's, and
  ``get_canonical_kmer_group_counts(mesh=)`` on the dense and the gather
  route against the JAX package's single-device counts;
* ``interop.from_numpy_state`` with a JAX mesh layout.

Tolerance: exact equality (integer outputs).
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
from genome_kmers_tpu_torch import kmers as tkmers
from genome_kmers_tpu_torch import parallel as tp
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.ops import filters as tf

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYSWKMBDHVN", dtype=np.uint8)


def _seq_list(seed: int, iupac: bool):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate([600, 90, 300]):
        s = ACGT[rng.integers(0, 4, n)].copy()
        src = int(rng.integers(0, n - 70))
        for dst in rng.integers(0, n - 70, 3):
            s[dst : dst + 70] = s[src : src + 70]
        if iupac:
            s[rng.integers(0, n, n // 20)] = IUPAC[rng.integers(0, len(IUPAC), n // 20)]
            s[n // 3 : n // 3 + 12] = ord("N")
        out.append((f"r{i}", s.tobytes().decode()))
    out.append(("allA", "A" * 40))
    return out


def _meshes(p: int):
    assert len(jax.devices()) >= p
    return jp.make_mesh(p), tp.make_mesh(devices=["cpu"] * p)


def _collections(sl, strands="forward"):
    return (gj.SequenceCollection(sequence_list=sl, strands_to_load=strands),
            gt.SequenceCollection(sequence_list=sl, strands_to_load=strands, device="cpu"))


def _shards(x, p: int) -> np.ndarray:
    return np.asarray(x).reshape(p, -1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _jax_rows(t: torch.Tensor, rows: int) -> np.ndarray:
    """A compact shard (real rows, one pad row) padded with its pad value
    to the JAX package's ``rows`` rows."""
    out = np.full(rows, _u32(t[-1:])[0], dtype=np.uint32)
    out[: t.shape[0] - 1] = _u32(t[:-1])
    return out


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _same_hist(a, b) -> bool:
    return np.array_equal(np.asarray(a[0]), np.asarray(b[0])) and int(a[1]) == int(b[1])


# --------------------------------------------------------------------------- #
# the refinement sample sort's layout
# --------------------------------------------------------------------------- #

LAYOUT_CASES = (
    [(iupac, p, None) for iupac in (False, True) for p in (1, 2, 3, 8)]
    + [(False, 3, 100), (True, 8, 40)]
)


def _layout_id(case):
    iupac, p, mx = case
    return f"{'iupac' if iupac else 'acgt'}-P{p}-{mx}"


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=_layout_id)
def test_unbounded_layout_matches_jax(case):
    """Per-shard positions, pads and converged run ids of the refinement
    sort from an assigned descending index (the position is a key): each
    shard's real rows and one pad row, which padded to ``info["shard_rows"]``
    rows are the JAX package's layout byte for byte; the compacted rows
    equal the single-device sort."""
    iupac, p, mx = case
    scj, sct = _collections(_seq_list(3, iupac))
    jm, tm = _meshes(p)
    pos = np.ascontiguousarray(gj.Kmers(scj, 1, mx).kmer_sba_start_indices[::-1])
    dj, dt = scj.device_cache("forward"), sct.device_cache("forward")
    j_out = jp.sample_sort_positions_unbounded(
        dj.packed if iupac else None, jnp.asarray(pos), dj.seg_starts, dj.seg_ends, jm,
        packed2=None if iupac else dj.packed2, max_kmer_len=mx, return_ragged=True,
    )
    t_args = (dt.packed if iupac else None, torch.from_numpy(pos.astype(np.int64)),
              dt.seg_starts, dt.seg_ends, tm)
    t_kw = {"packed2": None if iupac else dt.packed2, "max_kmer_len": mx}
    info = {}
    t_pos, t_pad, t_gid = tp.sample_sort_positions_unbounded(
        *t_args, **t_kw, return_ragged=True, info=info)
    j_pos, j_pad, j_gid = (_shards(x, p) for x in j_out)
    assert info["rounds"] >= 2 and len(info["capacity_factors"]) == info["rounds"]
    assert info["shard_rows"] == j_pos.shape[1]
    for s in range(p):
        n_real = int((j_pad[s] == 0).sum())
        assert t_pad[s].numpy().tolist() == [False] * n_real + [True]
        assert np.array_equal(j_pos[s], _jax_rows(t_pos[s], info["shard_rows"]))
        assert np.array_equal(j_pad[s] != 0, np.arange(info["shard_rows"]) >= n_real)
        assert np.array_equal(j_gid[s], _jax_rows(t_gid[s], info["shard_rows"]))
    # the run structure alone over the converged layout gives its run ids back
    again = tp.distributed_adjacent_gids(
        dt.packed if iupac else None, t_pos, t_pad, dt.seg_starts, dt.seg_ends, mx, tm,
        packed2=None if iupac else dt.packed2,
    )
    assert all(torch.equal(a, b) for a, b in zip(again, t_gid))
    km = gt.Kmers(sct, 1, mx)
    km.sort()
    flat = tp.sample_sort_positions(
        t_args[0], t_args[1], dt.seg_starts, dt.seg_ends, mx, tm, packed2=t_kw["packed2"])
    assert np.array_equal(_u32(flat), km.kmer_sba_start_indices)


@pytest.mark.parametrize("two_bit", [True, False])
def test_overflow_retry_matches_the_single_device_sorts(two_bit):
    """A capacity factor of 0.05 and 4 samples a shard: every round
    retries; the rows equal the single-device suffix sorts of both
    packages (ROADMAP.md §C3: the JAX mesh is not the reference here)."""
    from genome_kmers_tpu.ops.keys import compute_seg_ends as j_seg_ends
    from genome_kmers_tpu.ops.keys import pack_rank_words as j_pack
    from genome_kmers_tpu.ops.sort import sort_positions_suffix_dense as j_suffix

    rng = np.random.default_rng(31)
    unit = ACGT[rng.integers(0, 4, 80)]
    sba = np.concatenate([np.tile(unit, 6), ACGT[rng.integers(0, 4, 300)]])
    n = len(sba)
    j_starts = jnp.zeros(1, dtype=jnp.uint32)
    expected = np.asarray(j_suffix(j_pack(jnp.asarray(sba)), j_starts,
                                   j_seg_ends(j_starts, n), n, 1, None))
    sct = gt.SequenceCollection(sequence_list=[("r", sba.tobytes().decode())], device="cpu")
    dt = sct.device_cache("forward")
    km = gt.Kmers(sct, 1, None)
    km.sort()
    assert np.array_equal(km.kmer_sba_start_indices, expected)
    info = {}
    got = tp.sample_sort_positions_unbounded(
        None if two_bit else dt.packed, torch.arange(n, dtype=torch.int64), dt.seg_starts,
        dt.seg_ends, tp.make_mesh(devices=["cpu"] * 4), packed2=dt.packed2 if two_bit else None,
        n_samples=4, capacity_factor=0.05, info=info,
    )
    assert np.array_equal(_u32(got), expected)
    assert info["retries"] >= info["rounds"] and info["rounds"] > 2


# --------------------------------------------------------------------------- #
# Kmers on the mesh beyond one window: the checks of test_unbounded_mesh.py
# --------------------------------------------------------------------------- #


def _core_seqs():
    rng = np.random.default_rng(12)
    core = "".join(rng.choice(list("ACGT"), size=120))
    return [
        ("r1", core + "".join(rng.choice(list("ACGT"), size=500)) + core),
        ("r2", core[:90] + "".join(rng.choice(list("ACGT"), size=300))),
        ("r3", "".join(rng.choice(list("ACGT"), size=300, p=[0.7, 0.1, 0.1, 0.1]))),
    ]


def _n_seqs():
    rng = np.random.default_rng(13)
    core = "".join(rng.choice(list("ACGT"), size=120))
    return [
        ("n1", core + "N" + core + "".join(rng.choice(list("ACGTN"), size=200))),
        ("n2", "".join(rng.choice(list("ACGT"), size=300))),
    ]


@pytest.fixture(scope="module")
def unbounded():
    """``get(name)``: indexes built on first use in each test process."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _BUILDERS[name]()
        return built[name]

    return get


def _jax_sorted(seqs, mn, mx):
    km = gj.Kmers(gj.SequenceCollection(sequence_list=seqs), mn, mx)
    km.sort()
    return km


def _port(seqs, mn, mx, mesh=None):
    km = gt.Kmers(gt.SequenceCollection(sequence_list=seqs, device="cpu"), mn, mx)
    km.sort(mesh=mesh)
    return km


_TM = tp.make_mesh(devices=["cpu"] * 8)
_BUILDERS = {
    "suffix": lambda: (_jax_sorted(_core_seqs(), 1, None), _port(_core_seqs(), 1, None, _TM)),
    "suffix8": lambda: (_jax_sorted(_core_seqs(), 8, None), _port(_core_seqs(), 8, None, _TM)),
    "bounded12": lambda: (_jax_sorted(_core_seqs(), 1, 12), _port(_core_seqs(), 1, 12, _TM)),
    "n40": lambda: (_jax_sorted(_n_seqs(), 1, 40), _port(_n_seqs(), 1, 40, _TM)),
    "single": lambda: (_jax_sorted(_core_seqs(), 1, None), _port(_core_seqs(), 1, None)),
}


def _count_adjacent_gids(monkeypatch):
    calls = []
    real = tkmers.distributed_adjacent_gids

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tkmers, "distributed_adjacent_gids", counting)
    return calls


def _check_suffix_from_kept_ids(get, monkeypatch):
    kj, kt = get("suffix")
    cache = kt._dist_cache
    assert cache.gid_full is not None and cache.gid_full_k is None and cache.lanes is None
    assert np.array_equal(kt.kmer_sba_start_indices, kj.kmer_sba_start_indices)
    calls = _count_adjacent_gids(monkeypatch)
    got = kt.get_kmer_group_counts(None, max_counts_bin=30, mesh=_TM)
    assert calls == []  # the kept run ids serve: no refinement round
    assert _same_hist(got, kj.get_kmer_group_counts(None, max_counts_bin=30))


def _check_bounded_on_suffix_layout(get, monkeypatch):
    kj, kt = get("suffix")
    assert _same_hist(kt.get_kmer_group_counts(5, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(5, max_counts_bin=30))


def _check_filtered_suffix(get, monkeypatch):
    # min_kmer_len 8: the k = 8 GC window never truncates
    kj, kt = get("suffix8")
    fj, ft = (m.gen_kmer_gc_content_filter_func(0.25, 0.75, 8) for m in (jf, tf))
    assert _same_hist(kt.get_kmer_group_counts(None, kmer_filter_func=ft, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(None, kmer_filter_func=fj, max_counts_bin=30))


def _check_none_on_bounded_layout(get, monkeypatch):
    kj, kt = get("bounded12")
    calls = _count_adjacent_gids(monkeypatch)
    assert _same_hist(kt.get_kmer_group_counts(None, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(None, max_counts_bin=30))
    assert calls == [1]


def _check_beyond_window_kept_ids(get, monkeypatch):
    kj, kt = get("n40")
    assert kt._dist_cache.gid_full_k == 40
    calls = _count_adjacent_gids(monkeypatch)
    assert _same_hist(kt.get_kmer_group_counts(40, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(40, max_counts_bin=30))
    assert calls == []


def _check_beyond_window_fresh_ids(get, monkeypatch):
    kj, kt = get("n40")
    calls = _count_adjacent_gids(monkeypatch)
    assert _same_hist(kt.get_kmer_group_counts(35, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(35, max_counts_bin=30))
    assert calls == [1]


def _check_no_kept_layout(get, monkeypatch):
    kj, kt = get("single")
    assert kt._dist_cache is None
    assert _same_hist(kt.get_kmer_group_counts(None, max_counts_bin=30, mesh=_TM),
                      kj.get_kmer_group_counts(None, max_counts_bin=30))


def _check_count(get, monkeypatch):
    kj, kt = get("suffix")
    assert kt.get_kmer_count(None, mesh=_TM, min_group_size=2) == kj.get_kmer_count(
        None, min_group_size=2)
    # queries over the kept layout, whose shards hold their real rows and one pad row
    sba = kj.seq_coll.forward_sba.tobytes().decode()
    qs = [sba[i : i + 12] for i in range(0, 600, 37)] + ["A" * 12, "ACGTACGTACGT"]
    assert np.array_equal(kt.count_queries(qs, 12, mesh=_TM), kj.count_queries(qs, 12))


UNBOUNDED_CHECKS = {
    "suffix-kept-ids": _check_suffix_from_kept_ids,
    "bounded-on-suffix-layout": _check_bounded_on_suffix_layout,
    "filtered-suffix": _check_filtered_suffix,
    "none-on-bounded-layout": _check_none_on_bounded_layout,
    "beyond-window-kept-ids": _check_beyond_window_kept_ids,
    "beyond-window-fresh-ids": _check_beyond_window_fresh_ids,
    "no-kept-layout": _check_no_kept_layout,
    "count": _check_count,
}


@pytest.mark.parametrize("check", list(UNBOUNDED_CHECKS))
def test_unbounded_mesh_statistics_match_jax(unbounded, monkeypatch, check):
    UNBOUNDED_CHECKS[check](unbounded, monkeypatch)


def _filters(mod):
    return {
        "gc": mod.gen_kmer_gc_content_filter_func(0.3, 0.6, 8),
        "homopolymer": mod.gen_kmer_homopolymer_filter_func(4, 8),
        "length": mod.gen_kmer_length_filter_func(11),
        "crispr": mod.crispr_ngg_pam_filter,
        "callable": lambda sba, strand, i: bool(sba[i] != ord("A")),
    }


@pytest.mark.parametrize("fname", list(_filters(tf)))
@pytest.mark.parametrize("kmer_len", [None, 70])
def test_filters_beyond_one_window_match_jax(unbounded, fname, kmer_len):
    """A library filter on the kept suffix layout (plane route, the layout
    compacted, fresh run ids); a plain callable (survivors sample-sorted
    afresh by refinement rounds). Raises, where the JAX package raises,
    with its message."""
    kj, kt = unbounded("suffix8")
    want = _outcome(lambda: kj.get_kmer_group_counts(kmer_len, _filters(jf)[fname],
                                                     max_counts_bin=30))
    got = _outcome(lambda: kt.get_kmer_group_counts(kmer_len, _filters(tf)[fname],
                                                    max_counts_bin=30, mesh=_TM))
    if isinstance(want[0], type):  # the CRISPR guide runs past a record's end: raised
        assert got == want
    else:
        assert _same_hist(got, want)


def test_strands_kept_apart_at_none_match_jax():
    sl = _core_seqs()
    kj = gj.Kmers.from_strand(gj.SequenceCollection(sequence_list=sl, strands_to_load="both"),
                              1, None, source_strand="both", track_strands_separately=True)
    kj.sort()
    kt = gt.Kmers.from_strand(
        gt.SequenceCollection(sequence_list=sl, strands_to_load="both", device="cpu"),
        1, None, source_strand="both", track_strands_separately=True,
    )
    kt.sort(mesh=tp.make_mesh(devices=["cpu"] * 3))
    assert np.array_equal(kt.kmer_sba_start_indices, kj.kmer_sba_start_indices)
    mesh = kt._dist_cache.mesh
    for k in (None, 40):
        assert _same_hist(kt.get_kmer_group_counts(k, max_counts_bin=30, mesh=mesh),
                          kj.get_kmer_group_counts(k, max_counts_bin=30))


# --------------------------------------------------------------------------- #
# canonical statistics on a mesh
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("route", ["dense", "gather"])
@pytest.mark.parametrize("iupac", [False, True], ids=["acgt", "iupac"])
def test_canonical_layouts_match_jax(iupac, route):
    scj, sct = _collections(_seq_list(5, iupac))
    jm, tm = _meshes(3)
    dj, dt = scj.device_cache("forward"), sct.device_cache("forward")
    two = not iupac
    pj, pt = (dj.packed2, dt.packed2) if two else (dj.packed, dt.packed)
    k = 20
    if route == "dense":
        j_out = jp.sample_sort_canonical_dense_ragged(pj, dj.seg_starts, dj.seg_ends, 8, k, jm,
                                                      two_bit=two)
        t_out = tp.sample_sort_canonical_dense_ragged(pt, dt.seg_starts, dt.seg_ends, 8, k, tm,
                                                      two_bit=two)
    else:
        pos = np.ascontiguousarray(gj.Kmers(scj, 8, 31).kmer_sba_start_indices[::-1])
        j_out = jp.sample_sort_canonical_ragged(pj, jnp.asarray(pos), dj.seg_starts, dj.seg_ends,
                                                k, jm, two_bit=two)
        t_out = tp.sample_sort_canonical_ragged(pt, torch.from_numpy(pos.astype(np.int64)),
                                                dt.seg_starts, dt.seg_ends, k, tm, two_bit=two)
    j_pos, j_pad = _shards(j_out[0], 3), _shards(j_out[1], 3)
    assert len(t_out[2][0]) == len(j_out[2])
    for s in range(3):
        assert np.array_equal(j_pos[s], _u32(t_out[0][s]))
        assert np.array_equal(j_pad[s] != 0, t_out[1][s].numpy())
        for jl, tl in zip(j_out[2], t_out[2][s]):
            assert np.array_equal(_shards(jl, 3)[s], tl.numpy().view(np.uint32))


@pytest.mark.parametrize("route", ["dense", "gather"])
@pytest.mark.parametrize("iupac", [False, True], ids=["acgt", "iupac"])
def test_canonical_mesh_statistics_match_jax(iupac, route):
    sl = _seq_list(6, iupac)
    kj = gj.Kmers(gj.SequenceCollection(sequence_list=sl), 8, 31)
    kt = gt.Kmers(gt.SequenceCollection(sequence_list=sl, device="cpu"), 8, 31)
    if route == "gather":
        kj.sort()
        kt.sort()
    tm = tp.make_mesh(devices=["cpu"] * 8)
    for k in (8, 20):
        want = kj.get_canonical_kmer_group_counts(k, max_counts_bin=30)
        assert _same_hist(kt.get_canonical_kmer_group_counts(k, max_counts_bin=30, mesh=tm), want)


# --------------------------------------------------------------------------- #
# a JAX mesh index carried into the port
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("max_k", [None, 31])
def test_interop_carries_a_jax_mesh_layout(monkeypatch, max_k):
    sl = _seq_list(7, False)
    jm, tm = _meshes(3)
    kj = gj.Kmers(gj.SequenceCollection(sequence_list=sl), 1, max_k)
    kj.sort(mesh=jm)
    c = kj._dist_cache
    gid = None if c.gid_full is None else _shards(c.gid_full, 3)
    assert (gid is None) == (max_k is not None)
    sc = kj.seq_coll
    _, kt = from_numpy_state(
        sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, 1, max_k,
        device="cpu", mesh=tm, mesh_positions=_shards(c.positions, 3),
        mesh_pad=_shards(c.is_pad, 3), mesh_gid=gid,
    )
    assert np.array_equal(kt.kmer_sba_start_indices, kj.kmer_sba_start_indices)
    calls = _count_adjacent_gids(monkeypatch)
    for k in (max_k, 12):
        assert _same_hist(kt.get_kmer_group_counts(k, max_counts_bin=30, mesh=tm),
                          kj.get_kmer_group_counts(k, max_counts_bin=30, mesh=jm))
    assert calls == []
    qs = ["ACGTACGTACGT", sl[0][1][:12]]
    assert np.array_equal(kt.count_queries(qs, 12, mesh=tm), kj.count_queries(qs, 12, mesh=jm))
