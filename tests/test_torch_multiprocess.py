"""The port's mesh across processes: ``torch.distributed`` with Gloo on the
CPU, against the port's single-process mesh, the JAX package and the
string oracle.

Each test spawns its ranks over ``tcp://127.0.0.1:<free port>`` at the
shapes of ``tests/test_multiprocess.py``: 2 ranks x 2 CPU shards and 4
ranks x 2 CPU shards. The rank body is this file's ``__main__``; a rank
imports torch and the port alone and asserts at its end that no ``jax``
module was loaded (the JAX package is imported only inside the test
functions, in the parent). Each rank runs every check in one launch and
writes its results (its own shards of every layout, and every host value)
to a file; the parent runs the same checks on the port's single-process
mesh of as many shards while the ranks run.

``test_process_mesh_matches_single_process``: on an IUPAC (k = 5) and an
ACGT (k = 9) genome of three records, the gather, dense, hierarchical
(``make_mesh2(ranks, 2)``: a node is a rank), canonical (gather and dense)
sample sorts; the ragged histogram at (1, None) and (2, 4); count queries;
``Kmers.sort(mesh=)`` with its statistics, four library filters, queries
and canonical statistics; a sharded index saved on the full mesh and
loaded onto one shard per rank, and ``save_kmers_sharded`` /
``load_kmers_sharded``; on a repeat-heavy genome the refinement sort in
suffix mode with its per-round balance; ``LargeKmers`` (31, 31) with its
checkpoint. Held to: the single-process mesh shard for shard (rank r's
shards are shards ``r * 2, r * 2 + 1``) and every host value equal,
the saved files byte for byte; the JAX package's single-device ``Kmers``
and ``LargeKmers`` (sorted order, histograms, counts, filter outcomes,
queries); ``tests/oracle.py``.

``test_process_collectives``: the process-group collectives against
their single-process counterparts on the same values: ``all_to_all`` with
uneven blocks, empty blocks and all-empty exchanges, bool blocks, and the
2-D two-stage exchange's block order; ``all_gather``, ``psum``, ``pmax``,
``gather_host``, ``all_gather_shards`` of shards of any length (zero
too), ``barrier``.

Tolerance: exact equality. Each launch waits at most 240 s.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
N_LOCAL = 2
SHAPES = [(2, N_LOCAL), (4, N_LOCAL)]
SHAPE_IDS = ["2proc_x2dev", "4proc_x2dev"]
TIMEOUT = 240


# --------------------------------------------------------------------------- #
# the checks, run by each rank on its process mesh and by the parent on the
# single-process mesh of as many shards
# --------------------------------------------------------------------------- #


def _configs():
    """The genomes of tests/mp_worker.py: (name, records, k), and the
    repeat-heavy genome of its unbounded check."""
    rng = np.random.default_rng(20260817)
    configs = []
    for name, alphabet, k in (("iupac_k5", "ACGTN", 5), ("acgt_k9", "ACGT", 9)):
        seqs = [(f"rec{r}", "".join(rng.choice(list(alphabet), size=n)))
                for r, n in enumerate((97, 53, 71))]
        configs.append((name, seqs, k))
    unit = "".join(rng.choice(list("ACGT"), size=40))
    repeats = unit * 6 + "".join(rng.choice(list("ACGT"), size=37))
    return configs, repeats


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e).__name__, str(e)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _queries(seqs, k):
    """Present k-mers, an absent one and one with an N."""
    present = [s[i : i + k] for _, s in seqs for i in (0, 7, 20)]
    return list(dict.fromkeys(present)) + ["A" * k, "C" * (k - 1) + "N"]


def _checks(mesh, mesh2, mesh_one, out_dir: Path) -> dict:
    """Every check on ``mesh`` (2-D: ``mesh2``; one shard a rank:
    ``mesh_one``): name -> ("shards", [arrays of this process's shards])
    or ("host", value)."""
    import genome_kmers_tpu_torch as gt
    from genome_kmers_tpu_torch import parallel as tp
    from genome_kmers_tpu_torch.large_kmers import LargeKmers
    from genome_kmers_tpu_torch.ops.filters import (
        CrisprNggPamFilter,
        GcContentFilter,
        HomopolymerFilter,
        NoAmbiguousBasesFilter,
    )
    from genome_kmers_tpu_torch.parallel import sample_sort as tss

    out = {}

    def shards(name, xs):
        out[name] = ("shards", [_np(x) for x in xs])

    def lanes(name, xs):
        out[name] = ("shards", [np.stack([_np(w) for w in shard]) for shard in xs])

    def host(name, value):
        out[name] = ("host", value)

    configs, repeats = _configs()
    for name, seqs, k in configs:
        sc = gt.SequenceCollection(sequence_list=seqs, device="cpu")
        dc = sc.device_cache("forward")
        two_bit = dc.packed2 is not None
        packed, packed2 = (None, dc.packed2) if two_bit else (dc.packed, None)
        packed_e = dc.packed2 if two_bit else dc.packed
        ss, se = dc.seg_starts, dc.seg_ends
        pos = torch.from_numpy(gt.Kmers(sc, 1, k).kmer_sba_start_indices.astype(np.int64))
        rp, rd, rl = tp.sample_sort_positions_ragged(
            packed, pos, ss, se, k, mesh, packed2=packed2, return_lanes=True)
        shards(f"{name}/gather/pos", rp)
        shards(f"{name}/gather/pad", rd)
        lanes(f"{name}/gather/lanes", rl)
        host(f"{name}/gather/rows", tss.ragged_rows(rp, rd, mesh))
        host(f"{name}/sorted", _np(tp.sample_sort_positions(
            packed, pos, ss, se, k, mesh, packed2=packed2)))
        for mn, mx in ((1, None), (2, 4)):
            counts, total = tp.distributed_group_size_histogram_ragged(
                packed, rp, rd, ss, se, k, mesh, min_group_size=mn, max_group_size=mx,
                max_counts_bin=50, packed2=packed2)
            host(f"{name}/hist/{mn}-{mx}", (_np(counts), int(total)))
        host(f"{name}/queries", tp.distributed_count_queries(
            dc.packed, rp, rd, ss, se, _queries(seqs, k), k, mesh))
        dp, dd, dl = tp.sample_sort_positions_dense_ragged(
            packed_e, ss, se, len(pos), 1, k, mesh, two_bit=two_bit, return_lanes=True)
        shards(f"{name}/dense/pos", dp)
        shards(f"{name}/dense/pad", dd)
        lanes(f"{name}/dense/lanes", dl)
        hp, hd = tp.sample_sort_positions_ragged_hier(
            packed, pos, ss, se, k, mesh2, packed2=packed2)
        shards(f"{name}/hier/pos", hp)
        shards(f"{name}/hier/pad", hd)
        for route, (cp, cd, cl) in (
            ("gather", tp.sample_sort_canonical_ragged(packed_e, pos, ss, se, k, mesh,
                                                       two_bit=two_bit)),
            ("dense", tp.sample_sort_canonical_dense_ragged(packed_e, ss, se, 1, k, mesh,
                                                            two_bit=two_bit)),
        ):
            shards(f"{name}/canonical-{route}/pos", cp)
            shards(f"{name}/canonical-{route}/pad", cd)
            lanes(f"{name}/canonical-{route}/lanes", cl)
        # the Kmers calls on the mesh
        km = gt.Kmers(sc, 1, k)
        km.sort(mesh=mesh)
        shards(f"{name}/kmers/pos", km._dist_cache.positions)
        host(f"{name}/kmers/index", km.kmer_sba_start_indices)
        host(f"{name}/kmers/hist", km.get_kmer_group_counts(k, max_counts_bin=50, mesh=mesh))
        host(f"{name}/kmers/count", km.get_kmer_count(k, mesh=mesh))
        for fname, f in (("gc", GcContentFilter(0.3, 0.7, k)), ("homopoly", HomopolymerFilter(2, k)),
                         ("noamb", NoAmbiguousBasesFilter(k)), ("crispr", CrisprNggPamFilter())):
            host(f"{name}/kmers/filter-{fname}", _outcome(
                lambda f=f: km.get_kmer_count(k, kmer_filter_func=f, mesh=mesh)))
        host(f"{name}/kmers/queries", km.count_queries(_queries(seqs, k), k, mesh=mesh))
        host(f"{name}/kmers/queries-canonical",
             km.count_queries_canonical(_queries(seqs, k), k, mesh=mesh))
        host(f"{name}/kmers/canonical", km.get_canonical_kmer_group_counts(
            k, max_counts_bin=50, mesh=mesh))
        # checkpoints: saved on the full mesh, loaded onto one shard a rank
        path = out_dir / f"{name}-index"
        tp.save_sharded_index(path, rp, {"config": name}, mesh=mesh)
        restored, _, meta = tp.load_sharded_index(path, mesh=mesh_one)
        shards(f"{name}/ckpt/restored", restored)
        host(f"{name}/ckpt/n_real", int(meta["__n_real__"]))
        tp.save_kmers_sharded(km, out_dir / f"{name}-kmers")
        km2 = gt.Kmers(sc, 1, k)
        tp.load_kmers_sharded(km2, out_dir / f"{name}-kmers", mesh=mesh_one)
        host(f"{name}/ckpt/kmers", km2.kmer_sba_start_indices)
        # LargeKmers (31, 31)
        lk = LargeKmers.from_sequence_collection(sc, 31, 31)
        lk.sort(mesh)
        shards(f"{name}/large/pos", lk._sorted[0])
        host(f"{name}/large/rows", lk.sorted_positions())
        host(f"{name}/large/hist", lk.get_kmer_group_counts(31, max_counts_bin=50))
        host(f"{name}/large/count", lk.get_kmer_count(31))
        lk.save_checkpoint(out_dir / f"{name}-large")
        lk2 = LargeKmers.from_sequence_collection(sc, 31, 31)
        lk2.load_checkpoint(out_dir / f"{name}-large", mesh_one)
        host(f"{name}/large/restored", lk2.sorted_positions())
    # the refinement rounds on a repeat-heavy genome
    sc = gt.SequenceCollection(sequence_list=[("rep", repeats)], device="cpu")
    dc = sc.device_cache("forward")
    info = {}
    up, ud, ug = tp.sample_sort_positions_unbounded(
        None, torch.arange(len(repeats), dtype=torch.int64), dc.seg_starts, dc.seg_ends, mesh,
        packed2=dc.packed2, return_ragged=True, info=info)
    shards("unbounded/pos", up)
    shards("unbounded/gid", ug)
    host("unbounded/round_rows", info["round_rows"])
    km = gt.Kmers(sc)
    km.sort(mesh=mesh)
    host("unbounded/kmers/index", km.kmer_sba_start_indices)
    host("unbounded/kmers/hist-none", km.get_kmer_group_counts(None, max_counts_bin=50, mesh=mesh))
    host("unbounded/kmers/hist-12", km.get_kmer_group_counts(12, max_counts_bin=50, mesh=mesh))
    host("unbounded/kmers/hist-50", km.get_kmer_group_counts(50, max_counts_bin=50, mesh=mesh))
    return out


def _collectives(mesh, mesh2) -> None:
    """Each process-group collective against the single-process function on
    the same values (a mesh of every shard in this process); raises on a
    difference."""
    from genome_kmers_tpu_torch.parallel import collectives as col
    from genome_kmers_tpu_torch.parallel.distributed import Mesh

    n, first, n_local = mesh.n_shards, mesh.first, len(mesh.devices)
    local = range(first, first + n_local)
    whole = Mesh(["cpu"] * n)
    whole2 = Mesh(["cpu"] * n, mesh2.axis_names, tuple(mesh2.shape.values()))

    def block(p, b, rows_of, dtype=torch.int32):
        return (torch.arange(rows_of(p, b), dtype=torch.int64) + 1000 * p + 10 * b).to(dtype)

    def same(a, b):
        return len(a) == len(b) and all(
            len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y)) for x, y in zip(a, b))

    shapes = {
        "uneven": lambda p, b: (3 * p + 5 * b) % 7,
        "zero rows to some": lambda p, b: 0 if (p + b) % 3 == 0 else p + b + 1,
        "all empty": lambda p, b: 0,
        "one sender": lambda p, b: 9 if p == 0 else 0,
    }
    for label, rows_of in shapes.items():
        for dtype in (torch.int32, torch.int64):
            full = [[block(p, b, rows_of, dtype) for b in range(n)] for p in range(n)]
            for flat, process_mesh in ((whole, mesh), (whole2, mesh2)):
                want = col.all_to_all(full, flat)
                got = col.all_to_all([full[p] for p in local], process_mesh)
                assert same(got, [want[p] for p in local]), (label, dtype, flat.axis_names)
    flags = [[block(p, b, shapes["uneven"]) % 3 == 0 for b in range(n)] for p in range(n)]
    assert same(col.all_to_all([flags[p] for p in local], mesh),
                [col.all_to_all(flags, whole)[p] for p in local])
    values = [torch.tensor([p * 7 - 3, 100 - p]) for p in range(n)]
    mine = [values[p] for p in local]
    for fn in (col.all_gather, col.psum, col.pmax):
        want = fn(values, whole)
        assert all(torch.equal(g, want[p]) for g, p in zip(fn(mine, mesh), local)), fn.__name__
    bools = [torch.tensor(p % 2 == 0) for p in range(n)]
    assert all(torch.equal(g, col.all_gather(bools, whole)[0])
               for g in col.all_gather([bools[p] for p in local], mesh))
    assert np.array_equal(col.gather_host([np.array([p, p * p]) for p in local], mesh),
                          np.array([[p, p * p] for p in range(n)]))
    ragged = [torch.arange(p % 3 * 4, dtype=torch.int64) * (p + 1) for p in range(n)]
    got = col.all_gather_shards([ragged[p] for p in local], mesh)
    assert len(got) == n and all(torch.equal(g, r) for g, r in zip(got, ragged))
    empty = col.all_gather_shards([torch.zeros(0, dtype=torch.bool) for _ in local], mesh)
    assert len(empty) == n and all(e.shape == (0,) and e.dtype == torch.bool for e in empty)
    col.barrier(mesh)
    sharded = col.put_sharded(torch.arange(4 * n), mesh)
    assert all(torch.equal(s, torch.arange(4 * p, 4 * p + 4)) for s, p in zip(sharded, local))
    assert col.TRAFFIC["collectives"] > 0 and col.TRAFFIC["host_bytes"] > 0
    assert col.TRAFFIC["device_bytes"] == 0


def _rank_main(port: int, n_ranks: int, rank: int, n_local: int, mode: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_ranks, rank=rank)
    from genome_kmers_tpu_torch import parallel as tp

    out_dir = Path(out_dir)
    mesh = tp.make_mesh(devices=["cpu"] * n_local)
    mesh2 = tp.make_mesh2(n_ranks, n_local, devices=["cpu"] * n_local)
    assert mesh.n_shards == n_ranks * n_local and mesh.first == rank * n_local
    if mode == "collectives":
        _collectives(mesh, mesh2)
        results = {}
    else:
        results = _checks(mesh, mesh2, tp.make_mesh(devices=["cpu"]), out_dir / "process")
    banned = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "genome_kmers_tpu."))
              or m == "genome_kmers_tpu"]
    assert not banned, f"a rank imported {banned[:5]}"
    dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


# --------------------------------------------------------------------------- #
# the parent: launch, references, comparison
# --------------------------------------------------------------------------- #


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path: Path, n_ranks: int, n_local: int, mode: str):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("cannot bind a localhost TCP port")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(n_ranks):
        log = open(tmp_path / f"rank{rank}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(port), str(n_ranks), str(rank), str(n_local), mode,
             str(tmp_path)],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        ), log))
    return procs


def _wait(tmp_path: Path, procs) -> list:
    codes = []
    try:
        for proc, _ in procs:
            codes.append(proc.wait(timeout=TIMEOUT))
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    logs = "\n".join(f"--- rank {r} ---\n" + (tmp_path / f"rank{r}.log").read_text(errors="replace")[-3000:]
                     for r in range(len(procs)))
    assert codes is not None, f"a rank timed out\n{logs}"
    assert codes == [0] * len(procs), f"rank exit codes {codes}\n{logs}"
    results = []
    for r in range(len(procs)):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _merged(ranks: list) -> dict:
    """The ranks' results as one: shards concatenated in rank order; host
    values the same on every rank."""
    out = {}
    for key, (kind, value) in ranks[0].items():
        if kind == "shards":
            out[key] = [x for r in ranks for x in r[key][1]]
        else:
            for r in ranks[1:]:
                assert _equal(r[key][1], value), f"{key}: the ranks disagree"
            out[key] = value
    return out


def _files(path: Path) -> dict:
    return {p.relative_to(path): p.read_bytes() for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("n_ranks,n_local", SHAPES, ids=SHAPE_IDS)
def test_process_mesh_matches_single_process(tmp_path, n_ranks, n_local):
    import genome_kmers_tpu as gj
    from genome_kmers_tpu.large_kmers import LargeKmers as JLargeKmers
    from genome_kmers_tpu.ops import filters as jf
    from genome_kmers_tpu.parallel import make_mesh as j_make_mesh

    from genome_kmers_tpu_torch import parallel as tp
    from oracle import expected_kmers

    procs = _launch(tmp_path, n_ranks, n_local, "checks")
    n = n_ranks * n_local
    single = _checks(tp.make_mesh(devices=["cpu"] * n),
                     tp.make_mesh2(n_ranks, n_local, devices=["cpu"] * n),
                     tp.make_mesh(devices=["cpu"] * n_ranks), tmp_path / "single")
    got = _merged(_wait(tmp_path, procs))
    # the port's single-process mesh, shard for shard, and the saved files
    assert got.keys() == single.keys()
    for key, (_, want) in single.items():
        assert _equal(got[key], want), key
    assert _files(tmp_path / "process") == _files(tmp_path / "single")
    # the JAX package's single-device Kmers and LargeKmers, and the oracle
    configs, repeats = _configs()
    for name, seqs, k in configs:
        jkm = gj.Kmers(gj.SequenceCollection(sequence_list=seqs), 1, k)
        jkm.sort()
        _, _, _, oracle_sorted = expected_kmers(seqs, 1, k)
        assert got[f"{name}/kmers/index"].tolist() == oracle_sorted
        assert np.array_equal(got[f"{name}/gather/rows"], jkm.kmer_sba_start_indices)
        assert np.array_equal(got[f"{name}/ckpt/kmers"], jkm.kmer_sba_start_indices)
        restored = np.concatenate(got[f"{name}/ckpt/restored"])[: got[f"{name}/ckpt/n_real"]]
        layout = np.concatenate(got[f"{name}/gather/pos"]).astype(np.uint32)  # pads included
        assert np.array_equal(restored.astype(np.uint32), layout)
        for mn, mx in ((1, None), (2, 4)):
            want = jkm.get_kmer_group_counts(k, min_group_size=mn, max_group_size=mx,
                                             max_counts_bin=50)
            assert _equal((np.asarray(want[0]).astype(np.int64), int(want[1])),
                          got[f"{name}/hist/{mn}-{mx}"]), (name, mn, mx)
        want = jkm.get_kmer_group_counts(k, max_counts_bin=50)
        assert np.array_equal(got[f"{name}/kmers/hist"][0], want[0])
        assert got[f"{name}/kmers/hist"][1] == want[1] == got[f"{name}/kmers/count"]
        for fname, f in (("gc", jf.GcContentFilter(0.3, 0.7, k)), ("homopoly", jf.HomopolymerFilter(2, k)),
                         ("noamb", jf.NoAmbiguousBasesFilter(k)), ("crispr", jf.CrisprNggPamFilter())):
            want = _outcome(lambda f=f: jkm.get_kmer_count(k, kmer_filter_func=f))
            assert _equal(got[f"{name}/kmers/filter-{fname}"], want), (name, fname, want)
        q = _queries(seqs, k)
        assert np.array_equal(got[f"{name}/queries"], jkm.count_queries(q, k))
        assert np.array_equal(got[f"{name}/kmers/queries"], jkm.count_queries(q, k))
        assert np.array_equal(got[f"{name}/kmers/queries-canonical"],
                              jkm.count_queries_canonical(q, k))
        want = jkm.get_canonical_kmer_group_counts(k, max_counts_bin=50)
        assert np.array_equal(got[f"{name}/kmers/canonical"][0], want[0])
        assert got[f"{name}/kmers/canonical"][1] == want[1]
        jlk = JLargeKmers.from_sequence_collection(gj.SequenceCollection(sequence_list=seqs), 31, 31)
        jlk.sort(j_make_mesh(1))
        assert np.array_equal(got[f"{name}/large/rows"], np.asarray(jlk.sorted_positions()))
        assert np.array_equal(got[f"{name}/large/restored"], got[f"{name}/large/rows"])
        want = jlk.get_kmer_group_counts(31, max_counts_bin=50)
        assert np.array_equal(got[f"{name}/large/hist"][0], np.asarray(want[0]))
        assert got[f"{name}/large/hist"][1] == int(want[1]) == int(got[f"{name}/large/count"])
    # the refinement rounds: the suffix-string order, singleton groups, and
    # every round leaves each shard at most twice the mean rows
    order = sorted(range(len(repeats)), key=lambda i: repeats[i:])
    assert got["unbounded/kmers/index"].tolist() == order
    assert np.concatenate([p[:-1] for p in got["unbounded/pos"]]).tolist() == order
    assert got["unbounded/kmers/hist-none"][1] == len(repeats)
    assert got["unbounded/kmers/hist-none"][0][1] == len(repeats)
    for rows in got["unbounded/round_rows"][1:]:
        assert max(rows) <= 2 * -(-len(repeats) // n)
    jkm = gj.Kmers(gj.SequenceCollection(sequence_list=[("rep", repeats)]))
    jkm.sort()
    for kl in (12, 50):
        want = jkm.get_kmer_group_counts(kl, max_counts_bin=50)
        assert np.array_equal(got[f"unbounded/kmers/hist-{kl}"][0], want[0])
        assert got[f"unbounded/kmers/hist-{kl}"][1] == want[1]


@pytest.mark.parametrize("n_ranks,n_local", SHAPES, ids=SHAPE_IDS)
def test_process_collectives(tmp_path, n_ranks, n_local):
    _wait(tmp_path, _launch(tmp_path, n_ranks, n_local, "collectives"))


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6])
