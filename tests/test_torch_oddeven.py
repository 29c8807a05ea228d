"""The odd-even merge mesh sort (``parallel.distributed_sort_positions``),
the port against the JAX package, on the CPU.

The port's mesh is ``make_mesh(devices=["cpu"] * P)``, the JAX package's
``make_mesh(P)`` over XLA's virtual CPU devices (tests/conftest.py). At P
in {1, 2, 3, 4}, one 2-bit and one 4-bit shape of a seeded genome against
the JAX package's odd-even sort on its mesh of P devices; the other cases
of the JAX package's tests/test_distributed.py (several records, a
repetitive genome, short records whose caps tie, the 2-bit path at k = 31,
more shards than rows) against its single-device ``sort_positions``, the
truth of its own tests; and the raises (an unbounded k, past the 32/64
limit, a ``make_mesh2`` mesh) against the JAX package's, type and message.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu import parallel as jp
from genome_kmers_tpu.ops import keys as jk
from genome_kmers_tpu.ops import sort as js
from genome_kmers_tpu_torch import parallel as tp
from genome_kmers_tpu_torch.kernels.lane_sort import sort_lanes_cuda


def random_seq(n, seed, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(alphabet), size=n))


def _setup(seq_list, min_k, max_k):
    """(JAX device cache, JAX positions, port device cache, port positions)."""
    jsc = gj.SequenceCollection(sequence_list=seq_list, strands_to_load="forward")
    tsc = gt.SequenceCollection(sequence_list=seq_list, strands_to_load="forward", device="cpu")
    jpos = gj.Kmers(jsc, min_kmer_len=min_k, max_kmer_len=max_k).kmer_sba_start_indices
    tpos = gt.Kmers(tsc, min_kmer_len=min_k, max_kmer_len=max_k).kmer_sba_start_indices
    assert np.array_equal(np.asarray(jpos), np.asarray(tpos))
    return (jsc.device_cache("forward"), jnp.asarray(jpos), tsc.device_cache("forward"),
            torch.as_tensor(np.asarray(tpos), dtype=torch.int64))


def _port(tdc, tpos, k, mesh, two_bit):
    got = tp.distributed_sort_positions(
        None if two_bit else tdc.packed, tpos, tdc.seg_starts, tdc.seg_ends, k, mesh,
        packed2=tdc.packed2 if two_bit else None)
    assert got.dtype == torch.int64 and got.device == tpos.device
    return got.numpy()


def _jax_single(jdc, jpos, k):
    cap = jk.cap_lengths(jk.compute_valid_len(jpos, jdc.seg_starts, jdc.seg_ends), k)
    return np.asarray(js.sort_positions(jdc.packed, jpos, cap, k)).astype(np.int64)


SHAPES = {
    "2-bit k=31": ([("chr1", random_seq(777, 1277))], 31, 31, True),
    "4-bit k=16": ([("chr1", random_seq(503, 503, alphabet="ACGTN"))], 9, 16, False),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_matches_jax_oddeven(p, shape):
    seq_list, min_k, max_k, two_bit = SHAPES[shape]
    jdc, jpos, tdc, tpos = _setup(seq_list, min_k, max_k)
    assert len(jax.devices()) >= p
    want = np.asarray(jp.distributed_sort_positions(
        None if two_bit else jdc.packed, jpos, jdc.seg_starts, jdc.seg_ends, max_k,
        jp.make_mesh(p), packed2=jdc.packed2 if two_bit else None)).astype(np.int64)
    got = _port(tdc, tpos, max_k, tp.make_mesh(devices=["cpu"] * p), two_bit)
    assert np.array_equal(got, want)


CASES = {
    "multi record": ([("chr1", random_seq(150, 1)), ("chr2", random_seq(97, 2)),
                      ("chr3", random_seq(211, 3))], 12, 12, False, 8),
    "repetitive": ([("chr1", "ACGT" * 100)], 8, 8, False, 8),
    "short records, 2-bit cap ties": ([("r%d" % i, "A" * (3 + i % 5)) for i in range(40)],
                                      2, 8, True, 8),
    "2-bit k=64": ([("chr1", random_seq(300, 64))], 40, 64, True, 5),
    "more shards than rows": ([("chr1", random_seq(10, 10))], 8, 8, False, 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_single_device(case):
    seq_list, min_k, max_k, two_bit, p = CASES[case]
    jdc, jpos, tdc, tpos = _setup(seq_list, min_k, max_k)
    got = _port(tdc, tpos, max_k, tp.make_mesh(devices=["cpu"] * p), two_bit)
    assert np.array_equal(got, _jax_single(jdc, jpos, max_k))


def test_every_merge_goes_through_the_lane_sort(monkeypatch):
    """The local sorts and the merges of the paired shards are lane sorts
    (on a card, the kernel): P local sorts and one merge a paired shard a
    phase."""
    from genome_kmers_tpu_torch.parallel import distributed

    calls = []

    def counting(lanes):
        calls.append(lanes[0].shape[0])
        return sort_lanes_cuda(lanes)

    monkeypatch.setattr(distributed, "sort_lanes_cuda", counting)
    _, _, tdc, tpos = _setup([("chr1", random_seq(400, 4))], 8, 8)
    _port(tdc, tpos, 8, tp.make_mesh(devices=["cpu"] * 3), True)
    m = -(-len(tpos) // 3)
    # phases 0 and 2 pair (0, 1), phase 1 pairs (1, 2): six merges of 2m rows
    assert calls == [m] * 3 + [2 * m] * 6


def _raises(fn):
    with pytest.raises(NotImplementedError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("two_bit,max_k", [(False, None), (False, 33), (True, 65)])
def test_limits_raise_like_jax(two_bit, max_k):
    jdc, jpos, tdc, tpos = _setup([("chr1", random_seq(100, 4))], 1, max_k)
    want = _raises(lambda: jp.distributed_sort_positions(
        jdc.packed, jpos, jdc.seg_starts, jdc.seg_ends, max_k, jp.make_mesh(2),
        packed2=jdc.packed2 if two_bit else None))
    got = _raises(lambda: tp.distributed_sort_positions(
        tdc.packed, tpos, tdc.seg_starts, tdc.seg_ends, max_k, tp.make_mesh(devices=["cpu"] * 2),
        packed2=tdc.packed2 if two_bit else None))
    assert got == want


def test_2d_mesh_raises_like_jax():
    jdc, jpos, tdc, tpos = _setup([("chr1", random_seq(100, 4))], 8, 8)
    want = _raises(lambda: jp.distributed_sort_positions(
        jdc.packed, jpos, jdc.seg_starts, jdc.seg_ends, 8, jp.make_mesh2(2, 2)))
    got = _raises(lambda: tp.distributed_sort_positions(
        tdc.packed, tpos, tdc.seg_starts, tdc.seg_ends, 8, tp.make_mesh2(2, 2, devices=["cpu"] * 4)))
    assert got == want
