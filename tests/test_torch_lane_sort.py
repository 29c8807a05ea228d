"""The multi-lane sort's plain version against the TPU kernel, on the CPU.

``genome_kmers_tpu_torch.ops.sort.sort_lanes`` is the plain version that the
CUDA kernel (``csrc/lane_sort.cu``) is held against on the card; here it is
held against ``genome_kmers_tpu.ops.pallas_sort.bitonic_sort_tile`` in
interpret mode and against ``jax.lax.sort`` over all lanes as keys, on
heavily tied keys with a permutation as the last lane, with all-ones rows,
and with values on both sides of 2^31 (the order is unsigned). The wrapper
``sort_lanes_cuda`` must take the plain version for CPU tensors only and
refuse what the kernel does not take. Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu.ops.pallas_sort import bitonic_sort_tile
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.lane_sort import MAX_LANES, TILE_ROWS, sort_lanes_cuda
from genome_kmers_tpu_torch.ops.sort import sort_lanes


def _torch_lanes(lanes_u32):
    return tuple(torch.from_numpy(np.ascontiguousarray(x).view(np.int32)) for x in lanes_u32)


def _as_u32(lanes):
    return [lane.numpy().view(np.uint32) for lane in lanes]


def _tied_lanes(n_lanes: int, n: int, seed: int, all_ones_rows: int = 0):
    """uint32 key lanes with heavy ties, a quarter of the values mirrored
    to the top of the range (>= 2^31, 0xFFFFFFFF included), ``all_ones_rows``
    rows whose key lanes are all 0xFFFFFFFF, and a permutation last."""
    rng = np.random.default_rng(seed)
    lanes = []
    for lane in range(n_lanes - 1):
        vals = rng.integers(0, 40 if lane == 0 else 3, size=n).astype(np.uint32)
        high = rng.random(n) < 0.25
        vals = np.where(high, np.uint32(0xFFFFFFFF) - vals, vals).astype(np.uint32)
        vals[rng.choice(n, size=all_ones_rows, replace=False)] = 0xFFFFFFFF
        lanes.append(vals)
    lanes.append(rng.permutation(n).astype(np.uint32))
    return lanes


def _lax_sorted(lanes_u32):
    ref = jax.lax.sort(tuple(jnp.asarray(x) for x in lanes_u32), num_keys=len(lanes_u32))
    return [np.asarray(r) for r in ref]


@pytest.mark.parametrize("rows", [2, 16])
def test_plain_matches_bitonic_tile_and_lax_sort(rows):
    """The inputs of the TPU kernel's own test (tests/test_ops.py)."""
    rng = np.random.default_rng(rows)
    n = rows * 128
    w0 = rng.integers(0, 40, size=(rows, 128)).astype(np.uint32)  # heavy ties
    w1 = rng.integers(0, 3, size=(rows, 128)).astype(np.uint32)
    pos = rng.permutation(n).astype(np.uint32).reshape(rows, 128)
    tile = bitonic_sort_tile(tuple(jnp.asarray(x) for x in (w0, w1, pos)), interpret=True)
    flat = [x.reshape(-1) for x in (w0, w1, pos)]
    got = _as_u32(sort_lanes(_torch_lanes(flat)))
    for g, t, r in zip(got, tile, _lax_sorted(flat)):
        assert np.array_equal(g, np.asarray(t).reshape(-1))
        assert np.array_equal(g, r)


@pytest.mark.parametrize("n_lanes", [1, 2, 6])
def test_plain_matches_bitonic_tile_with_all_ones_rows(n_lanes):
    lanes = _tied_lanes(n_lanes, 256, seed=n_lanes, all_ones_rows=9)
    tile = bitonic_sort_tile(tuple(jnp.asarray(x.reshape(2, 128)) for x in lanes), interpret=True)
    got = _as_u32(sort_lanes(_torch_lanes(lanes)))
    for g, t, r in zip(got, tile, _lax_sorted(lanes)):
        assert np.array_equal(g, np.asarray(t).reshape(-1))
        assert np.array_equal(g, r)
    if n_lanes > 1:  # the all-ones rows sort last, by position
        assert (got[0][-9:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("n", [2, 127, 128, 4097])
def test_plain_matches_lax_sort_at_any_length(n_lanes, n):
    lanes = _tied_lanes(n_lanes, n, seed=100 * n_lanes + n, all_ones_rows=min(3, n))
    got = _as_u32(sort_lanes(_torch_lanes(lanes)))
    for g, r in zip(got, _lax_sorted(lanes)):
        assert np.array_equal(g, r)


def test_order_is_unsigned():
    keys = np.array([0x80000000, 1, 0xFFFFFFFF, 0x7FFFFFFF, 0], dtype=np.uint32)
    pos = np.arange(5, dtype=np.uint32)
    got = _as_u32(sort_lanes(_torch_lanes([keys, pos])))
    assert got[0].tolist() == [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    assert got[1].tolist() == [4, 1, 3, 0, 2]


@pytest.mark.parametrize("n", [0, 1])
def test_at_most_one_row_comes_back_as_it_is(n):
    lanes = _torch_lanes(_tied_lanes(3, n, seed=1))
    for out in (sort_lanes(lanes), sort_lanes_cuda(lanes)):
        assert all(torch.equal(a, b) for a, b in zip(out, lanes))


def test_wrapper_routes_cpu_tensors_to_plain_version_without_launch():
    lanes = _torch_lanes(_tied_lanes(6, 1000, seed=2, all_ones_rows=4))
    kept = [lane.clone() for lane in lanes]
    before = sort_lanes_cuda.launches
    got = sort_lanes_cuda(lanes)
    assert sort_lanes_cuda.launches == before
    assert all(g.dtype == torch.int32 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, sort_lanes(lanes)))
    assert all(torch.equal(a, b) for a, b in zip(lanes, kept))  # the input is not modified


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: (), "1..8 lanes"),
        (lambda: tuple(torch.zeros(4, dtype=torch.int32) for _ in range(MAX_LANES + 1)), "1..8 lanes"),
        (lambda: (torch.zeros(4, dtype=torch.int64),), "1-D int32 lanes"),
        (lambda: (torch.zeros(4, dtype=torch.uint8),), "1-D int32 lanes"),
        (lambda: (torch.zeros((2, 2), dtype=torch.int32),), "1-D int32 lanes"),
        (lambda: (torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)), "equal length"),
        (lambda: (torch.zeros(8, dtype=torch.int32)[::2],), "contiguous"),
        (lambda: (torch.zeros(4, dtype=torch.int32),
                  torch.zeros(4, dtype=torch.int32, device="meta")), "different devices"),
        (lambda: (torch.zeros(4, dtype=torch.int32, device="meta"),), "unsupported device"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(make, match):
    with pytest.raises(ValueError, match=match):
        sort_lanes_cuda(make())


def test_tile_fits_a_block_and_library_is_named_by_source_hash():
    assert TILE_ROWS & (TILE_ROWS - 1) == 0
    assert 4 * MAX_LANES * TILE_ROWS <= 232448  # the shared memory one block may opt into
    path = build.library_path("lane_sort.cu")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblane_sort_") and path.suffix == ".so"
    source = (build.CSRC / "lane_sort.cu").read_text()
    assert "thrust" not in source and "cub" not in source  # no sort library inside
