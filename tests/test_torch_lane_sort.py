"""The multi-lane sort's plain version against the TPU kernel, on the CPU,
and a NumPy model of the CUDA kernels' schedule against both.

``genome_kmers_tpu_torch.ops.sort.sort_lanes`` is the plain version that the
CUDA kernel (``csrc/lane_sort.cu``) is held against on the card; here it is
held against ``genome_kmers_tpu.ops.pallas_sort.bitonic_sort_tile`` in
interpret mode and against ``jax.lax.sort`` over all lanes as keys, on
heavily tied keys with a permutation as the last lane, with all-ones rows,
and with values on both sides of 2^31 (the order is unsigned). The wrapper
``sort_lanes_cuda`` must take the plain version for CPU tensors only and
refuse what the kernel does not take. The CUDA kernels run only on the card;
what surrounds them is held here: the pass schedule that sizes the scratch
buffers, the shared-memory budget, and a model of the kernels' steps (the
8-row network, the merge-path search with its "A on equal" rule, the serial
merge of 8 outputs a thread, the merge passes cut by output tile) on small
tiles. Tolerance: exact equality.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu.ops.pallas_sort import bitonic_sort_tile
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.lane_sort import (
    MAX_LANES,
    TILE_ROWS,
    pass_schedule,
    sort_lanes_cuda,
)
from genome_kmers_tpu_torch.ops.sort import sort_lanes

ROWS_PER_THREAD = 8  # rows of a thread's network, outputs it merges serially


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
    assert TILE_ROWS & (TILE_ROWS - 1) == 0 and TILE_ROWS <= 1 << 16  # 16-bit source indices
    source = (build.CSRC / "lane_sort.cu").read_text()
    # the wrapper's tile is the source's; the source holds its own budget
    # (tile plus source indices, times the blocks an SM holds) at compile time
    per_thread = int(re.search(r"kRowsPerThread = (\d+);", source).group(1))
    assert per_thread == ROWS_PER_THREAD
    assert int(re.search(r"kSortThreads = (\d+);", source).group(1)) * per_thread == TILE_ROWS
    assert "sizeof(uint32_t) * NL * kTile + sizeof(uint16_t) * kTile" in source
    assert re.search(r"static_assert\(kBlocksPerSm \* \(kSharedBytes \+ kSharedBytesReservedPerBlock\)"
                     r"\s*<= kSharedBytesPerSm", source)
    assert "kSharedBytesPerSm = 232448;" in source
    path = build.library_path("lane_sort.cu")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblane_sort_") and path.suffix == ".so"
    assert "thrust" not in source and "cub" not in source  # no sort library inside


_T = TILE_ROWS


@pytest.mark.parametrize(
    "n,n_rows,n_merges,result",
    [
        (2, _T, 0, 0),
        (_T - 1, _T, 0, 0),
        (_T, _T, 0, 0),
        (_T + 1, 2 * _T, 1, 1),
        (3 * _T, 3 * _T, 2, 0),
        (1 << 27, 1 << 27, 15, 1),
        ((1 << 27) + 1, (1 << 27) + _T, 16, 0),
    ],
)
def test_pass_schedule(n, n_rows, n_merges, result):
    rows, widths, buffer = pass_schedule(n)
    assert (rows, len(widths), buffer) == (n_rows, n_merges, result)
    assert rows % TILE_ROWS == 0 and 0 <= rows - n < TILE_ROWS  # a whole tile, no power of two
    assert widths == tuple(TILE_ROWS << p for p in range(n_merges))
    assert all(w < rows for w in widths) and (not widths or 2 * widths[-1] >= rows)


def test_pass_schedule_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        pass_schedule(0)


# --------------------------------------------------------------------------- #
# a model of the kernels: rows are tuples of Python ints, compared as tuples
# --------------------------------------------------------------------------- #

_NETWORK = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
            (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6)]
_MODEL_TILE = 64  # 8 threads x 8 rows


def _diagonal_split(run_a, run_b, diag):
    """Rows of A among the first ``diag`` outputs of the merge of A and B,
    A first on equal: the least i with A[i] > B[diag - 1 - i]."""
    lo, hi = max(0, diag - len(run_b)), min(diag, len(run_a))
    while lo < hi:
        mid = (lo + hi) // 2
        if run_a[mid] <= run_b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_eight(run_a, run_b, diag):
    """A thread's 8 outputs from ``diag`` on: split, then serial merge."""
    i = _diagonal_split(run_a, run_b, diag)
    j = diag - i
    out = []
    for _ in range(ROWS_PER_THREAD):
        take_a = j >= len(run_b) or (i < len(run_a) and run_a[i] <= run_b[j])
        out.append(run_a[i] if take_a else run_b[j])
        i, j = i + take_a, j + (not take_a)
    return out


def _model_block_sort(tile):
    threads = len(tile) // ROWS_PER_THREAD
    runs = []
    for t in range(threads):
        v = [tile[k * threads + t] for k in range(ROWS_PER_THREAD)]
        for i, j in _NETWORK:
            if not v[i] <= v[j]:
                v[i], v[j] = v[j], v[i]
        runs += v
    width = ROWS_PER_THREAD
    while width < len(tile):
        merged = []
        for t in range(threads):
            o = t * ROWS_PER_THREAD
            pair = o // (2 * width) * (2 * width)
            merged += _merge_eight(runs[pair : pair + width], runs[pair + width : pair + 2 * width],
                                   o - pair)
        runs, width = merged, 2 * width
    return runs


def _model_sort(lanes_u32, tile_rows=_MODEL_TILE):
    n = len(lanes_u32[0])
    n_rows, widths, result = pass_schedule(n, tile_rows)
    rows = [tuple(int(lane[i]) for lane in lanes_u32) for i in range(n)]
    rows += [(0xFFFFFFFF,) * len(lanes_u32)] * (n_rows - n)
    buffers = [[], None]
    for start in range(0, n_rows, tile_rows):
        buffers[0] += _model_block_sort(rows[start : start + tile_rows])
    held = 0
    for width in widths:
        src, out = buffers[held], []
        for row in range(0, n_rows, tile_rows):  # one block an output tile
            base = row // (2 * width) * (2 * width)
            run_a = src[base : base + width]
            run_b = src[base + width : base + 2 * width]
            diag = row - base
            a0 = _diagonal_split(run_a, run_b, diag)
            last = diag + tile_rows == len(run_a) + len(run_b)
            a1 = len(run_a) if last else _diagonal_split(run_a, run_b, diag + tile_rows)
            part_a = run_a[a0:a1]
            part_b = run_b[diag - a0 : diag - a0 + tile_rows - len(part_a)]
            assert len(part_a) + len(part_b) == tile_rows
            for t in range(tile_rows // ROWS_PER_THREAD):
                out += _merge_eight(part_a, part_b, t * ROWS_PER_THREAD)
        held = 1 - held
        buffers[held] = out
    assert held == result
    final = buffers[held]
    assert all(r == (0xFFFFFFFF,) * len(lanes_u32) for r in final[n:])
    return [np.array([r[l] for r in final[:n]], dtype=np.uint32) for l in range(len(lanes_u32))]


def test_network_sorts_every_zero_one_input():
    for bits in range(256):
        v = [(bits >> k) & 1 for k in range(8)]
        for i, j in _NETWORK:
            if v[i] > v[j]:
                v[i], v[j] = v[j], v[i]
        assert v == sorted(v)
    assert len(_NETWORK) == 19
    source = (build.CSRC / "lane_sort.cu").read_text()
    in_source = [(int(i), int(j)) for i, j in re.findall(r"GKT_EXCHANGE\((\d), (\d)\)", source)]
    assert in_source == _NETWORK


@pytest.mark.parametrize("diag", [0, 1, 3, 4, 5, 8])
def test_diagonal_split_takes_from_a_on_equal(diag):
    run_a, run_b = [(1,), (2,), (2,), (5,)], [(0,), (2,), (2,), (7,)]
    merged = sorted([(r, 0, i) for i, r in enumerate(run_a)] + [(r, 1, i) for i, r in enumerate(run_b)])
    from_a = sum(1 for _, which, _ in merged[:diag] if which == 0)
    assert _diagonal_split(run_a, run_b, diag) == from_a
    # an empty partner, and a partner that is all smaller
    assert _diagonal_split(run_a, [], min(diag, 4)) == min(diag, 4)
    assert _diagonal_split([(9,)] * 4, run_b, min(diag, 4)) == 0


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 6, 8])
@pytest.mark.parametrize(
    "n", [2, _MODEL_TILE - 1, _MODEL_TILE, _MODEL_TILE + 1, 2 * _MODEL_TILE + 1, 3 * _MODEL_TILE,
          5 * _MODEL_TILE + 17, 8 * _MODEL_TILE]
)
def test_block_sort_then_merges_model_matches_plain_and_lax_sort(n_lanes, n):
    lanes = _tied_lanes(n_lanes, n, seed=1000 * n_lanes + n, all_ones_rows=min(3, n))
    got = _model_sort(lanes)
    for g, w, r in zip(got, _as_u32(sort_lanes(_torch_lanes(lanes))), _lax_sorted(lanes)):
        assert np.array_equal(g, w)
        assert np.array_equal(g, r)


def _shaped_lanes(shape: str, n_lanes: int, n: int):
    lanes = _tied_lanes(n_lanes, n, seed=n_lanes)
    if shape == "constant keys":  # only the last lane differs
        return [np.full(n, 0x80000001, dtype=np.uint32) for _ in lanes[:-1]] + [lanes[-1]]
    order = np.lexsort(tuple(reversed(lanes)))
    if shape == "sorted":
        return [lane[order] for lane in lanes]
    if shape == "reversed":
        return [lane[order[::-1]] for lane in lanes]
    assert shape == "run all smaller"  # the least rows come last: a right run wholly before its left
    half = [lane[order] for lane in lanes]
    return [np.concatenate([lane[_MODEL_TILE:], lane[:_MODEL_TILE]]) for lane in half]


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("shape", ["sorted", "reversed", "constant keys", "run all smaller"])
def test_model_on_the_shapes_a_merge_can_get_wrong(shape, n_lanes):
    lanes = _shaped_lanes(shape, n_lanes, 3 * _MODEL_TILE + 5)
    got = _model_sort(lanes)
    for g, w in zip(got, _as_u32(sort_lanes(_torch_lanes(lanes)))):
        assert np.array_equal(g, w)
