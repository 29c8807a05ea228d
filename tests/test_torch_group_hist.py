"""The group-size histogram: its plain version against a NumPy oracle on
the CPU, and the CUDA kernel (``csrc/group_hist.cu``) bit for bit against
the plain version on a card (tests marked ``card``; they skip without one).

The cases are the inputs that break a naive kernel: every qualifying size
1 (one hot bin), ``max_counts_bin=1`` (everything in the top bin), a hot top
bin that lies in the kernel's shared histogram, sizes above the kernel's
shared span and above ``max_counts_bin``, no qualifying row, no row, a
length that is no multiple of the vector width, slices at odd storage
offsets (together and apart), and a k = 15-like distribution whose bins 2
and 3 are hot. No JAX here: the oracle is ``np.bincount``.
"""

import numpy as np
import pytest
import torch

from genome_kmers_tpu_torch.kernels.group_hist import group_size_hist, group_size_hist_cuda
from genome_kmers_tpu_torch.ops.groups import clipped_counts, hist_from_sizes

SHARED_SPAN = 4096  # kSharedBins of the source


def _case(name: str):
    """(sizes int64, qualifies bool, max_counts_bin) as NumPy arrays; the
    offset cases also give the storage offsets of the two slices."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "all_size1":
        n = 70001
        return np.ones(n, np.int64), np.ones(n, bool), 1000000, (0, 0)
    if name == "top_bin_only":
        n = 50000
        return rng.integers(1, 50, n), rng.random(n) < 0.9, 1, (0, 0)
    if name == "hot_top_bin_shared":
        n = 40000
        return rng.integers(35, 400, n), rng.random(n) < 0.95, 35, (0, 0)
    if name == "above_span_and_top":
        n = 60000
        size = rng.integers(1, 4, n)
        big = rng.random(n) < 0.02
        size[big] = rng.integers(SHARED_SPAN - 2, 3 * SHARED_SPAN, big.sum())
        size[7] = 18475410  # an N group
        return size, rng.random(n) < 0.8, 2 * SHARED_SPAN, (0, 0)
    if name == "above_span_default_bins":
        n = 30000
        size = rng.integers(SHARED_SPAN - 5, SHARED_SPAN + 5, n)
        size[::3] = 1
        return size, np.ones(n, bool), 1000000, (0, 0)
    if name == "none_qualify":
        n = 9999
        return rng.integers(1, 9, n), np.zeros(n, bool), 35, (0, 0)
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0, bool), 35, (0, 0)
    if name == "ragged_length":
        n = 4099
        return rng.integers(0, 12, n), rng.random(n) < 0.5, 10, (0, 0)
    if name == "odd_offset":
        n = 12347
        return rng.integers(1, 40, n), rng.random(n) < 0.7, 35, (3, 3)
    if name == "offsets_apart":
        n = 12346
        return rng.integers(1, 40, n), rng.random(n) < 0.7, 35, (1, 0)
    if name == "mask_odd":
        n = 12345
        return rng.integers(1, 40, n), rng.random(n) < 0.7, 35, (2, 1)
    if name == "k15_like":
        n = 300001
        size = np.minimum(rng.geometric(0.45, n) + 1, 10000)  # bins 2 and 3 hot
        size[rng.random(n) < 0.3] = 1
        return size, rng.random(n) < 0.6, 35, (0, 0)
    raise KeyError(name)


CASES = ["all_size1", "top_bin_only", "hot_top_bin_shared", "above_span_and_top",
         "above_span_default_bins", "none_qualify", "empty", "ragged_length", "odd_offset",
         "offsets_apart", "mask_odd", "k15_like"]


def _tensors(name: str, device):
    """The case as tensors on ``device``, sliced at its storage offsets."""
    size, q, mcb, (off_s, off_q) = _case(name)
    n = size.shape[0]
    big_s = torch.zeros(n + off_s, dtype=torch.int64, device=device)
    big_q = torch.zeros(n + off_q, dtype=torch.bool, device=device)
    big_s[off_s:] = torch.from_numpy(size.astype(np.int64))
    big_q[off_q:] = torch.from_numpy(q)
    ts, tq = big_s[off_s:], big_q[off_q:]
    assert ts.storage_offset() == off_s and tq.storage_offset() == off_q
    return ts, tq, mcb


def _oracle(name: str) -> np.ndarray:
    size, q, mcb, _ = _case(name)
    return np.bincount(np.minimum(size[q], mcb), minlength=mcb + 1).astype(np.int64)


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_numpy(name):
    size, q, mcb = _tensors(name, "cpu")
    got = group_size_hist(size, q, mcb)
    want = _oracle(name)
    assert got.dtype == torch.int64 and got.shape == (mcb + 1,)
    assert np.array_equal(got.numpy(), want)
    # the routes of ops/groups take the plain version on the CPU
    assert torch.equal(hist_from_sizes(size, q, mcb), got)
    assert torch.equal(clipped_counts(q, torch.clamp_max(size, mcb), mcb), got)
    assert torch.equal(clipped_counts(q, size, mcb), got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_kernel_bit_equal_to_plain_on_card(name, cuda_device):
    size, q, mcb = _tensors(name, cuda_device)
    before = group_size_hist_cuda.launches
    got = group_size_hist_cuda(size, q, mcb)
    torch.cuda.synchronize()
    want = group_size_hist(size, q, mcb)
    assert got.dtype == torch.int64 and got.device == size.device
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), _oracle(name))
    assert group_size_hist_cuda.launches == before + (size.shape[0] > 0)


def test_dispatch_plain_on_cpu_and_raises_elsewhere():
    size, q, mcb = _tensors("k15_like", "cpu")
    before = group_size_hist_cuda.launches
    assert torch.equal(group_size_hist_cuda(size, q, mcb), group_size_hist(size, q, mcb))
    assert group_size_hist_cuda.launches == before
    assert group_size_hist_cuda.passes == 1
    meta_s = torch.zeros(8, dtype=torch.int64, device="meta")
    meta_q = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        group_size_hist_cuda(meta_s, meta_q, mcb)
    with pytest.raises(ValueError, match="unsupported devices"):
        group_size_hist_cuda(size, meta_q[:0], mcb)
    assert group_size_hist_cuda.launches == before
