"""The port's 2-bit and 4-bit packs against the JAX package's, on the CPU.

``genome_kmers_tpu_torch.ops.keys.pack_rank2_words`` is the plain version
that the CUDA kernel (``csrc/pack2.cu``) is held against on the card; here
it is held bit for bit against ``genome_kmers_tpu.ops.keys.pack_rank2_words``
('$' and 'N' fields included) and against the Pallas kernel in interpret
mode (bitwise on ACGT-only bytes; with '$' the Pallas kernel's arithmetic
rank leaves garbage fields that every consumer masks, so there the sorted
index must agree). The 4-bit pack ``pack_rank_words`` is plain tensor
code in both packages and is held bit for bit on every IUPAC code. The
tolerance is exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_kmers_tpu.ops.keys import pack_rank2_words as jax_pack_rank2_words
from genome_kmers_tpu.ops.keys import pack_rank_words as jax_pack_rank_words
from genome_kmers_tpu.ops.pallas_kernels import pack_rank2_words_pallas
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.kernels.pack2 import pack_rank2_words_cuda
from genome_kmers_tpu_torch.ops.keys import (
    compute_seg_ends,
    pack_rank2_words,
    pack_rank_words,
    u32_bits_as_int32,
    widen_u32,
)
from genome_kmers_tpu_torch.ops.sort import sort_positions_dense


def _random_bytes(n, symbols, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=n)


def _as_u32(packed: torch.Tensor) -> np.ndarray:
    assert packed.dtype == torch.int32
    return packed.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 65536, 70001])
def test_plain_pack_matches_jax_bitwise(n):
    sba = _random_bytes(n, b"ACGT$N", seed=n)
    got = _as_u32(pack_rank2_words(torch.from_numpy(sba)))
    want = np.asarray(jax_pack_rank2_words(jnp.asarray(sba)))
    assert np.array_equal(got, want)


def test_plain_pack_matches_jax_on_every_byte_value():
    sba = np.arange(256, dtype=np.uint8).repeat(3)
    got = _as_u32(pack_rank2_words(torch.from_numpy(sba)))
    want = np.asarray(jax_pack_rank2_words(jnp.asarray(sba)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 65536, 70001])
def test_pack4_matches_jax_bitwise(n):
    sba = _random_bytes(n, b"$ABCDGHKMNRSTVWY", seed=200 + n)
    got = _as_u32(pack_rank_words(torch.from_numpy(sba)))
    want = np.asarray(jax_pack_rank_words(jnp.asarray(sba)))
    assert np.array_equal(got, want)


def test_pack4_matches_jax_on_every_byte_value_and_y_runs():
    """Runs of 'Y' (rank 15) pack to all-ones words: int32 -1."""
    sba = np.concatenate([np.arange(256, dtype=np.uint8).repeat(3),
                          np.frombuffer(b"Y" * 20, dtype=np.uint8)])
    packed = pack_rank_words(torch.from_numpy(sba))
    assert np.array_equal(_as_u32(packed), np.asarray(jax_pack_rank_words(jnp.asarray(sba))))
    assert int(packed[-20]) == -1 and int(widen_u32(packed)[-20]) == 0xFFFFFFFF


@pytest.mark.parametrize("n", [64, 65536, 70001])
def test_plain_pack_matches_pallas_interpret_on_acgt(n):
    sba = _random_bytes(n, b"ACGT", seed=100 + n)
    got = _as_u32(pack_rank2_words(torch.from_numpy(sba)))
    want = np.asarray(pack_rank2_words_pallas(jnp.asarray(sba), interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mn,mx", [(2, 8), (31, 31), (20, 48)])
def test_pallas_pack_with_separators_sorts_equal(mn, mx):
    """With '$' the raw words differ at separator-covering fields, but the
    dense sort only sees cap-masked fields: positions and lanes agree."""
    rng = np.random.default_rng(9)
    lens = [700, 90, 49, 300]
    text = "$".join("".join(rng.choice(list("ACGT"), size=n)) for n in lens)
    sba = np.frombuffer(text.encode(), dtype=np.uint8).copy()
    starts = np.concatenate([[0], np.cumsum(np.asarray(lens[:-1]) + 1)])
    seg_starts = torch.from_numpy(starts.astype(np.int64))
    seg_ends = compute_seg_ends(seg_starts, len(sba))
    n = sum(length - mn + 1 for length in lens)
    pallas = np.asarray(pack_rank2_words_pallas(jnp.asarray(sba), interpret=True))
    assert not np.array_equal(pallas, _as_u32(pack_rank2_words(torch.from_numpy(sba))))
    pallas_i32 = u32_bits_as_int32(torch.from_numpy(pallas.astype(np.int64)))
    own = sort_positions_dense(
        pack_rank2_words(torch.from_numpy(sba)), seg_starts, seg_ends, n, mn, mx,
        two_bit=True, uniform_cap=mn == mx, return_lanes=True,
    )
    other = sort_positions_dense(pallas_i32, seg_starts, seg_ends, n, mn, mx, two_bit=True,
                                 uniform_cap=mn == mx, return_lanes=True)
    assert torch.equal(own[0], other[0])
    for a, b in zip(own[1]["words"], other[1]["words"]):
        assert torch.equal(a, b)
    assert (own[1]["cap"] is None) == (other[1]["cap"] is None)
    if own[1]["cap"] is not None:
        assert torch.equal(own[1]["cap"], other[1]["cap"])


def test_wrapper_routes_cpu_tensor_to_plain_version_without_launch():
    sba = torch.from_numpy(_random_bytes(4099, b"ACGT$N", seed=3))
    before = pack_rank2_words_cuda.launches
    got = pack_rank2_words_cuda(sba)
    assert pack_rank2_words_cuda.launches == before
    assert got.dtype == torch.int32
    assert torch.equal(got, pack_rank2_words(sba))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        pack_rank2_words_cuda(torch.empty(8, dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("value", [0, 1, 2**31 - 1, 2**31, 2**32 - 1])
def test_u32_bit_pattern_round_trip(value):
    x = torch.tensor([value], dtype=torch.int64)
    bits = u32_bits_as_int32(x)
    assert bits.dtype == torch.int32
    assert int(bits.numpy().view(np.uint32)[0]) == value
    assert int(widen_u32(bits)[0]) == value


def test_library_named_by_source_hash_under_build_dir():
    path = build.library_path("pack2.cu")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "genome_kmers_tpu_torch")
    assert path.name.startswith("libpack2_") and path.suffix == ".so"
    assert (build.CSRC / "pack2.cu").exists()
