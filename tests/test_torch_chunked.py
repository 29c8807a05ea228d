"""The two-level chunked sort, the port against the JAX package, on the CPU.

The cases of the JAX package's tests/test_chunked.py, on genomes made from
a seed with NumPy: 2-bit keys at k = 8, 31 and 16 (one chunk: the fall
through), an all-'A' genome (every key equal), 4-bit keys on an ACGTN
genome, and many short records (short caps). Each case holds the port's
``sort_positions_chunked`` against the JAX package's ``sort_positions`` of
all the positions at once, the truth of the JAX package's own chunked
tests; a case of three chunks holds it against the JAX package's
``sort_positions_chunked`` itself, whose compiles of every chunk, bucket
and search shape cost seconds a case. Beyond one window the
same error as the JAX package's. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import chunked as jc
from genome_kmers_tpu.ops import keys as jk
from genome_kmers_tpu.ops import sort as js
from genome_kmers_tpu_torch.ops import chunked as tc
from genome_kmers_tpu_torch.ops import keys as tk


def random_seq(n, seed, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(alphabet), size=n))


def _setup(seq_list, min_k, max_k):
    """Per package: (device cache, positions, cap function)."""
    out = []
    for g, keys, as_positions, kw in (
        (gj, jk, jnp.asarray, {}),
        (gt, tk, lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64), {"device": "cpu"}),
    ):
        sc = g.SequenceCollection(sequence_list=seq_list, strands_to_load="forward", **kw)
        km = g.Kmers(sc, min_kmer_len=min_k, max_kmer_len=max_k)
        dc = sc.device_cache("forward")
        out.append((dc, as_positions(km.kmer_sba_start_indices),
                    lambda p, dc=dc, keys=keys: keys.cap_lengths(
                        keys.compute_valid_len(p, dc.seg_starts, dc.seg_ends), max_k)))
    return out


def _port_chunked(t, k, chunk, two_bit):
    dc, pos, cap_fn = t
    got = tc.sort_positions_chunked(dc.packed, pos, cap_fn, k,
                                    packed2=dc.packed2 if two_bit else None, chunk_rows=chunk)
    assert got.dtype == torch.int64
    return got.numpy()


CASES = {
    "2-bit k=8": ([("c", random_seq(5000, 5000))], 8, 8, 512, True),
    "2-bit k=31": ([("c", random_seq(3000, 3000))], 31, 31, 700, True),
    "one chunk": ([("c", random_seq(2048, 2048))], 16, 16, 2048, True),
    "all equal": ([("c", "A" * 4000)], 4, 4, 500, True),
    "4-bit ACGTN": ([("c", random_seq(3000, 9, alphabet="ACGTN"))], 2, 12, 800, False),
    "short records": ([("r%d" % i, random_seq(60 + i, 100 + i)) for i in range(12)], 2, 16, 300, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_direct_sort(case):
    seq_list, min_k, max_k, chunk, two_bit = CASES[case]
    j, t = _setup(seq_list, min_k, max_k)
    dc, pos, cap_fn = j
    want = np.asarray(js.sort_positions(dc.packed, pos, cap_fn(pos), max_k,
                                        packed2=dc.packed2 if two_bit else None))
    assert np.array_equal(_port_chunked(t, max_k, chunk, two_bit), want.astype(np.int64))


def test_matches_jax_chunked():
    """Three chunks, the last one short, against the JAX package's chunked
    sort itself."""
    two_bit = True
    j, t = _setup([("c", random_seq(1400, 77))], 10, 10)
    dc, pos, cap_fn = j
    want = np.asarray(jc.sort_positions_chunked(dc.packed, pos, cap_fn, 10,
                                                packed2=dc.packed2 if two_bit else None,
                                                chunk_rows=512))
    assert np.array_equal(_port_chunked(t, 10, 512, two_bit), want.astype(np.int64))


@pytest.mark.parametrize("two_bit,max_k", [(True, 65), (False, 33), (False, None)])
def test_beyond_one_window_raises_like_jax(two_bit, max_k):
    j, t = _setup([("c", random_seq(600, 5))], 4, max_k)
    outcomes = []
    for dc, pos, cap_fn in (j, t):
        with pytest.raises(NotImplementedError) as err:
            (jc if dc is j[0] else tc).sort_positions_chunked(
                dc.packed, pos, cap_fn, max_k, packed2=dc.packed2 if two_bit else None,
                chunk_rows=256)
        outcomes.append(str(err.value))
    assert outcomes[0] == outcomes[1]
