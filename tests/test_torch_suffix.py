"""Suffix mode and k-mers longer than one compare window: the port's
refinement rounds against the JAX package, on the CPU.

The same seeded genomes (a few thousand bases: exact repeats of 150 bases,
a tiled repeat, an all-'T' record, records as short as ``min_kmer_len``;
the IUPAC genome adds N runs longer than two windows, sparse codes and an
all-'Y' record) go through ``genome_kmers_tpu.ops.sort`` and
``genome_kmers_tpu_torch.ops.sort``, function by function (the key words
at non-zero offsets, ``_sort_round``, ``_sort_round2``,
``_first_round_dense``, ``_first_round_dense2``, ``_double_round2``,
``sort_positions_suffix_dense`` with its run ids, ``sort_positions`` and
``adjacent_boundaries`` beyond a window) and through ``Kmers`` as a whole
(suffix mode, (5, 70) on 2-bit keys, (3, 40) on 4-bit keys; a fresh, a
re-sorted and an assigned index), also against the string oracle. The
multi-lane sorts take the plain ``sort_lanes`` on CPU tensors. Tolerance:
exact equality (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import keys as jkeys
from genome_kmers_tpu.ops import sort as jsort
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.ops import keys as tkeys
from genome_kmers_tpu_torch.ops import sort as tsort
from oracle import expected_groups, expected_hist, expected_kmers

U32_MAX = 0xFFFFFFFF


def _records(kind: str, min_len: int = 1):
    """Seeded records, every one at least ``min_len`` long."""
    rng = np.random.default_rng(101 if kind == "acgt" else 103)

    def rand(n, alphabet="ACGT", p=None):
        return "".join(rng.choice(list(alphabet), size=n, p=p))

    unit = rand(150)
    tile = rand(11)
    if kind == "acgt":
        records = [rand(300) + unit + rand(40) + unit, unit[:120] + rand(30), "T" * 90,
                   tile * 18, rand(70)]
    else:
        probs = [0.23] * 4 + [0.02] * 4
        records = [rand(250, "ACGTNRYK", probs) + unit + "N" * 80 + unit[:100],
                   "ACGT" + "N" * 75 + "ACGTT" + "N" * 90, "Y" * 45, tile * 12,
                   rand(60, "ACGTN")]
    records += [rand(min_len), rand(min_len + 3)]
    return [(f"r{i}", seq) for i, seq in enumerate(records)]


def _sba(seq_list):
    text = "$".join(seq for _, seq in seq_list)
    starts = np.concatenate([[0], np.cumsum([len(seq) + 1 for _, seq in seq_list[:-1]])])
    return np.frombuffer(text.encode(), dtype=np.uint8).copy(), starts.astype(np.uint32)


class _Genome:
    """One genome on both sides: packs, segment tables and the canonical
    k-mer starts for ``min_len``."""

    def __init__(self, kind: str, min_len: int = 1):
        self.kind, self.min_len = kind, min_len
        self.seq_list = _records(kind, min_len)
        self.sba, self.seg_starts = _sba(self.seq_list)
        self.j_starts = jnp.asarray(self.seg_starts)
        self.j_ends = jkeys.compute_seg_ends(self.j_starts, len(self.sba))
        self.t_starts = torch.from_numpy(self.seg_starts.astype(np.int64))
        self.t_ends = tkeys.compute_seg_ends(self.t_starts, len(self.sba))
        self.j_packed = jkeys.pack_rank_words(jnp.asarray(self.sba))
        self.t_packed = tkeys.pack_rank_words(torch.from_numpy(self.sba))
        if kind == "acgt":
            self.j_packed2 = jkeys.pack_rank2_words(jnp.asarray(self.sba))
            self.t_packed2 = tkeys.pack_rank2_words(torch.from_numpy(self.sba))
        else:
            self.j_packed2 = self.t_packed2 = None
        ends = self.t_ends.numpy()
        self.starts = np.concatenate([
            np.arange(s, e - min_len + 2, dtype=np.int64) for s, e in zip(self.seg_starts, ends)
        ])

    def caps(self, positions: np.ndarray, max_k):
        """(JAX uint32 cap, torch int64 cap) for the given positions."""
        seg = np.searchsorted(self.seg_starts, positions, side="right") - 1
        vl = self.t_ends.numpy()[seg] - positions + 1
        cap = vl if max_k is None else np.minimum(vl, max_k)
        return jnp.asarray(cap.astype(np.uint32)), torch.from_numpy(cap.astype(np.int64))


_GENOMES = {}


def _genome(kind, min_len=1) -> _Genome:
    if (kind, min_len) not in _GENOMES:
        _GENOMES[kind, min_len] = _Genome(kind, min_len)
    return _GENOMES[kind, min_len]


def _j(x: torch.Tensor):
    return jnp.asarray(x.numpy().astype(np.uint32))


def _same(t: torch.Tensor, j) -> bool:
    """A port tensor (int64 values or int32 bit patterns) equals a JAX
    uint32 array."""
    values = t.numpy()
    values = values.view(np.uint32) if t.dtype == torch.int32 else values.astype(np.uint32)
    if t.dtype == torch.int64:
        assert values.size == 0 or (t.numpy().min() >= 0 and t.numpy().max() <= U32_MAX)
    return np.array_equal(values, np.asarray(j))


def _jmax(max_k):
    return jnp.uint32(U32_MAX if max_k is None else max_k)


# --------------------------------------------------------------------------- #
# key words at non-zero offsets
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("offset", [0, 8, 28, 32, 60, 64, 96, 160])
@pytest.mark.parametrize("max_k", [None, 70])
@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_key_words_at_offsets_match_jax(kind, max_k, offset):
    g = _genome(kind)
    rng = np.random.default_rng(offset)
    positions = rng.permutation(g.starts)[: len(g.starts) // 2]
    j_cap, t_cap = g.caps(positions, max_k)
    j_pos, t_pos = jnp.asarray(positions.astype(np.uint32)), torch.from_numpy(positions)
    want = jkeys.build_key_words(g.j_packed, j_pos, j_cap, 4, jnp.uint32(offset))
    got = tkeys.build_key_words(g.t_packed, t_pos, t_cap, 4, offset)
    assert all(_same(a, b) for a, b in zip(got, want)) and len(got) == len(want) == 4
    if kind == "acgt":
        want = jkeys.build_key2_words(g.j_packed2, j_pos, j_cap, 2, jnp.uint32(offset))
        got = tkeys.build_key2_words(g.t_packed2, t_pos, t_cap, 2, offset)
        assert all(_same(a, b) for a, b in zip(got, want)) and len(got) == len(want) == 2


# --------------------------------------------------------------------------- #
# the window rounds
# --------------------------------------------------------------------------- #


def _input_positions(g: _Genome, order: str) -> np.ndarray:
    if order == "ascending":
        return g.starts
    if order == "descending":
        return g.starts[::-1].copy()
    return np.random.default_rng(5).permutation(g.starts)[: len(g.starts) // 2]


@pytest.mark.parametrize("order", ["ascending", "descending", "shuffled subset"])
@pytest.mark.parametrize("kind,max_k", [("acgt", None), ("acgt", 100), ("iupac", None), ("iupac", 48)])
def test_sort_rounds_match_jax_round_by_round(kind, max_k, order):
    """``_sort_round`` (4-bit) and, on the ACGT genome, ``_sort_round2``
    driven to convergence on both sides; every round's positions, caps, run
    ids and resolve flag are equal."""
    g = _genome(kind)
    positions = _input_positions(g, order)
    j_cap, t_cap = g.caps(positions, max_k)
    j_pos, t_pos = jnp.asarray(positions.astype(np.uint32)), torch.from_numpy(positions)
    zeros = jnp.zeros(len(positions), dtype=jnp.uint32)
    rounds = [(lambda *a: jsort._sort_round(g.j_packed, *a[:4], 4, a[4]),
               lambda *a: tsort._sort_round(g.t_packed, *a[:4], 4, a[4]))]
    if kind == "acgt":
        rounds.append((lambda *a: jsort._sort_round2(g.j_packed2, *a),
                       lambda *a: tsort._sort_round2(g.t_packed2, *a)))
    for j_round, t_round in rounds:
        j_state = j_round(j_pos, j_cap, zeros, jnp.uint32(0), True)
        t_state = t_round(t_pos, t_cap, None, 0, True)
        offset, n_rounds = 32, 1
        while True:
            assert all(_same(t, j) for t, j in zip(t_state[:3], j_state[:3])), (offset, n_rounds)
            assert t_state[3].dtype == torch.bool and bool(t_state[3]) == bool(j_state[3])
            if not bool(j_state[3]):
                break
            j_state = j_round(*j_state[:3], jnp.uint32(offset), False)
            t_state = t_round(*t_state[:3], offset, False)
            offset += 32
            n_rounds += 1
        # the 150-base repeats need several windows unless the cap ends them
        assert n_rounds >= (4 if max_k is None or max_k >= 100 else 2)


@pytest.mark.parametrize("order", ["ascending", "descending", "shuffled subset"])
@pytest.mark.parametrize(
    "kind,max_k", [("acgt", None), ("acgt", 65), ("acgt", 100), ("iupac", None), ("iupac", 33),
                   ("iupac", 48), ("iupac", 200)],
)
def test_sort_positions_beyond_a_window_matches_jax(kind, max_k, order):
    g = _genome(kind)
    positions = _input_positions(g, order)
    j_cap, t_cap = g.caps(positions, max_k)
    want, j_lanes = jsort.sort_positions(
        g.j_packed, jnp.asarray(positions.astype(np.uint32)), j_cap, max_k,
        packed2=g.j_packed2, return_lanes=True,
    )
    got, t_lanes = tsort.sort_positions(
        g.t_packed, torch.from_numpy(positions), t_cap, max_k, packed2=g.t_packed2,
        return_lanes=True,
    )
    assert got.dtype == torch.int64 and _same(got, want)
    assert t_lanes is None and j_lanes is None
    # the order is the string order of the capped suffixes, ties by position
    text = g.sba.tobytes().decode()
    suffix = {int(p): text[p : p + int(c)] for p, c in zip(positions, t_cap.numpy())}
    assert got.tolist() == sorted(suffix, key=lambda p: (suffix[p], p))


@pytest.mark.parametrize("kmer_len", [None, 33, 65, 100, 149, 150, 151, 400])
@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_adjacent_boundaries_beyond_a_window_match_jax(kind, kmer_len):
    """The unbounded branch compares on the 4-bit pack whatever the genome."""
    g = _genome(kind)
    j_cap, t_cap = g.caps(g.starts, None)
    sorted_pos = tsort.sort_positions(
        g.t_packed, torch.from_numpy(g.starts), t_cap, None, packed2=g.t_packed2
    )
    j_cap, t_cap = g.caps(sorted_pos.numpy(), kmer_len)
    want = jsort.adjacent_boundaries(g.j_packed, _j(sorted_pos), j_cap, kmer_len)
    got = tsort.adjacent_boundaries(g.t_packed, sorted_pos, t_cap, kmer_len)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(want))
    text = g.sba.tobytes().decode()
    strings = [text[p : p + int(c)] for p, c in zip(sorted_pos.tolist(), t_cap.numpy())]
    assert got.tolist() == [True] + [a != b for a, b in zip(strings[1:], strings[:-1])]


def test_adj_eq_round_matches_jax():
    g = _genome("acgt")
    j_cap, t_cap = g.caps(g.starts, None)
    sorted_pos = tsort.sort_positions(g.t_packed, torch.from_numpy(g.starts), t_cap, None)
    j_cap, t_cap = g.caps(sorted_pos.numpy(), None)
    j_eq, t_eq = jnp.ones(len(g.starts), dtype=bool), torch.ones(len(g.starts), dtype=torch.bool)
    for offset in (0, 32, 64, 96):
        j_eq, j_unr = jsort._adj_eq_round(g.j_packed, _j(sorted_pos), j_cap, j_eq, jnp.uint32(offset), 4)
        t_eq, t_unr = tsort._adj_eq_round(g.t_packed, sorted_pos, t_cap, t_eq, offset, 4)
        assert np.array_equal(t_eq.numpy(), np.asarray(j_eq)) and bool(t_unr) == bool(j_unr)
    assert bool(j_unr)  # the 150-base repeats are still tied after 128 bases


# --------------------------------------------------------------------------- #
# the dense first rounds and prefix doubling
# --------------------------------------------------------------------------- #

DENSE_CONFIGS = [(1, None), (1, 70), (5, None), (5, 70), (20, None), (33, 100)]


@pytest.mark.parametrize("mn,mx", DENSE_CONFIGS)
@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_first_round_dense_matches_jax(kind, mn, mx):
    g = _genome(kind, mn)
    want = jsort._first_round_dense(g.j_packed, g.j_starts, g.j_ends, jnp.uint32(mn), _jmax(mx), 4)
    got = tsort._first_round_dense(g.t_packed, g.t_starts, g.t_ends, mn, mx, 4)
    assert all(_same(t, j) for t, j in zip(got[:3], want[:3]))
    assert bool(got[3]) == bool(want[3]) is True
    # invalid rows (separators, short tails) sort last with cap 0
    n = len(g.starts)
    assert np.array_equal(np.sort(got[0][:n].numpy()), g.starts) and not got[1][n:].any()


@pytest.mark.parametrize("mn,mx", DENSE_CONFIGS)
def test_first_round_dense2_matches_jax(mn, mx):
    g = _genome("acgt", mn)
    want = jsort._first_round_dense2(g.j_packed2, g.j_starts, g.j_ends, jnp.uint32(mn), _jmax(mx))
    got = tsort._first_round_dense2(g.t_packed2, g.t_starts, g.t_ends, mn, mx)
    assert all(_same(t, j) for t, j in zip(got[:2], want[:2]))
    assert bool(got[2]) == bool(want[2]) is True
    n = len(g.starts)
    assert np.array_equal(np.sort(got[0][:n].numpy()), g.starts)


def test_first_round_dense2_keeps_all_t_rows_ahead_of_the_invalid_fold():
    """28 'T's are all-ones in word 0 and in word 1 down to its low byte,
    which holds the window length 28, not 0xFF: the row stays real."""
    seq_list = [("t", "T" * 60), ("u", "T" * 28), ("a", "ACGT")]
    sba, seg_starts = _sba(seq_list)
    starts = torch.from_numpy(seg_starts.astype(np.int64))
    ends = tkeys.compute_seg_ends(starts, len(sba))
    packed2 = tkeys.pack_rank2_words(torch.from_numpy(sba))
    pos, gid, unresolved = tsort._first_round_dense2(packed2, starts, ends, 1, None)
    assert pos[-2:].tolist() == [60, 89]  # the two separators, last
    text = sba.tobytes().decode()
    keys = [(text[p : p + 28].split("$")[0], p) for p in pos[:-2].tolist()]
    assert keys == sorted(keys) and bool(unresolved)
    # rows whose first 28 bases are 'T' share the last real run
    assert (gid[:-2] == gid[-3]).sum() == 34 and gid[-1] == gid[-2] == gid[-3] + 1


@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_double_round2_matches_jax_round_by_round(kind):
    g = _genome(kind)
    if kind == "acgt":
        j_pos, j_gid, j_unr = jsort._first_round_dense2(
            g.j_packed2, g.j_starts, g.j_ends, jnp.uint32(1), _jmax(None))
        t_pos, t_gid, t_unr = tsort._first_round_dense2(g.t_packed2, g.t_starts, g.t_ends, 1, None)
        j_cap, t_cap = g.caps(t_pos.numpy(), None)
        h = 28
    else:
        j_pos, j_cap, j_gid, j_unr = jsort._first_round_dense(
            g.j_packed, g.j_starts, g.j_ends, jnp.uint32(1), _jmax(None), 4)
        t_pos, t_cap, t_gid, t_unr = tsort._first_round_dense(g.t_packed, g.t_starts, g.t_ends, 1, None, 4)
        h = 32
    n_rounds = 0
    while bool(j_unr):
        j_pos, j_gid, j_cap, j_unr = jsort._double_round2(j_pos, j_gid, j_cap, jnp.uint32(h))
        t_pos, t_gid, t_cap, t_unr = tsort._double_round2(t_pos, t_gid, t_cap, h)
        assert _same(t_pos, j_pos) and _same(t_gid, j_gid) and _same(t_cap, j_cap), h
        assert bool(t_unr) == bool(j_unr)
        h += h
        n_rounds += 1
    # 28 bases -> past the 150-base repeats; 32 -> past the IUPAC genome's 100
    assert n_rounds == (3 if kind == "acgt" else 2)


@pytest.mark.parametrize("host_loops", [False, True], ids=["fused JAX loop", "host JAX loop"])
@pytest.mark.parametrize("mn,mx", DENSE_CONFIGS + [(1, 33), (3, 40), (70, None)])
@pytest.mark.parametrize("kind", ["acgt", "iupac"])
def test_sort_positions_suffix_dense_matches_jax(kind, mn, mx, host_loops, monkeypatch):
    if host_loops:
        monkeypatch.setenv("GKT_HOST_LOOPS", "1")
    g = _genome(kind, mn)
    n = len(g.starts)
    want_pos, want_gid = jsort.sort_positions_suffix_dense(
        g.j_packed if g.j_packed2 is None else None, g.j_starts, g.j_ends, n, mn, mx,
        packed2=g.j_packed2, return_gid=True,
    )
    got_pos, got_gid = tsort.sort_positions_suffix_dense(
        g.t_packed if g.t_packed2 is None else None, g.t_starts, g.t_ends, n, mn, mx,
        packed2=g.t_packed2, return_gid=True,
    )
    assert got_pos.shape[0] == n and _same(got_pos, want_pos) and _same(got_gid, want_gid)
    alone = tsort.sort_positions_suffix_dense(
        g.t_packed if g.t_packed2 is None else None, g.t_starts, g.t_ends, n, mn, mx,
        packed2=g.t_packed2,
    )
    assert torch.equal(alone, got_pos)
    # equal to the gather sort over the canonical start set
    _, t_cap = g.caps(g.starts, mx)
    gathered = tsort.sort_positions(
        g.t_packed, torch.from_numpy(g.starts), t_cap, mx, packed2=g.t_packed2)
    assert torch.equal(got_pos, gathered)


# --------------------------------------------------------------------------- #
# Kmers as a whole
# --------------------------------------------------------------------------- #

KMERS_CONFIGS = [("acgt", 1, None), ("acgt", 5, 70), ("acgt", 20, None), ("acgt", 64, 65),
                 ("iupac", 1, None), ("iupac", 3, 40), ("iupac", 5, None), ("iupac", 33, 33)]


def _pair(kind, mn, mx):
    seq_list = _records(kind, mn)
    jkm = gj.Kmers(gj.SequenceCollection(sequence_list=seq_list), mn, mx)
    tkm = gt.Kmers(gt.SequenceCollection(sequence_list=seq_list, device="cpu"), mn, mx)
    return seq_list, jkm, tkm


def _stat_lens(mn, mx):
    return [None, 1, mn, 31, 32, 33, 64, 65, 100, 151] + ([] if mx is None else [mx, mx + 1])


def _same_statistics(tkm, jkm, kmer_lens, sorted_kmers=None, mx=None):
    for kmer_len in kmer_lens:
        got = tkm.get_kmer_group_counts(kmer_len, max_counts_bin=40)
        want = jkm.get_kmer_group_counts(kmer_len, max_counts_bin=40)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1], kmer_len
        if sorted_kmers is not None and (kmer_len is None) == (mx is None) and (
            mx is None or kmer_len <= mx
        ):  # above max_kmer_len the index compares on, the oracle's strings end
            o_counts, o_total = expected_hist(sorted_kmers, kmer_len, max_counts_bin=40)
            assert np.array_equal(got[0], o_counts) and got[1] == o_total, kmer_len
        for bounds in ({}, {"min_group_size": 2}, {"min_group_size": 2, "max_group_size": 3}):
            assert tkm.get_kmer_count(kmer_len, **bounds) == jkm.get_kmer_count(kmer_len, **bounds)


@pytest.mark.parametrize("kind,mn,mx", KMERS_CONFIGS)
def test_kmers_fresh_sort_and_statistics_match_jax_and_oracle(kind, mn, mx):
    seq_list, jkm, tkm = _pair(kind, mn, mx)
    jkm.sort()
    tkm.sort()
    _, _, sorted_kmers, sorted_indices = expected_kmers(seq_list, mn, mx)
    got = tkm.kmer_sba_start_indices
    assert got.dtype == np.uint32 and list(got) == sorted_indices
    assert np.array_equal(got, jkm.kmer_sba_start_indices)
    # no single-window lanes; the converged run ids are kept instead
    assert tkm._lanes_cache is None and tkm._ensure_lanes() is None
    assert all(tkm._stats_route(k, gt.kmer_filter_keep_all)[0] == "boundary"
               for k in (1, mn, 31, 100))
    assert _same(tkm._suffix_gid_cache[0], jkm._suffix_gid_cache[0])
    assert tkm._suffix_gid_cache[1] == jkm._suffix_gid_cache[1] == mx
    _same_statistics(tkm, jkm, _stat_lens(mn, mx), sorted_kmers, mx)
    nums = list(range(len(tkm)))
    assert tkm.get_kmer_strs(nums, None) == jkm.get_kmer_strs(nums, None) == sorted_kmers
    assert [tkm.get_kmer_str(i) for i in nums[::7]] == sorted_kmers[::7]


@pytest.mark.parametrize("kind,mn,mx", KMERS_CONFIGS)
def test_kmers_yielding_calls_beyond_a_window_match_jax_and_oracle(kind, mn, mx):
    seq_list, jkm, tkm = _pair(kind, mn, mx)
    jkm.sort()
    tkm.sort()
    sorted_kmers = expected_kmers(seq_list, mn, mx)[2]
    for kmer_len in (None, mx, 40, 100):
        for bounds in ({}, {"min_group_size": 2, "yield_first_n": 1}, {"max_group_size": 2}):
            arrays = tkm.get_kmers_arrays(kmer_len, **bounds)
            for a, w in zip(arrays, jkm.get_kmers_arrays(kmer_len, **bounds)):
                assert a.dtype == w.dtype and np.array_equal(a, w)
            got = [(int(n), int(y), int(t)) for n, _, y, t in zip(*arrays)]
            assert list(tkm.get_kmers(kmer_len, **bounds)) == got
            if kmer_len == mx:  # elsewhere the oracle's strings end at max_kmer_len
                assert got == expected_groups(sorted_kmers, kmer_len, **bounds)
    full = list(tkm.get_kmers(None, one_based_seq_index=True, kmer_info_to_yield="full"))
    assert full == list(jkm.get_kmers(None, one_based_seq_index=True, kmer_info_to_yield="full"))
    if mx is None:  # kmer_len None reads to the end of the record
        assert [row[4] for row in full] == [len(s) for s in sorted_kmers]


@pytest.mark.parametrize("order", ["re-sort", "descending", "shuffled subset"])
@pytest.mark.parametrize("kind,mn,mx", KMERS_CONFIGS)
def test_kmers_resort_and_assigned_index_match_jax(kind, mn, mx, order):
    """Not the fresh index: the refinement branch of ``sort_positions``;
    neither side keeps lanes or run ids, so the statistics compare window
    by window."""
    seq_list, jkm, tkm = _pair(kind, mn, mx)
    if order == "re-sort":
        jkm.sort()
        tkm.sort()
        fresh = tkm.kmer_sba_start_indices.copy()
    else:
        fresh = None
        assigned = tkm.kmer_sba_start_indices[::-1].copy()
        if order == "shuffled subset":
            assigned = np.random.default_rng(3).permutation(assigned)[: len(assigned) // 2]
        jkm.kmer_sba_start_indices = assigned.copy()
        tkm.kmer_sba_start_indices = assigned.copy()
        assert tkm.get_kmer_count(None) == jkm.get_kmer_count(None) == len(assigned)
    jkm.sort()
    tkm.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    assert fresh is None or np.array_equal(tkm.kmer_sba_start_indices, fresh)
    assert tkm._lanes_cache is None and tkm._suffix_gid_cache is None
    assert jkm._suffix_gid_cache is None
    _same_statistics(tkm, jkm, [None, mn, 33, 100] + ([] if mx is None else [mx]))


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "descending input"])
@pytest.mark.parametrize("kind,mn,mx", KMERS_CONFIGS)
def test_sort_reports_each_round_and_exposes_the_run_ids(kind, mn, mx, fresh):
    """``on_round`` hears the rounds' names in order and changes nothing;
    ``suffix_run_ids`` is the fresh sort's converged ids, None after a
    gather sort."""
    _, jkm, tkm = _pair(kind, mn, mx)
    if not fresh:
        tkm.kmer_sba_start_indices = tkm.kmer_sba_start_indices[::-1].copy()
    names = []
    tkm.sort(on_round=names.append)
    jkm.sort()
    assert np.array_equal(tkm.kmer_sba_start_indices, jkm.kmer_sba_start_indices)
    window = "_sort_round2" if kind == "acgt" else "_sort_round"
    if fresh:
        later = "_double_round2" if (mn, mx) == (1, None) else window
        first = "_first_round_dense2" if kind == "acgt" else "_first_round_dense"
        assert names[0] == first and set(names[1:]) <= {later}
        assert _same(tkm.suffix_run_ids, jkm._suffix_gid_cache[0])
    else:
        assert names and set(names) == {window}
        assert tkm.suffix_run_ids is None
    if mx is not None:  # one round a window of the compare length, at most
        assert len(names) <= -(-mx // 28)


def test_a_sort_within_one_window_reports_no_round():
    _, _, tkm = _pair("acgt", 5, 31)
    names = []
    tkm.sort(on_round=names.append)
    tkm.sort(on_round=names.append)  # the gather sort
    assert names == [] and tkm.suffix_run_ids is None


def test_assignment_and_sort_reset_the_run_ids():
    _, jkm, tkm = _pair("acgt", 1, None)
    tkm.sort()
    assert tkm._suffix_gid_cache is not None
    sorted_pos = tkm.kmer_sba_start_indices.copy()
    tkm.kmer_sba_start_indices = sorted_pos
    assert tkm._suffix_gid_cache is None and not tkm._is_sorted is None
    tkm.sort()
    assert tkm._suffix_gid_cache is None  # a gather sort keeps none
    assert np.array_equal(tkm.kmer_sba_start_indices, sorted_pos)


@pytest.mark.parametrize("kind,mn,mx", [("acgt", 1, None), ("acgt", 5, 70), ("iupac", 3, 40)])
@pytest.mark.parametrize("with_gid", [True, False], ids=["with run ids", "positions alone"])
def test_interop_carries_a_suffix_sorted_index(kind, mn, mx, with_gid):
    seq_list, jkm, _ = _pair(kind, mn, mx)
    jkm.sort()
    sc = jkm.seq_coll
    state = (sc.forward_sba, sc._forward_sba_seg_starts, sc.forward_record_names, mn, mx)
    gid = np.asarray(jkm._suffix_gid_cache[0]) if with_gid else None
    _, tkm = from_numpy_state(*state, positions=jkm.kmer_sba_start_indices, suffix_gid=gid,
                              two_bit=kind == "acgt", device="cpu")
    assert tkm._is_sorted and tkm._lanes_cache is None
    assert (tkm._suffix_gid_cache is not None) == with_gid
    _same_statistics(tkm, jkm, [None, mn, 33, 100] + ([] if mx is None else [mx]))
    with pytest.raises(ValueError, match="keeps no key lanes"):
        from_numpy_state(*state, positions=jkm.kmer_sba_start_indices,
                         words=[jkm.kmer_sba_start_indices], two_bit=kind == "acgt", device="cpu")
