"""The reference against brute force on tiny genomes: Python strings,
sorted, grouped and counted one by one."""

import math

import numpy as np
import pytest

from kmerbench import judge
from kmerbench.reference import kmers_ref as ref


def _records(seed, alphabet=b"ACGT", lengths=(300, 41, 180), repeat=b"ACGTTGCAACGTTGCAACGTTGCAACGTTGCAAGG"):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        b = np.frombuffer(alphabet, dtype=np.uint8)[rng.integers(0, len(alphabet), n)].copy()
        for _ in range(3):  # repeats longer than a word, so deep ties
            at = int(rng.integers(0, max(n - len(repeat), 1)))
            b[at:at + len(repeat)] = np.frombuffer(repeat, dtype=np.uint8)[: n - at]
        b[5:12] = ord("T")  # a homopolymer
        out.append((f"r{i}", b))
    return out


def _brute(records, min_len, max_len):
    """(sorted positions, their k-mer strings) by Python string sorting."""
    rows, start = [], 0
    for _, b in records:
        s = b.tobytes().decode()
        for i in range(len(s) - min_len + 1):
            rows.append((s[i:] if max_len is None else s[i:i + max_len], start + i))
        start += len(s) + 1
    rows.sort()
    return np.array([p for _, p in rows], dtype=np.uint32), [k for k, _ in rows]


def _brute_counts(kmers, k, keep=None, max_counts_bin=ref.MAX_COUNTS_BIN):
    groups = {}
    for i, s in enumerate(kmers):
        if keep is None or keep(s):
            groups[s[:k]] = groups.get(s[:k], 0) + 1
    hist = np.zeros(max_counts_bin + 1, dtype=np.int64)
    for size in groups.values():
        hist[min(size, max_counts_bin)] += 1
    return hist, sum(groups.values())


def _gc(lo, hi, k):
    mn, mx = math.ceil(k * lo), math.floor(k * hi)
    return lambda s: mn <= sum(c in "GC" for c in s[:k]) <= mx


def _homopolymer(max_h, k):
    def keep(s):
        run = 1
        for a, b in zip(s[:k], s[1:k]):
            run = run + 1 if a == b else 1
            if run > max_h:
                return False
        return True
    return keep


FILTERS = [
    (["gc_content", 0.3, 0.7, 12], _gc(0.3, 0.7, 12)),
    (["homopolymer", 3, 12], _homopolymer(3, 12)),
    (["no_ambiguous_bases", 12], lambda s: set(s[:12]) <= set("ACGT")),
]


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTN", b"ACGRTN"])
@pytest.mark.parametrize("min_len,max_len", [(12, 12), (31, 31), (1, None), (5, 40)])
def test_order_and_counts_against_brute_force(alphabet, min_len, max_len):
    records = _records(11, alphabet)
    g = ref.Genome(records)
    pos, kmers = _brute(records, min_len, max_len)
    errs, ix = ref.check_index(g, pos, min_len, max_len)
    assert errs == {"rows": len(pos), "outside": 0, "too_short": 0, "duplicates": 0,
                    "missing": 0, "unordered_pairs": 0}
    for k in (1, 7, 12, 25, 31, 45):
        if max_len is not None and k > max_len:
            continue
        hist, total = ref.group_counts(ix, k)
        want_hist, want_total = _brute_counts(kmers, k)
        assert total == want_total and np.array_equal(hist, want_hist), k
    if min_len >= 12:
        for spec, keep in FILTERS:
            hist, total = ref.group_counts(ix, 12, spec)
            want_hist, want_total = _brute_counts(kmers, 12, keep)
            assert total == want_total and np.array_equal(hist, want_hist), spec


@pytest.mark.parametrize("max_len", [31, None])
def test_check_index_finds_each_fault(max_len):
    records = _records(5)
    g = ref.Genome(records)
    pos, kmers = _brute(records, 31 if max_len else 1, max_len)
    min_len = 31 if max_len else 1

    def bad(p):
        errs, _ = ref.check_index(g, p, min_len, max_len)
        return {k: v for k, v in errs.items() if k != "rows" and v}

    i = next(j for j in range(len(kmers) - 1) if kmers[j] != kmers[j + 1])
    swapped = pos.copy()
    swapped[[i, i + 1]] = swapped[[i + 1, i]]
    assert bad(swapped) == {"unordered_pairs": 1}
    tie = next(j for j in range(len(kmers) - 1) if kmers[j] == kmers[j + 1])
    ties = pos.copy()
    ties[[tie, tie + 1]] = ties[[tie + 1, tie]]
    assert bad(ties) == {"unordered_pairs": 1}
    assert bad(pos[: len(pos) // 2]) == {"missing": len(pos) - len(pos) // 2}
    dup = pos.copy()
    dup[3] = dup[2]
    assert set(bad(dup)) >= {"duplicates", "missing"}
    out = pos.copy()
    out[0] = g.n + 3
    assert "outside" in bad(out)
    assert bad(np.sort(pos))  # genome order is not k-mer order


def test_control_fails_where_the_program_passes():
    """The control (fingerprint identity, narrowed to 8 bits so that a tiny
    genome has collisions; 32 bits at the cells' sizes) and the suffix order
    cut at CONTROL_DEPTH bases both fail the comparison the true answers
    pass."""
    records = _records(9, lengths=(900, 700))
    g = ref.Genome(records)
    for min_len, max_len, timed in ((31, 31, True), (31, 31, False), (1, None, True)):
        pos, kmers = _brute(records, min_len, max_len)
        steps = [{"op": "group_counts", "k": 31}, {"op": "count", "k": 31}]
        answers = [(s, _brute_counts(kmers, 31)) for s in steps]
        answers[1] = (steps[1], answers[1][1][1])
        index_step = {"op": "index", "min": min_len, "max": max_len}
        outputs = {"index": (pos, index_step), "answers": answers}
        assert judge.passed(judge.judge(g, outputs))
        control = judge.control_outputs(g, outputs, timed, bits=8)
        assert not judge.passed(judge.judge(g, control)), (min_len, max_len, timed)
