"""Plain reference of the k-mer index and its group statistics, in PyTorch
tensor operations on the CPU (its threads make the check of a
chromosome-sized index take seconds, not minutes).

It works everything out again from the generated records: the SBA (records
joined by '$'), each k-mer's bases, the filters, the groups and the
histograms. It imports nothing of the program, of the JAX package or of
JAX, and calls none of their functions.

Semantics held (those of genome-kmers): a k-mer at SBA position p is the
first ``min(valid_len(p), max_kmer_len)`` bases from p, where
``valid_len`` counts the bases to its record's end (None: to the end).
The index lists every position with ``valid_len >= min_kmer_len`` once,
in lexicographic order of the k-mers (byte order, a shorter string before
its extensions), equal k-mers by ascending position. A group at
``kmer_len`` is a run of rows whose first ``kmer_len`` bases are equal;
the histogram counts groups by size (under a filter: by survivor count,
groups without survivors left out), sizes above ``MAX_COUNTS_BIN`` (the
library's default) in the top bin, and the total counts the k-mers of
the counted groups.

How the order is checked: the index is the unique order of (k-mer,
position), so a permutation of the expected positions in which every
adjacent pair is in order is that order. ``check_index`` verifies exactly
that, comparing bases a word of ``B`` at a time and going deeper only for
the pairs still tied. The groups are then the runs of equal prefixes in the
verified order: the statistics are worked out over it, never over an order
the check refused.
"""

from __future__ import annotations

import numpy as np
import torch

DOLLAR = ord("$")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
I64 = torch.int64
MAX_COUNTS_BIN = 1000000  # get_kmer_group_counts' default top bin, as genome-kmers has it


def _i64(x: int) -> int:
    """The int64 of the same 64 bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_HASH_A = _i64(0x9E3779B97F4A7C15)
_HASH_B = _i64(0xC2B2AE3D27D4EB4F)


class Genome:
    """The reference's view of a list of (name, uint8 bases) records."""

    def __init__(self, records):
        self.names = [name for name, _ in records]
        lengths = np.array([len(b) for _, b in records], dtype=np.int64)
        self.lengths = lengths
        self.starts = np.concatenate([[0], np.cumsum(lengths[:-1] + 1)]).astype(np.int64)
        n = int(lengths.sum()) + len(records) - 1
        sba = np.empty(n, dtype=np.uint8)
        vl = np.zeros(n, dtype=np.int32)
        for s, (_, bases), length in zip(self.starts, records, lengths):
            sba[s:s + length] = bases
            vl[s:s + length] = np.arange(length, 0, -1, dtype=np.int32)
        sba[self.starts[1:] - 1] = DOLLAR
        self.sba, self.n = sba, n
        self.sba_t, self.vl = torch.from_numpy(sba), torch.from_numpy(vl)
        present = np.flatnonzero(np.bincount(sba, minlength=256))
        symbols = [int(b) for b in present if b != DOLLAR]
        # codes keep byte order; 0 is the terminator and whatever lies past it
        codes = np.zeros(256, dtype=np.int64)
        codes[symbols] = np.arange(1, len(symbols) + 1)
        self.codes_table = torch.from_numpy(codes)
        self.acgt_only = set(symbols) <= set(ACGT.tolist())
        self.bits = max(1, len(symbols).bit_length())
        self.B = 63 // self.bits  # a word's bases fill at most 63 bits: signed compares hold
        self.masks = torch.tensor(
            [((1 << (self.bits * r)) - 1) << (self.bits * (self.B - r)) for r in range(self.B + 1)],
            dtype=I64,
        )
        self._windows = None

    def kmer_count(self, min_len: int) -> int:
        return int(np.maximum(self.lengths - min_len + 1, 0).sum())

    def windows(self) -> torch.Tensor:
        """W[i] = the codes of bases i .. i+B-1 packed big-endian (0 past the
        array's end), for every i in [0, n), padded with B zeros. Built by
        doubling: log2(B) passes and one combine per set bit of B."""
        if self._windows is None:
            n, B, bits = self.n, self.B, self.bits
            size = n + B
            piece = torch.zeros(size, dtype=I64)
            piece[:n] = self.codes_table[self.sba_t.to(I64)]
            result = torch.zeros(size, dtype=I64)
            have, p = 0, 1
            while True:
                if B & p:
                    head = result[: size - have]
                    head.bitwise_left_shift_(bits * p).bitwise_or_(piece[have:])
                    have += p
                if 2 * p > B:
                    break
                nxt = piece.bitwise_left_shift(bits * p)
                nxt[: size - p].bitwise_or_(piece[p:])
                piece, p = nxt, 2 * p
            self._windows = result
        return self._windows

    def row_word(self, pos: torch.Tensor, offset: int, cap) -> torch.Tensor:
        """Bases [offset, offset + B) of the k-mer at each position, cut at
        its length ``cap`` (an int for every row, or a tensor; the unused
        places are 0). A row shorter than ``offset`` reads a padding word,
        which the cut empties."""
        at = torch.clamp_max(pos + offset, self.n + self.B - 1)
        return self.cut(self.windows()[at], offset, cap)

    def cut(self, w: torch.Tensor, offset: int, cap) -> torch.Tensor:
        """Words of bases [offset, offset + B) with the places at and past
        ``cap`` set to 0."""
        if isinstance(cap, int):
            keep = min(max(cap - offset, 0), self.B)
            return w if keep == self.B else w & int(self.masks[keep])
        return w & self.masks[torch.clamp(cap.to(I64) - offset, 0, self.B)]


def check_index(g: Genome, pos: np.ndarray, min_len: int, max_len):
    """Counts of what is wrong with ``pos`` as the sorted index of
    (min_len, max_len): rows outside the SBA or too short, duplicate rows,
    expected rows missing, adjacent pairs out of order. Returns (counts,
    the ``Index`` over ``pos``, None where a row lies outside the SBA)."""
    out = {"rows": int(pos.shape[0]), "outside": 0, "too_short": 0, "duplicates": 0,
           "missing": 0, "unordered_pairs": 0}
    p = torch.from_numpy(np.asarray(pos).astype(np.int64))
    out["outside"] = int(((p < 0) | (p >= g.n)).sum())
    if out["outside"]:
        out["unordered_pairs"] = max(out["rows"] - 1, 0)
        return out, None
    ix = Index(g, p, max_len)
    out["too_short"] = int((ix.vl < min_len).sum())
    mark = torch.zeros(g.n, dtype=torch.bool)
    mark[p] = True
    out["duplicates"] = out["rows"] - int(mark.sum())
    out["missing"] = g.kmer_count(min_len) - int((mark & (g.vl >= min_len)).sum())
    del mark
    out["unordered_pairs"] = _unordered_pairs(ix)
    return out, ix


def _pair_verdict(wa, wb, ca, cb, pa, pb, offset, B):
    """(pairs out of order, pairs still tied past this word)."""
    bad = int((wa > wb).sum())
    eq = wa == wb
    ends = eq & (torch.minimum(ca, cb) - offset <= B)
    # equal up to the shorter one's end: the shorter first, equal ones by position
    bad += int((ends & ((ca > cb) | ((ca == cb) & (pa > pb)))).sum())
    return bad, eq & ~ends


def _unordered_pairs(ix) -> int:
    g, pos, cap, B = ix.g, ix.pos, ix.cap, ix.g.B
    if ix.n < 2:
        return 0
    w = ix.words(0)
    bad, tied = _pair_verdict(w[:-1], w[1:], cap[:-1], cap[1:], pos[:-1], pos[1:], 0, B)
    active = torch.nonzero(tied).flatten()
    del tied
    offset = B
    while active.numel():
        a, b = pos[active], pos[active + 1]
        ca, cb = cap[active], cap[active + 1]
        wa, wb = g.row_word(a, offset, ca), g.row_word(b, offset, cb)
        more, tied = _pair_verdict(wa, wb, ca, cb, a, b, offset, B)
        bad += more
        active = active[tied]
        offset += B
    return bad


class Index:
    """A sorted index over the genome, with its rows' words (each cut at the
    row's compare length) and adjacent equality at each prefix length,
    computed once for every statistic over it."""

    def __init__(self, g: Genome, pos, max_len):
        self.g, self.max_len = g, max_len
        self.pos = pos if isinstance(pos, torch.Tensor) else torch.from_numpy(
            np.asarray(pos).astype(np.int64))
        self.n = self.pos.shape[0]
        self.vl = g.vl[self.pos]
        self.cap = self.vl if max_len is None else torch.clamp_max(self.vl, max_len)
        self.min_cap = int(self.cap.min()) if self.n else 0
        self.uniform = self.n == 0 or self.min_cap == int(self.cap.max())
        self._words, self._same = {}, {}

    def _cap(self, k=None):
        """Each row's length cut at k: an int where every row has it."""
        if self.uniform:
            return self.min_cap if k is None else min(self.min_cap, k)
        return self.cap if k is None else torch.clamp_max(self.cap, k)

    def words(self, offset: int) -> torch.Tensor:
        if offset not in self._words:
            self._words[offset] = self.g.row_word(self.pos, offset, self._cap())
        return self._words[offset]

    def prefix_words(self, offset: int, k: int) -> torch.Tensor:
        return self.g.cut(self.words(offset), offset, self._cap(k))

    def same_as_previous(self, k: int) -> torch.Tensor:
        """same[i]: rows i and i + 1 agree on their first k bases (a
        shorter row agrees only with a row of its own length)."""
        if k not in self._same:
            same = torch.ones(max(self.n - 1, 0), dtype=torch.bool)
            for offset in range(0, k, self.g.B):
                w = self.prefix_words(offset, k)
                same &= w[1:] == w[:-1]
                del w
            self._same[k] = same
        return self._same[k]

    def group_starts(self, k: int) -> torch.Tensor:
        """First row of every group of equal first-k bases."""
        if self.n == 0:
            return torch.zeros(0, dtype=I64)
        starts = torch.nonzero(~self.same_as_previous(k)).flatten() + 1
        return torch.cat([torch.zeros(1, dtype=I64), starts])


# --------------------------------------------------------------------------- #
# filters: the definitions of genome-kmers' library filters, over positions
# whose window lies inside its record; each is ``reference/filters/<name>.py``
# --------------------------------------------------------------------------- #


def window_sum(flags: torch.Tensor, width: int) -> torch.Tensor:
    """sums[i] = flags set in [i, i + width), for every i in [0, n) (the
    array's end counts as unset)."""
    n = flags.shape[0]
    cs = torch.zeros(n + width + 1, dtype=torch.int32)
    torch.cumsum(flags, 0, dtype=torch.int32, out=cs[1:n + 1])
    cs[n + 1:] = cs[n]
    return cs[width:width + n] - cs[:n]


def require_window(ix: Index, k: int) -> None:
    if ix.n and int(ix.vl.min()) < k:
        raise ValueError(f"a {k}-base filter window reaches a record's end")


def survivors(ix: Index, spec):
    """The filter ``spec`` = [name, *args] over the rows, None for no filter."""
    if not spec:
        return None
    from kmerbench import catalog

    return catalog.reference_filter(spec[0]).mask(ix, *spec[1:])


# --------------------------------------------------------------------------- #
# statistics
# --------------------------------------------------------------------------- #


def histogram(sizes: torch.Tensor) -> np.ndarray:
    return torch.bincount(torch.clamp_max(sizes, MAX_COUNTS_BIN),
                          minlength=MAX_COUNTS_BIN + 1).numpy()


def _sizes(starts: torch.Tensor, n: int, keep=None) -> torch.Tensor:
    """Rows (or, with ``keep``, survivors) of each group; under a filter the
    groups without survivors are left out."""
    ends = torch.cat([starts[1:], torch.tensor([n], dtype=I64)])
    if keep is None:
        return ends - starts
    before = torch.zeros(n + 1, dtype=torch.int32)  # n < 2^31 on one card
    torch.cumsum(keep, 0, dtype=torch.int32, out=before[1:])
    sizes = (before[ends] - before[starts]).to(I64)
    return sizes[sizes >= 1]


def group_counts(ix: Index, k: int, spec=None):
    """(histogram, total) of ``get_kmer_group_counts(k, filter)``."""
    sizes = _sizes(ix.group_starts(k), ix.n, survivors(ix, spec))
    return histogram(sizes), int(sizes.sum())


# --------------------------------------------------------------------------- #
# the control: the same answers with one guarantee broken
# --------------------------------------------------------------------------- #


def fingerprints(ix: Index, k: int, bits: int = 32) -> torch.Tensor:
    """A ``bits``-bit fingerprint (non-negative int64) of each row's first k
    bases: the identity a hash table of k-mers would keep, which merges
    colliding k-mers."""
    h = torch.zeros(ix.n, dtype=I64)
    for offset in range(0, k, ix.g.B):
        h = h * _HASH_A + ix.prefix_words(offset, k) * _HASH_B
        h ^= torch.bitwise_right_shift(h, 29) & ((1 << 35) - 1)
    return torch.bitwise_right_shift(h, 64 - bits) & ((1 << bits) - 1)


def control_index_fingerprint(g: Genome, min_len: int, max_len, bits: int = 32) -> np.ndarray:
    """Every expected position ordered by (fingerprint, position): an
    index whose k-mer identity is a ``bits``-bit hash (breaks "exact")."""
    if max_len is None:
        raise ValueError("the fingerprint control needs a bounded compare length")
    ix = Index(g, torch.nonzero(g.vl >= min_len).flatten(), max_len)
    key = torch.bitwise_left_shift(fingerprints(ix, max_len, min(bits, 31)), 32) | ix.pos
    return (torch.sort(key).values & 0xFFFFFFFF).numpy()


def control_index_truncated(ix: Index, depth: int) -> np.ndarray:
    """The order compared to ``depth`` bases only, ties by position (breaks
    "order" past ``depth``), from a verified order."""
    first = torch.zeros(ix.n, dtype=I64)
    first[ix.group_starts(depth)] = 1
    key = torch.bitwise_left_shift(torch.cumsum(first, 0), 32) | ix.pos
    return (torch.sort(key).values & 0xFFFFFFFF).numpy()


def control_group_counts(ix: Index, k: int, spec=None, bits: int = 32):
    """``group_counts`` with groups by fingerprint (breaks "exact")."""
    fp = fingerprints(ix, k, bits)
    keep = survivors(ix, spec)
    if keep is not None:
        fp = fp[keep]
    sizes = torch.unique(fp, return_counts=True)[1]
    return histogram(sizes), int(sizes.sum())
