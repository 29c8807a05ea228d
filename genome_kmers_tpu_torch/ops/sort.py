"""Single-device sorted k-mer index construction.

Counterpart of ``genome_kmers_tpu/ops/sort.py``. Within one compare window
(k <= 64 on 2-bit keys, k <= 32 on 4-bit keys) three sorts live here.

**The dense 2-bit sort** (``sort_positions_dense(two_bit=True)``), the fresh
index of an ACGT genome. The JAX package sorts its key lanes with one stable
``lax.sort`` and the position as payload; here the lanes go through
``torch.sort(..., stable=True)``, which CUDA needs asked for explicitly (its
default sort is not stable). The key of a row is, most significant first: an
"invalid" bit (rows that are not k-mer starts), the meaningful 2k bits of
its key words, and, unless ``uniform_cap`` says every row has one cap, its
cap. These bits are cut into int64 sort keys of at most 63 bits
(non-negative, so signed order is unsigned order) and sorted least
significant key first, each pass stable, starting from ascending positions:
ties keep the position order, the tie-break that the JAX package gets from
its iota payload. Under ``uniform_cap`` at ``max_kmer_len <= 31`` (the
index's ``min_kmer_len == max_kmer_len``) the whole key is one int64
(1 + 2k <= 63 bits), so one sort does it and the retained words come back
out of the sorted key by shifts.

**The dense 4-bit sort** (``sort_positions_dense(two_bit=False)``), the
fresh index of a genome with N runs or IUPAC codes. At k = 31 its key is an
invalid lane and four 32-bit words, wider than any int64, so the rows go
through the multi-lane sort ``kernels/lane_sort.py::sort_lanes_cuda`` with
the position as the last lane: the order a stable sort with an ascending
iota payload gives.

**The gather sort** (``sort_positions``) of any position set in any input
order: re-sorts, assigned indices. Key words are gathered per position and
the position is an explicit last key, again through ``sort_lanes_cuda``.

**Beyond one window** (``max_kmer_len=None``, "compare to the end of the
record", or a bounded length above the window) the sorts refine iteratively:
sort by one window, give every run of equal keys an id, then re-sort keyed
by (run id, next window, position) until no run is both tied and has bases
left. ``sort_positions_suffix_dense`` is the fresh sort (its first round runs
over every SBA position without a gather; at ``min_kmer_len == 1`` and no
bound the later rounds double the compared prefix instead,
``_double_round2``), the last branch of ``sort_positions`` the gather sort,
and the last branch of ``adjacent_boundaries`` the matching group-boundary
compare. The loops are driven from the host, one scalar read a round; the
JAX package's fused ``lax.while_loop`` programs and its shape bucketing are
not carried over. Every round whose key is wider than one int64 goes through
``sort_lanes_cuda``, the position an explicit lane and the cap the lane
after it: rows differ in the position, so the cap never decides the order
and rides along as a payload does. The two rounds whose key is exactly 64
bits (``_first_round_dense2``, ``_double_round2``) take one stable
``torch.sort`` of an int64 key, which measured faster on the card than the
kernel at three or four lanes. ``on_round``, where a loop takes it, is called
with the round function's name once that round's scalar has been read, which
is when the round has finished on the device: a caller can time the rounds
between two calls without adding a wait.

``sort_lanes`` is the plain version of that kernel (a block sort of 4096-row
tiles, then merge-path passes): chained stable ``torch.sort`` passes.
``sort_lanes_cuda`` takes it for CPU tensors; nothing on a CUDA device's
paths calls it.
"""

from __future__ import annotations

import torch

from ..kernels.lane_sort import sort_lanes_cuda
from ..tracing import span
from .encoding import BASES_PER_WORD, BASES_PER_WORD2, DIBIT_MASKS, NIBBLE_MASKS
from .keys import (
    build_key2_words,
    build_key2_words_dense,
    build_key_words,
    build_key_words_dense,
    cap_lengths,
    compute_valid_len,
    u32_bits_as_int32,
    valid_len_all,
    widen_u32,
)

WINDOW_BASES = 32  # one compare window of 4-bit keys: 4 words
WINDOW2_BASES = 64  # one compare window of 2-bit keys: 4 words
WINDOW_WORDS = 4  # 4-bit words of a refinement round: 32 bases
WINDOW2_WORDS = 2  # 2-bit words of a refinement round: the same 32 bases
# The first dense 2-bit round compares 28 bases, so that the low byte of its
# second word is free to carry the in-window cap (<= 28).
WINDOW2F_BASES = 28
_INT32_MIN = -(1 << 31)
_INT64_MIN = -(1 << 63)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sort_lanes(lanes) -> tuple:
    """Rows of int32 lanes (uint32 bit patterns) sorted ascending,
    lexicographically over all lanes, most significant first, compared as
    unsigned; the lanes of a row move together. The plain version of
    ``kernels/lane_sort.py::sort_lanes_cuda``: one stable ``torch.sort`` a
    lane, least significant lane first. Flipping the sign bit turns the
    unsigned order of the bit patterns into the signed order torch sorts by.
    Being stable, it keeps the input order of fully equal rows; the kernel
    promises its result only when the last lane is unique."""
    lanes = tuple(lanes)
    if lanes[0].shape[0] <= 1:
        return lanes
    perm = None
    for lane in reversed(lanes):
        key = lane ^ _INT32_MIN
        idx = torch.sort(key if perm is None else key[perm], stable=True).indices
        perm = idx if perm is None else perm[idx]
    return tuple(lane[perm] for lane in lanes)


_KEY_BITS = 63  # bits per int64 sort key, keeping the sign bit clear


def _pack_chunks(lanes):
    """Concatenate the bits of ``lanes`` ((values, width) pairs, most
    significant first, 0 <= values < 2**width) and cut them into int64 keys
    of at most ``_KEY_BITS`` bits. Comparing the keys in order compares the
    lanes in order. Returns (keys, key widths)."""
    chunks, widths = [], []
    cur, used = None, 0
    for lane, width in lanes:
        left = width
        while left:
            if used == _KEY_BITS:
                chunks.append(cur)
                widths.append(used)
                cur, used = None, 0
            take = min(left, _KEY_BITS - used)
            part = (lane >> (left - take)) & ((1 << take) - 1)
            cur = part if cur is None else (cur << take) | part
            used += take
            left -= take
    chunks.append(cur)
    widths.append(used)
    return chunks, widths


def _unpack_chunks(chunks, chunk_widths, lane_widths):
    """Inverse of ``_pack_chunks``: the lanes of the given widths."""
    lanes = []
    ci, avail = 0, chunk_widths[0]
    for width in lane_widths:
        lane, left = None, width
        while left:
            if avail == 0:
                ci += 1
                avail = chunk_widths[ci]
            take = min(left, avail)
            part = (chunks[ci] >> (avail - take)) & ((1 << take) - 1)
            lane = part if lane is None else (lane << take) | part
            avail -= take
            left -= take
        lanes.append(lane)
    return lanes


def _dense_key_chunks(packed2, seg_starts, seg_ends, min_len, k, uniform_cap):
    """Sort keys for every position 0..L-1 of the pack (see module doc).
    Returns (keys, key widths, lane widths); the lanes are the invalid bit,
    the words (the last one cut to its meaningful bits) and, unless
    ``uniform_cap``, the cap. A function of its own so that the lanes, a
    few int64 tensors of L rows, are freed before the sort allocates."""
    n_words = _cdiv(k, BASES_PER_WORD2)
    cap = torch.clamp_max(valid_len_all(seg_starts, seg_ends, packed2.shape[0]), k)
    invalid = (cap < min_len).to(torch.int64)
    words = build_key2_words_dense(packed2, cap, n_words)
    last_bits = 2 * (k - BASES_PER_WORD2 * (n_words - 1))
    lanes = [(invalid, 1)] + [(w, 32) for w in words[:-1]]
    lanes.append((words[-1] >> (32 - last_bits), last_bits))
    if not uniform_cap:
        lanes.append((cap, k.bit_length()))
    chunks, chunk_widths = _pack_chunks(lanes)
    return chunks, chunk_widths, [w for _, w in lanes]


def _sort_dense(packed2, seg_starts, seg_ends, min_len, k, uniform_cap):
    """Fresh sort over ALL positions 0..L-1 of the pack: key words are
    shifted slices of the pack and valid_len comes from the segment table,
    so nothing is gathered from the genome. Rows that are not k-mer starts
    (separators, tails shorter than ``min_len``) carry the invalid bit and
    sort after every real row.

    Returns (positions in sorted order, the first key sorted, the keys,
    key widths, lane widths) over all L rows: the later keys are gathered
    in sorted order only by a caller that keeps them, which also keeps the
    real-row prefix."""
    with span("gk:sort.keys", packed2):
        chunks, chunk_widths, lane_widths = _dense_key_chunks(
            packed2, seg_starts, seg_ends, min_len, k, uniform_cap
        )
    with span("gk:sort.order", packed2):
        perm = None
        for chunk in reversed(chunks):
            vals, idx = torch.sort(chunk if perm is None else chunk[perm], stable=True)
            perm = idx if perm is None else perm[idx]
    return perm, vals, chunks, chunk_widths, lane_widths


def _sort_dense4(packed, seg_starts, seg_ends, min_len, k):
    """Fresh sort over ALL positions 0..L-1 of the 4-bit pack. The lanes
    are (invalid, words..., iota): the leading invalid lane stays, because a
    real 4-bit word can be all-ones (rank 15 = 'Y'), and iota as the last
    key gives the order of a stable sort with iota as payload. Termination
    rides in the words (rank 0 past the cap), so there is no cap lane.

    Returns the sorted lanes (int32 bit patterns) over all L rows; the
    caller keeps the real-row prefix."""
    length = packed.shape[0]
    with span("gk:sort.keys", packed):
        cap = torch.clamp_max(valid_len_all(seg_starts, seg_ends, length), k)
        invalid = (cap < min_len).to(torch.int32)
        words = build_key_words_dense(packed, cap, _cdiv(k, BASES_PER_WORD))
        del cap
        if length <= 1 << 31:
            iota = torch.arange(length, dtype=torch.int32, device=packed.device)
        else:
            iota = u32_bits_as_int32(torch.arange(length, dtype=torch.int64, device=packed.device))
    with span("gk:sort.order", packed, kernel=sort_lanes_cuda):
        return sort_lanes_cuda((invalid,) + words + (iota,))


def sort_positions_dense(
    packed, seg_starts, seg_ends, n, min_kmer_len, max_kmer_len,
    two_bit=False, uniform_cap=False, return_lanes=False,
):
    """Fresh sort of the canonical k-mer start set (every position with
    valid_len >= min_kmer_len) from the genome's int32 pack: the 2-bit pack
    of an ACGT genome when ``two_bit``, else the 4-bit pack. ``n`` is the
    known canonical start count. ``uniform_cap`` (every k-mer has the same
    cap, as at min_kmer_len == max_kmer_len) drops the cap lane of 2-bit
    keys; 4-bit keys never have one.

    Returns int64 positions in sorted order, ties by position; with
    ``return_lanes`` a ``(positions, lanes)`` pair whose lanes are the
    retained sorted lanes in the JAX package's layout ``{"two_bit",
    "built_k", "words", "cap"}``. 2-bit words are int64 lanes of uint32
    values, with cap None under ``uniform_cap``; 4-bit words are int32 bit
    patterns and never have a cap lane."""
    k = max_kmer_len
    if not two_bit:
        n_words = _cdiv(k, BASES_PER_WORD)
        res = _sort_dense4(packed, seg_starts, seg_ends, min_kmer_len, k)
        with span("gk:sort.lanes", packed):
            pos = widen_u32(res[-1][:n])
            if not return_lanes:
                return pos
            return pos, {
                "two_bit": False,
                "built_k": k,
                "words": tuple(w[:n] for w in res[1 : 1 + n_words]),
                "cap": None,
            }
    perm, vals, chunks, chunk_widths, lane_widths = _sort_dense(
        packed, seg_starts, seg_ends, min_kmer_len, k, uniform_cap
    )
    if not return_lanes:
        return perm[:n]
    with span("gk:sort.lanes", packed):
        sorted_chunks = [vals] + [c[perm] for c in chunks[1:]]
        del vals, chunks
        lanes = _unpack_chunks([c[:n] for c in sorted_chunks], chunk_widths, lane_widths)
        n_words = _cdiv(k, BASES_PER_WORD2)
        words = lanes[1 : 1 + n_words]
        words[-1] = words[-1] << (32 - lane_widths[n_words])
    return perm[:n], {
        "two_bit": True,
        "built_k": k,
        "words": tuple(words),
        "cap": None if uniform_cap else lanes[-1],
    }


def _round_done(unresolved, name: str, on_round) -> bool:
    """Read a round's one scalar, report the round, and say whether another
    is needed."""
    more = bool(unresolved)
    if on_round is not None:
        on_round(name)
    return more


def sort_positions(
    packed, positions, cap_len, max_kmer_len, packed2=None, uniform_cap=False,
    return_lanes=False, on_round=None,
):
    """Sort k-mer start positions lexicographically by their capped k-mer.

    ``positions`` (int64) may come in ANY order (a sorted index, a
    descending or a subset index): the position is an explicit last key,
    not a stable payload. ``cap_len`` is min(valid_len, max_kmer_len) per
    position. With ``packed2`` (ACGT genome, max_kmer_len <= 64) the keys
    are 2-bit words and, unless ``uniform_cap``, the cap; else 4-bit words
    from ``packed`` (max_kmer_len <= 32).

    Returns int64 sorted positions, ties by position; with
    ``return_lanes`` a ``(positions, lanes)`` pair whose lanes are the
    retained sorted lanes (int32 bit-pattern words, int64 cap), or None for
    an index of at most one k-mer and on the refinement path
    (``max_kmer_len`` None or beyond one window), where no single-window
    lanes exist. ``on_round``, a port addition, hears of each refinement
    round (see module doc)."""
    n = positions.shape[0]
    if n <= 1:
        return (positions, None) if return_lanes else positions
    pos_lane = u32_bits_as_int32(positions)
    if packed2 is not None and max_kmer_len is not None and max_kmer_len <= WINDOW2_BASES:
        n_words = _cdiv(max_kmer_len, BASES_PER_WORD2)
        words = build_key2_words(packed2, positions, cap_len, n_words)
        caps = () if uniform_cap else (cap_len.to(torch.int32),)
        res = sort_lanes_cuda(words + caps + (pos_lane,))
        if not return_lanes:
            return widen_u32(res[-1])
        return widen_u32(res[-1]), {
            "two_bit": True,
            "built_k": max_kmer_len,
            "words": tuple(res[:n_words]),
            "cap": None if uniform_cap else res[n_words].to(torch.int64),
        }
    if max_kmer_len is not None and max_kmer_len <= WINDOW_BASES:
        n_words = _cdiv(max_kmer_len, BASES_PER_WORD)
        words = build_key_words(packed, positions, cap_len, n_words)
        res = sort_lanes_cuda(words + (pos_lane,))
        if not return_lanes:
            return widen_u32(res[-1])
        return widen_u32(res[-1]), {
            "two_bit": False,
            "built_k": max_kmer_len,
            "words": tuple(res[:n_words]),
            "cap": None,  # the 4-bit encoding carries termination in-word
        }
    # refinement rounds of 32 bases, on the 2-bit pack where there is one
    # (half the key lanes); the host reads one scalar a round
    def sort_round(pos, cap, gid, offset, first):
        if packed2 is not None:
            return _sort_round2(packed2, pos, cap, gid, offset, first)
        return _sort_round(packed, pos, cap, gid, offset, WINDOW_WORDS, first)

    name = "_sort_round" if packed2 is None else "_sort_round2"
    pos, cap, gid, unresolved = sort_round(positions, cap_len, None, 0, True)
    offset = WINDOW_BASES
    while _round_done(unresolved, name, on_round):
        pos, cap, gid, unresolved = sort_round(pos, cap, gid, offset, False)
        offset += WINDOW_BASES
    return (pos, None) if return_lanes else pos


# --------------------------------------------------------------------------- #
# refinement rounds: compare lengths beyond one window
# --------------------------------------------------------------------------- #


def _adjacent_eq(words, base_eq: torch.Tensor) -> torch.Tensor:
    """eq[i] = base_eq[i] and every lane of ``words`` equal between rows i
    and i-1; eq[0] is False."""
    eq = base_eq.clone()
    for w in words:
        eq[1:] &= w[1:] == w[:-1]
    eq[:1] = False
    return eq


def _run_structure(eq: torch.Tensor, beyond: torch.Tensor):
    """(run ids, any unresolved) of sorted rows from their adjacent-equality
    mask. A pair of equal neighbours is unresolved iff either still has
    bases beyond the compared length (``beyond``); where both have ended the
    tie is final. The ids count the runs from 1, one ``cumsum`` a round."""
    unresolved = eq[1:] & (beyond[1:] | beyond[:-1])
    return torch.cumsum(~eq, dim=0), unresolved.any()


def _ones_like_rows(lane: torch.Tensor) -> torch.Tensor:
    return torch.ones(lane.shape[0], dtype=torch.bool, device=lane.device)


def _sort_round(packed, positions, cap_len, group_id, offset: int, n_words: int, first: bool):
    """One refinement round on the 4-bit pack: sort by (run id, the
    ``n_words`` key words from ``offset`` bases on, position), then
    recompute the run structure. On the ``first`` round there are no runs
    yet and ``group_id`` is not read. The cap is the lane after the
    position: it moves with its row and never decides the order.

    Returns (sorted positions, sorted cap_len, run ids, any unresolved):
    int64 tensors and a 0-dim bool tensor."""
    words = build_key_words(packed, positions, cap_len, n_words, offset)
    lead = () if first else (u32_bits_as_int32(group_id),)
    res = sort_lanes_cuda(
        lead + words + (u32_bits_as_int32(positions), u32_bits_as_int32(cap_len))
    )
    s_pos, s_cap = widen_u32(res[-2]), widen_u32(res[-1])
    eq = _adjacent_eq(res[:-2], _ones_like_rows(s_pos))
    gid, unresolved = _run_structure(eq, s_cap > offset + n_words * BASES_PER_WORD)
    return s_pos, s_cap, gid, unresolved


def _sort_round2(packed2, positions, cap_len, group_id, offset: int, first: bool):
    """One refinement round on the 2-bit pack: two window words where the
    4-bit round has four, and the in-window cap as a key after them
    (rank('A') = 0, so the end of a k-mer cannot ride inside 2-bit words).
    Same contract as ``_sort_round``."""
    words = build_key2_words(packed2, positions, cap_len, WINDOW2_WORDS, offset)
    win = torch.clamp(cap_len - offset, 0, WINDOW_BASES).to(torch.int32)
    lead = () if first else (u32_bits_as_int32(group_id),)
    res = sort_lanes_cuda(
        lead + words + (win, u32_bits_as_int32(positions), u32_bits_as_int32(cap_len))
    )
    s_pos, s_cap = widen_u32(res[-2]), widen_u32(res[-1])
    eq = _adjacent_eq(res[:-2], _ones_like_rows(s_pos))
    gid, unresolved = _run_structure(eq, s_cap > offset + WINDOW_BASES)
    return s_pos, s_cap, gid, unresolved


def _dense_caps(seg_starts, seg_ends, length: int, min_len: int, max_k):
    """(cap, invalid) for every position 0..length-1: min(valid_len, max_k)
    (``max_k`` None = unbounded), forced to 0 on the rows that are not
    k-mer starts (separators, tails shorter than ``min_len``)."""
    cap = cap_lengths(valid_len_all(seg_starts, seg_ends, length), max_k)
    invalid = cap < min_len
    return torch.where(invalid, 0, cap), invalid


def _first_round_dense(packed, seg_starts, seg_ends, min_len: int, max_k, n_words: int):
    """First refinement round over ALL positions of the 4-bit pack, the
    dense form of ``_sort_round(..., first=True)``: key words are shifted
    slices of the pack, nothing is gathered. Rows that are not k-mer starts
    carry a leading invalid lane and cap 0: they sort last and count as
    resolved. The position (iota) is the last key, the order a stable sort
    with an iota payload gives.

    Returns (sorted positions, sorted cap, run ids, any unresolved) in the
    form ``_sort_round`` takes for the remaining rounds."""
    length = packed.shape[0]
    cap, invalid = _dense_caps(seg_starts, seg_ends, length, min_len, max_k)
    words = build_key_words_dense(packed, cap, n_words)
    iota = torch.arange(length, dtype=torch.int64, device=packed.device)
    res = sort_lanes_cuda(
        (invalid.to(torch.int32),) + words + (u32_bits_as_int32(iota), u32_bits_as_int32(cap))
    )
    del words, iota, invalid, cap
    s_pos, s_cap = widen_u32(res[-2]), widen_u32(res[-1])
    eq = _adjacent_eq(res[:-2], _ones_like_rows(s_pos))
    gid, unresolved = _run_structure(eq, s_cap > n_words * BASES_PER_WORD)
    return s_pos, s_cap, gid, unresolved


def _first_round_dense2(packed2, seg_starts, seg_ends, min_len: int, max_k):
    """First refinement round over ALL positions of the 2-bit pack. The
    window is 28 bases, which leaves 8 zero bits at the bottom of word 1 for
    the in-window cap: equal words then order by cap, the
    shorter-equal-prefix-is-smaller rule. Rows that are not k-mer starts
    fold to all-ones words and sort strictly last (word 1 of a real row has
    a low byte <= 28, so even an all-'T' k-mer stays below them).

    The key is exactly 64 bits: one int64 with the sign bit flipped (signed
    order = unsigned order) under one stable ``torch.sort``, whose indices
    are the sorted positions. "Extends beyond the window" is read back per
    sorted row by a gather.

    Returns (sorted positions, run ids, any unresolved); the caller
    rebuilds the caps when a refinement round follows."""
    length = packed2.shape[0]
    cap, invalid = _dense_caps(seg_starts, seg_ends, length, min_len, max_k)
    win = torch.clamp_max(cap, WINDOW2F_BASES)
    beyond = cap > WINDOW2F_BASES
    w0, w1 = build_key2_words_dense(packed2, win, WINDOW2_WORDS)
    del cap
    key = torch.where(invalid, -1, (w0 << 32) | w1 | win) ^ _INT64_MIN
    del w0, w1, win, invalid
    s_key, s_pos = torch.sort(key, stable=True)
    del key
    eq = _adjacent_eq((s_key,), _ones_like_rows(s_pos))
    gid, unresolved = _run_structure(eq, beyond[s_pos])
    return s_pos, gid, unresolved


def _double_round2(pos, gid, cap, h: int):
    """One prefix-doubling round over the run ids: rows ordered by their
    first ``h`` bases re-key by (run id, run id of the suffix that starts
    ``h`` bases later) and are then ordered by 2h bases, so a genome full
    of repeats resolves in O(log(longest repeat)) rounds where window rounds
    need O(longest repeat / 32).

    Valid only for min_kmer_len == 1 and max_kmer_len None over every SBA
    position: each lookup target ``pos + h`` is then itself a ranked row
    and no cap falls inside the doubled span. ``gid`` are the current run
    ids in sorted order; a row that has ended (cap <= h) re-keys to 0,
    below every real id + 1: the shorter-equal-prefix-is-smaller rule. Ties
    keep the position order, which the input has within every run.

    Both keys are below 2^32: they are one int64 under one stable
    ``torch.sort``, and the position and the cap follow by two gathers.

    Returns (sorted positions, run ids, sorted cap, any unresolved)."""
    length = pos.shape[0]
    inv = torch.zeros(length, dtype=torch.int64, device=pos.device)
    inv[pos] = gid
    beyond = cap > h
    at = torch.clamp_max(torch.where(beyond, pos + h, 0), length - 1)
    key2 = torch.where(beyond, inv[at] + 1, 0)
    del inv, beyond, at
    key = ((gid << 32) | key2) ^ _INT64_MIN
    del key2
    s_key, order = torch.sort(key, stable=True)
    del key
    s_pos, s_cap = pos[order], cap[order]
    # As in the JAX package, row 0 counts as equal to itself in this round:
    # the ids it returns count from 0 (the other rounds' from 1), and a
    # first row with bases left beyond 2h asks for one more round.
    eq = _ones_like_rows(s_pos)
    eq[1:] = s_key[1:] == s_key[:-1]
    beyond = s_cap > 2 * h
    unresolved = (eq[1:] & (beyond[1:] | beyond[:-1])).any() | beyond[:1].any()
    return s_pos, torch.cumsum(~eq, dim=0), s_cap, unresolved


def sort_positions_suffix_dense(
    packed, seg_starts, seg_ends, n, min_kmer_len, max_kmer_len, packed2=None,
    return_gid=False, on_round=None,
):
    """Fresh sort of the canonical start set for an unbounded or
    beyond-window ``max_kmer_len``: the first round runs over every SBA
    position without a gather; later rounds re-sort within the unresolved
    runs, by prefix doubling at ``min_kmer_len == 1`` and no bound, else by
    gathered 32-base windows. The result equals ``sort_positions`` over the
    canonical start set. ``n`` is the known canonical start count;
    ``packed`` is the 4-bit pack, or pass ``packed2`` (ACGT genomes) for the
    folded 2-bit first round and the two-word window rounds. The loop is
    driven from the host and reads one scalar a round; ``on_round`` hears of
    each round (see module doc).

    ``return_gid``: also return the converged run ids of the sorted rows.
    Rows share an id iff their k-mers are equal under the sort's full
    comparison, so group boundaries at that identity are an adjacent
    difference.

    Returns int64 sorted positions, or (positions, run ids)."""
    doubling = min_kmer_len == 1 and max_kmer_len is None
    # each round is one span, ending on the scalar read that decides the next
    if packed2 is not None:
        with span("gk:sort.round", packed2):
            pos, gid, unresolved = _first_round_dense2(
                packed2, seg_starts, seg_ends, min_kmer_len, max_kmer_len
            )
            more = _round_done(unresolved, "_first_round_dense2", on_round)
        offset = WINDOW2F_BASES
        cap = None
        while more:
            with span("gk:sort.round", pos):
                if cap is None:
                    # the folded first round keeps no cap lane; a valid length
                    # can only be negative for a row past the last record
                    cap = torch.clamp_min(
                        cap_lengths(compute_valid_len(pos, seg_starts, seg_ends), max_kmer_len),
                        0,
                    )
                if doubling:
                    name = "_double_round2"
                    pos, gid, cap, unresolved = _double_round2(pos, gid, cap, offset)
                    offset += offset
                else:
                    name = "_sort_round2"
                    pos, cap, gid, unresolved = _sort_round2(
                        packed2, pos, cap, gid, offset, False
                    )
                    offset += WINDOW_BASES
                more = _round_done(unresolved, name, on_round)
    else:
        with span("gk:sort.round", packed):
            pos, cap, gid, unresolved = _first_round_dense(
                packed, seg_starts, seg_ends, min_kmer_len, max_kmer_len, WINDOW_WORDS
            )
            more = _round_done(unresolved, "_first_round_dense", on_round)
        offset = WINDOW_BASES
        while more:
            with span("gk:sort.round", pos):
                if doubling:
                    name = "_double_round2"
                    pos, gid, cap, unresolved = _double_round2(pos, gid, cap, offset)
                    offset += offset
                else:
                    name = "_sort_round"
                    pos, cap, gid, unresolved = _sort_round(
                        packed, pos, cap, gid, offset, WINDOW_WORDS, False
                    )
                    offset += WINDOW_BASES
                more = _round_done(unresolved, name, on_round)
    if return_gid:
        return pos[:n], gid[:n]
    return pos[:n]


def _adj_eq_round(packed, positions, cap_len, eq, offset: int, n_words: int):
    """One round of the adjacent-pair compare at the given base offset:
    (eq narrowed by this window's words, any pair still equal with bases
    left beyond it)."""
    words = build_key_words(packed, positions, cap_len, n_words, offset)
    eq = _adjacent_eq(words, eq)
    beyond = cap_len > offset + n_words * BASES_PER_WORD
    unresolved = eq[1:] & (beyond[1:] | beyond[:-1])
    return eq, unresolved.any()


def _masked(word: torch.Tensor, mask_u32: int) -> torch.Tensor:
    """``word & mask`` for a word lane in either form (ops/keys.py)."""
    if word.dtype == torch.int32 and mask_u32 >= 1 << 31:
        mask_u32 -= 1 << 32
    return word & mask_u32


def boundaries_from_sorted_lanes(words, cap, kmer_len: int, two_bit: bool) -> torch.Tensor:
    """Group-boundary mask from retained sorted key lanes: a pure adjacent
    compare, no genome gathers. Any ``kmer_len`` up to the built length
    works: word content beyond each row's cap is already zero, so masking
    each word to ``kmer_len`` bases and clamping the cap lane to
    ``min(cap, kmer_len)`` gives exactly the lanes of a build at kmer_len.
    ``cap=None`` is the uniform-cap case, or the 4-bit one, which has no cap
    lane."""
    per_word = BASES_PER_WORD2 if two_bit else BASES_PER_WORD
    masks = DIBIT_MASKS if two_bit else NIBBLE_MASKS
    n = words[0].shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=words[0].device)
    for w_idx, w in enumerate(words):
        keep = min(max(kmer_len - per_word * w_idx, 0), per_word)
        if keep == 0:
            break
        ww = _masked(w, int(masks[keep]))
        eq[1:] &= ww[1:] == ww[:-1]
    if cap is not None:
        c = torch.clamp_max(cap, kmer_len)
        eq[1:] &= c[1:] == c[:-1]
    boundary = ~eq
    boundary[:1] = True
    return boundary


def adjacent_boundaries(
    packed, sorted_positions, cap_len, kmer_len, packed2=None, uniform_cap=False
) -> torch.Tensor:
    """Group-boundary mask over a sorted position array, from gathered key
    words: boundary[i] is True iff the k-mers at sorted_positions[i] and
    [i-1] differ when compared up to ``kmer_len`` bases (``cap_len`` is
    min(valid_len, kmer_len)); boundary[0] is True. On 2-bit keys the cap
    is part of the identity unless ``uniform_cap``. ``kmer_len`` None
    compares to the end of the record; it and any length beyond one window
    take rounds of 32 bases over ``packed``, the 4-bit pack."""
    n = sorted_positions.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=sorted_positions.device)
    if packed2 is not None and kmer_len is not None and kmer_len <= WINDOW2_BASES:
        lanes = build_key2_words(
            packed2, sorted_positions, cap_len, _cdiv(kmer_len, BASES_PER_WORD2)
        )
        if not uniform_cap:
            lanes += (cap_len,)
    elif kmer_len is not None and kmer_len <= WINDOW_BASES:
        lanes = build_key_words(packed, sorted_positions, cap_len, _cdiv(kmer_len, BASES_PER_WORD))
    else:
        # kmer_len None or beyond a window: compare window by window on the
        # 4-bit pack until no equal pair has bases left
        eq = torch.ones(n, dtype=torch.bool, device=sorted_positions.device)
        offset = 0
        while True:
            eq, unresolved = _adj_eq_round(
                packed, sorted_positions, cap_len, eq, offset, WINDOW_WORDS
            )
            offset += WINDOW_BASES
            if not bool(unresolved):
                break
        return ~eq
    eq = torch.ones(n, dtype=torch.bool, device=sorted_positions.device)
    for lane in lanes:
        eq[1:] &= lane[1:] == lane[:-1]
    boundary = ~eq
    boundary[:1] = True
    return boundary
