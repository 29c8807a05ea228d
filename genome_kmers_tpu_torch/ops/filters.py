"""K-mer filters: the reference's scalar filters and their masks over
tensors of k-mer start positions.

Counterpart of ``genome_kmers_tpu/ops/filters.py``. Each filter has two
faces:

* ``__call__(sba, sba_strand, kmer_sba_start_idx) -> bool``: scalar, host
  NumPy, the reference's semantics, including which ValueError fires first;
* ``batch_mask(ctx) -> bool tensor``: ``check_batch`` (raises the
  reference's ValueError for the first offending row in index order) and
  ``mask_pure`` (the mask, on the positions' device).

A library filter reaches its mask by one of three routes, chosen as the JAX
package chooses them:

* **lanes flags** (``lanes_spec``): the filter's (pass, raise) outcome from
  the sorted key lanes a sort retains, with no genome read
  (ops/groups.lanes_filtered_*);
* **flag plane** (``_plane_spec``): a uint8 plane in genome order, bit 0
  "passes", bit 1 "would raise", cached on the device cache and gathered at
  the positions;
* **window gathers**: from the genome scans (G/C prefix counts, run
  lengths, next ambiguous base) when the context has no device cache.

Exact-parity notes (the reference's control flow):

* homopolymer: the overflow ValueError comes first; ``kmer_len <
  max_homopolymer_size`` returns True before any '$' check; a run longer
  than the maximum before the '$' returns False without raising;
* GC: the impossible range returns False before touching the SBA; a k-mer
  whose G/C count exceeds the maximum before a '$' returns False without
  raising;
* no-ambiguous: a non-ACGT base before a '$' returns False without raising;
* CRISPR PAM: reads raw bytes at +21/+22 with no '$' check.

Conventions (ops/keys.py): positions, lengths and scans are int64 or int32
tensors. Key words are widened once to int64 lanes holding uint32 values
(``widen_u32``), so shifts are logical, and every ``~`` and ``<<`` is masked
back to 32 bits. torch has no population count, so ``popcount32`` is a SWAR
count. The JAX package's scans use ``lax.cummax`` / ``lax.cummin``, which in
torch took about 390 ms each over 2^27 int64 rows on an H100 80GB HBM3
(700 W limit); the scans here take index forms instead: run starts from
``nonzero``, the next ambiguous base from the list of ambiguous rows, and
the next '$' as ``p + valid_len_genome[p]``, since no window crosses a '$'.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels.lanes_flags import Scalars, lanes_flags_cuda
from .keys import keep_mask, widen_u32

_DOLLAR = ord("$")
_ACGT = frozenset((ord("A"), ord("C"), ord("G"), ord("T")))
_U32 = 0xFFFFFFFF
# next_amb where no ambiguous base follows: above every position, and
# next_amb - p >= k for every k a filter can pass, so min(next_amb - p, k)
# is exact
_NO_AMB = (1 << 31) - 1


class FilterContext:
    """Per-call context handed to ``batch_mask``: the SBA, the k-mer start
    positions and their valid lengths (int64 tensors on one device), and
    the genome scans, computed lazily and shared between filters.

    ``valid_rows`` (a bool tensor beside the positions, or None for all)
    names the rows the raise checks consider: the mesh path's ragged
    layouts carry pad rows, whose positions stand in for no k-mer. The mask
    (``mask_pure``) is computed for every row regardless."""

    def __init__(self, sba_u8: np.ndarray, positions, valid_len, sba_dev=None, valid_rows=None,
                 scans=None):
        self.sba_np = sba_u8
        self.sba_len = int(len(sba_u8))
        self._sba_dev = sba_dev
        self.positions = positions
        self.valid_len = valid_len
        self.valid_rows = valid_rows
        # scans: optional provider of gc_cumsum / run_len / next_amb /
        # filter_flags (the SequenceCollection device cache), so the genome
        # scans are computed once per strand and not once per query
        self._scans = scans
        self._gc_cumsum = None
        self._run_len = None
        self._next_amb = None

    def _rows(self, condition: torch.Tensor) -> torch.Tensor:
        """A raise condition restricted to the valid rows."""
        return condition if self.valid_rows is None else condition & self.valid_rows

    @property
    def sba(self) -> torch.Tensor:
        if callable(self._sba_dev):
            # a lazy provider (the device cache), so a filter that never
            # reads SBA bytes never uploads them
            self._sba_dev = self._sba_dev()
        if self._sba_dev is None:
            self._sba_dev = torch.from_numpy(self.sba_np).to(self.positions.device)
        return self._sba_dev

    @property
    def gc_cumsum(self):
        if self._gc_cumsum is None:
            self._gc_cumsum = (
                self._scans.gc_cumsum if self._scans is not None else _gc_cumsum(self.sba)
            )
        return self._gc_cumsum

    @property
    def run_len(self):
        if self._run_len is None:
            self._run_len = (
                self._scans.run_len if self._scans is not None else _run_lengths(self.sba)
            )
        return self._run_len

    @property
    def next_amb(self):
        if self._next_amb is None:
            self._next_amb = (
                self._scans.next_amb if self._scans is not None else _next_ambiguous(self.sba)
            )
        return self._next_amb


# --------------------------------------------------------------------------- #
# genome scans (int32, genome order)
# --------------------------------------------------------------------------- #


def _prefix_count(flags: torch.Tensor) -> torch.Tensor:
    """out[i] = number of True flags in flags[0:i] (length n + 1, int32)."""
    out = torch.zeros(flags.shape[0] + 1, dtype=torch.int32, device=flags.device)
    torch.cumsum(flags, dim=0, dtype=torch.int32, out=out[1:])
    return out


def _top_rank(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Each word's own base: the top field of an int32 pack."""
    return (packed >> (32 - bits)) & ((1 << bits) - 1)


def _gc_cumsum(sba):
    """gc[i] = number of G/C bytes in sba[0:i] (length n + 1)."""
    return _prefix_count((sba == ord("G")) | (sba == ord("C")))


def _gc_cumsum_ranks2(packed2):
    """``_gc_cumsum`` from the 2-bit pack: a word's top field is its own
    base's rank (A0 C1 G2 T3, '$' 0), so no byte SBA is read."""
    r = _top_rank(packed2, 2)
    return _prefix_count((r == 1) | (r == 2))


def _gc_cumsum_ranks4(packed):
    """``_gc_cumsum`` from the 4-bit pack (C = rank 3, G = rank 5)."""
    r = _top_rank(packed, 4)
    return _prefix_count((r == 3) | (r == 5))


def _run_lengths_from_changes(changed: torch.Tensor) -> torch.Tensor:
    """r[i] = i - (last j <= i with changed[j]) + 1 (changed[0] is True):
    the start of i's run is the run's entry in the list of run starts."""
    starts = torch.nonzero(changed).flatten()
    run_id = torch.cumsum(changed, dim=0) - 1
    idx = torch.arange(changed.shape[0], dtype=torch.int64, device=changed.device)
    return (idx - starts[run_id] + 1).to(torch.int32)


def _changes(symbols: torch.Tensor) -> torch.Tensor:
    changed = torch.ones(symbols.shape[0], dtype=torch.bool, device=symbols.device)
    changed[1:] = symbols[1:] != symbols[:-1]
    return changed


def _run_lengths(sba):
    """r[i] = length of the equal-byte run ending at i (>= 1)."""
    return _run_lengths_from_changes(_changes(sba))


def _run_lengths_ranks2(packed2, is_dollar):
    """``_run_lengths`` from 2-bit ranks. '$' packs as rank 0 (= A), so the
    byte semantics (a separator breaks runs on both sides) are restored with
    explicit breaks at '$' rows."""
    changed = _changes(_top_rank(packed2, 2)) | is_dollar
    changed[1:] |= is_dollar[:-1]
    return _run_lengths_from_changes(changed)


def _run_lengths_ranks4(packed):
    """``_run_lengths`` from 4-bit ranks: the ranks are a bijection of the
    allowed bytes ('$' is rank 0 and nothing else), so no '$' special case."""
    return _run_lengths_from_changes(_changes(_top_rank(packed, 4)))


def _next_from(is_amb: torch.Tensor) -> torch.Tensor:
    """na[i] = smallest j >= i with is_amb[j], else _NO_AMB (int32): the
    entry of the ambiguous-row list after the ones strictly before i."""
    rows = torch.nonzero(is_amb).flatten()
    rows = torch.cat([rows, rows.new_full((1,), _NO_AMB)])
    before = torch.cumsum(is_amb, dim=0) - is_amb.to(torch.int64)
    return rows[before].to(torch.int32)


def _next_ambiguous(sba):
    """na[i] = smallest j >= i whose byte is neither A/C/G/T nor '$'."""
    is_amb = ~(
        (sba == ord("A")) | (sba == ord("C")) | (sba == ord("G")) | (sba == ord("T"))
        | (sba == _DOLLAR)
    )
    return _next_from(is_amb)


def _next_ambiguous_ranks4(packed):
    """``_next_ambiguous`` from 4-bit ranks (A=1, C=3, G=5, T=12, '$'=0)."""
    r = _top_rank(packed, 4)
    is_amb = ~((r == 1) | (r == 3) | (r == 5) | (r == 12) | (r == 0))
    return _next_from(is_amb)


def no_ambiguous_scan(n: int, device) -> torch.Tensor:
    """``next_amb`` of a genome with no ambiguous base: the sentinel at
    every row, as a stride-0 view that holds one element."""
    return torch.full((1,), _NO_AMB, dtype=torch.int32, device=device).expand(n)


# --------------------------------------------------------------------------- #
# genome-order flag planes: each filter's outcome at every genome row, bit 0
# "passes", bit 1 "would raise", from scans and shifted slices. A filtered
# query then gathers one uint8 plane at its positions, and the plane stays
# on the device cache across queries.
# --------------------------------------------------------------------------- #


def _at_next_dollar(prefix, vl_g):
    """v[p] = prefix[nd(p)], nd(p) the first '$' row at or after p (or n).
    valid_len runs to the segment's end and is 0 on a '$' row, so nd(p) =
    p + valid_len_genome[p]; the JAX package takes a reverse cummin."""
    n = vl_g.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vl_g.device)
    return prefix[torch.clamp_max(idx + vl_g, n)]


def _pad_prefix(prefix, k: int):
    """prefix (length n + 1) extended so prefix_pad[j] = prefix[min(j, n)]
    for j up to n + k: clamped lookups become shifted slices."""
    return torch.cat([prefix, prefix[-1:].expand(k)])


def _pack_flags(mask, raises):
    return mask.to(torch.uint8) | (raises.to(torch.uint8) << 1)


def _gc_flags_genome(gc_cumsum, vl_g, min_c: int, max_c: int, k: int):
    """GC plane. gc_end[p] = G/C count in the first min(k, bases to the
    segment end) bases = min(ce[p + k], ce[nd(p)]) - ce[p]."""
    n = vl_g.shape[0]
    ce = gc_cumsum
    ce_pk = _pad_prefix(ce, k)[k : k + n]
    gc_end = torch.minimum(ce_pk, _at_next_dollar(ce, vl_g)) - ce[:n]
    trunc = vl_g < k
    ok = (gc_end >= min_c) & (gc_end <= max_c)
    return _pack_flags(~trunc & ok, trunc & (gc_end <= max_c))


def _homopolymer_flags_genome(run_len, vl_g, k: int, max_h: int):
    """Homopolymer plane for k >= max_h (a shorter k returns True before any
    '$' check). Overflow past the array end raises unconditionally; a '$'
    inside the window raises only when no run exceeded max_h before it, so
    the raise bit looks at the truncated window [p + max_h, min(p + k, next
    '$')) for violating-run markers."""
    n = run_len.shape[0]
    cs = _prefix_count(run_len > max_h)
    cs_pad = _pad_prefix(cs, k)
    hi = cs_pad[k : k + n]  # cs[min(p + k, n)]
    lo = cs_pad[max_h : max_h + n]  # cs[min(p + max_h, n)]
    any_bad = hi > lo  # prefix counts are monotone
    # runs never cross a '$', so the markers in [p + max_h, nd) are exactly
    # the ones before it
    cs_nd = _at_next_dollar(cs, vl_g)
    early = torch.minimum(hi, cs_nd) > torch.minimum(lo, cs_nd)
    idx = torch.arange(n, dtype=torch.int64, device=run_len.device)
    overflow = idx >= max(n - (k - 1), 0)
    return _pack_flags(~any_bad, overflow | ((vl_g < k) & ~early))


def _no_ambiguous_flags_genome(next_amb, vl_g, k: int):
    """No-ambiguous plane. Bit 1: a '$' comes before any ambiguous base
    (raises); overflow past the array end is checked per row apart (another
    message, checked first)."""
    n = vl_g.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=vl_g.device)
    d = torch.clamp_max(vl_g, k)
    a = torch.clamp_max(next_amb - idx, k)
    return _pack_flags(a >= k, (d < k) & (d < a))


def _crispr_from_ranks(r, g: int):
    n = r.shape[0]
    rpad = torch.cat([r, r.new_zeros(23)])
    return ((rpad[21 : 21 + n] == g) & (rpad[22 : 22 + n] == g)).to(torch.uint8)


def _crispr_flags_genome(packed2):
    """CRISPR NGG plane from 2-bit ranks (G = 2); rows past the end read
    rank 0, as the overflow check raises before the raw-byte read would."""
    return _crispr_from_ranks(_top_rank(packed2, 2), 2)


def _crispr_flags_genome_ranks4(packed):
    """CRISPR NGG plane from 4-bit ranks (G = 5; '$' and past the end 0)."""
    return _crispr_from_ranks(_top_rank(packed, 4), 5)


# --------------------------------------------------------------------------- #
# lanes flags: a filter's (pass, raise) outcome from the retained sorted key
# lanes, the k-mers' content in sorted row order. Field j of word w is base
# offset (bases_per_word * w + j), big-endian within the word; fields at and
# past a row's cap = min(valid_len, built_k) are zero. GC count is a
# popcount of (w ^ w >> 1) & 0x5555... on 2-bit words, ambiguity and
# truncation are nibble tests on 4-bit words, homopolymer runs are
# adjacent-field equality bits.
#
# Each ``*_lanes_flags*`` function returns ``(mask, errs)``, ``errs`` the
# per-row raise conditions in the order the filter's ``check_batch`` tests
# them; ops/groups.fold_err_conditions folds them to the first offending
# row. ``params`` holds Python ints. On a card the GC-content, homopolymer
# and 4-bit no-ambiguous forms are one launch of a hand-written kernel
# (``kernels/lanes_flags.py``, ``_kernel_on_card``) that equals them bit for
# bit; their torch ops are the plain versions, which run for CPU tensors.
# --------------------------------------------------------------------------- #


def _kernel_on_card(kind: str, scalars):
    """Decorator of a lanes-flags function that the kernel computes: tensors
    off the CPU go to ``lanes_flags_cuda(kind, ..., scalars(*params))`` (one
    launch, or a raise), CPU tensors to the decorated torch ops, its plain
    version, which stays reachable as ``fn.__wrapped__``. ``scalars`` maps
    the function's params to the kernel's ``Scalars``; the function keeps
    ``kind`` and ``scalars`` as attributes."""

    def wrap(plain):
        @functools.wraps(plain)
        def flags(words, cap, positions, params):
            if positions.device.type != "cpu":
                return lanes_flags_cuda(kind, words, cap, positions, scalars(*params))
            return plain(words, cap, positions, params)

        flags.kind, flags.scalars = kind, scalars
        return flags

    return wrap


def _gc_scalars(k, min_count, max_count, cap_const, impossible_range):
    return Scalars(k, cap_const=cap_const, lo=min_count, hi=max_count, constant=impossible_range)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _ones_shl(shift: torch.Tensor) -> torch.Tensor:
    """0xFFFFFFFF << shift per row, kept to 32 bits (shift in [0, 31])."""
    return (_U32 << shift) & _U32


def _row_caps(cap, positions, cap_const: int):
    """Per-row compare caps: the retained cap lane, or the uniform constant
    (2-bit uniform-cap lanes carry no cap lane: every cap is built_k)."""
    if cap is not None:
        return cap
    return positions.new_tensor(cap_const).expand(positions.shape)


def _nib_nonzero_bits(y):
    """Bit 0 of each nibble set iff that nibble is nonzero (only shifts
    within a nibble are OR'd, so no borrow between nibbles)."""
    return (y | (y >> 1) | (y >> 2) | (y >> 3)) & 0x11111111


def _nib_match_count(zz, v: int):
    """Number of nibbles of ``zz`` equal to ``v`` (callers set excluded
    nibbles to 0xF, which matches no counted rank)."""
    nz = _nib_nonzero_bits(zz ^ (v * 0x11111111))
    return popcount32(nz ^ 0x11111111)


def _kept4(w, km: int):
    """4-bit word with the fields outside ``km`` set to 0xF."""
    return (w & km) | (~km & _U32)


@_kernel_on_card("gc2", _gc_scalars)
def gc_lanes_flags2(words, cap, positions, params):
    """GC-content filter on 2-bit lanes. params: [k_f, min_count,
    max_count, cap_const, impossible_range]."""
    k, mn, mx, cap_const, impossible = (int(p) for p in params)
    if impossible:
        none = torch.zeros(positions.shape, dtype=torch.bool, device=positions.device)
        return none, (none,)
    gc = torch.zeros(positions.shape, dtype=torch.int64, device=positions.device)
    for i, w in enumerate(words):
        km = keep_mask(k, i, 16, 2)
        if km == 0:
            continue
        ww = widen_u32(w) & km
        # per 2-bit field, b1 ^ b0 == 1 exactly for C (01) and G (10);
        # zeroed fields (past the cap or past k) read as A and add 0
        gc += popcount32(((ww >> 1) ^ ww) & 0x55555555)
    trunc = _row_caps(cap, positions, cap_const) < k
    # the reference scans left to right: a truncated k-mer raises only when
    # its G/C count did not exceed the maximum first
    return ~trunc & (gc >= mn) & (gc <= mx), (trunc & (gc <= mx),)


@_kernel_on_card("gc4", _gc_scalars)
def gc_lanes_flags4(words, cap, positions, params):
    """GC-content filter on 4-bit lanes (C = rank 3, G = rank 5); same
    params as ``gc_lanes_flags2``."""
    del cap  # 4-bit lanes carry termination in-word (zero nibbles)
    k, mn, mx, _, impossible = (int(p) for p in params)
    trunc = torch.zeros(positions.shape, dtype=torch.bool, device=positions.device)
    if impossible:
        return trunc, (trunc,)
    gc = torch.zeros(positions.shape, dtype=torch.int64, device=positions.device)
    for i, w in enumerate(words):
        km = keep_mask(k, i, 8, 4)
        if km == 0:
            continue
        zz = _kept4(widen_u32(w), km)
        gc += _nib_match_count(zz, 3) + _nib_match_count(zz, 5)
        # a zero nibble among the kept fields: the cap falls in the window
        trunc |= _nib_nonzero_bits(zz) != 0x11111111
    return ~trunc & (gc >= mn) & (gc <= mx), (trunc & (gc <= mx),)


def noamb_lanes_flags2(words, cap, positions, params):
    """No-ambiguous filter on 2-bit lanes: the alphabet is ACGT, so only
    truncation matters. params: [k_f, overflow_thr, cap_const]."""
    del words
    k, thr, cap_const = (int(p) for p in params)
    trunc = _row_caps(cap, positions, cap_const) < k
    # a '$' reached before any ambiguous base (there is none) raises
    return ~trunc, (positions >= thr, trunc)


@_kernel_on_card("noamb4", lambda k, thr: Scalars(k, thr=thr))
def noamb_lanes_flags4(words, cap, positions, params):
    """No-ambiguous filter on 4-bit lanes. params: [k_f, overflow_thr]."""
    del cap
    k, thr = (int(p) for p in params)
    trunc = torch.zeros(positions.shape, dtype=torch.bool, device=positions.device)
    amb = torch.zeros_like(trunc)
    for i, w in enumerate(words):
        km = keep_mask(k, i, 8, 4)
        if km == 0:
            continue
        w = widen_u32(w)
        trunc |= _nib_nonzero_bits(_kept4(w, km)) != 0x11111111
        # ambiguous: a kept nibble outside {0 ('$' / past the cap), A=1,
        # C=3, G=5, T=12}; excluded fields are zeroed here, so they are 0
        ww = w & km
        amb_bits = _nib_nonzero_bits(ww)
        for v in (1, 3, 5, 12):
            amb_bits &= _nib_nonzero_bits(ww ^ (v * 0x11111111))
        amb |= amb_bits != 0
    # an ambiguous base found before the '$' fails the k-mer without raising
    return ~trunc & ~amb, (positions >= thr, trunc & ~amb)


def length_lanes_flags(words, cap, positions, params):
    """Length filter (at least min_f bases to the segment end). params:
    [min_f, cap_const], min_f clamped to [0, built_k]."""
    del words
    return _row_caps(cap, positions, int(params[1])) >= int(params[0]), ()


def length_lanes_flags4(words, cap, positions, params):
    """Length filter on 4-bit lanes: cap >= min_f iff no zero nibble among
    the first min_f fields. params: [min_f]."""
    del cap
    mf = int(params[0])
    trunc = torch.zeros(positions.shape, dtype=torch.bool, device=positions.device)
    for i, w in enumerate(words):
        km = keep_mask(mf, i, 8, 4)
        if km:
            trunc |= _nib_nonzero_bits(_kept4(widen_u32(w), km)) != 0x11111111
    return ~trunc, ()


def _compress_even_bits(x):
    """Pack the bits at even positions 0, 2, ..., 30 of ``x`` into bits
    0..15 (the odd-position bits must be 0)."""
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def _shr64(hi, lo, t: int):
    """(hi, lo) >> t for t in [0, 32]: the low t bits of hi move to the top
    of lo."""
    carry = (hi & ((1 << t) - 1)) << (32 - t)
    return hi >> t, (lo >> t) | carry


def _run_fold64(hi, lo, run_len: int):
    """Nonzero iff a run of >= ``run_len`` (1..64) consecutive set bits lies
    in the 64-bit mask (hi, lo): shift-AND with doubling steps capped at 16
    (1+2+4+8+16+16+16 = 63 covers every run_len - 1)."""
    rem = run_len - 1
    for cap_t in (1, 2, 4, 8, 16, 16, 16):
        t = min(cap_t, rem)
        if t == 0:
            break  # the remaining steps shift by 0: no-ops
        h2, l2 = _shr64(hi, lo, t)
        hi, lo = hi & h2, lo & l2
        rem -= t
    return (hi | lo) != 0


def _mask_stream64(hi, lo, m):
    """Keep the eq flags of bases j in [1, m-1] of a 64-bit big-endian
    stream (flag of base j at bit 63 - j); ``m`` is an int or a per-row
    tensor of base counts."""
    if isinstance(m, int):
        lo_keep = (_U32 << min(max(64 - m, 0), 31)) & _U32 if m > 32 else 0
        return hi & ((_U32 << min(max(32 - m, 0), 31)) & _U32), lo & lo_keep
    hi = hi & _ones_shl(torch.clamp(32 - m, 0, 31))
    lo = torch.where(m > 32, lo & _ones_shl(torch.clamp(64 - m, 0, 31)), 0)
    return hi, lo


@_kernel_on_card("homopoly2", lambda k, max_h, cap_const, thr, short_circuit: Scalars(
    k, thr=thr, cap_const=cap_const, max_h=max_h, constant=short_circuit))
def homopoly_lanes_flags2(words, cap, positions, params):
    """Homopolymer filter on 2-bit lanes. params: [k_f, max_h, cap_const,
    overflow_thr, short_circuit].

    Adjacent-base equality becomes one bit a base ((w ^ w >> 2) folded and
    compressed), assembled into a 64-bit big-endian stream (eq flag of base
    j at bit 63 - j, j = 1..k_f-1); a run longer than max_h exists iff
    max_h consecutive flags survive the shift-AND fold. The raise fold runs
    over the flags below each row's truncation point min(k_f, cap), where
    the fields are real: a run that exceeded max_h before the '$' preempts
    the raise."""
    k, max_h, cap_const, thr, short = (int(p) for p in params)
    overflow = positions >= thr
    if short:
        return torch.ones(positions.shape, dtype=torch.bool, device=positions.device), (overflow,)
    halves = []
    prev_w = None
    for w in words:
        w = widen_u32(w)
        e = ~(w ^ (w >> 2)) & _U32
        ebits = e & (e >> 1) & 0x55555555  # bit (30 - 2j) = eq(j, j - 1)
        c = _compress_even_bits(ebits) & 0x7FFF  # bit (15 - j), j = 1..15
        if prev_w is not None:
            c |= ((prev_w & 3) == (w >> 30)).to(torch.int64) << 15
        halves.append(c)
        prev_w = w
    while len(halves) < 4:
        halves.append(torch.zeros_like(halves[0]))
    hi = (halves[0] << 16) | halves[1]
    lo = (halves[2] << 16) | halves[3]
    capv = _row_caps(cap, positions, cap_const)
    # flags of j in [1, k_f - 1] for the mask (runs of zero fields past a
    # row's cap only matter on truncated rows, which never pass)
    run_bad = _run_fold64(*_mask_stream64(hi, lo, k), max_h)
    run_bad_cap = _run_fold64(*_mask_stream64(hi, lo, torch.clamp_max(capv, k)), max_h)
    return ~run_bad, (overflow | ((capv < k) & ~run_bad_cap),)


@_kernel_on_card("homopoly4", lambda k, max_h, thr, short_circuit: Scalars(
    k, thr=thr, max_h=max_h, constant=short_circuit))
def homopoly_lanes_flags4(words, cap, positions, params):
    """Homopolymer filter on 4-bit lanes (built_k <= 32, so the eq stream
    fits 32 bits). params: [k_f, max_h, overflow_thr, short_circuit]. Raise
    semantics as in ``homopoly_lanes_flags2``. A row's cap counts its kept
    nonzero nibbles only; the JAX package also counts the nibbles past
    ``k_f`` (set to 0xF), so on lanes built longer than ``k_f`` a truncated
    row's raise can be missed there (ROADMAP.md §C2)."""
    del cap
    k, max_h, thr, short = (int(p) for p in params)
    overflow = positions >= thr
    if short:
        return torch.ones(positions.shape, dtype=torch.bool, device=positions.device), (overflow,)
    trunc = torch.zeros(positions.shape, dtype=torch.bool, device=positions.device)
    capv = torch.zeros(positions.shape, dtype=torch.int64, device=positions.device)
    e = torch.zeros_like(capv)
    prev_w = None
    for i, w in enumerate(words):
        w = widen_u32(w)
        keep = keep_mask(k, i, 8, 4)
        nz = _nib_nonzero_bits(_kept4(w, keep))
        trunc |= nz != 0x11111111
        capv += popcount32(nz & keep & 0x11111111)
        eqnib = _nib_nonzero_bits(w ^ (w >> 4)) ^ 0x11111111  # bit (28 - 4j)
        c = _compress_even_bits(_compress_even_bits(eqnib)) & 0x7F  # bit (7 - j)
        if prev_w is not None:
            c |= ((prev_w & 0xF) == (w >> 28)).to(torch.int64) << 7
        e |= c << (24 - 8 * i)
        prev_w = w

    def fold32(x):
        rem = max_h - 1
        for cap_t in (1, 2, 4, 8, 16):
            t = min(cap_t, rem)
            if t == 0:
                break
            x = x & (x >> t)
            rem -= t
        return x != 0

    run_bad = fold32(e & ((_U32 << min(max(32 - k, 0), 31)) & _U32))
    # raise preemption: the flags below each row's truncation point only
    run_bad_cap = fold32(e & _ones_shl(torch.clamp(32 - capv, 0, 31)))
    return ~run_bad, (overflow | (trunc & ~run_bad_cap),)


def crispr_lanes_flags2(words, cap, positions, params):
    """CRISPR NGG PAM on 2-bit lanes: bases +21/+22 are fields 5 and 6 of
    word 1. Exact only when every row's cap covers 23 bases (the caller's
    gate). params: [overflow_thr]."""
    del cap
    w1 = widen_u32(words[1])
    mask = (((w1 >> 20) & 3) == 2) & (((w1 >> 18) & 3) == 2)
    return mask, (positions >= int(params[0]),)


def crispr_lanes_flags4(words, cap, positions, params):
    """CRISPR NGG PAM on 4-bit lanes: bases +21/+22 are fields 5 and 6 of
    word 2 (8 bases a word); G = rank 5. Same gate as the 2-bit form."""
    del cap
    w2 = widen_u32(words[2])
    mask = (((w2 >> 8) & 0xF) == 5) & (((w2 >> 4) & 0xF) == 5)
    return mask, (positions >= int(params[0]),)


def _overflow_thr(sba_len: int, last_offset: int) -> int:
    """Threshold t with (pos >= t) == (pos + last_offset >= sba_len) for
    every real position: the lanes form of ``_overflow_cond``."""
    return max(sba_len - last_offset, 0)


def flag_plane(scans, key, build):
    """A filter's genome-order flag plane on a scans provider (the
    SequenceCollection device cache), built once and cached there; None
    when the provider keeps no planes."""
    if scans is None:
        return None
    store = getattr(scans, "filter_flags", None)
    if store is None:
        return None
    if key not in store:
        store[key] = build(scans)
    return store[key]


def _genome_flags(ctx: FilterContext, key, build):
    """The cached flag plane gathered at ctx.positions, or None when the
    context has no device cache. The gathered rows memoize on the context
    (check_batch and mask_pure share them)."""
    hit = getattr(ctx, "_flags_rows_cache", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    plane = flag_plane(ctx._scans, key, build)
    if plane is None:
        return None
    rows = plane[ctx.positions]
    ctx._flags_rows_cache = (key, rows)
    return rows


def _first_row(cond: torch.Tensor) -> torch.Tensor:
    """Index of the first True row (0 when there is none), as a 0-d tensor:
    torch's argmax takes no bool tensor."""
    return torch.argmax(cond.to(torch.uint8))


def _first_true_pos(ctx: FilterContext, cond):
    """Position of the first valid row (in index order) satisfying
    ``cond``, or None: one scalar read when no row does, one more when one
    does."""
    cond = ctx._rows(cond)
    if not bool(torch.any(cond)):
        return None
    return int(ctx.positions[_first_row(cond)])


def _first_offender(ctx: FilterContext, conds):
    """(condition index, position) of the first row in index (walk) order
    that trips any of ``conds``, or None. Ties at one row go to the
    earlier-listed condition, the scalar filter's check order: the
    reference's walk raises at the first offending row, not at the
    highest-priority condition over the batch."""
    conds = [ctx._rows(cond) for cond in conds]
    combined = conds[0]
    for cond in conds[1:]:
        combined = combined | cond
    if not bool(torch.any(combined)):
        return None
    i = _first_row(combined)
    pos = int(ctx.positions[i])
    for ci, cond in enumerate(conds):
        if bool(cond[i]):
            return ci, pos
    return len(conds) - 1, pos  # unreachable: combined[i] is True


def _overflow_cond(ctx: FilterContext, last_offset: int):
    """Rows with position + last_offset >= sba_len."""
    return ctx.positions >= max(ctx.sba_len - last_offset, 0)


class KmerFilter:
    """Base class: a filter usable per k-mer (the reference's signature) and
    as a mask over a batch of positions.

    ``batch_mask`` = ``check_batch`` (may raise the reference's ValueError)
    + ``mask_pure`` (the bool mask, on the positions' device). ``batchable``
    marks, as in the JAX package, a filter that takes a whole batch; every
    subclass inherits it."""

    batchable = True

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        raise NotImplementedError

    def check_batch(self, ctx: FilterContext) -> None:
        """Raise the reference's ValueError if any row is invalid."""
        return None

    def mask_pure(self, ctx: FilterContext):
        raise NotImplementedError

    def batch_mask(self, ctx: FilterContext):
        self.check_batch(ctx)
        return self.mask_pure(ctx)

    def _plane_spec(self):
        """(cache key, scans -> uint8 plane build function) of this filter's
        genome-order flag plane, or None when it has none."""
        return None

    def _flags(self, ctx):
        spec = self._plane_spec()
        if spec is None:
            return None
        return _genome_flags(ctx, spec[0], spec[1])

    def lanes_spec(self, lanes, sba_len: int, index_min_kmer_len: int):
        """(flags_fn, params, msg_makers) evaluating this filter on retained
        sorted key lanes (the lanes-flags section), or None when these lanes
        cannot express it. ``flags_fn(words, cap, positions, params) ->
        (mask, errs)``; ``msg_makers`` holds one ``pos -> message`` callable
        for each entry of errs, in check order."""
        return None


class KeepAllFilter(KmerFilter):
    """Keeps every k-mer (reference kmers.py:14-16)."""

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return True

    def mask_pure(self, ctx):
        return torch.ones(ctx.positions.shape[0], dtype=torch.bool, device=ctx.positions.device)


kmer_filter_keep_all = KeepAllFilter()


def _scalar_valid_len(sba, start):
    """Bases from start to the segment end, scanning for '$' (host)."""
    n = len(sba)
    i = start
    while i < n and sba[i] != _DOLLAR:
        i += 1
    return i - start


class LengthFilter(KmerFilter):
    """Passes iff the k-mer has at least min_kmer_len bases before the
    segment end (reference kmers.py:19-34 via kmers.py:262-282)."""

    def __init__(self, min_kmer_len: int):
        self.min_kmer_len = min_kmer_len

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        return kmer_has_required_len(sba, kmer_sba_start_idx, self.min_kmer_len)

    def mask_pure(self, ctx):
        return ctx.valid_len >= max(self.min_kmer_len, 0)

    def lanes_spec(self, lanes, sba_len, index_min_kmer_len):
        mf = max(self.min_kmer_len, 0)
        if mf > lanes["built_k"]:
            return None
        if lanes["two_bit"]:
            return length_lanes_flags, (mf, lanes["built_k"]), ()
        return length_lanes_flags4, (mf,), ()


def gen_kmer_length_filter_func(min_kmer_len: int) -> LengthFilter:
    """Reference kmers.py:19-34."""
    return LengthFilter(min_kmer_len)


def _too_large(k: int, pos) -> str:
    return f"The kmer_len ({k}) requested is too large for kmer_sba_start_idx ({pos})"


class HomopolymerFilter(KmerFilter):
    """Passes iff no homopolymer longer than max_homopolymer_size lies
    within the k-mer window (reference kmers.py:37-100)."""

    def __init__(self, max_homopolymer_size: int, kmer_len: int):
        if max_homopolymer_size < 1:
            raise ValueError(
                f"max_homopolymer_size ({max_homopolymer_size}) must be >= 1"
            )
        if kmer_len < 1:
            raise ValueError(f"kmer_len ({kmer_len}) must be >= 1")
        self.max_homopolymer_size = max_homopolymer_size
        self.kmer_len = kmer_len

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        k, max_h = self.kmer_len, self.max_homopolymer_size
        if kmer_sba_start_idx + k - 1 >= len(sba):
            raise ValueError(_too_large(k, kmer_sba_start_idx))
        if k < max_h:
            return True
        size = 1
        for j in range(1, k):
            idx = kmer_sba_start_idx + j
            if sba[idx] == _DOLLAR:
                raise ValueError(_too_large(k, kmer_sba_start_idx))
            if sba[idx] == sba[idx - 1]:
                size += 1
                if size > max_h:
                    return False
            else:
                size = 1
        return True

    def _plane_spec(self):
        k, max_h = self.kmer_len, self.max_homopolymer_size
        if k < max_h:
            return None
        return ("homopoly", k, max_h), lambda sc: _homopolymer_flags_genome(
            sc.run_len, sc.valid_len_genome, k, max_h
        )

    def check_batch(self, ctx):
        k, max_h = self.kmer_len, self.max_homopolymer_size
        # overflow past the array end always raises; a '$' inside the window
        # raises only when k >= max_h (shorter k-mers return True before the
        # '$' scan) and no run exceeded max_h before the '$' (the
        # left-to-right scan returns False first); one message for both
        if k < max_h:
            cond = _overflow_cond(ctx, k - 1)
        else:
            fl = self._flags(ctx)
            if fl is not None:
                cond = (fl & 2) != 0
            else:
                cs = _prefix_count(ctx.run_len > max_h)
                pos = ctx.positions
                d = torch.clamp_max(ctx.valid_len, k)
                early = _windowed_any(cs, pos + max_h, pos + d - 1)
                cond = _overflow_cond(ctx, k - 1) | ((ctx.valid_len < k) & ~early)
        bad = _first_true_pos(ctx, cond)
        if bad is not None:
            raise ValueError(_too_large(k, bad))

    def mask_pure(self, ctx):
        k, max_h = self.kmer_len, self.max_homopolymer_size
        if k < max_h:
            return torch.ones(ctx.positions.shape[0], dtype=torch.bool, device=ctx.positions.device)
        fl = self._flags(ctx)
        if fl is not None:
            return (fl & 1) != 0
        return _homopolymer_mask(ctx.run_len, ctx.positions, k, max_h)

    def lanes_spec(self, lanes, sba_len, index_min_kmer_len):
        k, max_h = self.kmer_len, self.max_homopolymer_size
        if k < 1 or k > lanes["built_k"]:
            return None
        short = 1 if k < max_h else 0
        mh = min(max_h, 65)  # short-circuit rows never reach the fold
        thr = _overflow_thr(sba_len, k - 1)
        if lanes["two_bit"]:
            fn, params = homopoly_lanes_flags2, (k, mh, lanes["built_k"], thr, short)
        else:
            fn, params = homopoly_lanes_flags4, (k, mh, thr, short)
        return fn, params, (lambda pos: _too_large(k, pos),)


def _windowed_any(flags_cumsum, lo, hi):
    """Any flag in the index window [lo, hi] (inclusive), given the prefix
    count of the flags (length n + 1)."""
    n = flags_cumsum.shape[0] - 1
    hi_c = torch.clamp_max(hi + 1, n)
    lo_c = torch.minimum(lo, hi_c)
    return (flags_cumsum[hi_c] - flags_cumsum[lo_c]) > 0


def _homopolymer_mask(run_len, positions, kmer_len, max_h):
    # a run longer than max_h lies wholly inside [p, p + k - 1] iff some i in
    # [p + max_h, p + k - 1] has run_len[i] > max_h
    if kmer_len - 1 < max_h:  # empty window: cannot fail
        return torch.ones(positions.shape[0], dtype=torch.bool, device=positions.device)
    cs = _prefix_count(run_len > max_h)
    return ~_windowed_any(cs, positions + max_h, positions + (kmer_len - 1))


def gen_kmer_homopolymer_filter_func(max_homopolymer_size: int, kmer_len: int) -> HomopolymerFilter:
    """Reference kmers.py:37-100."""
    return HomopolymerFilter(max_homopolymer_size, kmer_len)


def _too_larger(k: int, pos) -> str:
    # "too larger" is the reference's message, kept verbatim
    return f"The kmer_len ({k}) requested is too larger for kmer_sba_start_idx ({pos})"


class GcContentFilter(KmerFilter):
    """Passes iff the GC fraction is within [min, max] (reference
    kmers.py:103-192)."""

    def __init__(self, min_allowed_gc_frac: float, max_allowed_gc_frac: float, kmer_len: int):
        if min_allowed_gc_frac > max_allowed_gc_frac:
            raise ValueError(
                f"min_allowed_gc_frac ({min_allowed_gc_frac}) must be <= max_allowed_gc_frac ({max_allowed_gc_frac})"
            )
        if min_allowed_gc_frac < 0.0 or min_allowed_gc_frac > 1.0:
            raise ValueError(
                f"min_allowed_gc_frac ({min_allowed_gc_frac}) must be in the range [0.0, 1.0]"
            )
        if max_allowed_gc_frac < 0.0 or max_allowed_gc_frac > 1.0:
            raise ValueError(
                f"max_allowed_gc_frac ({max_allowed_gc_frac}) must be in the range [0.0, 1.0]"
            )
        self.kmer_len = kmer_len
        self.min_allowed_gc_count = int(math.ceil(kmer_len * min_allowed_gc_frac))
        self.max_allowed_gc_count = int(math.floor(kmer_len * max_allowed_gc_frac))

    def _impossible(self) -> bool:
        return self.max_allowed_gc_count < self.min_allowed_gc_count

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        if self._impossible():
            return False
        count = 0
        for j in range(self.kmer_len):
            idx = kmer_sba_start_idx + j
            if idx >= len(sba) or sba[idx] == _DOLLAR:
                raise ValueError(_too_larger(self.kmer_len, kmer_sba_start_idx))
            if sba[idx] == ord("G") or sba[idx] == ord("C"):
                count += 1
                if count > self.max_allowed_gc_count:
                    return False
        return self.min_allowed_gc_count <= count <= self.max_allowed_gc_count

    def _gc_window(self, ctx):
        """(G/C count over min(valid_len, k) bases, truncated flag), memoized
        on the context: check_batch and mask_pure share its two gathers."""
        k = self.kmer_len
        cached = getattr(ctx, "_gc_window_cache", None)
        if cached is not None and cached[0] == k:
            return cached[1]
        pos, vl, gc = ctx.positions, ctx.valid_len, ctx.gc_cumsum
        d = torch.clamp_max(vl, k)
        out = (gc[pos + d] - gc[pos], vl < k)
        ctx._gc_window_cache = (k, out)
        return out

    def _plane_spec(self):
        k, mn, mx = self.kmer_len, self.min_allowed_gc_count, self.max_allowed_gc_count
        return ("gc", k, mn, mx), lambda sc: _gc_flags_genome(
            sc.gc_cumsum, sc.valid_len_genome, mn, mx, k
        )

    def check_batch(self, ctx):
        if self._impossible():
            return
        # a k-mer that reaches a '$' or the array end raises only if its G/C
        # count did not exceed the maximum first (left-to-right scan)
        fl = self._flags(ctx)
        if fl is not None:
            raises = (fl & 2) != 0
        else:
            gc_before_end, truncated = self._gc_window(ctx)
            raises = truncated & (gc_before_end <= self.max_allowed_gc_count)
        bad = _first_true_pos(ctx, raises)
        if bad is not None:
            raise ValueError(_too_larger(self.kmer_len, bad))

    def mask_pure(self, ctx):
        if self._impossible():
            return torch.zeros(ctx.positions.shape[0], dtype=torch.bool, device=ctx.positions.device)
        fl = self._flags(ctx)
        if fl is not None:
            return (fl & 1) != 0
        count, truncated = self._gc_window(ctx)  # the full window's count where not truncated
        return (
            ~truncated
            & (count >= self.min_allowed_gc_count)
            & (count <= self.max_allowed_gc_count)
        )

    def lanes_spec(self, lanes, sba_len, index_min_kmer_len):
        k = self.kmer_len
        if k < 1 or k > lanes["built_k"]:
            return None
        params = (
            k,
            max(self.min_allowed_gc_count, 0),
            max(self.max_allowed_gc_count, 0),
            lanes["built_k"],
            int(self._impossible()),
        )
        fn = gc_lanes_flags2 if lanes["two_bit"] else gc_lanes_flags4
        return fn, params, (lambda pos: _too_larger(k, pos),)


def gen_kmer_gc_content_filter_func(
    min_allowed_gc_frac: float, max_allowed_gc_frac: float, kmer_len: int
) -> GcContentFilter:
    """Reference kmers.py:103-192."""
    return GcContentFilter(min_allowed_gc_frac, max_allowed_gc_frac, kmer_len)


def _beyond_sba(k: int) -> str:
    return f"kmer_len ({k}) is invalid. It extends beyond len(sba)"


def _end_of_segment(k: int) -> str:
    return f"end of segment was reached. kmer_len ({k}) invalid."


class NoAmbiguousBasesFilter(KmerFilter):
    """Passes iff only A/C/G/T lie within the k-mer (reference
    kmers.py:195-229)."""

    def __init__(self, kmer_len: int):
        self.kmer_len = kmer_len

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        k = self.kmer_len
        if kmer_sba_start_idx + k > len(sba):
            raise ValueError(_beyond_sba(k))
        for j in range(k):
            base = sba[kmer_sba_start_idx + j]
            if base == _DOLLAR:
                raise ValueError(_end_of_segment(k))
            if base not in _ACGT:
                return False
        return True

    def _amb_offsets(self, ctx):
        """(offset of the first '$' in the window, k if none; offset of the
        first ambiguous base in it, k if none), memoized on the context."""
        k = self.kmer_len
        cached = getattr(ctx, "_amb_offsets_cache", None)
        if cached is not None and cached[0] == k:
            return cached[1]
        pos = ctx.positions
        d = torch.clamp_max(ctx.valid_len, k)
        a = torch.clamp_max(ctx.next_amb[pos] - pos, k)
        out = (d, a)
        ctx._amb_offsets_cache = (k, out)
        return out

    def _plane_spec(self):
        k = self.kmer_len
        return ("noamb", k), lambda sc: _no_ambiguous_flags_genome(
            sc.next_amb, sc.valid_len_genome, k
        )

    def check_batch(self, ctx):
        k = self.kmer_len
        if not ctx.positions.shape[0]:
            return
        # a '$' found before an ambiguous base raises; an ambiguous base
        # found first fails the k-mer. The first offending row in walk order
        # raises, and at one row the overflow check comes first.
        overflow = _overflow_cond(ctx, k - 1)
        fl = self._flags(ctx)
        if fl is not None:
            seg = (fl & 2) != 0
        else:
            d, a = self._amb_offsets(ctx)
            seg = (d < k) & (d < a)
        hit = _first_offender(ctx, (overflow, seg))
        if hit is not None:
            raise ValueError(_beyond_sba(k) if hit[0] == 0 else _end_of_segment(k))

    def mask_pure(self, ctx):
        fl = self._flags(ctx)
        if fl is not None:
            return (fl & 1) != 0
        _, a = self._amb_offsets(ctx)
        return a >= self.kmer_len

    def lanes_spec(self, lanes, sba_len, index_min_kmer_len):
        k = self.kmer_len
        if k < 1 or k > lanes["built_k"]:
            return None
        thr = _overflow_thr(sba_len, k - 1)
        if lanes["two_bit"]:
            fn, params = noamb_lanes_flags2, (k, thr, lanes["built_k"])
        else:
            fn, params = noamb_lanes_flags4, (k, thr)
        return fn, params, (lambda pos: _beyond_sba(k), lambda pos: _end_of_segment(k))


def gen_no_ambiguous_bases_filter(kmer_len: int) -> NoAmbiguousBasesFilter:
    """Reference kmers.py:195-229."""
    return NoAmbiguousBasesFilter(kmer_len)


_GUIDE_BEYOND = "The guide defined at this start index extends beyond the sba"


class CrisprNggPamFilter(KmerFilter):
    """Passes for 23-mers ending in GG, the SpyCas9 NGG PAM at offsets
    +21/+22 (reference kmers.py:232-259). Reads raw bytes with no '$' check,
    as the reference does."""

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        if kmer_sba_start_idx + 23 > len(sba):
            raise ValueError(_GUIDE_BEYOND)
        return sba[kmer_sba_start_idx + 21] == ord("G") and sba[
            kmer_sba_start_idx + 22
        ] == ord("G")

    def check_batch(self, ctx):
        if ctx.positions.shape[0] and bool(torch.any(ctx._rows(_overflow_cond(ctx, 22)))):
            raise ValueError(_GUIDE_BEYOND)

    def _plane_spec(self):
        def build(sc):
            # the packs carry each base's identity ('$' and past the end are
            # rank 0, not G: the same outcome as the raw-byte read, whose
            # out-of-range rows raise in check_batch first); 2-bit on ACGT
            # genomes, 4-bit on the others
            if sc.packed2 is not None:
                return _crispr_flags_genome(sc.packed2)
            return _crispr_flags_genome_ranks4(sc.packed)

        return ("crispr",), build

    def mask_pure(self, ctx):
        fl = self._flags(ctx)
        if fl is not None:
            return (fl & 1) != 0
        pos = ctx.positions
        last = ctx.sba_len - 1  # rows past the end raised in check_batch
        b21 = ctx.sba[torch.clamp_max(pos + 21, last)]
        b22 = ctx.sba[torch.clamp_max(pos + 22, last)]
        return (b21 == ord("G")) & (b22 == ord("G"))

    def lanes_spec(self, lanes, sba_len, index_min_kmer_len):
        # the reference reads raw bytes at +21/+22 with no '$' check, so a
        # window across a segment end can match the next segment's bases;
        # lanes zero the fields past the cap, so they are exact only when
        # every row's cap covers 23 bases: index min_kmer_len >= 23 (every
        # row has valid_len >= min_kmer_len) and built_k >= 23
        if index_min_kmer_len < 23 or lanes["built_k"] < 23:
            return None
        # valid_len >= min_kmer_len holds by construction but not after an
        # assignment to kmer_sba_start_indices: the index checks it against
        # the data on demand (Kmers._cap_covers_min_k), and rows whose cap
        # falls short take the plane route instead
        check = lanes.get("cap_cover_check")
        if check is not None and not check():
            return None
        fn = crispr_lanes_flags2 if lanes["two_bit"] else crispr_lanes_flags4
        return fn, (_overflow_thr(sba_len, 22),), (lambda pos: _GUIDE_BEYOND,)


crispr_ngg_pam_filter = CrisprNggPamFilter()


def kmer_has_required_len(sba, sba_start_idx, min_kmer_len) -> bool:
    """Scalar version of reference kmers.py:262-282."""
    for idx in range(sba_start_idx, sba_start_idx + min_kmer_len):
        if idx >= len(sba) or sba[idx] == _DOLLAR:
            return False
    return True


class VectorizedFilter(KmerFilter):
    """A custom filter as one mask over tensors: the fast path for filters
    that are not the library's.

    The reference's only custom-filter contract is a scalar callable
    ``(sba, sba_strand, kmer_sba_start_idx) -> bool``, which the engine can
    honour only with a per-position host loop. Written as one tensor
    expression, the same decision runs on the device like the library
    filters::

        f = VectorizedFilter(
            lambda sba, positions, valid_len: sba[positions] == ord("A")
        )
        km.get_kmer_count(k, kmer_filter_func=f)

    ``mask_fn(sba, positions, valid_len) -> bool tensor`` receives torch
    tensors on the index's device: the SBA as uint8 bytes, the k-mer start
    positions and the bases to the segment end as int64. This is the one
    difference from the JAX package's ``VectorizedFilter``, whose
    ``mask_fn`` takes jax arrays (uint32 positions and lengths). An optional
    ``check_fn(ctx)`` may raise first; an optional ``scalar_fn`` with the
    reference signature gives ``__call__``, which otherwise evaluates the
    mask at the one position.
    """

    def __init__(self, mask_fn, scalar_fn=None, check_fn=None):
        self._mask_fn = mask_fn
        self._scalar_fn = scalar_fn
        self._check_fn = check_fn

    def __call__(self, sba, sba_strand, kmer_sba_start_idx) -> bool:
        if self._scalar_fn is not None:
            return bool(self._scalar_fn(sba, sba_strand, kmer_sba_start_idx))
        sba_np = np.ascontiguousarray(sba, dtype=np.uint8)
        pos = torch.tensor([kmer_sba_start_idx], dtype=torch.int64)
        vl = torch.tensor([_scalar_valid_len(sba_np, kmer_sba_start_idx)], dtype=torch.int64)
        return bool(self._mask_fn(torch.from_numpy(sba_np), pos, vl)[0])

    def check_batch(self, ctx: FilterContext) -> None:
        if self._check_fn is not None:
            self._check_fn(ctx)

    def mask_pure(self, ctx: FilterContext):
        return self._mask_fn(ctx.sba, ctx.positions, ctx.valid_len)
