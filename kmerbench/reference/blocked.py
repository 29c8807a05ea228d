"""The plain reference of ``kmers_ref.py`` in blocks of rows, on any devices:
for an index too large to check on the host at once (the whole human genome:
3.1e9 rows, whose host check would hold int64 windows, positions and words
of every row, 150-200 GB).

It gives the same exact counts as ``kmers_ref.check_index`` and
``kmers_ref.group_counts`` (rows outside the SBA, too short, repeated or
missing; adjacent pairs out of order; the group-size histogram and its
total), and the same fingerprint control, with no sampling. The rows are
cut into blocks of ``BLOCK_ROWS``; each block is worked out on one of the
devices (``devices()``: every visible CUDA card, else the CPU), one thread
a device, and the pairs and groups that cross a block's edge are stitched:
a block reads the row before it, and the groups' open ends are joined on
the host in block order.

Words are built here from the SBA bytes with ``kmers_ref``'s codes and
widths (``B`` bases of ``bits`` bits a word): every device holds the
windows of every position (``windows``), built chunk by chunk. Valid
lengths come from the record table. It imports nothing of the program, of
the JAX package or of JAX.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kmerbench.reference import kmers_ref as ref

I64 = torch.int64
BLOCK_ROWS = 1 << 27  # rows a block (the tests make them small)
CHUNK = 1 << 27  # positions a chunk of the windows build and the position scans
DEVICES = None  # the devices of the check; None: every visible card, else the CPU


def devices() -> list:
    if DEVICES is not None:
        return [torch.device(d) for d in DEVICES]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _on_devices(fn, jobs: list, devs: list) -> list:
    """``fn(device, job)`` for every job, job j on device ``j % len(devs)``,
    one thread a device; the results in job order."""
    def worker(d):
        return [(j, fn(devs[d], jobs[j])) for j in range(d, len(jobs), len(devs))]

    out = [None] * len(jobs)
    with ThreadPoolExecutor(len(devs)) as pool:
        for results in pool.map(worker, range(len(devs))):
            for j, value in results:
                out[j] = value
    return out


def _blocks(n: int) -> list:
    return [(a, min(a + BLOCK_ROWS, n)) for a in range(0, n, BLOCK_ROWS)]


class Genome:
    """The reference's view of the records (``kmers_ref.Genome``'s SBA,
    codes and word widths), with the windows kept on each device."""

    def __init__(self, records):
        self.names = [name for name, _ in records]
        self.lengths = np.array([len(b) for _, b in records], dtype=np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lengths[:-1] + 1)]).astype(np.int64)
        self.n = int(self.lengths.sum()) + len(records) - 1
        sba = np.full(self.n, ref.DOLLAR, dtype=np.uint8)
        for s, (_, bases) in zip(self.starts, records):
            sba[s:s + len(bases)] = bases
        self.sba = sba
        present = np.flatnonzero(np.bincount(sba, minlength=256))
        symbols = [int(b) for b in present if b != ref.DOLLAR]
        codes = np.zeros(256, dtype=np.int64)
        codes[symbols] = np.arange(1, len(symbols) + 1)
        self.codes = codes
        self.acgt_only = set(symbols) <= set(ref.ACGT.tolist())
        self.bits = max(1, len(symbols).bit_length())
        self.B = 63 // self.bits
        self.masks = [((1 << (self.bits * r)) - 1) << (self.bits * (self.B - r))
                      for r in range(self.B + 1)]
        self.devices = devices()
        # each device's state, built before any block runs (one thread a device)
        cards = list(dict.fromkeys(self.devices))
        self._state = dict(zip(cards, _on_devices(lambda dev, _: self._build(dev), cards, cards)))

    def kmer_count(self, min_len: int) -> int:
        return int(np.maximum(self.lengths - min_len + 1, 0).sum())

    def _build(self, dev) -> dict:
        """The device's windows (W[i] = codes of bases i .. i+B-1, big-endian,
        0 past the end, padded with B zeros), record starts and ends."""
        B, bits, n = self.B, self.bits, self.n
        codes = torch.from_numpy(self.codes).to(dev)
        windows = torch.zeros(n + B, dtype=I64, device=dev)
        for a in range(0, n, CHUNK):
            b = min(a + CHUNK, n)
            piece = torch.zeros(b - a + B, dtype=I64, device=dev)
            raw = torch.from_numpy(self.sba[a:min(b + B, n)]).to(dev)
            piece[: raw.shape[0]] = codes[raw.to(I64)]
            windows[a:b] = _pack(piece, B, bits)[: b - a]
            del piece, raw
        return {
            "windows": windows,
            "starts": torch.from_numpy(self.starts).to(dev),
            "ends": torch.from_numpy(self.starts + self.lengths).to(dev),
            "masks": torch.tensor(self.masks, dtype=I64, device=dev),
        }

    def on(self, dev) -> dict:
        return self._state[dev]

    def valid_len(self, st: dict, p: torch.Tensor) -> torch.Tensor:
        """Bases from each position (inside the SBA) to its record's end; 0
        at a separator."""
        r = torch.searchsorted(st["starts"], p, right=True) - 1
        return torch.clamp_min(st["ends"][r] - p, 0)

    def cut(self, st: dict, w: torch.Tensor, offset: int, cap) -> torch.Tensor:
        """``kmers_ref.Genome.cut``: the places at and past ``cap`` set to 0."""
        if isinstance(cap, int):
            keep = min(max(cap - offset, 0), self.B)
            return w if keep == self.B else w & self.masks[keep]
        return w & st["masks"][torch.clamp(cap - offset, 0, self.B)]

    def row_word(self, st: dict, p: torch.Tensor, offset: int, cap) -> torch.Tensor:
        at = torch.clamp_max(p + offset, self.n + self.B - 1)
        return self.cut(st, st["windows"][at], offset, cap)


def _pack(piece: torch.Tensor, B: int, bits: int) -> torch.Tensor:
    """``kmers_ref.Genome.windows``' doubling over one padded chunk of codes."""
    size = piece.shape[0]
    result = torch.zeros_like(piece)
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
    return result


def _rows(pos: np.ndarray, a: int, b: int, dev) -> torch.Tensor:
    """Rows ``a .. b-1`` of the host index as int64 on ``dev``."""
    block = pos[a:b]
    if block.dtype == np.uint32:
        return torch.from_numpy(block.view(np.int32)).to(dev).to(I64) & 0xFFFFFFFF
    return torch.from_numpy(np.ascontiguousarray(block, dtype=np.int64)).to(dev)


class Index:
    """A sorted index in blocks: the host positions, and each statistic at
    each ``k`` worked out once."""

    def __init__(self, g: Genome, pos: np.ndarray, max_len):
        self.g, self.pos, self.max_len = g, pos, max_len
        self.n = int(pos.shape[0])
        self._sizes = {}

    def caps(self, st, p):
        vl = self.g.valid_len(st, p)
        return vl if self.max_len is None else torch.clamp_max(vl, self.max_len)

    def group_counts(self, k: int):
        """(histogram, total) of ``kmers_ref.group_counts(ix, k)``."""
        if k not in self._sizes:
            summaries = _on_devices(lambda dev, blk: _group_block(self, dev, blk, k),
                                    _blocks(self.n), self.g.devices)
            self._sizes[k] = _stitch(summaries)
        return self._sizes[k]


def _same(ix: Index, st: dict, p: torch.Tensor, cap: torch.Tensor, k: int) -> torch.Tensor:
    """same[i]: rows i and i + 1 of ``p`` agree on their first k bases."""
    g = ix.g
    ck = torch.clamp_max(cap, k)
    same = torch.ones(max(p.shape[0] - 1, 0), dtype=torch.bool, device=p.device)
    for offset in range(0, k, g.B):
        w = g.row_word(st, p, offset, ck)
        same &= w[1:] == w[:-1]
    return same


def _group_block(ix: Index, dev, blk, k: int):
    """(rows before the block's first group start, rows from its last start
    to its end or None without a start, histogram and sum of the groups
    that start and end inside it)."""
    a, b = blk
    g = ix.g
    st = g.on(dev)
    lo = max(a - 1, 0)
    p = _rows(ix.pos, lo, b, dev)
    same = _same(ix, st, p, ix.caps(st, p), k)
    if a == 0:  # row 0 starts a group
        same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), same])
    starts = torch.nonzero(~same).flatten()  # relative to a
    if starts.numel() == 0:
        return b - a, None, None, 0
    sizes = starts[1:] - starts[:-1]
    hist = torch.bincount(torch.clamp_max(sizes, ref.MAX_COUNTS_BIN),
                          minlength=ref.MAX_COUNTS_BIN + 1).cpu()
    first, last = int(starts[0]), int(starts[-1])
    return first, (b - a) - last, hist, last - first


def _stitch(summaries: list):
    """The histogram and total over every block's summary, in block order."""
    hist = torch.zeros(ref.MAX_COUNTS_BIN + 1, dtype=I64)
    total, open_size = 0, 0
    for head, tail, block_hist, block_sum in summaries:
        open_size += head
        if tail is None:
            continue
        if open_size:
            hist[min(open_size, ref.MAX_COUNTS_BIN)] += 1
            total += open_size
        hist += block_hist
        total += block_sum
        open_size = tail
    if open_size:
        hist[min(open_size, ref.MAX_COUNTS_BIN)] += 1
        total += open_size
    return hist.numpy(), total


# --------------------------------------------------------------------------- #
# the index check
# --------------------------------------------------------------------------- #


def _check_block(ix: Index, dev, blk, min_len: int, mark: dict):
    """(outside, too short, pairs out of order) of rows ``a .. b-1`` (the
    pairs that end in them), marking their positions in the device's
    ``mark``."""
    a, b = blk
    g = ix.g
    st = g.on(dev)
    lo = max(a - 1, 0)
    raw = _rows(ix.pos, lo, b, dev)
    own = raw[a - lo:]
    outside = int(((own < 0) | (own >= g.n)).sum())
    p = torch.clamp(raw, 0, g.n - 1)
    cap = ix.caps(st, p)
    too_short = int((g.valid_len(st, p[a - lo:]) < min_len).sum())
    mark[dev][p[a - lo:]] = True  # threads that share a device set the same bytes
    if p.shape[0] < 2:
        return outside, too_short, 0
    B = g.B
    w = g.row_word(st, p, 0, cap)
    bad, tied = ref._pair_verdict(w[:-1], w[1:], cap[:-1], cap[1:], p[:-1], p[1:], 0, B)
    del w
    active = torch.nonzero(tied).flatten()
    offset = B
    while active.numel():
        pa, pb = p[active], p[active + 1]
        ca, cb = cap[active], cap[active + 1]
        wa, wb = g.row_word(st, pa, offset, ca), g.row_word(st, pb, offset, cb)
        more, tied = ref._pair_verdict(wa, wb, ca, cb, pa, pb, offset, B)
        bad += more
        active = active[tied]
        offset += B
    return outside, too_short, bad


def check_index(g: Genome, pos: np.ndarray, min_len: int, max_len):
    """``kmers_ref.check_index`` in blocks: (counts, the ``Index`` over
    ``pos``, None where a row lies outside the SBA)."""
    rows = int(pos.shape[0])
    out = {"rows": rows, "outside": 0, "too_short": 0, "duplicates": 0, "missing": 0,
           "unordered_pairs": 0}
    ix = Index(g, pos, max_len)
    mark = {dev: torch.zeros(g.n, dtype=torch.bool, device=dev) for dev in g._state}
    parts = _on_devices(lambda dev, blk: _check_block(ix, dev, blk, min_len, mark),
                        _blocks(rows), g.devices)
    out["outside"] = sum(o for o, _, _ in parts)
    if out["outside"]:
        out["unordered_pairs"] = max(rows - 1, 0)
        return out, None
    out["too_short"] = sum(t for _, t, _ in parts)
    out["unordered_pairs"] = sum(u for _, _, u in parts)
    dev0 = g.devices[0]
    union = mark.pop(dev0)
    for m in mark.values():
        union |= m.to(dev0)
    mark.clear()
    st = g.on(dev0)
    distinct = int(union.sum())
    kept = 0
    for a in range(0, g.n, CHUNK):
        b = min(a + CHUNK, g.n)
        p = torch.arange(a, b, dtype=I64, device=dev0)
        kept += int((union[a:b] & (g.valid_len(st, p) >= min_len)).sum())
    del union
    out["duplicates"] = rows - distinct
    out["missing"] = g.kmer_count(min_len) - kept
    return out, ix


# --------------------------------------------------------------------------- #
# the control: k-mer identity by fingerprint, in ranges of its value
# --------------------------------------------------------------------------- #


def _fingerprints(g: Genome, st: dict, p: torch.Tensor, cap, k: int, bits: int) -> torch.Tensor:
    """``kmers_ref.fingerprints`` of rows at ``p`` (their first k bases, each
    cut at ``cap``)."""
    ck = torch.clamp_max(cap, k)
    h = torch.zeros(p.shape[0], dtype=I64, device=p.device)
    for offset in range(0, k, g.B):
        w = g.row_word(st, p, offset, ck)
        h = h * ref._HASH_A + w * ref._HASH_B
        h ^= torch.bitwise_right_shift(h, 29) & ((1 << 35) - 1)
    return torch.bitwise_right_shift(h, 64 - bits) & ((1 << bits) - 1)


def _ranges(bits: int, parts: int) -> list:
    top = 1 << bits
    return [(r * top // parts, (r + 1) * top // parts) for r in range(parts)]


def control_index_fingerprint(g: Genome, min_len: int, max_len, bits: int = 32) -> np.ndarray:
    """``kmers_ref.control_index_fingerprint`` in ranges of the fingerprint:
    every expected position ordered by (fingerprint, position)."""
    if max_len is None:
        raise ValueError("the fingerprint control needs a bounded compare length")
    fb = min(bits, 31)

    def one_range(dev, rng):
        lo, hi = rng
        st = g.on(dev)
        keys = []
        for a in range(0, g.n, CHUNK):
            p = torch.arange(a, min(a + CHUNK, g.n), dtype=I64, device=dev)
            vl = g.valid_len(st, p)
            keep = vl >= min_len
            p, vl = p[keep], vl[keep]
            fp = _fingerprints(g, st, p, torch.clamp_max(vl, max_len), max_len, fb)
            inside = (fp >= lo) & (fp < hi)
            keys.append(torch.bitwise_left_shift(fp[inside], 32) | p[inside])
        key = torch.sort(torch.cat(keys)).values & 0xFFFFFFFF
        return key.to(torch.int32).cpu().numpy().view(np.uint32)

    parts = _on_devices(one_range, _ranges(fb, len(g.devices)), g.devices)
    return np.concatenate(parts)


def control_group_counts(ix: Index, k: int, bits: int = 32):
    """``kmers_ref.control_group_counts``: groups by fingerprint, each range
    of its value counted on one device over every block of rows."""
    g = ix.g

    def one_range(dev, rng):
        lo, hi = rng
        st = g.on(dev)
        kept = []
        for a, b in _blocks(ix.n):
            p = _rows(ix.pos, a, b, dev)
            fp = _fingerprints(g, st, p, ix.caps(st, p), k, bits)
            kept.append(fp[(fp >= lo) & (fp < hi)])
        sizes = torch.unique(torch.cat(kept), return_counts=True)[1]
        hist = torch.bincount(torch.clamp_max(sizes, ref.MAX_COUNTS_BIN),
                              minlength=ref.MAX_COUNTS_BIN + 1)
        return hist.cpu(), int(sizes.sum())

    parts = _on_devices(one_range, _ranges(bits, len(g.devices)), g.devices)
    return sum(h for h, _ in parts).numpy(), sum(t for _, t in parts)
