"""The lanes-flags kernel (``csrc/lanes_flags.cu``) of the GC-content,
homopolymer and no-ambiguous filters.

On the CPU: the dispatch (CPU tensors run the plain versions of
``ops/filters.py`` and launch nothing), the checks the wrapper makes before
any launch, and a NumPy model of the kernel's arithmetic (the nibble and
field tests, the multiply that compresses the eq bits, the packed popcounts,
the run folds) held against the plain versions row for row. On a card
(tests marked ``card``; they skip without one): the kernel bit for bit
against the plain versions, one launch a call, and the one-card and mesh
routes of a filtered ``get_kmer_group_counts``.

The cases cover every filter on both widths: random and repeat-rich lanes
with N and IUPAC nibbles, arbitrary bit patterns, rows truncated at segment
ends, positions at and past the overflow threshold, ``k_f`` below the
built length (ROADMAP.md §C2), ``max_h`` above ``k_f`` (short circuit), an
impossible GC range, 2-bit lanes with and without a cap lane and with int32
or int64 words, 0, 1, 3 and 5 rows, and slices at odd storage offsets. No
JAX here.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu_torch as gk
from genome_kmers_tpu_torch.kernels.lanes_flags import KINDS, lanes_flags_cuda
from genome_kmers_tpu_torch.ops import filters as F
from genome_kmers_tpu_torch.ops.encoding import RANK_TABLE
from genome_kmers_tpu_torch.ops.keys import keep_mask

PLAIN = {"gc4": F.gc_lanes_flags4, "noamb4": F.noamb_lanes_flags4,
         "homopoly4": F.homopoly_lanes_flags4, "gc2": F.gc_lanes_flags2,
         "homopoly2": F.homopoly_lanes_flags2}
ACGT4 = RANK_TABLE[np.frombuffer(b"ACGT", np.uint8)].astype(np.uint32)  # 1 3 5 12
AMBIGUOUS4 = RANK_TABLE[np.frombuffer(b"NRYSWKMBDHV", np.uint8)].astype(np.uint32)
SBA_LEN = 1 << 20

VARIANTS4 = ["random", "repeats", "long_runs", "raw_bits", "k_below_built", "wide", "constant",
             "rows0", "rows1", "rows3", "rows5", "odd_offset"]
VARIANTS2 = VARIANTS4 + ["no_cap", "int32_words"]
CASES = [(kind, v) for kind in KINDS for v in (VARIANTS2 if kind.endswith("2") else VARIANTS4)]
IDS = [f"{kind}-{v}" for kind, v in CASES]


def _filter(kind: str, variant: str, k: int):
    if kind.startswith("gc"):
        # (0.5, 0.51) at k = 31: ceil(15.5) = 16 > floor(15.81) = 15
        return F.GcContentFilter(*((0.5, 0.51) if variant == "constant" else (0.3, 0.7)), k)
    if kind.startswith("homopoly"):
        max_h = {"constant": k + 9, "long_runs": k * 3 // 8}.get(variant, 5)
        return F.HomopolymerFilter(max_h, k)
    return F.NoAmbiguousBasesFilter(1 if variant == "constant" else k)


def _words(rng, n: int, built_k: int, two_bit: bool, variant: str, caps):
    """Sorted-lane words of n rows built to ``built_k``: ranks from the
    alphabet (4-bit: some N and IUPAC codes), homopolymer runs where
    ``variant`` is "repeats" (longer in "long_runs"), fields at and past
    each row's cap zero; or arbitrary bits ("raw_bits")."""
    per, bits = (16, 2) if two_bit else (8, 4)
    n_words = -(-built_k // per)
    if variant == "raw_bits":
        return rng.integers(0, 1 << 32, (n_words, n), dtype=np.uint64).astype(np.uint32)
    if two_bit:
        ranks = rng.integers(0, 4, (n, n_words * per)).astype(np.uint32)
    else:
        ranks = ACGT4[rng.integers(0, 4, (n, n_words * per))]
        amb = rng.random(ranks.shape) < 0.03
        ranks[amb] = AMBIGUOUS4[rng.integers(0, len(AMBIGUOUS4), int(amb.sum()))]
    if variant in ("repeats", "long_runs"):
        lengths = (2, 12) if variant == "repeats" else (8, 40)
        for row in range(n):
            for _ in range(3):
                start, length = rng.integers(0, built_k), rng.integers(*lengths)
                ranks[row, start : start + length] = ranks[row, start]
    ranks[np.arange(n_words * per)[None, :] >= caps[:, None]] = 0
    words = np.zeros((n_words, n), np.uint32)
    for j in range(n_words * per):
        words[j // per] |= ranks[:, j] << np.uint32(32 - bits * (j % per + 1))
    return words


def _case(kind: str, variant: str):
    """(words as NumPy arrays of the lane dtype, cap or None, positions,
    params, storage offset of the slices)."""
    two_bit = kind.endswith("2")
    rng = np.random.default_rng(sum(f"{kind}/{variant}".encode()))
    n = {"rows0": 0, "rows1": 1, "rows3": 3, "rows5": 5, "odd_offset": 4099}.get(variant, 5003)
    built_k, k = 31, 31
    if variant == "k_below_built":
        built_k, k = (64, 37) if two_bit else (32, 20)
    elif variant == "wide":
        built_k = k = 32 if kind == "homopoly4" else 64
    elif variant == "long_runs":
        built_k = k = 64 if two_bit else 32
    trunc = rng.random(n) < (0.2 if variant == "k_below_built" else 0.05)
    caps = np.where(trunc, rng.integers(0, built_k, n), built_k)
    if variant == "no_cap":
        caps[:] = built_k  # lanes without a cap lane: every row's cap is built_k
    words = _words(rng, n, built_k, two_bit, variant, caps)
    dtype = np.int64 if two_bit and variant != "int32_words" else np.int32
    words = [w.astype(dtype) if dtype == np.int64 else w.view(np.int32) for w in words]
    cap = None if (not two_bit or variant == "no_cap") else caps.astype(np.int64)
    if variant == "raw_bits" and two_bit:
        cap = rng.integers(0, built_k + 1, n).astype(np.int64)
    spec = _filter(kind, variant, k).lanes_spec({"two_bit": two_bit, "built_k": built_k},
                                                SBA_LEN, built_k)
    assert spec[0] is PLAIN[kind]
    positions = rng.integers(0, SBA_LEN, n).astype(np.int64)
    edge = rng.random(n) < 0.05
    positions[edge] = rng.integers(SBA_LEN - k - 2, SBA_LEN, int(edge.sum()))
    return words, cap, positions, spec[1], 3 if variant == "odd_offset" else 0


def _tensors(case, device):
    """The case's lanes as tensors on ``device``, each sliced at the case's
    storage offset."""
    words, cap, positions, params, off = case

    def lane(a):
        big = torch.zeros(a.shape[0] + off, dtype=getattr(torch, str(a.dtype)), device=device)
        big[off:] = torch.from_numpy(a)
        return big[off:]

    return ([lane(w) for w in words], None if cap is None else lane(cap), lane(positions),
            params)


# --------------------------------------------------------------------------- #
# a NumPy model of the kernel's row arithmetic (row_flags in the source)
# --------------------------------------------------------------------------- #

U32 = np.uint32(0xFFFFFFFF)


def _popc(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _ones_shl(s):
    return U32 << np.clip(s, 0, 31).astype(np.uint32)


def _fold(x, run: int, steps: int):
    rem = run - 1
    for cap_t in (1, 2, 4, 8, 16, 16, 16)[:steps]:
        t = min(cap_t, rem)
        if t <= 0:
            break
        x = x & (x >> x.dtype.type(t))
        rem -= t
    return x != 0


def _nibble_bits(z):
    """compress_nibble_bits: bits 0, 4, ..., 28 to 0..7 by two multiplies."""
    lo = (((z & 0x1111) * np.uint32(0x249)) >> 9) & 0xF
    hi = ((((z >> 16) & 0x1111) * np.uint32(0x249)) >> 9) & 0xF
    return lo | (hi << 4)


def _even_bits(x):
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0xFFFF


def _model(kind, words, cap, positions, params):
    """(mask, errs) as the kernel computes them, over NumPy uint32 words."""
    _, per, bits, _, _ = KINDS[kind]
    p = [int(v) for v in params]
    k = p[0]
    reach = min(len(words), max(-(-k // per), 1))
    w = [np.asarray(x).astype(np.int64).astype(np.uint32) for x in words[:reach]]
    keep = [np.uint32(keep_mask(k, i, per, bits)) for i in range(reach)]
    n = positions.shape[0]
    if kind in ("gc4", "gc2") and p[4]:
        return np.zeros(n, bool), (np.zeros(n, bool),)
    if kind == "homopoly4" and p[3] or kind == "homopoly2" and p[4]:
        return np.ones(n, bool), (positions >= (p[2] if kind == "homopoly4" else p[3]),)
    if kind in ("gc4", "noamb4"):
        zero = acc0 = acc1 = np.zeros(n, np.uint32)
        for i, x in enumerate(w):
            s1, s2, s3 = x >> 1, x >> 2, x >> 3
            kept = keep[i] & np.uint32(0x11111111)
            zero = zero | (~(x | s1 | s2 | s3) & kept)
            if kind == "gc4":
                hit = ~s3 & x & (s1 ^ s2)
            else:
                hit = ~((~s3 & ((~s2 & ~s1 & ~x) | (x & ~(s1 & s2)))) | (s3 & s2 & ~s1 & ~x))
            hit = hit & kept
            if i < 4:
                acc0 = acc0 | (hit << np.uint32(i))
            else:
                acc1 = acc1 | (hit << np.uint32(i - 4))
        trunc = zero != 0
        if kind == "gc4":
            gc = _popc(acc0) + _popc(acc1)
            return ~trunc & (gc >= p[1]) & (gc <= p[2]), (trunc & (gc <= p[2]),)
        amb = (acc0 | acc1) != 0
        return ~trunc & ~amb, (positions >= p[1], trunc & ~amb)
    if kind == "homopoly4":
        zero = kept_nonzero = e = np.zeros(n, np.uint32)
        for i, x in enumerate(w):
            kept = keep[i] & np.uint32(0x11111111)
            nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111
            zero = zero | (~nz & kept)
            kept_nonzero = kept_nonzero | ((nz & kept) << np.uint32(i))
            y = x ^ (x >> 4)
            eq = ~(y | (y >> 1) | (y >> 2) | (y >> 3)) & 0x11111111
            c = _nibble_bits(eq) & 0x7F
            if i > 0:
                c = c | (((w[i - 1] & 0xF) == (x >> 28)).astype(np.uint32) << 7)
            e = e | (c << np.uint32(24 - 8 * i))
        capv = _popc(kept_nonzero)
        run_bad = _fold(e & _ones_shl(np.int64(32 - k)), p[1], 5)
        run_bad_cap = _fold(e & _ones_shl(32 - capv), p[1], 5)
        return ~run_bad, ((positions >= p[2]) | ((zero != 0) & ~run_bad_cap),)
    cap_const = p[3] if kind == "gc2" else p[2]
    capv = np.full(n, cap_const, np.int64) if cap is None else np.asarray(cap)
    if kind == "gc2":
        gc = np.zeros(n, np.int64)
        for i, x in enumerate(w):
            gc += _popc((((x & keep[i]) >> 1) ^ (x & keep[i])) & 0x55555555)
        trunc = capv < k
        return ~trunc & (gc >= p[1]) & (gc <= p[2]), (trunc & (gc <= p[2]),)
    e = np.zeros(n, np.uint64)
    for i, x in enumerate(w):
        same = ~(x ^ (x >> 2))
        c = _even_bits(same & (same >> 1) & 0x55555555) & 0x7FFF
        if i > 0:
            c = c | (((w[i - 1] & 3) == (x >> 30)).astype(np.uint32) << 15)
        e = e | (c.astype(np.uint64) << np.uint64(48 - 16 * i))

    def keep64(m):
        hi = _ones_shl(32 - m).astype(np.uint64)
        lo = np.where(m > 32, _ones_shl(64 - m), 0).astype(np.uint64)
        return (hi << np.uint64(32)) | lo

    run_bad = _fold(e & keep64(np.full(n, k, np.int64)), p[1], 7)
    run_bad_cap = _fold(e & keep64(np.minimum(capv, k)), p[1], 7)
    return ~run_bad, ((positions >= p[3]) | ((capv < k) & ~run_bad_cap),)


def _as_numpy(result):
    mask, errs = result
    return mask.cpu().numpy(), tuple(e.cpu().numpy() for e in errs)


@pytest.mark.parametrize("kind,variant", CASES, ids=IDS)
def test_kernel_model_matches_plain(kind, variant):
    words, cap, positions, params, _ = case = _case(kind, variant)
    want = _as_numpy(PLAIN[kind](*_tensors(case, "cpu")))
    got = _model(kind, words, cap, positions, params)
    assert np.array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert np.array_equal(g, w)
    if variant == "random":  # the case holds rows of every outcome
        assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_tensors_run_the_plain_version(kind):
    """The dispatch: CPU tensors take the torch ops (``__wrapped__``) and
    launch nothing; the wrapper itself refuses them."""
    case = _case(kind, "random")
    words, cap, positions, params = _tensors(case, "cpu")
    before = lanes_flags_cuda.launches
    via_dispatch = PLAIN[kind](words, cap, positions, params)
    plain = PLAIN[kind].__wrapped__(words, cap, positions, params)
    assert lanes_flags_cuda.launches == before == 0
    assert lanes_flags_cuda.passes == 1
    assert len(via_dispatch[1]) == len(plain[1]) == KINDS[kind][3] - 1
    for a, b in zip([via_dispatch[0], *via_dispatch[1]], [plain[0], *plain[1]]):
        assert a.dtype == b.dtype == torch.bool and a.shape == positions.shape
        assert torch.equal(a, b)
    assert PLAIN[kind].kind == kind
    with pytest.raises(ValueError, match="unsupported devices"):
        lanes_flags_cuda(kind, words, cap, positions, PLAIN[kind].scalars(*params))


def test_wrapper_raises_before_any_launch():
    words, cap, positions, params = _tensors(_case("gc2", "random"), "cpu")
    w4, _, pos4, params4 = _tensors(_case("noamb4", "random"), "cpu")
    scalars, scalars4 = PLAIN["gc2"].scalars(*params), PLAIN["noamb4"].scalars(*params4)
    bad = {
        "unknown kind": ("gc8", words, cap, positions, scalars),
        "no word lane": ("gc2", [], cap, positions, scalars),
        "int64 positions": ("gc2", words, cap, positions.to(torch.int32), scalars),
        "one dtype": ("gc2", [words[0].to(torch.int16)], cap, positions, scalars),
        "among": ("noamb4", [w.to(torch.int64) for w in w4], None, pos4, scalars4),
        "int64 cap": ("gc2", words, cap.to(torch.int32), positions, scalars),
        "1-D lanes": ("gc2", [words[0].reshape(1, -1)], cap, positions, scalars),
        "rows": ("gc2", [words[0][:-1]], cap, positions, scalars),
        "stride": ("gc2", [torch.zeros(2 * len(positions), dtype=torch.int64)[::2]], cap,
                   positions, scalars),
    }
    before = lanes_flags_cuda.launches
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            lanes_flags_cuda(*args)
    meta = [w.to("meta") for w in w4]
    with pytest.raises(ValueError, match="unsupported devices"):
        PLAIN["noamb4"](meta, None, pos4.to("meta"), params4)  # the dispatch reaches the wrapper
    with pytest.raises(ValueError, match="unsupported devices"):
        lanes_flags_cuda("noamb4", w4, None, pos4.to("meta"), scalars4)
    assert lanes_flags_cuda.launches == before


# --------------------------------------------------------------------------- #
# on a card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("kind,variant", CASES, ids=IDS)
def test_kernel_bit_equal_to_plain_on_card(kind, variant, cuda_device):
    case = _case(kind, variant)
    words, cap, positions, params = _tensors(case, cuda_device)
    before = lanes_flags_cuda.launches
    got = PLAIN[kind](words, cap, positions, params)
    torch.cuda.synchronize()
    assert lanes_flags_cuda.launches == before + (positions.shape[0] > 0)
    want = PLAIN[kind](*_tensors(case, "cpu"))
    assert got[0].device == positions.device and got[0].dtype == torch.bool
    assert got[0].shape == positions.shape and len(got[1]) == len(want[1])
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)


def _genome(iupac: bool):
    """Two records; with ``iupac`` N and RY runs (4-bit lanes), else ACGT
    alone (2-bit lanes; the mesh and ``LargeKmers`` keep int32 words and
    recompute the caps)."""
    rng = np.random.default_rng(11)
    seq = "".join(rng.choice(list("ACGT"), 6000))
    seq = seq[:1500] + "A" * 12 + ("N" * 40 if iupac else seq[1552:1592]) + seq[1552:3000]
    seq += seq[200:1400] + ("RY" if iupac else "") + seq[3000:]
    return [("chr1", seq), ("chr2", seq[:900] + "GGGGGGGC" * 3)]


@pytest.mark.card
@pytest.mark.parametrize("iupac", [False, True], ids=["acgt", "iupac"])
def test_routes_launch_once_a_call_on_card(iupac, cuda_device):
    """A filtered get_kmer_group_counts launches the kernel once on one card
    and once a shard on a mesh of 4 shards of the card and on ``LargeKmers``
    (1 and 4 shards), counted from 0, with the CPU's answers; on 2-bit lanes
    the no-ambiguous filter launches nothing (its flags are two compares)."""
    from genome_kmers_tpu_torch.parallel import make_mesh

    filters = [F.GcContentFilter(0.3, 0.7, 31), F.HomopolymerFilter(5, 31),
               F.NoAmbiguousBasesFilter(31), F.HomopolymerFilter(40, 31)]
    want = []
    sc_cpu = gk.SequenceCollection(sequence_list=_genome(iupac), strands_to_load="forward",
                                   device="cpu")
    km_cpu = gk.Kmers(sc_cpu, 31, 31)
    km_cpu.sort()
    for f in filters:
        want.append(km_cpu.get_kmer_group_counts(31, kmer_filter_func=f))
    sc = gk.SequenceCollection(sequence_list=_genome(iupac), strands_to_load="forward",
                               device=str(cuda_device))
    km = gk.Kmers(sc, 31, 31)
    km.sort()
    assert km._lanes_cache["two_bit"] != iupac
    m1 = make_mesh(1, devices=[str(cuda_device)])
    m4 = make_mesh(4, devices=[str(cuda_device)] * 4)
    km_mesh = gk.Kmers(sc, 31, 31)
    km_mesh.sort(mesh=m4)
    lk1 = gk.LargeKmers.from_sequence_collection(sc, 31, 31)
    lk1.sort(m1)
    lk4 = gk.LargeKmers.from_sequence_collection(sc, 31, 31)
    lk4.sort(m4)
    for f, (hist, total) in zip(filters, want):
        kernel = iupac or not isinstance(f, F.NoAmbiguousBasesFilter)
        routes = ((1, lambda: km.get_kmer_group_counts(31, kmer_filter_func=f)),
                  (4, lambda: km_mesh.get_kmer_group_counts(31, kmer_filter_func=f, mesh=m4)),
                  (1, lambda: lk1.get_kmer_group_counts(31, f)),
                  (4, lambda: lk4.get_kmer_group_counts(31, f)))
        for launches, call in routes:
            lanes_flags_cuda.launches = 0
            got = call()
            assert lanes_flags_cuda.launches == (launches if kernel else 0)
            assert np.array_equal(np.asarray(got[0]).astype(np.int64), hist)
            assert int(got[1]) == total
