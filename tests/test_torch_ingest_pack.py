"""The strided upload of the port against the JAX package, on the CPU.

Counterpart of ``tests/test_ingest_pack.py``. ``_DeviceCache`` packs the
uploaded bytes (``kernels/pack2.py`` for 2 bits, tensor ops for 4);
``_DeviceCache._build_from_strided`` builds the same packs from a host
strided pack (1/4 the bytes at 2 bits a base, 1/2 at 4), uploaded and
expanded on the device by ``ops/keys.expand_strided2/4``, the bytes left on
the host. Held here: the expansions equal the JAX package's on the same
strided packs, bit for bit as uint32; both routes give bit-equal packs;
the strided build leaves the bytes on the host, and the alphabet is
answered on the host by the collection's scan; a failed strided build
raises and tries no other route; the widened native alphabet scan equals
its plain NumPy version, errors included, on one thread and on several.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.ops import keys as jkeys
from genome_kmers_tpu.ops import large as jlarge
from genome_kmers_tpu_torch import native
from genome_kmers_tpu_torch import sequence_collection as tsc_mod
from genome_kmers_tpu_torch.interop import from_numpy_state
from genome_kmers_tpu_torch.ops import filters as tf
from genome_kmers_tpu_torch.ops import keys as tkeys
from genome_kmers_tpu_torch.ops import large as tlarge
from genome_kmers_tpu_torch.sequence_collection import _DeviceCache

ACGT_BYTES = np.frombuffer(b"ACGT$", dtype=np.uint8)
IUPAC_BYTES = np.frombuffer(b"ACGTRYSWKMBDHVN$", dtype=np.uint8)
STARTS = np.zeros(1, dtype=np.uint32)


def _sba(n: int, alphabet=ACGT_BYTES, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + n).choice(alphabet, size=n)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1234])
def test_expand_strided_matches_jax(n):
    """Both widths on the same strided packs (the port's host packers equal
    the JAX package's), against the JAX functions and the direct packs."""
    for bits, alphabet in ((2, ACGT_BYTES), (4, IUPAC_BYTES)):
        sba = _sba(n, alphabet, bits)
        if bits == 2:
            strided, want_pack = jlarge.pack_rank2_strided_np(sba), jkeys.expand_strided2
            got_pack, t_expand = tlarge.pack_rank2_strided_np(sba), tkeys.expand_strided2
            direct = tkeys.pack_rank2_words(torch.from_numpy(sba))
        else:
            strided, want_pack = jlarge.pack_rank_strided_np(sba), jkeys.expand_strided4
            got_pack, t_expand = tlarge.pack_rank_strided_np(sba), tkeys.expand_strided4
            direct = tkeys.pack_rank_words(torch.from_numpy(sba))
        assert got_pack.dtype == np.uint32 and np.array_equal(got_pack, strided)
        want = np.asarray(want_pack(strided, n))
        got = t_expand(torch.from_numpy(strided.view(np.int32)), n)
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert np.array_equal(got.numpy().view(np.uint32), want.astype(np.uint32))
        assert torch.equal(got, direct)


@pytest.mark.parametrize("step", [16, 48, 64])
def test_expand_strided_in_steps(monkeypatch, step):
    """The expansion in steps of ``_EXPAND_STEP`` positions (2^24 on the
    card) gives the same words at every cut."""
    monkeypatch.setattr(tkeys, "_EXPAND_STEP", step)
    for n in (1, 47, 48, 49, 1234):
        sba = _sba(n, IUPAC_BYTES, step)
        ranks2 = tlarge.pack_rank2_strided_np(sba).view(np.int32)
        ranks4 = tlarge.pack_rank_strided_np(sba).view(np.int32)
        assert torch.equal(tkeys.expand_strided2(torch.from_numpy(ranks2), n),
                           tkeys.pack_rank2_words(torch.from_numpy(sba)))
        assert torch.equal(tkeys.expand_strided4(torch.from_numpy(ranks4), n),
                           tkeys.pack_rank_words(torch.from_numpy(sba)))


def test_expand_strided_needs_the_trailing_word():
    strided = tlarge.pack_rank2_strided_np(_sba(32), extra_words=0)
    with pytest.raises(ValueError, match="trailing zero word"):
        tkeys.expand_strided2(torch.from_numpy(strided.view(np.int32)), 32)


def _both_routes(sba):
    """(strided-route cache, byte-route cache) of one SBA; the strided one
    holds its packs from ``_build_from_strided``."""
    strided, byte = _DeviceCache(sba, STARTS, torch.device("cpu")), _DeviceCache(
        sba, STARTS, torch.device("cpu"))
    strided._packed = strided._build_from_strided(4)
    if strided.is_acgt_only:
        strided._packed2 = strided._build_from_strided(2)
    byte.sba  # the bytes on the device first: the byte route
    return strided, byte


@pytest.mark.parametrize("alphabet", ["acgt", "iupac"])
@pytest.mark.parametrize("n", [1, 17, 4097])
def test_both_routes_give_equal_packs(alphabet, n):
    sba = _sba(n, ACGT_BYTES if alphabet == "acgt" else IUPAC_BYTES)
    strided, byte = _both_routes(sba)
    assert torch.equal(strided.packed, byte.packed)
    if alphabet == "acgt":
        assert torch.equal(strided.packed2, byte.packed2)
    else:
        assert strided.packed2 is None and byte.packed2 is None
    assert strided._sba_dev is None and byte._sba_dev is not None
    assert torch.equal(strided.packed, tkeys.pack_rank_words(torch.from_numpy(sba)))


@pytest.mark.parametrize("bits", [2, 4])
def test_the_default_route_leaves_the_bytes_on_the_host(bits):
    """A fresh cache answers its alphabet, builds its segment tables and
    the strided pack with the bytes left on the host; its pack of either
    width is then built from the uploaded bytes, equal to the strided
    build's."""
    dc = _DeviceCache(_sba(3000), STARTS, torch.device("cpu"))
    assert dc.is_acgt_only and dc.seg_ends.shape == (1,)
    strided = dc._build_from_strided(bits)
    assert dc._sba_dev is None
    pack = dc.packed2 if bits == 2 else dc.packed
    assert pack.shape == (3000,) and dc._sba_dev is not None
    assert torch.equal(pack, strided)


def test_packed2_of_an_iupac_sba_is_none_without_an_upload(monkeypatch):
    monkeypatch.setattr(torch, "bincount", None)  # no device count of the bytes
    sba = np.frombuffer(b"ACGTNNACGT", dtype=np.uint8).copy()
    dc = _DeviceCache(sba, STARTS, torch.device("cpu"))
    assert dc.packed2 is None and dc._sba_dev is None and dc.is_acgt_only is False


def test_the_collection_seeds_the_alphabet_answer(monkeypatch, tmp_path):
    """The construction's alphabet scan answers every strand's cache; an
    SBA that arrives without it (interop, load) is scanned on the host when
    asked. No device bincount runs either way."""
    monkeypatch.setattr(torch, "bincount", None)
    for seqs, acgt in (([("a", "ACGTTGCA" * 9), ("b", "GGCATT")], True),
                       ([("a", "ACGTRYNN" * 9), ("b", "GGCATT")], False)):
        sc = gt.SequenceCollection(sequence_list=seqs, strands_to_load="both", device="cpu")
        for strand in ("forward", "reverse_complement", "both_concat"):
            dc = sc.device_cache(strand)
            assert dc._is_acgt_only is acgt
            assert (dc.packed2 is not None) is acgt
            assert (dc._sba_dev is None) == (not acgt)  # the byte route uploads them
        single = gt.SequenceCollection(sequence_list=seqs, device="cpu")
        single.reverse_complement()
        assert single.device_cache("reverse_complement")._is_acgt_only is acgt
        carried, _ = from_numpy_state(single.revcomp_sba, single._revcomp_sba_seg_starts,
                                      single.revcomp_record_names, 3, 3,
                                      source_strand="reverse_complement", device="cpu")
        dc = carried.device_cache("reverse_complement")
        assert dc._is_acgt_only is None and dc.is_acgt_only is acgt
        path = str(tmp_path / f"sc-{acgt}")
        single.save(path, format="shelve")
        loaded = gt.SequenceCollection(sequence_list=[("z", "A")], device="cpu")
        loaded.load(path, format="shelve")
        dc = loaded.device_cache("reverse_complement")
        assert dc._is_acgt_only is None and dc.is_acgt_only is acgt and dc._sba_dev is None


@pytest.mark.parametrize("strided", [True, "default"])
def test_filtered_statistics_on_an_acgt_genome_never_upload_the_bytes(strided):
    """With the packs built by the strided upload no filtered call uploads
    the bytes; by the default route they are uploaded where the 2-bit pack
    is built from them."""
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in (400, 260)]
    sc = gt.SequenceCollection(sequence_list=[(f"chr{i}", s) for i, s in enumerate(seqs)],
                               device="cpu")
    dc = sc.device_cache("forward")
    if strided is True:
        dc._packed2, dc._packed = dc._build_from_strided(2), dc._build_from_strided(4)
    km = gt.Kmers(sc, min_kmer_len=23, max_kmer_len=23)
    km.sort()
    for f in (tf.gen_kmer_gc_content_filter_func(0.3, 0.7, 23),
              tf.gen_kmer_homopolymer_filter_func(3, 23), tf.gen_no_ambiguous_bases_filter(23),
              tf.crispr_ngg_pam_filter):
        km.get_kmer_count(23, kmer_filter_func=f)
        km.get_kmer_group_counts(23, kmer_filter_func=f)
    assert (dc._sba_dev is None) == (strided is True)


@pytest.mark.parametrize("step", ["pack", "expand"])
@pytest.mark.parametrize("bits", [2, 4])
def test_a_failed_strided_build_raises(monkeypatch, bits, step):
    """A failure of the host pack or the expansion raises; the byte route
    is not tried."""

    def fail(*args, **kwargs):
        raise RuntimeError(f"{step} failed")

    name = {("pack", 2): "pack_rank2_strided_np", ("pack", 4): "pack_rank_strided_np",
            ("expand", 2): "expand_strided2", ("expand", 4): "expand_strided4"}[step, bits]
    monkeypatch.setattr(tsc_mod, name, fail)
    dc = _DeviceCache(_sba(500), STARTS, torch.device("cpu"))
    with pytest.raises(RuntimeError, match=f"{step} failed"):
        dc._build_from_strided(bits)
    assert dc._sba_dev is None and dc._packed is None and dc._packed2 is None


def _scan_cases():
    rng = np.random.default_rng(11)
    allowed = {ord(c) for c in "ACGTRYSWKMBDHVN$"}
    for n in (0, 1, 63, 64, 65, 200, 4096):
        for kind in ("acgt", "iupac", "bad"):
            sba = rng.choice(ACGT_BYTES if kind == "acgt" else IUPAC_BYTES, size=n)
            if kind == "bad" and n:
                for at in {0, n // 2, n - 1, min(63, n - 1), min(64, n - 1)}:
                    bad = sba.copy()
                    bad[at] = rng.choice(np.frombuffer(b"xn\x00\xff", dtype=np.uint8))
                    bad[-1] = ord("z") if at != n - 1 else bad[-1]
                    yield f"{kind}-{n}-{at}", bad, allowed
            else:
                yield f"{kind}-{n}", sba, allowed
                yield f"{kind}-{n}-all", sba, native.ALL_BYTES


@pytest.mark.parametrize("name,sba,allowed", list(_scan_cases()),
                         ids=[c[0] for c in _scan_cases()])
def test_alphabet_scan_equals_its_plain_version(name, sba, allowed):
    got = native.scan_alphabet_native(sba, allowed)
    assert got == native.scan_alphabet_plain(sba, allowed)
    assert native.validate_alphabet_native(sba, allowed) == got[0]


@pytest.mark.parametrize("n_threads", [2, 3, 8])
def test_threaded_alphabet_scan_equals_its_plain_version(n_threads):
    """The scan in ``n_threads`` chunks (threads from 4 MB on by default):
    the first offending byte is the first chunk's that holds one."""
    for name, sba, allowed in _scan_cases():
        want = native.scan_alphabet_plain(sba, allowed)
        assert native.scan_alphabet_native(sba, allowed, n_threads=n_threads) == want, name
    big = _sba((4 << 20) + 3, IUPAC_BYTES)
    for at in (0, 1 << 21, len(big) - 1):
        bad = big.copy()
        bad[at] = ord("x")
        bad[-1] = ord("z") if at != len(big) - 1 else bad[-1]
        assert native.scan_alphabet_native(bad, native.ALL_BYTES - {ord("x"), ord("z")}) == (
            native.scan_alphabet_plain(bad, native.ALL_BYTES - {ord("x"), ord("z")}))


def test_the_collection_raises_the_offending_bytes():
    with pytest.raises(ValueError, match=r"non-allowed characters! \(\{120\}\)"):
        gt.SequenceCollection(sequence_list=[("a", "ACGTxACGT")], device="cpu")
