"""The port's native library against the JAX package's NumPy paths, on the CPU.

The FASTA parse (single-threaded, forced into chunks, and above 8 MB with
records that run across chunk boundaries), the NumPy route past the native
parse's record limit, the empty-sequence and empty-file errors, the
alphabet check and its message, the reverse complement and the two row
decoders, each byte for byte against the JAX package or the plain version
beside it; and the build: a hashed library under ``build/``, a failed build
raising with the compiler's output. Tolerance: exact equality.
"""

import numpy as np
import pytest

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.io.fasta import parse_fasta_bytes as jax_parse_fasta_bytes
from genome_kmers_tpu.io.fasta import parse_fasta_file as jax_parse_fasta_file
from genome_kmers_tpu.ops.encoding import reverse_complement_bytes as jax_reverse_complement_bytes
from genome_kmers_tpu_torch import native
from genome_kmers_tpu_torch.io.fasta import _parse_fasta_dispatch, parse_fasta_file
from genome_kmers_tpu_torch.kernels import build
from genome_kmers_tpu_torch.ops.encoding import COMPLEMENT_TABLE, reverse_complement_bytes

FASTAS = [
    b">chr1\nATCGAATTAG\n",
    b">chr1\nATCGAATTAG\n>chr2\nGGATCTTGCATT\n>chr3\nGTGATTGACCCCT\n",
    b">chr1\nATCGA\nATTAG\n>chr2 desc here\nGGAT\nCTTGCATT\n",
    b">chr1\r\nATCG\r\nAATT\r\n>chr2\r\nGGCC\r\n",
    b">chr1\natcgaattag\n",
    b">chr1\nATCG",  # no trailing newline
    b">a\nA\n>b\nC\n>c\nG\n",
    b">a desc\nACGT\n>b\n",  # a trailing empty record is accepted, as in the JAX package
    b">a\nNNRYKM\nbdhvsw\n>b   spaced   name\nACGT$ACGT\n",
]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _same_parse(got, want):
    (g_sba, g_starts, g_names), (w_sba, w_starts, w_names) = got, want
    assert g_sba.dtype == w_sba.dtype == np.uint8 and g_starts.dtype == w_starts.dtype == np.uint32
    assert np.array_equal(g_sba, w_sba) and np.array_equal(g_starts, w_starts)
    assert g_names == w_names


@pytest.mark.parametrize("n_chunks", [None, 1, 3, 16])
@pytest.mark.parametrize("data", FASTAS)
def test_parse_matches_jax_numpy_parse(data, n_chunks):
    """Single-threaded, and forced into 1, 3 or 16 line-aligned chunks."""
    runs = native.parse_fasta_bytes_native.runs
    sba, starts, spans = native.parse_fasta_bytes_native(data, n_chunks=n_chunks)
    assert native.parse_fasta_bytes_native.runs == runs + 1
    assert native.parse_fasta_bytes_native.chunks == (n_chunks or 1)
    names = [gt.kmers.SequenceCollection._get_fasta_record_name(data[s:e].decode()) for s, e in spans]
    _same_parse((sba, starts, names), jax_parse_fasta_bytes(data))
    _same_parse(_parse_fasta_dispatch(data), jax_parse_fasta_bytes(data))


def test_threaded_parse_of_a_large_buffer_with_records_across_chunks():
    """Above 8 MB the parse cuts the buffer into chunks: records of up to
    3 MB with CRLF and LF line ends, wrapped at 61 bases, continue across
    the chunk boundaries; byte for byte the JAX package's NumPy parse."""
    rng = np.random.default_rng(12)
    parts = []
    for i in range(7):
        n = int(rng.integers(1, 3 * 10**6))
        body = bytes(rng.choice(np.frombuffer(b"ACGTacgtN", dtype=np.uint8), size=n))
        nl = b"\r\n" if i % 3 == 0 else b"\n"
        wrapped = nl.join(body[j : j + 61] for j in range(0, n, 61))
        parts.append(b">rec" + str(i).encode() + b" desc\n" + wrapped + nl)
    data = b"".join(parts)
    assert len(data) > 8 << 20
    runs = native.parse_fasta_bytes_native.runs
    got = _parse_fasta_dispatch(data)
    assert native.parse_fasta_bytes_native.runs == runs + 1
    assert native.parse_fasta_bytes_native.chunks > 1
    # some record continues from one chunk into the next
    bounds = np.zeros(native.parse_fasta_bytes_native.chunks + 1, dtype=np.int64)
    arr = np.frombuffer(data, dtype=np.uint8)
    native._lib().gk_chunk_bounds(native._u8(arr), arr.size, len(bounds) - 1, native._i64(bounds))
    assert any(data[b : b + 1] != b">" for b in bounds[1:-1])
    _same_parse(got, jax_parse_fasta_bytes(data))


def test_too_many_records_take_the_numpy_parse(tmp_path):
    """More records than max(1024, n // 8): the native parse declines and
    the NumPy parse (the plain version) answers, equal to the JAX package."""
    data = b"".join(b">%x\nA\n" % i for i in range(3000))
    assert len(data) // 8 < 3000
    assert native.parse_fasta_bytes_native(data) is None
    runs = native.parse_fasta_bytes_native.runs
    path = tmp_path / "many.fa"
    path.write_bytes(data)
    _same_parse(parse_fasta_file(path), jax_parse_fasta_file(path))
    assert native.parse_fasta_bytes_native.runs == runs


PARSE_ERRORS = [
    (b">chr1\nATCG\n>chr2\n>chr3\nGGCC\n", ValueError),
    (b">a\nACGT\n>b\n>c\nGG\n", ValueError),
    (b"", AssertionError),
    (b"\n\n", AssertionError),
    (b"ACGT\n", AssertionError),
]


def _parse_error(path, error):
    """The error of the JAX package's native parse route, stated here: its
    NumPy route, which it takes where its own library failed to build or
    load, returns an empty parse of a buffer of blank lines instead
    (ROADMAP.md §C6), so the answer is not read from whichever route the
    JAX package took in this process."""
    if error is ValueError:
        return ValueError, f"At least one empty sequence was found in the input file ({path})"
    return AssertionError, "After parsing the fasta file, we expect sba to be full"


@pytest.mark.parametrize("data,error", PARSE_ERRORS)
def test_parse_errors_match_jax(tmp_path, data, error):
    """Empty sequences (the message names the file), an empty file, no
    header: the JAX package's native route's error and message."""
    path = tmp_path / "g.fa"
    path.write_bytes(data)
    assert _outcome(lambda: parse_fasta_file(path)) == _parse_error(path, error)


@pytest.mark.parametrize("data,error", PARSE_ERRORS)
def test_parse_errors_of_the_numpy_route(tmp_path, monkeypatch, data, error):
    """The port's plain route (``parse_fasta_bytes`` through the dispatch,
    the native parse declining the buffer) gives the native route's error
    and message."""
    from genome_kmers_tpu_torch.io import fasta

    path = tmp_path / "g.fa"
    path.write_bytes(data)
    monkeypatch.setattr(fasta, "parse_fasta_bytes_native", lambda data: None)
    assert _outcome(lambda: fasta.parse_fasta_file(path)) == _parse_error(path, error)


@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_threaded_parse_empty_sequence_error(n_chunks):
    with pytest.raises(ValueError, match="empty sequence"):
        native.parse_fasta_bytes_native(b">a\nACGT\n>b\n>c\nGG\n", n_chunks=n_chunks)


@pytest.mark.parametrize(
    "seq_list",
    [[("a", "ACGTacgt")], [("a", "ACGT"), ("b", "AC-GT*x")], [("a", "ACGTRYSWKMBDHVN")]],
)
def test_alphabet_check_matches_jax(seq_list):
    """The native scan decides; the message lists every offending byte."""
    got = _outcome(lambda: gt.SequenceCollection(sequence_list=seq_list, device="cpu").forward_sba)
    want = _outcome(lambda: gj.SequenceCollection(sequence_list=seq_list).forward_sba)
    if isinstance(want, tuple):
        assert got == want and want[0] is ValueError
    else:
        assert np.array_equal(got, want)


def test_validate_alphabet_native_returns_the_first_offender():
    allowed = {ord(c) for c in "ACGT$"}
    sba = np.frombuffer(b"ACGTxACGTn", dtype=np.uint8)
    assert native.validate_alphabet_native(sba, allowed) == ord("x")
    assert native.validate_alphabet_native(sba[:4], allowed) == -1
    assert native.validate_alphabet_native(sba[:0], allowed) == -1


def test_fasta_collection_equals_jax_and_runs_the_native_parse(tmp_path):
    path = tmp_path / "g.fasta"
    path.write_text(">c1 x\nATCGAATTAG\n>c2\nGGATCTTGCATT\n>c3\nNNRYACGT\n")
    runs = native.parse_fasta_bytes_native.runs
    for strands in ("forward", "reverse_complement", "both"):
        tsc = gt.SequenceCollection(fasta_file_path=path, strands_to_load=strands, device="cpu")
        assert tsc == gj.SequenceCollection(fasta_file_path=path, strands_to_load=strands)
    assert native.parse_fasta_bytes_native.runs == runs + 3


@pytest.mark.parametrize("n", [0, 1, 10001, (1 << 16) - 1, 1 << 16, (1 << 16) + 3, 200_003])
def test_reverse_complement_matches_jax(n):
    """The native scan from 2^16 bytes on, the table gather below it."""
    rng = np.random.default_rng(n)
    sba = rng.choice(np.frombuffer(b"ACGTRYSWKMBDHVN$", dtype=np.uint8), size=n)
    got = reverse_complement_bytes(sba)
    assert got.dtype == np.uint8 and np.array_equal(got, jax_reverse_complement_bytes(sba))
    assert np.array_equal(native.reverse_complement_native(sba, COMPLEMENT_TABLE),
                          COMPLEMENT_TABLE[sba][::-1])


@pytest.mark.parametrize("n", [0, 1, 7, 100_000])
@pytest.mark.parametrize("k", [1, 5, 31])
def test_decode_rows_matches_its_plain_version(n, k):
    rng = np.random.default_rng(n * 13 + k)
    sba = rng.choice(np.frombuffer(b"ACGTN$", dtype=np.uint8), size=max(n + k + 10, 64))
    pos = rng.integers(0, len(sba) - k + 1, size=n).astype(np.int64)
    got = native.decode_rows_native(sba, pos, k)
    assert got.shape == (n, k) and np.array_equal(got, native.decode_rows_plain(sba, pos, k))
    assert np.array_equal(got, gj.Kmers._decode_block_bytes(sba, pos, k))


@pytest.mark.parametrize("n", [0, 1, 9, 50_000])
def test_decode_rows_var_matches_its_plain_version(n):
    rng = np.random.default_rng(n * 3 + 1)
    sba = rng.choice(np.frombuffer(b"ACGTN$", dtype=np.uint8), size=max(n + 40, 64))
    lens = rng.integers(0, 30, size=n).astype(np.int64)
    pos = rng.integers(0, len(sba) - 30, size=n).astype(np.int64)
    data, offsets = native.decode_rows_var_native(sba, pos, lens)
    p_data, p_offsets = native.decode_rows_var_plain(sba, pos, lens)
    j_data, j_offsets = gj.Kmers._decode_var_bytes(sba, pos, lens)
    assert np.array_equal(offsets, p_offsets) and np.array_equal(offsets, j_offsets)
    assert np.array_equal(data, p_data) and np.array_equal(data, j_data)


def test_decode_bounds_guards():
    sba = np.frombuffer(b"ACGTACGT", dtype=np.uint8)
    with pytest.raises(IndexError):
        native.decode_rows_native(sba, np.array([6], dtype=np.int64), 5)
    with pytest.raises(IndexError):
        native.decode_rows_native(sba, np.array([-1], dtype=np.int64), 3)
    with pytest.raises(IndexError):
        native.decode_rows_var_native(sba, np.array([6], dtype=np.int64), np.array([5]))
    with pytest.raises(ValueError):
        native.decode_rows_var_native(sba, np.array([0], dtype=np.int64), np.array([-1]))


def test_library_is_built_under_build_with_a_hashed_name():
    native._lib()
    path = native.library_path()
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path.name.startswith("libfasta_parser_") and path.suffix == ".so"


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    lib = tmp_path / "libbroken.so"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp") as info:
        build.compile_library(src, ["g++", *native.GXX_FLAGS], lib)
    assert "error" in str(info.value) and not lib.exists()
    assert not list(tmp_path.glob("*.tmp"))
