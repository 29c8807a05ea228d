"""Reference methods of the port against the JAX package, on the CPU.

``Kmers.__eq__`` / ``__ne__``, ``get_kmer_str_no_checks``,
``get_is_less_than_func``, ``generate_get_kmer_info_func``, the
``__getitem__`` stub, the reference documentation's goldens through them,
the A10 export methods (ported since; held against the JAX package), and
the collection-side module functions
and attributes (``bisect_right``, ``reverse_complement_sba``, the mapping
arrays), the coverage of the JAX package (by AST: every public
module-level function and class has a counterpart of the same name in the
port's module of the same name, but for a short list of JAX/XLA-specific
helpers and the Pallas entry points), the signatures of the opt-in sorts
and ``runtime.enable_persistent_compilation_cache``. Modelled on the JAX package's own tests of these methods
(``tests/test_kmers.py``, ``tests/test_strand.py``,
``tests/test_reference_goldens.py``, ``tests/test_sequence_collection.py``).
Tolerance: exact equality.
"""

import ast
import bisect
from pathlib import Path

import numpy as np
import pytest
import torch

import genome_kmers_tpu as gj
import genome_kmers_tpu_torch as gt
from genome_kmers_tpu.sequence_collection import bisect_right as jax_bisect_right
from genome_kmers_tpu.sequence_collection import reverse_complement_sba as jax_reverse_complement_sba
from genome_kmers_tpu_torch.sequence_collection import bisect_right, reverse_complement_sba

SEQ_LIST_1 = [("chr1", "ATCGAATTAG")]
SEQ_LIST_2 = [("chr1", "ATCGAATTAG"), ("chr2", "GGATCTTGCATT"), ("chr3", "GTGATTGACCCCT")]
SEQ_LIST_IUPAC = [("chr1", "ATCGNNTTAG"), ("chr2", "GGRYCTTGCNNT"), ("chr3", "GTGATNNNNNCCT")]

# reference docs/overview.rst:46-74 (all sorted 3-mers) and :76-96 (the first
# of each group of size 2-3), as the JAX package's golden test has them
GOLDEN_SORTED_3MERS = [
    "AAT", "ACC", "ATC", "ATC", "ATT", "ATT", "ATT", "CAT", "CCC", "CCC",
    "CCT", "CGA", "CTT", "GAA", "GAC", "GAT", "GAT", "GCA", "GGA", "GTG",
    "TAG", "TCG", "TCT", "TGA", "TGA", "TGC", "TTA", "TTG", "TTG",
]
GOLDEN_FIRST_OF_GROUPS_2_TO_3 = ["ATC", "ATT", "CCC", "GAT", "TGA", "TTG"]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)


def _pkgs(seq_list, strands="forward"):
    return (
        (gj, gj.SequenceCollection(sequence_list=seq_list, strands_to_load=strands)),
        (gt, gt.SequenceCollection(sequence_list=seq_list, strands_to_load=strands, device="cpu")),
    )


# --------------------------------------------------------------------------- #
# equality
# --------------------------------------------------------------------------- #


def _variants(g, sc, sc_other):
    """Indexes that differ from the first in one field each."""
    base = lambda: g.Kmers(sc, 3, 8)  # noqa: E731
    sorted_ = base()
    sorted_.sort()
    assigned = base()
    assigned.kmer_sba_start_indices = assigned.kmer_sba_start_indices[:-1].copy()
    return [
        base(), base(), sorted_, assigned, g.Kmers(sc, 2, 8), g.Kmers(sc, 3, 9),
        g.Kmers(sc, 3, None), g.Kmers(sc_other, 3, 8), g.Kmers(),
    ]


def test_equality_matches_jax():
    """Every pair of a set of indexes compares as in the JAX package: equal
    fields and collections are equal, and one differing field (length,
    state, index, collection) is enough to differ."""
    tables = []
    for g, sc in _pkgs(SEQ_LIST_2):
        other = (g.SequenceCollection(sequence_list=SEQ_LIST_1)
                 if g is gj else g.SequenceCollection(sequence_list=SEQ_LIST_1, device="cpu"))
        ks = _variants(g, sc, other)
        tables.append([[_outcome(lambda: a == b) for b in ks[:-1]] for a in ks[:-1]]
                      + [[_outcome(lambda: ks[-1] == ks[-1])]])
        assert ks[0] == ks[1] and not ks[0] != ks[1] and ks[0] is not ks[1]
        assert ks[0] != ks[2] and ks[2] == ks[2]
    got, want = tables[1], tables[0]
    assert [[x if not isinstance(x, tuple) else x[0] for x in row] for row in got] == [
        [x if not isinstance(x, tuple) else x[0] for x in row] for row in want
    ]


def test_equal_sorted_indexes_on_one_collection_compare_equal():
    for g, sc in _pkgs(SEQ_LIST_IUPAC):
        a, b = g.Kmers(sc, 4, 4), g.Kmers(sc, 4, 4)
        a.sort()
        b.sort()
        assert a == b and not (a != b)


def test_state_flags_match_jax():
    (_, jsc), (_, tsc) = _pkgs(SEQ_LIST_2)
    jk, tk = gj.Kmers(jsc, 3, 8), gt.Kmers(tsc, 3, 8)
    assert (tk._is_initialized, tk._is_set) == (jk._is_initialized, jk._is_set) == (True, False)
    assert (gt.Kmers()._is_initialized, gt.Kmers()._is_set) == (False, False)


# --------------------------------------------------------------------------- #
# strings, comparator, info closure
# --------------------------------------------------------------------------- #


def test_get_kmer_str_no_checks_matches_jax():
    for g, sc in _pkgs(SEQ_LIST_1):
        km = g.Kmers(sc, 3, 3)
        assert km.get_kmer_str_no_checks(0, "+", 3) == "ATC"
    (_, jsc), (_, tsc) = _pkgs(SEQ_LIST_2)
    jk, tk = gj.Kmers(jsc, 3, 8), gt.Kmers(tsc, 3, 8)
    for num in range(len(jk)):
        for k in (1, 3, 8):
            assert tk.get_kmer_str_no_checks(num, "+", k) == jk.get_kmer_str_no_checks(num, "+", k)
    for strand in ("-", "x"):
        assert _outcome(lambda: tk.get_kmer_str_no_checks(0, strand, 3)) == _outcome(
            lambda: jk.get_kmer_str_no_checks(0, strand, 3))


def test_kmer_strings_read_the_revcomp_sba_like_jax():
    """A reverse-complement index reads its own SBA (tests/test_strand.py)."""
    strs, counts = [], []
    for g, sc in _pkgs(SEQ_LIST_2, "reverse_complement"):
        km = g.Kmers.from_strand(sc, 5, 5, source_strand="reverse_complement")
        strs.append([km.get_kmer_str_no_checks(i, "+", 5) for i in range(len(km))])
        km.sort()
        counts.append(km.count_queries([strs[-1][0], strs[-1][3]], 5).tolist())
    assert strs[0] == strs[1] and counts[0] == counts[1]


@pytest.mark.parametrize("seq_list,mn,mx", [(SEQ_LIST_1, 2, None), (SEQ_LIST_2, 3, 5),
                                             (SEQ_LIST_IUPAC, 1, 4)])
def test_get_is_less_than_func_matches_jax(seq_list, mn, mx):
    """Every ordered pair of SBA positions, with and without tie-breaks and
    validation, including the too-short errors (tests/test_kmers.py)."""
    results = []
    for g, sc in _pkgs(seq_list):
        km = g.Kmers(sc, mn, mx)
        sba = sc.forward_sba
        fns = [km.get_is_less_than_func(v, t) for v in (True, False) for t in (False, True)]
        results.append([
            _outcome(lambda: f(a, b)) for f in fns
            for a in range(len(sba)) for b in range(len(sba)) if sba[a] != ord("$") and sba[b] != ord("$")
        ])
    assert results[0] == results[1]
    km = gt.Kmers(gt.SequenceCollection(sequence_list=SEQ_LIST_1, device="cpu"), 2, None)
    lt, lt_ties = km.get_is_less_than_func(True, False), km.get_is_less_than_func(True, True)
    s = "ATCGAATTAG"
    for a in range(9):
        for b in range(9):
            assert lt(a, b) == (s[a:] < s[b:])
            assert lt_ties(a, b) == (s[a:] < s[b:] or (s[a:] == s[b:] and a < b))


@pytest.mark.parametrize("strands", ["forward", "reverse_complement", "both"])
@pytest.mark.parametrize("one_based", [False, True])
def test_generate_get_kmer_info_func_matches_jax(strands, one_based):
    out = []
    for g, sc in _pkgs(SEQ_LIST_2, strands):
        km = (g.Kmers(sc, 3, 6) if strands == "forward"
              else g.Kmers.from_strand(sc, 3, 6, source_strand=strands))
        info = km.generate_get_kmer_info_func(one_based)
        idx = km.kmer_sba_start_indices
        sba = km._host_sba()
        out.append([_outcome(lambda: info(num, idx, sba, k, 1, 2))
                    for num in (-1, 0, 5, len(idx) - 1, len(idx)) for k in (None, 3, 6, 50)])
    assert out[0] == out[1]


def test_getitem_is_the_reference_stub():
    for g, sc in _pkgs(SEQ_LIST_2):
        km = g.Kmers(sc, 3, 3)
        assert km.__getitem__() is None
    assert _outcome(lambda: gt.Kmers(_pkgs(SEQ_LIST_2)[1][1], 3, 3)[0])[0] is TypeError


def test_reference_goldens_through_get_kmer_str_no_checks():
    """The documented workflow (tests/test_reference_goldens.py)."""
    sc = gt.SequenceCollection(sequence_list=SEQ_LIST_2, device="cpu")
    km = gt.Kmers(sc, min_kmer_len=3)
    km.sort()
    out = [km.get_kmer_str_no_checks(info[0], info[1], kmer_len=3)
           for info in km.get_kmers(kmer_len=3, kmer_info_to_yield="full")]
    assert out == GOLDEN_SORTED_3MERS
    gen = km.get_kmers(kmer_len=3, kmer_info_to_yield="full", min_group_size=2, max_group_size=3,
                       yield_first_n=1)
    out = [km.get_kmer_str_no_checks(info[0], info[1], kmer_len=3) for info in gen]
    assert out == GOLDEN_FIRST_OF_GROUPS_2_TO_3


@pytest.mark.parametrize("method", ["get_kmers_full_arrays", "to_csv"])
def test_persistence_and_export_raise_naming_a10(method, tmp_path):
    """The A10 export methods once raised naming A10; ported, they give the
    JAX package's output on the reference's golden genome."""
    km = gt.Kmers(gt.SequenceCollection(sequence_list=SEQ_LIST_2, device="cpu"), 3, 3)
    jk = gj.Kmers(gj.SequenceCollection(sequence_list=SEQ_LIST_2), 3, 3)
    km.sort()
    jk.sort()
    if method == "to_csv":
        fields = ["kmer", "chrom", "start", "strand", "group_size"]
        km.to_csv(3, str(tmp_path / "port.csv"), fields)
        jk.to_csv(3, str(tmp_path / "jax.csv"), fields)
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
        return
    got, want = km.get_kmers_full_arrays(3, True), jk.get_kmers_full_arrays(3, True)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)


# --------------------------------------------------------------------------- #
# the collection side
# --------------------------------------------------------------------------- #


def test_bisect_right_matches_stdlib_and_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = np.sort(rng.integers(0, 100, size=rng.integers(1, 20)))
        x = int(rng.integers(-5, 105))
        assert bisect_right(a, x) == bisect.bisect_right(list(a), x) == jax_bisect_right(a, x)
    assert bisect_right([], 3) == 0


RC_CASES = [
    ("A", "T"),
    ("ACGT", "ACGT"),
    ("AACG", "CGTT"),
    ("ACGT$AAC", "GTT$ACGT"),
    ("ACGTRYSWKMBDHVN", "NBDHVKMWSRYACGT"),
]


@pytest.mark.parametrize("seq,expected", RC_CASES)
def test_reverse_complement_sba_matches_jax(seq, expected):
    sc, jsc = gt.SequenceCollection(device="cpu"), gj.SequenceCollection()
    arr = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    out = reverse_complement_sba(arr, sc._complement_mapping_arr)
    assert bytearray(out).decode() == expected
    assert np.array_equal(out, jax_reverse_complement_sba(arr, jsc._complement_mapping_arr))
    assert reverse_complement_sba(arr, sc._complement_mapping_arr, inplace=True) is arr
    assert bytearray(arr).decode() == expected


def test_mapping_attributes_match_jax():
    sc, jsc = gt.SequenceCollection(device="cpu"), gj.SequenceCollection()
    assert np.array_equal(sc._complement_mapping_arr, jsc._complement_mapping_arr)
    assert sc._complement_mapping_arr.dtype == jsc._complement_mapping_arr.dtype
    assert np.array_equal(sc._get_complement_mapping_array(), jsc._get_complement_mapping_array())
    assert sc._get_complement_mapping_array() is not sc._complement_mapping_arr
    assert np.array_equal(sc._uint8_to_u1_mapping, jsc._uint8_to_u1_mapping)
    assert sc._uint8_to_u1_mapping.dtype == jsc._uint8_to_u1_mapping.dtype
    assert sc._u1_to_uint8_mapping == jsc._u1_to_uint8_mapping


def test_version_matches_jax():
    assert gt.__version__ == gj.__version__ == "0.1.0"


# --------------------------------------------------------------------------- #
# coverage of the JAX package
# --------------------------------------------------------------------------- #

REPO = Path(__file__).resolve().parents[1]
_PAIRS64 = ("uint32 (hi, lo) pair arithmetic: the JAX package runs without 64-bit integers; "
            "the port's positions are int64 tensors (ops/large.split64 / fuse64 make the lanes)")
# the JAX package's public functions and classes that the port has no
# counterpart of, each with its reason
JAX_ONLY = {
    "ops.pallas_kernels.pack_rank2_words_pallas":
        "Pallas entry point: kernels/pack2.py (csrc/pack2.cu) replaces it",
    "ops.pallas_sort.bitonic_sort_tile":
        "Pallas entry point: kernels/lane_sort.py (csrc/lane_sort.cu) replaces it",
    "parallel.distributed.put_global": "places an array on a jax.sharding.NamedSharding",
    "parallel.distributed.mesh_pspec": "a jax PartitionSpec",
    "parallel.distributed.mesh_axes": "the axis names of jax collectives in shard_map",
    "ops.groups.adaptive_bin_count":
        "power-of-two bin counts, so that XLA reuses a compile; the port's histogram is one bincount",
    **{f"ops.large.{name}": _PAIRS64 for name in (
        "add64", "add64_u32", "sub64", "less64", "lesseq64", "min64", "lexmin2", "lexmax2",
        "pairsum_small", "searchsorted64_right", "build_dense_positions_pairs", "split64_np",
        "fuse64_np")},
}


def _module_files(root: Path) -> dict:
    """Dotted module name (relative to the package) -> its source file."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        out[".".join(parts[:-1] if parts[-1] == "__init__" else parts)] = path
    return out


def _public_defs(path: Path) -> dict:
    """The public module-level functions and classes of a source file."""
    return {node.name: node for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_")}


def _bound_names(path: Path) -> set:
    """Every name a source file binds at module level: definitions, imports,
    assignments."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


JAX_MODULES = _module_files(REPO / "genome_kmers_tpu")
PORT_MODULES = _module_files(REPO / "genome_kmers_tpu_torch")


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_port_covers_the_jax_module(module):
    """Each public function and class of the JAX package's module has a
    counterpart of its name in the port's module of the same name, or is in
    ``JAX_ONLY``."""
    wanted = {name for name in _public_defs(JAX_MODULES[module])
              if f"{module}.{name}" not in JAX_ONLY}
    if not wanted:
        return
    assert module in PORT_MODULES, f"the port has no module {module}"
    missing = wanted - _bound_names(PORT_MODULES[module])
    assert not missing, f"{module}: no counterpart of {sorted(missing)}"


def test_jax_only_list_is_current():
    """Every exception names a public definition of the JAX package that the
    port indeed lacks."""
    for qualified in JAX_ONLY:
        module, name = qualified.rsplit(".", 1)
        assert name in _public_defs(JAX_MODULES[module]), qualified
        assert module not in PORT_MODULES or name not in _bound_names(PORT_MODULES[module]), qualified


def _signature(path: Path, name: str) -> tuple:
    args = _public_defs(path)[name].args
    defaults = [ast.unparse(d) for d in args.defaults]
    names = [a.arg for a in args.args]
    return names, dict(zip(names[len(names) - len(defaults):], defaults))


@pytest.mark.parametrize("qualified", [
    "ops.hybrid.ambiguity_mask",
    "ops.hybrid.hybrid_sort_positions", "ops.chunked.sort_positions_chunked",
    "parallel.distributed.distributed_sort_positions",
    "runtime.enable_persistent_compilation_cache",
])
def test_opt_in_sorts_keep_the_jax_signatures(qualified):
    module, name = qualified.rsplit(".", 1)
    assert _signature(PORT_MODULES[module], name) == _signature(JAX_MODULES[module], name)


def test_persistent_compilation_cache_moves_the_build_dir(tmp_path):
    """``enable_persistent_compilation_cache(dir)`` points the libraries'
    paths under ``dir`` and builds nothing; twice is safe; a failed build
    there still raises; without an argument the default comes back."""
    from genome_kmers_tpu_torch import runtime
    from genome_kmers_tpu_torch.kernels import build

    default = build.BUILD_DIR
    source = build.CSRC / "pack2.cu"
    cache = tmp_path / "cache"
    try:
        runtime.enable_persistent_compilation_cache(str(cache))
        runtime.enable_persistent_compilation_cache(str(cache))
        assert build.hashed_library_path(source).parent == cache.resolve()
        assert build.library_path("lane_sort.cu").parent == cache.resolve()
        assert not cache.exists()
        with pytest.raises(RuntimeError, match="failed to build"):
            build.compile_library(source, ["false"], build.library_path("pack2.cu"))
        assert list(cache.iterdir()) == []
    finally:
        runtime.enable_persistent_compilation_cache()
    assert build.BUILD_DIR == default == runtime.DEFAULT_BUILD_DIR
    assert build.hashed_library_path(source).parent == default


def test_small_counterparts_match_jax():
    """The helpers the coverage test asked for: the host 4-bit pack, the
    rank table lookup, the clipped histogram with its total, and the native
    library's loader."""
    import jax.numpy as jnp

    from genome_kmers_tpu.ops import encoding as je
    from genome_kmers_tpu.ops import groups as jg
    from genome_kmers_tpu.ops import keys as jk
    from genome_kmers_tpu_torch import native
    from genome_kmers_tpu_torch.ops import encoding as te
    from genome_kmers_tpu_torch.ops import groups as tg
    from genome_kmers_tpu_torch.ops import keys as tk

    rng = np.random.default_rng(12)
    sba = np.frombuffer(b"$ACGTRYSWKMBDHVN", dtype=np.uint8)[rng.integers(0, 16, 300)]
    assert np.array_equal(te.pack_rank_words_np(sba), je.pack_rank_words_np(sba))
    assert np.array_equal(tk.ascii_to_ranks(torch.from_numpy(sba)).numpy(),
                          np.asarray(jk.ascii_to_ranks(jnp.asarray(sba))))
    boundary = rng.random(200) < 0.3
    boundary[0] = True
    jb, tb = jnp.asarray(boundary), torch.from_numpy(boundary)
    jsize, tsize = jg.group_sizes_at_boundaries(jb), tg.group_sizes_at_boundaries(tb)
    for mn, mx, bins in ((1, None, 5), (2, 4, 3)):
        want = jg.group_size_histogram(jb, jsize, mn, jnp.uint32(0xFFFFFFFF if mx is None else mx), bins)
        got = tg.group_size_histogram(tb, tsize, mn, mx, bins)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])) and got[1] == int(want[1])
    assert native.get_lib() is native.get_lib()
