"""The port's signatures against the JAX package's, by AST (no JAX import,
no compile).

For every public module-level function and class of the JAX package that
the port's module of the same name binds (``test_torch_api_parity`` holds
that coverage), and for the non-callable names of the documented
``__all__`` lists: each JAX parameter is in the port's signature by name,
in order and with the same default, and any parameter the port adds comes
after them with a default, so that a call written to the JAX API means the
same on the port. A class's public methods, ``__init__`` and class
attributes (such as ``KmerFilter.batchable``) are held the same way,
inherited members included. Defaults compare after a light normalisation:
``jnp``/``np`` integer scalars as ints, lists as tuples, a filter instance
as its class name. ``BY_DESIGN`` names the symbols whose signatures differ
on purpose, each with its reason; a test holds that each of them still
differs.
"""

import ast
from functools import lru_cache
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "genome_kmers_tpu"
PORT_ROOT = REPO / "genome_kmers_tpu_torch"

_INT64 = ("positions are one int64 tensor where the JAX package carries a uint32 (hi, lo) "
          "pair: it runs without 64-bit integers")
BY_DESIGN = {
    "ops.keys.valid_len_all":
        "takes the row count ``length`` where the JAX package takes an ``iota`` tensor: the "
        "dense sorts would otherwise build a 2^27-row iota only to read its length",
    "ops.large.build_key2_words_strided": _INT64,
    "ops.large.build_key_words_strided": _INT64,
    "ops.large.compute_valid_len64": _INT64 + "; so are the segment bounds",
    "parallel.large.distributed_group_size_histogram_large_ragged": _INT64,
    "parallel.large.rebuild_large_lanes": _INT64,
    "parallel.query.distributed_count_queries_large": _INT64,
    "parallel.sample_sort.distributed_adjacent_gids_large": _INT64,
    "parallel.distributed.mesh_lanes_filter_flags":
        "adds a required ``mesh``: a sharded array of the port is a list of per-shard tensors, "
        "which does not name its mesh, where the JAX program reads it off the arrays' sharding",
    "parallel.large.large_lanes_filter_flags":
        _INT64 + "; the caps come from the segment bounds on each shard (``seg_starts_u64``, "
        "``seg_ends_u64``, ``mesh``) where the JAX program takes a cap lane and a ``base``",
}


def _module_path(root: Path, module: str) -> Path:
    base = root.joinpath(*module.split(".")) if module else root
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _modules(root: Path) -> list:
    out = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


@lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def _assigned(node, name: str) -> bool:
    return isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == name for t in node.targets)


def _resolve(root: Path, module: str, name: str):
    """(module, node) of the definition or assignment that binds ``name``
    in ``module``, through the package's relative imports; None if none."""
    path = _module_path(root, module)
    if not path.exists():
        return None
    body = _tree(path).body
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
            return module, node
    for node in body:
        if _assigned(node, name):
            return module, node
    package = module.split(".") if path.name == "__init__.py" else module.split(".")[:-1]
    for node in body:
        if isinstance(node, ast.ImportFrom) and node.level and node.module:
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    base = package[: len(package) - (node.level - 1)]
                    return _resolve(root, ".".join(base + node.module.split(".")), alias.name)
    return None


def _normalise(node, root: Path, module: str) -> str:
    """A default value or class attribute as a comparable string."""
    if node is None:
        return "<required>"
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name) and node.func.value.id in ("jnp", "np")
            and len(node.args) == 1 and not node.keywords):
        try:
            value = ast.literal_eval(node.args[0])
        except ValueError:
            value = None
        if isinstance(value, int):
            return repr(value)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and not node.args:
        return f"<instance of {node.func.id}>"
    if isinstance(node, ast.Name):
        found = _resolve(root, module, node.id)
        if found is not None and isinstance(found[1], ast.Assign):
            return _normalise(found[1].value, root, found[0])
        return node.id
    try:
        value = ast.literal_eval(node)
    except ValueError:
        return ast.unparse(node)
    return repr(_as_tuples(value))


def _as_tuples(value):
    if isinstance(value, (list, tuple)):
        return tuple(_as_tuples(v) for v in value)
    return value


def _params(fn: ast.FunctionDef, root: Path, module: str) -> list:
    """[(name, default)] in call order; ``*args`` and ``**kwargs`` as
    their starred names, keyword-only parameters after a ``*`` marker."""
    a = fn.args
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, _normalise(d, root, module)) for p, d in zip(positional, defaults)]
    if a.vararg is not None:
        out.append((f"*{a.vararg.arg}", "<varargs>"))
    elif a.kwonlyargs:
        out.append(("*", "<marker>"))
    out += [(p.arg, _normalise(d, root, module)) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg is not None:
        out.append((f"**{a.kwarg.arg}", "<kwargs>"))
    return out


def _members(root: Path, module: str, cls: ast.ClassDef) -> dict:
    """name -> (module, node) of a class's public methods, ``__init__`` and
    public class attributes, its bases' first (within the package)."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            found = _resolve(root, module, base.id)
            if found is not None and isinstance(found[1], ast.ClassDef):
                out.update(_members(root, found[0], found[1]))
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and (
                not node.name.startswith("_") or node.name == "__init__"):
            out[node.name] = (module, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = (module, node)
        elif (isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
              and not node.target.id.startswith("_") and node.value is not None):
            out[node.target.id] = (module, node)
    return out


def _shape(root: Path, module: str, node) -> object:
    """What is compared: a function's parameters, an assignment's value."""
    if isinstance(node, ast.FunctionDef):
        return _params(node, root, module)
    return _normalise(node.value, root, module)


def _all_names(root: Path, module: str) -> list:
    for node in _tree(_module_path(root, module)).body:
        if _assigned(node, "__all__"):
            return ast.literal_eval(node.value)
    return []


def _symbols() -> dict:
    """Qualified JAX symbol -> (JAX (module, node), port (module, node))."""
    out = {}

    def add(qualified, jax_def, port_def):
        out[qualified] = (jax_def, port_def)

    for module in _modules(JAX_ROOT):
        for node in _tree(_module_path(JAX_ROOT, module)).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
                continue
            port = _resolve(PORT_ROOT, module, node.name)
            if port is None:
                continue  # test_torch_api_parity holds the coverage
            qualified = f"{module}.{node.name}"
            if isinstance(node, ast.FunctionDef):
                add(qualified, (module, node), port)
                continue
            port_members = (_members(PORT_ROOT, *port)
                            if isinstance(port[1], ast.ClassDef) else {})
            for name, jax_member in _members(JAX_ROOT, module, node).items():
                add(f"{qualified}.{name}", jax_member, port_members.get(name))
    # the documented non-callables: the package's and parallel's __all__
    for module in ("", "parallel"):
        for name in _all_names(JAX_ROOT, module):
            jax_def = _resolve(JAX_ROOT, module, name)
            if isinstance(jax_def[1], ast.Assign):
                add(f"{module or 'genome_kmers_tpu'}.{name}", jax_def,
                    _resolve(PORT_ROOT, module, name))
    return out


SYMBOLS = _symbols()


def _differences(qualified: str) -> list:
    (j_mod, j_node), port = SYMBOLS[qualified]
    if port is None:
        return [f"the port has no {qualified}"]
    p_mod, p_node = port
    want, got = _shape(JAX_ROOT, j_mod, j_node), _shape(PORT_ROOT, p_mod, p_node)
    if not isinstance(want, list):
        return [] if want == got else [f"value {got} where the JAX package has {want}"]
    if not isinstance(got, list):
        return [f"not a function in the port: {got}"]
    problems = []
    if got[: len(want)] != want:
        problems.append(f"parameters {got} where the JAX package has {want}")
    extra = got[len(want):]
    if any(default == "<required>" for _, default in extra):
        problems.append(f"added parameters without a default: {extra}")
    return problems


@pytest.mark.parametrize("qualified", sorted(q for q in SYMBOLS if q not in BY_DESIGN))
def test_port_keeps_the_jax_signature(qualified):
    assert not _differences(qualified), _differences(qualified)


@pytest.mark.parametrize("qualified", sorted(BY_DESIGN))
def test_by_design_list_is_current(qualified):
    """Each listed symbol exists on both sides and still differs."""
    assert qualified in SYMBOLS and SYMBOLS[qualified][1] is not None
    assert _differences(qualified), f"{qualified} now matches: take it off BY_DESIGN"


@pytest.mark.parametrize("qualified", [
    "ops.sort.sort_positions_dense", "ops.sort.sort_positions",
    "parallel.distributed.distributed_group_size_histogram_ragged",
    "ops.filters.KmerFilter.batchable", "ops.filters.VectorizedFilter.batchable",
    "ops.filters.FilterContext.__init__", "ops.groups.fold_err_conditions",
    "ops.groups.selection_masks", "ops.groups.sizes_digest",
    "ops.canonical.canonical_sizes_digest_dense",
])
def test_the_surface_under_test_includes(qualified):
    """The symbols whose JAX contracts the port once lacked are among the
    cases above, so a change in how the cases are found cannot drop them."""
    assert qualified in SYMBOLS and qualified not in BY_DESIGN
