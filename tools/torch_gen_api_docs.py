#!/usr/bin/env python
"""Generate docs/torch_api_reference.md, the API reference of the PyTorch
port ``genome_kmers_tpu_torch``, from its live signatures and docstrings.

The counterpart of ``tools/gen_api_docs.py``, over the same surface of the
port: the package's classes (``SequenceCollection``, ``Kmers``,
``LargeKmers``) with their methods and properties, the rest of the
package's ``__all__``, ``ops.filters``' classes and filter factories,
``parallel.__all__``, and the public functions of ``profiling``,
``io.fasta`` and ``runtime``. Each symbol's signature and docstring go out
verbatim. Where a symbol departs from the JAX package's surface, its
heading says how, read off its signature and docstring: a ``device=``
argument, an ``on_round`` callback, int64 positions, torch tensors in a
``VectorizedFilter``'s ``mask_fn``, a mesh across processes. The page is
the same bytes with or without a CUDA card: no memory address, no torch
build string and no device-dependent default goes into it. It imports
torch and the port, never jax.

    python tools/torch_gen_api_docs.py            # write the page
    python tools/torch_gen_api_docs.py --check    # exit 1 if it is stale

``tests/test_torch_api_docs.py`` regenerates the page and holds it byte for
byte.
"""

import inspect
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
TARGET = REPO / "docs" / "torch_api_reference.md"

FILTER_CLASSES = (
    "KmerFilter", "KeepAllFilter", "LengthFilter", "HomopolymerFilter", "GcContentFilter",
    "NoAmbiguousBasesFilter", "CrisprNggPamFilter", "VectorizedFilter",
)
FILTER_FUNCTIONS = (
    "gen_kmer_length_filter_func", "gen_kmer_homopolymer_filter_func",
    "gen_kmer_gc_content_filter_func", "gen_no_ambiguous_bases_filter", "kmer_has_required_len",
)
# (mark, test on (parameter names, docstring)): the port's departures from
# the JAX package's surface
DEPARTURES = (
    ("`device=`", lambda params, doc: "device" in params or "devices" in params),
    ("`on_round`", lambda params, doc: "on_round" in params),
    ("int64 positions", lambda params, doc: re.search(
        r"int64\b[^.;]*\bposition|\bposition[^.;]*\bint64", " ".join(doc.split())) is not None),
    ("torch tensors in `mask_fn`", lambda params, doc: "mask_fn" in doc and "torch" in doc),
    ("process mesh", lambda params, doc: "torch.distributed" in doc or "across processes" in doc),
)


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _sig(obj) -> str:
    sig = _signature(obj)
    if sig is None:
        return "(...)"
    # an instance default (a library filter) prints without its address
    return re.sub(r"<([\w.]+) object at 0x[0-9a-fA-F]+>", r"<\1>", str(sig))


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(no docstring)*"


def _flag(obj) -> str:
    sig = _signature(obj) if callable(obj) else None
    params = set(sig.parameters) if sig is not None else set()
    doc = inspect.getdoc(obj) or ""
    marks = [mark for mark, test in DEPARTURES if test(params, doc)]
    return f" — **port:** {', '.join(marks)}" if marks else ""


def _emit_callable(out, name, obj, level="###"):
    out += [f"{level} `{name}{_sig(obj)}`{_flag(obj)}", "", _doc(obj), ""]


def _emit_class(out, name, cls):
    out += [f"## class `{name}`{_flag(cls)}", "", _doc(cls), ""]
    _emit_callable(out, f"{name}.__init__", cls.__init__)
    for mname in sorted(dir(cls)):
        if mname.startswith("_"):
            continue
        m = inspect.getattr_static(cls, mname)
        if isinstance(m, property):
            out += [f"### property `{name}.{mname}`{_flag(m.fget)}", "", _doc(m.fget), ""]
        elif isinstance(m, (staticmethod, classmethod)):
            _emit_callable(out, f"{name}.{mname}", m.__func__)
        elif callable(m):
            _emit_callable(out, f"{name}.{mname}", m)
        else:
            out += [f"### attribute `{name}.{mname} = {m!r}`", ""]


def _emit_module_functions(out, module):
    for name in sorted(dir(module)):
        obj = getattr(module, name)
        if (not name.startswith("_") and callable(obj)
                and getattr(obj, "__module__", "") == module.__name__):
            _emit_callable(out, name, obj, level="##")


def generate() -> str:
    import genome_kmers_tpu_torch as g
    from genome_kmers_tpu_torch import parallel, profiling, runtime, tracing
    from genome_kmers_tpu_torch.io import fasta
    from genome_kmers_tpu_torch.ops import filters as f

    out = [
        "# genome-kmers-tpu PyTorch port API reference",
        "",
        "*Generated by `tools/torch_gen_api_docs.py` from live docstrings — do not edit by"
        " hand (a test regenerates it and fails on drift).*",
        "",
        "The port keeps the JAX package's documented surface: the same names, and each"
        " parameter by name, order and default (`tests/test_torch_signatures.py` holds"
        " that). A heading marked **port:** says where the symbol departs from it: a"
        " `device=` argument (the torch device, \"cuda\" by default; pass \"cpu\" without a"
        " card), an `on_round` callback, int64 positions where the JAX package has uint32,"
        " torch tensors in a `VectorizedFilter`'s `mask_fn`, or a mesh across the"
        " processes of `torch.distributed`.",
        "",
        "# Package `genome_kmers_tpu_torch`",
        "",
        _doc(g),
        "",
    ]
    for cls_name in ("SequenceCollection", "Kmers", "LargeKmers"):
        _emit_class(out, cls_name, getattr(g, cls_name))

    out += ["## Module-level functions (`genome_kmers_tpu_torch`)", ""]
    for name in sorted(g.__all__):
        obj = getattr(g, name)
        if inspect.isclass(obj):
            continue
        if callable(obj):
            _emit_callable(out, name, obj)
        else:
            out += [f"### `{name}`{_flag(obj)}", "",
                    f"Instance of `{type(obj).__name__}`: {_doc(obj)}", ""]

    out += ["# Module `genome_kmers_tpu_torch.ops.filters`", "", _doc(f), ""]
    for name in FILTER_CLASSES:
        _emit_class(out, name, getattr(f, name))
    for name in FILTER_FUNCTIONS:
        _emit_callable(out, name, getattr(f, name), level="##")

    out += ["# Module `genome_kmers_tpu_torch.parallel`", "", _doc(parallel), ""]
    for name in sorted(parallel.__all__):
        obj = getattr(parallel, name)
        if callable(obj) and not inspect.isclass(obj):
            _emit_callable(out, name, obj, level="##")
        elif isinstance(obj, str):
            out += [f"## `{name}`", "",
                    f"`{obj!r}` — the mesh axis name for position-sharded data parallelism.", ""]
        else:
            out += [f"## `{name}`{_flag(obj)}", "", _doc(obj), ""]

    for title, module in (("profiling", profiling), ("io.fasta", fasta), ("runtime", runtime),
                          ("tracing", tracing)):
        out += [f"# Module `genome_kmers_tpu_torch.{title}`", "", _doc(module), ""]
        _emit_module_functions(out, module)

    return "\n".join(out).rstrip() + "\n"


def main() -> int:
    text = generate()
    if "--check" in sys.argv:
        current = TARGET.read_text() if TARGET.exists() else ""
        if current != text:
            print("docs/torch_api_reference.md is stale: regenerate it with "
                  "python tools/torch_gen_api_docs.py")
            return 1
        print("docs/torch_api_reference.md is up to date")
        return 0
    TARGET.write_text(text)
    print(f"wrote {TARGET.relative_to(REPO)} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
