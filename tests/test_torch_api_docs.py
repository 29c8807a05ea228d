"""docs/torch_api_reference.md, the port's API reference, is generated from
the port's live signatures and docstrings by tools/torch_gen_api_docs.py:
regenerate it and require the committed page byte for byte, so that it
cannot drift from the code. The generator reads the port only: its source
imports no JAX, and the page documents no symbol of the JAX package."""

import ast
import importlib.util
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "torch_gen_api_docs.py"
PAGE = REPO / "docs" / "torch_api_reference.md"


def _load_tool():
    spec = importlib.util.spec_from_file_location("torch_gen_api_docs", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_torch_api_reference_up_to_date():
    assert PAGE.read_text() == _load_tool().generate(), (
        "docs/torch_api_reference.md is stale: run python tools/torch_gen_api_docs.py")


def test_generator_and_page_stay_on_the_port():
    imported = set()
    for node in ast.walk(ast.parse(TOOL.read_text())):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert imported <= {"inspect", "re", "sys", "pathlib", "genome_kmers_tpu_torch"}, imported
    headings = [line for line in PAGE.read_text().splitlines() if line.startswith("#")]
    assert not [h for h in headings if re.search(r"\bgenome_kmers_tpu\b(?!_torch)|\bjax\b", h)]
    assert "0x" not in "\n".join(headings)  # no memory address in a signature
