"""The port never imports JAX or anything of the JAX package, and
``chip_smoke.py`` refuses to run, and prints no result, without a CUDA
card.

One fresh interpreter a test worker (a module-scoped fixture) imports the
modules, then loads the tools, in a fixed order and records after each
step which modules of JAX or of the JAX package are loaded. Each case
asserts on its own step: nothing banned may be loaded once its module is
imported. A module that brought JAX in earlier fails every later case too,
so an earlier import cannot hide a later one's; the message names the
first step that brought it in.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "genome_kmers_tpu_torch", "genome_kmers_tpu_torch.interop", "chip_smoke",
    "genome_kmers_tpu_torch.kernels.lane_sort", "genome_kmers_tpu_torch.kernels.group_hist",
    "genome_kmers_tpu_torch.kernels.lanes_flags",
    "genome_kmers_tpu_torch.ops.sort",
    "genome_kmers_tpu_torch.kmers", "genome_kmers_tpu_torch.sequence_collection",
    "genome_kmers_tpu_torch.ops.filters", "genome_kmers_tpu_torch.ops.groups",
    "genome_kmers_tpu_torch.native", "genome_kmers_tpu_torch.ops.query",
    "genome_kmers_tpu_torch.ops.canonical", "genome_kmers_tpu_torch.parallel",
    "genome_kmers_tpu_torch.parallel.collectives", "genome_kmers_tpu_torch.parallel.distributed",
    "genome_kmers_tpu_torch.parallel.sample_sort", "genome_kmers_tpu_torch.parallel.query",
    "genome_kmers_tpu_torch.parallel.checkpoint", "genome_kmers_tpu_torch.parallel.hier",
    "genome_kmers_tpu_torch.profiling",
    "genome_kmers_tpu_torch.io.csv_out", "genome_kmers_tpu_torch.large_kmers",
    "genome_kmers_tpu_torch.ops.large", "genome_kmers_tpu_torch.parallel.large",
    "genome_kmers_tpu_torch.ops.hybrid", "genome_kmers_tpu_torch.ops.chunked",
    "genome_kmers_tpu_torch.runtime", "genome_kmers_tpu_torch.tracing",
]
TOOLS = ["torch_run_soak", "torch_run_applications", "torch_run_e2e_validation",
         "torch_gen_api_docs"]

# Runs in the fresh interpreter: prints one JSON object, step -> the banned
# modules loaded after it. The API page generator is also run, since it
# imports the port's modules as it walks them.
_RECORDER = """
import importlib, importlib.util, json, sys
banned = ('jax', 'genome_kmers_tpu')
def loaded():
    return sorted(m for m in sys.modules
                  if m in banned or m.startswith(tuple(b + '.' for b in banned)))
out = {}
for module in MODULES:
    importlib.import_module(module)
    out[module] = loaded()
for tool in TOOLS:
    spec = importlib.util.spec_from_file_location(tool, f'tools/{tool}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if tool == 'torch_gen_api_docs':
        mod.generate()
    out[tool] = loaded() + ([] if 'genome_kmers_tpu_torch' in sys.modules else ['<no port>'])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def banned_after():
    code = f"MODULES = {MODULES!r}\nTOOLS = {TOOLS!r}\n" + _RECORDER
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def _check(banned_after: dict, step: str) -> None:
    banned = banned_after[step]
    first = next((s for s in MODULES + TOOLS if banned_after[s]), None)
    assert not banned, (f"{len(banned)} modules ({', '.join(banned[:3])}, ...) loaded by the "
                        f"time {step} was imported; first brought in by {first}")


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax(module, banned_after):
    _check(banned_after, module)


@pytest.mark.parametrize("script", TOOLS)
def test_tool_import_loads_no_jax(script, banned_after):
    _check(banned_after, script)


def test_chip_smoke_fails_without_cuda():
    code = (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    for line in proc.stdout.splitlines():
        assert not (line.startswith("{") and json.loads(line).get("ok"))
