"""The port never imports JAX or anything of the JAX package, and
``chip_smoke.py`` refuses to run, and prints no result, without a CUDA
card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "module",
    ["genome_kmers_tpu_torch", "genome_kmers_tpu_torch.interop", "chip_smoke",
     "genome_kmers_tpu_torch.kernels.lane_sort", "genome_kmers_tpu_torch.ops.sort",
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
     "genome_kmers_tpu_torch.runtime"],
)
def test_import_loads_no_jax(module):
    code = (
        f"import sys, {module}\n"
        "banned = ('jax', 'genome_kmers_tpu')\n"
        "assert not any(m in banned or m.startswith(tuple(b + '.' for b in banned))"
        " for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "script", ["torch_run_soak", "torch_run_applications", "torch_run_e2e_validation"])
def test_tool_import_loads_no_jax(script):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('{script}', 'tools/{script}.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "banned = ('jax', 'genome_kmers_tpu')\n"
        "assert 'genome_kmers_tpu_torch' in sys.modules\n"
        "assert not any(m in banned or m.startswith(tuple(b + '.' for b in banned))"
        " for m in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


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
