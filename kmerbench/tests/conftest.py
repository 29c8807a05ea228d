"""Tests of the benchmark's own code. They run on the CPU; the ones marked
``card`` need a CUDA card and skip without one:

    python -m pytest kmerbench/tests            # on the CPU
    python -m pytest kmerbench/tests -m card    # on a machine with a card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")
