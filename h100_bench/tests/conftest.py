"""Tests of the H100 benchmark.  Run from the repository root:

    python -m pytest h100_bench/tests -q            # here, on the CPU
    python -m pytest h100_bench/tests -q -m cuda    # on the card

Tests marked ``cuda`` need the card and skip without one; each decides
inside a fixture, never while the module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA GPU (runs a cell on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
