"""Tests of the benchmark's harness. On the CPU they run the harness at
tiny sizes through the port's plain versions; the tests marked ``card``
need a CUDA device and decide so inside a fixture."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs on the card")
    return torch.device("cuda")
