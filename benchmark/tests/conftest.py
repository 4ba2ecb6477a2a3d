"""Tests of the benchmark harness (``pytest benchmark/tests``).

Tests marked ``card`` need an NVIDIA card; whether there is one is decided
inside the ``card`` fixture, never while a module is imported, so every
worker collects the same tests. On the card: ``python3 -m pytest
benchmark/tests -m card``.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on the card")
    return torch.device("cuda")
