"""Tests of the benchmark harness.  CPU tests run at smoke sizes; tests
marked ``card`` need the H100 and skip without it:

    python3 -m pytest -q portbench/tests            # CPU
    python3 -m pytest -q portbench/tests -m card    # on the card
"""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for path in (BENCH, os.path.join(os.path.dirname(BENCH), "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA H100 (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
