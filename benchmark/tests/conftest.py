"""Tests of the benchmark's harness. Tests marked `card` need a CUDA
device and skip without one; whether there is one is decided inside the
`cuda_card` fixture, never while a module is imported. Run them on the
card with `python3 -m pytest benchmark/tests -m card`."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
