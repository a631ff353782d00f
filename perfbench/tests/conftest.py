"""The benchmark's tests: on the CPU at reduced sizes, except those marked
``cuda``, which need a card and skip without one (decided in the fixture,
never at import)."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")
