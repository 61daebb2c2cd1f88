"""The benchmark's own tests: `python -m pytest slambench/tests -q` on the
CPU; the tests marked `card` run where a CUDA device is (through the chip
tool: `python -m pytest slambench/tests -q -m card -s`)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the cells' own sizes); skips "
        "without one")


@pytest.fixture
def card():
    """cuda:0, or a skip where this machine has no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own sizes "
                    "on the card")
    return torch.device("cuda", 0)
