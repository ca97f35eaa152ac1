"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the root of the repository (on the CPU; those marked `card` run on a
CUDA card and skip elsewhere)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")
