"""Test settings of the benchmark's own tests.

Tests that need the card carry ``@pytest.mark.chip`` and take the
``cuda_device`` fixture, which skips them where there is no CUDA device; the
decision is made when the test runs, never at import.  Run them on the card
with ``python3 -m pytest -q -m chip ffbench``.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return "cuda"
