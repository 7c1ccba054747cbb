"""Test settings of the benchmark's own tests.

Tests that need the card carry ``@pytest.mark.chip`` and take the
``cuda_device`` fixture, which skips them where there is no CUDA device; the
decision is made when the test runs, never at import.  Run them on the card
with ``python3 -m pytest -q -m chip ffbench``.

``bn254_config`` is a configuration whose coefficients are BN254 scalar
field elements of 8 words: the request law of the paper's BN254 half
(section 7.4), kept here until the program serves it.
"""
import json
from pathlib import Path

import pytest

from ffbench.reference.bn254_fr_ntt import R as BN254_R


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return "cuda"


@pytest.fixture
def bn254_config():
    serve = json.loads((Path(__file__).resolve().parent / "configs"
                        / "dilithium_mix.json").read_text())["serve"]
    return {
        "name": "bn254_full_mix",
        "workload": "bn254_full",
        "modulus": str(BN254_R),
        "reference": "bn254_fr_ntt",
        "degrees": {"law": "uniform", "low": 64, "high": 512},
        "coefficients": {"law": "uniform", "low": 0, "high": str(BN254_R),
                         "words": 8},
        "work": {"channels": 18, "channel_bits": 31, "element_bytes": 32},
        "serve": serve,
    }
