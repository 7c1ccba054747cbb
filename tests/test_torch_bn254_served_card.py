"""BN254 scalar-field transforms served through ``CryptoServer`` on the card:
8 rows of ``bn254_full`` field elements at every bucket (64, 128, 256, 512),
the last row of each all r − 1, answered word for word as the benchmark's
plain reference (``ffbench/reference/bn254_fr_ntt.py``, on the card) and as
the CPU's program gives them.  Needs a CUDA device and the kernel library's
toolchain; skips without a device.  Run on the card with
``PYTHONPATH=src python3 -m pytest -q -m chip
tests/test_torch_bn254_served_card.py``.  The CPU half is
``tests/test_torch_bn254_served.py``; this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from ffbench.reference import bn254_fr_ntt as REF
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.core.scheduler.queue import TenantRequest
from repro_torch.core.scheduler.rectangular import StackedBatch
from repro_torch.serve.server import CryptoServer, ServeConfig

P = REF.R
WORDS = 8
ROWS = 8
BUCKETS = (64, 128, 256, 512)
PAPER = dict(n_c=8, max_age_s=0.005, max_pending=1024,
             accum="fp32_mantissa", reduction="eager", validate=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return "cuda"


def _rows(d: int, seed: int) -> np.ndarray:
    """(ROWS, d, 8) uint32 words of elements uniform in [0, r), the last
    row all r − 1."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(d)]
            for _ in range(ROWS - 1)] + [[P - 1] * d]
    return np.array([[[(v >> (32 * k)) & 0xFFFFFFFF for k in range(WORDS)]
                      for v in row] for row in vals], np.uint32)


@pytest.mark.chip
def test_every_bucket_on_the_card_equals_the_reference_and_the_cpu(
        cuda_device):
    server = CryptoServer(ServeConfig(**PAPER), coscheduler=SliceCoScheduler(
        device=cuda_device))
    cpu = SliceCoScheduler(device="cpu", merge_rows_max=ROWS)
    sent = {}
    for d in BUCKETS:
        x = _rows(d, seed=d)
        reqs = [TenantRequest(d * 100 + i, "bn254_full", d, 0.0, coeffs=row)
                for i, row in enumerate(x)]
        sent[d] = x, reqs, [server.submit(r, now=0.0) for r in reqs]
    server.drain(0.0)
    for d, (x, reqs, handles) in sent.items():
        got = np.stack([h.result() for h in handles])
        assert got.shape == (ROWS, d, WORDS) and got.dtype == np.uint32
        want = REF.transform(torch.from_numpy(x.astype(np.int64)).to(
            cuda_device), P).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        on_cpu = cpu.dispatch(StackedBatch("bn254_full", d, reqs, x)).rows
        np.testing.assert_array_equal(got, on_cpu)
    ops = server.cos.program_stats()["stage_ops"]
    assert sorted(ops) == sorted(f"bn254_full/d{d}" for d in BUCKETS)
    assert len({ops[k]["reduce"] for k in ops}) == 1
