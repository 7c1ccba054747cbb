"""The launch slots on the card: a steady launch makes no pinned host
allocation and constructs no CUDA event, and its rows equal those of the
CPU co-scheduler on the same operands.  Needs a CUDA
device and the kernel library's toolchain; skips without a device.  Run on
the card with ``PYTHONPATH=src python3 -m pytest -q -m chip
tests/test_torch_launch_slots_card.py``.  The CPU half of the slot tests, against the JAX package,
is ``tests/test_torch_launch_slots.py``; this file imports no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import field as TF
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.core.scheduler.rectangular import StackedBatch

Q = TF.DILITHIUM_Q
LAUNCHES = 1000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")
    return torch.device("cuda", 0)


@pytest.mark.chip
def test_steady_launches_allocate_no_pinned_memory_and_make_no_event(
        cuda_device, monkeypatch):
    """1,000 launches of one warm Dilithium d = 256 program of 8 rows: the
    pinned host allocator's counts do not move, no ``torch.cuda.Event`` is
    made, the program keeps one slot, and every launch's rows equal the
    CPU co-scheduler's for the same operand."""
    workload, d, n = "dilithium", 256, 8
    cos = TCOS.SliceCoScheduler(device=cuda_device)
    rng = np.random.default_rng(23)
    ops = [rng.integers(0, Q, (n, d), dtype=np.uint64).astype(np.uint32)
           for _ in range(8)]
    batches = [StackedBatch(workload=workload, d_bucket=d, operand=op,
                            requests=[types.SimpleNamespace(tenant_id=i)
                                      for i in range(n)])
               for op in ops]
    cpu = TCOS.SliceCoScheduler(device="cpu")
    want = [cpu.dispatch(b).rows for b in batches]
    np.testing.assert_array_equal(cos.dispatch(batches[0]).rows, want[0])

    made = []
    real = torch.cuda.Event

    class CountedEvent(real):
        def __new__(cls, *args, **kwargs):
            made.append(1)
            return super().__new__(cls, *args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    before = torch.cuda.host_memory_stats()
    for i in range(LAUNCHES):
        res = cos.dispatch(batches[i % len(batches)])
        np.testing.assert_array_equal(res.rows, want[i % len(batches)])
    after = torch.cuda.host_memory_stats()
    assert made == []
    for key in ("num_host_alloc", "allocations.allocated"):
        assert after[key] == before[key], key
    stats = cos.program_stats()
    assert (stats["slots"], stats["slot_grows"]) == (1, 0)
