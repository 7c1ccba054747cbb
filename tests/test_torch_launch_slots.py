"""The co-scheduler's launch slots (``repro_torch.core.scheduler.program.
LaunchSlot``): each program's ring of host buffers, events and graphs that
every launch goes through, held by a launch group until its gather.

On the CPU a slot is plain tensors and the launch runs ``e2e`` eagerly
between the slot's copies, so these tests hold the slot bookkeeping to the
JAX co-scheduler's ``jitted_for`` rows and to the transform's oracle: rows
after slots are reused, flights in the air at once, flights dropped
without a gather, results kept after later launches, and the counters
``slots`` and ``slot_grows``.  The card's part (no pinned allocation and no
event made by a steady launch) is in ``tests/test_torch_launch_slots_card.py``.
"""
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.scheduler import coscheduler as JCOS
from repro_torch.core import field as TF
from repro_torch.core import ntt as NTT
from repro_torch.core.scheduler import TenantRequest as TReq
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.core.scheduler.rectangular import StackedBatch
from repro_torch.serve import CryptoServer, ServeConfig

Q = TF.DILITHIUM_Q
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
# as tests/test_torch_programs.py: Dilithium d = 256 eager and lazy, BN254
# at d = 16 (nine channels and rns_to_field)
CONFIGS = {"dilithium-eager": ({}, "dilithium", 256),
           "dilithium-lazy": (MIXED, "dilithium", 256),
           "bn254": ({}, "bn254", 16)}
ROWS = 3


def _live(rng, cos, workload, d, n=ROWS):
    """n rows of residues (uint32) for one launch of the class."""
    if workload == "dilithium":
        return rng.integers(0, Q, (n, d), dtype=np.uint64).astype(np.uint32)
    moduli = np.array(cos.engine_for(workload, d).chain.moduli, np.uint64)
    raw = rng.integers(0, 2**31, (n, d, len(moduli)), dtype=np.uint64)
    return (raw % moduli).astype(np.uint32)


def _batch(workload, d, operand, first_tid=0):
    reqs = [types.SimpleNamespace(tenant_id=first_tid + i)
            for i in range(operand.shape[0])]
    return StackedBatch(workload=workload, d_bucket=d, requests=reqs,
                        operand=operand)


def _oracle_rows(operand, d=None):
    d = operand.shape[1] if d is None else d
    w = NTT.ntt_matrix(d, Q, negacyclic=True).astype(np.int64)
    x = np.zeros((operand.shape[0], d), np.int64)
    x[:, :operand.shape[1]] = operand
    return ((x @ w) % Q).astype(np.uint32)


def _dil_batches(seed, n_batches, n=ROWS, d=64):
    rng = np.random.default_rng(seed)
    return [_batch("dilithium", d, _live(rng, None, "dilithium", d, n), i * n)
            for i in range(n_batches)]


def _slots(cos):
    stats = cos.program_stats()
    return stats["slots"], stats["slot_grows"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_rows_equal_jax_jitted_for_after_reuse(name):
    """Two flights of one program in the air (two slots), then six launches
    in turn through the same slots, 8 = 4 x the slot count in all: every
    launch's rows equal the JAX co-scheduler's compiled program on the same
    operand, bit for bit."""
    kw, workload, d = CONFIGS[name]
    jc = JCOS.SliceCoScheduler(**kw)
    tc = TCOS.SliceCoScheduler(device="cpu", **kw)
    rng = np.random.default_rng(31)
    ops = [_live(rng, tc, workload, d) for _ in range(8)]
    jitted = jc.jitted_for(workload, d)
    planes = jc.device_planes_for(workload, d)

    def check(res, op):
        want = np.asarray(jitted(jnp.asarray(op), planes))
        np.testing.assert_array_equal(res.rows, want)

    flights = [tc.launch_mixed([_batch(workload, d, op)]) for op in ops[:2]]
    assert _slots(tc) == (2, 1)
    for flight, op in zip(flights, ops[:2]):
        (res,) = tc.gather(flight)
        check(res, op)
    for op in ops[2:]:
        check(tc.dispatch(_batch(workload, d, op)), op)
    assert _slots(tc) == (2, 1)
    assert tc.trace_counts == {(workload, d): 1}
    assert tc.program_stats()["captures"] == 1


@pytest.mark.parametrize("order", ["in-order", "reversed"])
def test_k_plus_one_flights_keep_their_own_rows(order):
    """``inflight_depth`` 3 with the async pipeline: a class that launches
    at every serving event holds k + 1 = 4 flights of one program before
    the oldest is gathered.  The program stops at four slots, and every
    request gets its own row; four flights launched by hand and gathered in
    either order keep theirs too."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    server = CryptoServer(ServeConfig(validate=False, n_c=1,
                                      async_pipeline=True, inflight_depth=3),
                          coscheduler=cos)
    rng = np.random.default_rng(7)
    coeffs = rng.integers(0, Q, (24, 64), dtype=np.uint64).astype(np.uint32)
    handles = []
    for i, row in enumerate(coeffs):
        handles.append(server.submit(TReq(i, "dilithium", 64, 0.0, row),
                                     now=time.perf_counter()))
        if i == 10:
            assert server.inflight_groups == 3
            assert _slots(cos) == (4, 3)
    server.drain(time.perf_counter())
    want = _oracle_rows(coeffs)
    for h, row in zip(handles, want):
        np.testing.assert_array_equal(h.result(), row)
    assert _slots(cos) == (4, 3)

    batches = _dil_batches(8, 4, n=1)
    flights = [cos.launch_mixed([b]) for b in batches]
    pairs = list(zip(flights, batches))
    if order == "reversed":
        pairs.reverse()
    for flight, batch in pairs:
        (res,) = cos.gather(flight)
        assert res.batch is batch
        np.testing.assert_array_equal(res.rows, _oracle_rows(batch.operand))
    assert _slots(cos) == (4, 3)


def test_dropped_flights_return_their_slots():
    """100 cycles of a launch left in flight (the async pipeline, depth 1)
    then ``reset_after_failure``, which drops it ungathered: the program
    keeps one slot, and the server still answers exactly afterwards, with
    the k + 1 = 2 slots that depth 1 holds at most."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    server = CryptoServer(ServeConfig(validate=False, n_c=1,
                                      async_pipeline=True),
                          coscheduler=cos)
    rng = np.random.default_rng(11)
    for i in range(100):
        row = rng.integers(0, Q, 64, dtype=np.uint64).astype(np.uint32)
        server.submit(TReq(i, "dilithium", 64, 0.0, row),
                      now=time.perf_counter())
        assert server.inflight_groups == 1
        server.reset_after_failure(time.perf_counter())
        assert server.inflight_groups == 0
    assert _slots(cos) == (1, 0)
    rows = rng.integers(0, Q, (3, 64), dtype=np.uint64).astype(np.uint32)
    handles = [server.submit(TReq(100 + i, "dilithium", 64, 0.0, row),
                             now=time.perf_counter())
               for i, row in enumerate(rows)]
    server.drain(time.perf_counter())
    for h, want in zip(handles, _oracle_rows(rows)):
        np.testing.assert_array_equal(h.result(), want)
    assert _slots(cos) == (2, 1)


def test_gathered_rows_outlive_later_launches():
    """A gathered ``DispatchResult``'s rows and outputs are a copy of the
    slot's output: five later launches through the same slot leave them as
    they were."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    first, *later = _dil_batches(12, 6)
    res = cos.dispatch(first)
    kept = res.rows.copy()
    outputs = {t: row.copy() for t, row in res.outputs.items()}
    for batch in later:
        np.testing.assert_array_equal(cos.dispatch(batch).rows,
                                      _oracle_rows(batch.operand))
    np.testing.assert_array_equal(res.rows, kept)
    np.testing.assert_array_equal(kept, _oracle_rows(first.operand))
    for t, row in res.outputs.items():
        np.testing.assert_array_equal(row, outputs[t])
    (prog,) = cos.jitted_for("dilithium", 64).values()
    assert len(prog.slots) == 1
    assert not np.shares_memory(res.rows, prog.slots[0].out_view)


def test_a_flight_is_gathered_once():
    """A second gather of one flight raises instead of reading a slot that
    another launch may have written since."""
    cos = TCOS.SliceCoScheduler(device="cpu")
    a, b = _dil_batches(13, 2)
    flight = cos.launch_mixed([a])
    (res,) = cos.gather(flight)
    np.testing.assert_array_equal(res.rows, _oracle_rows(a.operand))
    cos.dispatch(b)
    with pytest.raises(RuntimeError, match="gathered already"):
        cos.gather(flight)


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no-merge"])
def test_a_sync_server_grows_no_slot(merge):
    """A synchronous server over mixed degrees (three buckets) gathers every
    launch before the next: one slot a program, ``slot_grows`` 0."""
    cos = TCOS.SliceCoScheduler(device="cpu", merge=merge)
    server = CryptoServer(ServeConfig(validate=False, n_c=4,
                                      max_age_s=0.01), coscheduler=cos)
    rng = np.random.default_rng(19)
    handles, want = [], []
    for i in range(30):
        d = (40, 64, 100, 200)[i % 4]
        row = rng.integers(0, Q, d, dtype=np.uint64).astype(np.uint32)
        handles.append(server.submit(TReq(i, "dilithium", d, 0.0, row),
                                     now=time.perf_counter()))
        server.pump(time.perf_counter())
        bucket = max(64, 1 << (d - 1).bit_length())
        want.append(_oracle_rows(row[None], bucket)[0])
    server.drain(time.perf_counter())
    for h, row in zip(handles, want):
        np.testing.assert_array_equal(h.result(), row)
    stats = cos.program_stats()
    assert stats["slot_grows"] == 0
    assert stats["slots"] == stats["captures"] == sum(
        cos.trace_counts.values()) >= 3
