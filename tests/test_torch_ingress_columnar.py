"""Columnar vectorised ingress of the port: scalar-oracle parity
(decisions, reasons, retry hints, bucket levels), the tenant interner, the
submit_many batch edge, pending-load accounting, and the retry-hint refill —
the unit tests of ``tests/test_ingress_columnar.py`` against the port's
modules.  The port's columnar ``admit_batch`` is also held against the JAX
package's scalar per-request ``admit`` on the same seeded arrivals.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.scheduler import TenantRequest as JRequest
from repro.serve.admission import AdmissionController as JAdmission
from repro.serve.admission import TenantInterner as JInterner
from repro_torch.core import field as F
from repro_torch.core.scheduler import TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.serve import CryptoServer, ServeConfig
from repro_torch.serve.admission import (AdmissionController, TenantInterner,
                                         TokenBucket)
from repro_torch.serve.batcher import ContinuousBatcher

RNG = np.random.default_rng(17)

# One co-scheduler for the module: engines and planes are reused.
COS = SliceCoScheduler(device="cpu")


def _cfg(**kw):
    kw.setdefault("validate", False)
    kw.setdefault("n_c", 4)
    kw.setdefault("max_age_s", 0.01)
    return ServeConfig(**kw)


def _server(**kw):
    return CryptoServer(_cfg(**kw), coscheduler=COS)


def _dil(tid, d=64, t=0.0, coeffs=None):
    if coeffs is None:
        coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d,
                                         dtype=np.uint64), np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


# --- satellite bugfix: retry hints must refill to now ---------------------------

def test_time_until_refills_to_now():
    # binary-exact values throughout: rate 8 Hz, instants on 2^-k grids
    tb = TokenBucket(rate_hz=8.0, burst=2.0)
    assert tb.try_take(0.0) and tb.try_take(0.0)      # level -> 0
    assert not tb.try_take(0.0)
    # legacy call (no now): prices the deficit from the stale level
    assert tb.time_until() == 0.125
    # half a token accrues by t = 1/16; the hint must shrink accordingly —
    # the pre-fix code kept quoting 0.125 here (the regression this pins)
    assert tb.time_until(now=0.0625) == 0.0625
    # and the hint is exact: a take at now + hint succeeds, earlier fails
    tb2 = TokenBucket(rate_hz=8.0, burst=2.0)
    tb2.try_take(0.0)
    tb2.try_take(0.0)
    h = tb2.time_until(now=0.0)
    assert h == 0.125
    assert not tb2.try_take(0.109375)                 # 7/64 s: 0.875 tokens
    assert tb2.try_take(0.125)                        # exactly 1.0 token

    # rate 0 quirk is preserved: no accrual ever, hint stays inf
    tb3 = TokenBucket(rate_hz=0.0, burst=1.0)
    assert tb3.try_take(0.0)
    assert tb3.time_until(now=100.0) == float("inf")


# --- tenant interner ------------------------------------------------------------

def test_tenant_interner_dense_and_fallback():
    it = TenantInterner(dense_limit=1 << 10)
    assert it.intern(5) == 0
    assert it.intern(7) == 1
    assert it.intern(5) == 0                          # stable
    assert it.intern(1 << 40) == 2                    # beyond dense range
    assert it.intern(-3) == 3                         # negative
    assert it.intern("tenant-x") == 4                 # non-integer
    assert it.index_of(7) == 1 and it.index_of(8) is None
    assert it.index_of("tenant-x") == 4
    assert len(it) == 5


def test_tenant_interner_vectorised_matches_scalar():
    a = TenantInterner()
    b = TenantInterner()
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = rng.integers(0, 500, 64)
        va = a.intern_many(ids)
        vb = np.asarray([b.intern(int(t)) for t in ids])
        np.testing.assert_array_equal(va, vb)
    assert len(a) == len(b)
    # growth past the initial dense table, still consistent
    big = np.arange(900, 1100) * 7 % (1 << 18)
    np.testing.assert_array_equal(
        a.intern_many(big), np.asarray([b.intern(int(t)) for t in big]))


# --- scalar vs columnar parity --------------------------------------------------

def _controllers(seed):
    """One random admission config, instantiated in both layouts."""
    rng = np.random.default_rng(seed)
    kw = dict(
        max_pending=int(rng.choice([3, 20, 10_000])),
        tenant_rate_hz=(float(rng.choice([0.0, 0.5, 8.0, 1000.0]))
                        if rng.random() < 0.85 else None),
        tenant_burst=float(rng.integers(1, 5)),
        slo_deadline_s=(float(rng.choice([0.001, 0.1, 1e9]))
                        if rng.random() < 0.7 else None),
        service_rate_init=float(rng.choice([0.0, 10.0, 1024.0, 1e6])))
    return (AdmissionController(columnar=False, **kw),
            AdmissionController(columnar=True, **kw), kw, rng)


def _random_batch(rng, n):
    n_ten = int(rng.integers(1, 30))
    skew = rng.choice(["unique", "zipf", "hot", "mixed"])
    if skew == "unique":
        ids = rng.permutation(10_000)[:n]
    elif skew == "hot":
        ids = np.zeros(n, np.int64)
    elif skew == "zipf":
        ids = np.minimum(rng.zipf(1.5, n), n_ten).astype(np.int64)
    else:
        ids = rng.integers(0, n_ten, n)
    return ids


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_admit_batch_parity(seed):
    """admit_batch on the columnar layout is bit-identical to the scalar
    per-request oracle: decisions, reason codes, retry hints, and the token
    level every touched bucket is left at — over random tenant skews,
    rates, gate configs, and clock jitter, across sequential batches."""
    oracle, fast, _, rng = _controllers(seed)
    n = int(rng.integers(1, 150))
    ids = _random_batch(rng, n)
    pend0 = int(rng.integers(0, 30))
    cp = float(rng.integers(0, 50)) if rng.random() < 0.5 else None
    t0 = float(rng.normal(0, 2))                   # negative clocks too
    for _ in range(3):
        ts = t0 + np.cumsum(rng.exponential(0.01, n))
        if rng.random() < 0.3:                     # non-monotone jitter
            ts = ts + rng.normal(0, 0.005, n)
        t0 = float(ts.max()) + float(rng.exponential(0.05))
        da = oracle.admit_batch(ids, ts, pending=pend0, cluster_pending=cp)
        db = fast.admit_batch(ids, ts, pending=pend0, cluster_pending=cp)
        np.testing.assert_array_equal(da.admitted, db.admitted)
        np.testing.assert_array_equal(da.reason_codes, db.reason_codes)
        # exact — the hints ride the same IEEE ops in both layouts
        np.testing.assert_array_equal(da.retry_after_s, db.retry_after_s)
        assert da.reasons() == db.reasons()
        assert da.counts() == db.counts()
        for tid in set(ids.tolist()):
            la = oracle.bucket_level(tid, t0)
            if la is not None:                     # bucket was reached
                assert fast.bucket_level(tid, t0) == la


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_admit_per_request_parity(seed):
    """The per-request admit() path on columnar state matches the TokenBucket
    dict bit for bit (including the now-refilled retry hints)."""
    oracle, fast, _, rng = _controllers(seed)
    ids = _random_batch(rng, 40)
    ts = np.cumsum(rng.exponential(0.01, 40))
    for tid, t in zip(ids.tolist(), ts.tolist()):
        pend = int(rng.integers(0, 25))
        req = _dil(int(tid), 64, t)
        da = oracle.admit(req, t, pending=pend)
        db = fast.admit(req, t, pending=pend)
        assert (da.admitted, da.reason, da.retry_after_s) == \
               (db.admitted, db.reason, db.retry_after_s)


def test_admit_batch_of_one_equals_admit():
    a = AdmissionController(columnar=True, tenant_rate_hz=4.0,
                            tenant_burst=1.0, slo_deadline_s=0.5)
    b = AdmissionController(columnar=True, tenant_rate_hz=4.0,
                            tenant_burst=1.0, slo_deadline_s=0.5)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 5, 60)
    ts = np.cumsum(rng.exponential(0.05, 60))
    for tid, t in zip(ids.tolist(), ts.tolist()):
        da = a.admit(_dil(int(tid), 64, t), float(t), pending=0)
        db = b.admit_batch(np.asarray([tid]), np.asarray([t]), pending=0)
        assert (da.admitted, da.reason, da.retry_after_s) == \
               (bool(db.admitted[0]), db.reasons()[0],
                float(db.retry_after_s[0]))


def test_draining_and_duplicate_submit_many():
    server = _server(tenant_rate_hz=100.0)
    r0, r1 = _dil(0), _dil(1)
    hs = server.submit_many([r0, r1, r0], nows=[0.0, 0.0, 0.0])
    assert not hs[0].rejected and not hs[1].rejected
    assert hs[2].rejected and hs[2].decision.reason == "duplicate"
    # still pending from the earlier batch → duplicate across batches too
    h = server.submit_many([r1], nows=[0.001])[0]
    assert h.rejected and h.decision.reason == "duplicate"
    server.drain(0.01)
    assert hs[0].result() is not None and hs[1].result() is not None
    hs2 = server.submit_many([_dil(2), _dil(3)], now=0.02)
    assert all(x.rejected and x.decision.reason == "draining" for x in hs2)
    by_reason = server.telemetry.snapshot()["admission"]["by_reason"]
    assert by_reason["duplicate"] == 2
    assert by_reason["draining"] == 2
    assert by_reason["ok"] == 2


def test_submit_many_matches_per_request_submit():
    """Same trace through the batch edge (columnar) and the per-request
    loop (scalar oracle server): identical decisions and bit-identical
    per-tenant results."""
    kw = dict(n_c=4, max_age_s=10.0, tenant_rate_hz=2.0, tenant_burst=1.0)
    s_batch = _server(**kw)                       # columnar default
    s_loop = _server(columnar_admission=False, **kw)
    reqs = []
    for i in range(24):
        d = 64
        coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d,
                                         dtype=np.uint64), np.uint32)
        t = i * 1e-4
        reqs.append((
            _dil(i % 6, d, t, coeffs), _dil(i % 6, d, t, coeffs.copy())))
    hs_batch = s_batch.submit_many([a for a, _ in reqs],
                                   nows=[a.arrival_time for a, _ in reqs])
    hs_loop = [s_loop.submit(b, now=b.arrival_time) for _, b in reqs]
    s_batch.drain(0.01)
    s_loop.drain(0.01)
    for hb, hl in zip(hs_batch, hs_loop):
        assert hb.rejected == hl.rejected
        if hb.rejected:
            assert hb.decision.reason == hl.decision.reason
            assert hb.decision.retry_after_s == hl.decision.retry_after_s
        else:
            np.testing.assert_array_equal(hb.result(), hl.result())
    assert (s_batch.telemetry.snapshot()["admission"]["by_reason"]
            == s_loop.telemetry.snapshot()["admission"]["by_reason"])


# --- satellite bugfix: failover replay must not re-charge admission -------------

def test_replay_bypasses_admission_and_leaves_bucket_levels_identical():
    """A replayed request was admitted and token-charged once, on the host
    that died — re-entering it on the survivor must not touch the
    survivor's token buckets or SLO gate.  Pinned by comparing the
    survivor's columnar bucket levels bit-for-bit against a scalar oracle
    controller that only ever saw the normal (non-replay) traffic."""
    kw = dict(n_c=4, max_age_s=10.0, tenant_rate_hz=4.0, tenant_burst=2.0)
    survivor = _server(**kw)                       # columnar default
    oracle = AdmissionController(columnar=False, tenant_rate_hz=4.0,
                                 tenant_burst=2.0)
    # normal traffic on the survivor, mirrored into the oracle
    for i, t in enumerate((0.0, 0.125, 0.25)):
        req = _dil(i % 2, 64, t)
        assert not survivor.submit(req, now=t).rejected
        assert oracle.admit(req, t, pending=0).admitted
    # a dead peer's journal: admitted there, never seen here.  The oracle
    # deliberately never sees these — that is the contract under test.
    dead = _server(**kw)
    entries = []
    for i, t in enumerate((0.05, 0.1)):
        req = _dil(i % 2, 64, t, coeffs=np.asarray(
            RNG.integers(0, F.DILITHIUM_Q, 64, dtype=np.uint64), np.uint32))
        req.request_id = 1000 + i
        h = dead.submit(req, now=t)
        assert not h.rejected
        entries.append((req, h))
    replayed, deduped = survivor.replay_admitted(entries, 0.3)
    assert (replayed, deduped) == (2, 0)
    for tid in (0, 1):
        assert survivor.admission.bucket_level(tid, 0.3) == \
            oracle.bucket_level(tid, 0.3)
    # replay is visible in telemetry but not in the token accounting
    by_reason = survivor.telemetry.snapshot()["admission"]["by_reason"]
    assert by_reason["replayed"] == 2
    # later normal traffic is charged normally, still bit-identical
    req = _dil(0, 64, 0.5)
    d_srv = survivor.submit(req, now=0.5)
    d_orc = oracle.admit(req, 0.5, pending=0)
    assert d_srv.rejected == (not d_orc.admitted)
    assert survivor.admission.bucket_level(0, 0.5) == \
        oracle.bucket_level(0, 0.5)
    # idempotence: a second delivery of the same journal dedups entirely
    # and still leaves the buckets untouched
    assert survivor.replay_admitted(entries, 0.6) == (0, 2)
    assert survivor.admission.bucket_level(1, 0.6) == \
        oracle.bucket_level(1, 0.6)
    survivor.drain(1.0)
    dead.drain(1.0)


# --- satellite bugfix: pending_load sees held + in-flight rows ------------------

def test_pending_load_counts_inflight_ring():
    server = _server(n_c=2, async_pipeline=True, slo_deadline_s=0.001,
                     max_age_s=10.0)
    server.admission.service_rate = 1000.0        # pin the wait model
    server.submit(_dil(0), now=0.0)
    server.submit(_dil(1), now=0.0)               # full → async launch
    assert server.batcher.depth == 0
    assert server.inflight_groups == 1
    assert server.pending_load == 2               # launched, not gathered
    # the SLO gate must price those rows: wait = 2/1000 > 1ms deadline.
    # Before the fix it read batcher.depth == 0 and admitted.
    h = server.submit(_dil(2), now=0.0)
    assert h.rejected and h.decision.reason == "slo_miss"
    server.drain(0.01)
    assert server.pending_load == 0


def test_pending_load_counts_held_rows():
    server = _server(n_c=4)
    bt = ContinuousBatcher(n_c=2)
    (cb,) = bt.add(_dil(7), 0.0) + bt.add(_dil(8), 0.0)
    # pending_load is pure accounting — park a closed batch in the pen the
    # way _apply_holdback would: (ClosedBatch, release_at, held_at, hid)
    server._held[("dilithium", 64)] = (cb, 1.0, 0.0, 0)
    assert server.pending_load == 2
    assert server.batcher.depth == 0


# --- the port's columnar edge against the JAX scalar oracle ---------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_admit_batch_equals_jax_scalar_admit(seed):
    """The port's columnar ``admit_batch`` and the JAX package's scalar
    per-request ``admit`` take the same decisions, reasons and retry hints,
    and leave every bucket at the same level, over sequential batches."""
    _, port, kw, rng = _controllers(seed)
    ref = JAdmission(columnar=False, **kw)
    n = int(rng.integers(20, 120))
    ids = _random_batch(rng, n)
    pend = int(rng.integers(0, 30))
    t0 = 0.0
    for _ in range(3):
        ts = t0 + np.cumsum(rng.exponential(0.01, n))
        t0 = float(ts.max()) + float(rng.exponential(0.05))
        got = port.admit_batch(ids, ts, pending=pend)
        # the batch's semantics: each request sees the rows admitted
        # before it in the batch as pending
        want, admitted = [], 0
        for tid, t in zip(ids.tolist(), ts.tolist()):
            want.append(ref.admit(JRequest(int(tid), "dilithium", 64,
                                           float(t)),
                                  float(t), pending=pend + admitted))
            admitted += want[-1].admitted
        assert got.admitted.tolist() == [d.admitted for d in want]
        assert got.reasons() == [d.reason for d in want]
        assert got.retry_after_s.tolist() == [d.retry_after_s for d in want]
        for tid in set(ids.tolist()):
            assert port.bucket_level(tid, t0) == ref.bucket_level(tid, t0)


def test_tenant_interner_equals_jax():
    rng = np.random.default_rng(5)
    port, ref = TenantInterner(), JInterner()
    for _ in range(4):
        ids = rng.integers(0, 3000, 200)
        np.testing.assert_array_equal(port.intern_many(ids),
                                      ref.intern_many(ids))
    assert len(port) == len(ref)
    for tid in (1 << 40, -3, "tenant-x"):
        assert port.intern(tid) == ref.intern(tid)
