"""Closed-loop dispatch of the port: the adaptive occupancy controller, the
λ-priced merge holdback, the depth-k launch ring and ladder validation —
the unit tests of ``tests/test_controller.py`` against the port's modules,
on the CPU.  A controller of each package fed the same seeded
``observe_dispatch`` sequence must take the same decisions.

Left out: the cluster drain barrier and cluster parity (in
``tests/test_torch_cluster.py``), the JAX compilation cache (the port records
``compilation_cache_dir`` only, tested here) and the ``perf_report``
script's tests, which read the JAX package's benchmark records.
"""
import numpy as np
import pytest

from repro.serve.controller import AdaptiveController as JController
from repro_torch.core import field as F
from repro_torch.core.scheduler import TenantRequest
from repro_torch.core.scheduler.coscheduler import (MIN_ROW_TILE,
                                                    SliceCoScheduler,
                                                    validate_row_ladder)
from repro_torch.launch.serve import serve_crypto, serve_crypto_online
from repro_torch.serve import CryptoServer, LoadGenerator, ServeConfig
from repro_torch.serve.controller import AdaptiveController

RNG = np.random.default_rng(31)

LADDER = (4, 8, 16)

# One laddered co-scheduler for the whole module: every server (and the
# offline replays) reuses its engines and planes.
COS = SliceCoScheduler(merge=True, row_ladder=LADDER, device="cpu")


def _dil_request(tid, d=64, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


def _cfg(**kw):
    kw.setdefault("validate", False)
    kw.setdefault("n_c", 4)
    kw.setdefault("max_age_s", 0.002)
    kw.setdefault("merge_dispatch", True)
    kw.setdefault("row_ladder_max", LADDER[-1])
    return ServeConfig(**kw)


# Where a test prices the SLO gate, the service time is the modelled one
# (``deterministic_timing``): measured, it would be the CPU's wall time of
# the plain versions, which moves with the machine's load and would let
# the gate reject rows that the test needs admitted.  The holdback is
# priced from the arrival model and the deadline, not the service time.
SLO_PRICED = dict(deterministic_timing=True)


def _run_trace(trace, **kw):
    server = CryptoServer(_cfg(**kw), coscheduler=COS)
    load = LoadGenerator(trace, attach=False).run(server)
    assert not load.rejected
    return server, load


# --- satellite: row-ladder construction validation ------------------------------

def test_row_ladder_rejects_non_monotonic():
    with pytest.raises(ValueError, match="strictly increasing"):
        SliceCoScheduler(row_ladder=(16, 8, 32), device="cpu")
    with pytest.raises(ValueError, match="strictly increasing"):
        validate_row_ladder((8, 4))


def test_row_ladder_rejects_duplicates():
    with pytest.raises(ValueError, match="duplicate rung 8"):
        SliceCoScheduler(row_ladder=(4, 8, 8, 16), device="cpu")


def test_row_ladder_rejects_sub_tile_rungs():
    with pytest.raises(ValueError, match="minimum M-tile"):
        SliceCoScheduler(row_ladder=(1, 8, 16), device="cpu")
    with pytest.raises(ValueError, match="minimum M-tile"):
        validate_row_ladder((0,))
    with pytest.raises(ValueError, match="at least one rung"):
        validate_row_ladder(())
    assert validate_row_ladder((MIN_ROW_TILE, 8)) == (MIN_ROW_TILE, 8)


# --- config validation ----------------------------------------------------------

def test_serve_config_cross_field_validation():
    with pytest.raises(ValueError, match="inflight_depth"):
        CryptoServer(_cfg(inflight_depth=0))
    with pytest.raises(ValueError, match="async_pipeline"):
        CryptoServer(_cfg(inflight_depth=2))          # ring needs async
    with pytest.raises(ValueError, match="controller"):
        CryptoServer(_cfg(holdback_lambda=1.0))       # pricing needs the model
    with pytest.raises(ValueError, match="merge_dispatch"):
        CryptoServer(_cfg(holdback_lambda=1.0, controller=True,
                          merge_dispatch=False))
    with pytest.raises(ValueError, match="holdback_lambda"):
        CryptoServer(_cfg(holdback_lambda=-0.5, controller=True))


def test_controller_parameter_validation():
    kw = dict(ladder=LADDER, n_c=4, max_age_s=0.002)
    with pytest.raises(ValueError, match="alpha"):
        AdaptiveController(alpha=0.0, **kw)
    with pytest.raises(ValueError, match="gain"):
        AdaptiveController(gain=0.0, **kw)
    with pytest.raises(ValueError, match="ladder"):
        AdaptiveController(ladder=(), n_c=4, max_age_s=0.002)


# --- controller unit behaviour --------------------------------------------------

def test_controller_bounds_and_rung_snap():
    ctl = AdaptiveController(ladder=LADDER, n_c=4, max_age_s=0.002,
                             slo_deadline_s=0.05, holdback_slo_fraction=0.5)
    key = ("dilithium", 64)
    assert ctl.target_rows(key) == 4          # floor = n_c
    assert ctl.max_age_s(key) == 0.002        # initial = static value
    # age ceiling is SLO-capped: ≤ fraction × deadline
    assert ctl.max_age_ceil_s <= 0.5 * 0.05 + 1e-12
    # rung snapping clamps to [n_c, ladder top]
    assert ctl._snap_rung(1) == 4
    assert ctl._snap_rung(9) == 16
    assert ctl._snap_rung(1000) == 16


def test_controller_starving_raises_age_overload_lowers_it():
    ctl = AdaptiveController(ladder=LADDER, n_c=4, max_age_s=0.002,
                             gain=0.5, alpha=1.0)
    key = ("dilithium", 64)
    # low fill, shallow queue → starving → age grows toward the ceiling
    ctl.observe_dispatch(key, live_rows=4, queue_depth=0, now=0.0)
    assert ctl.max_age_s(key) == pytest.approx(0.003)
    # deep backlog → overloaded → age shrinks toward the floor, and the
    # backlog itself raises the target rung
    ctl.observe_dispatch(key, live_rows=4, queue_depth=200, now=0.01)
    assert ctl.max_age_s(key) < 0.003
    assert ctl.target_rows(key) == LADDER[-1]
    # cluster depth folds into the setpoint even when the local queue is
    # shallow (gossip says merge partners are en route)
    ctl2 = AdaptiveController(ladder=LADDER, n_c=4, max_age_s=0.002,
                              alpha=1.0)
    ctl2.observe_dispatch(key, live_rows=4, queue_depth=0, now=0.0,
                          cluster_depth=64.0)
    assert ctl2.target_rows(key) == LADDER[-1]
    assert ctl2.snapshot()["cluster_depth_max"] == 64.0


# --- tentpole: convergence under a drifting rate --------------------------------

def _drifting_requests():
    """Deterministic two-phase stream: sparse (400 req/s) then dense
    (8,000 req/s) — the drift that mistunes any static close policy."""
    reqs, t, tid = [], 0.0, 0
    for _ in range(30):                       # phase A: gap 2.5 ms
        reqs.append(_dil_request(tid, 64, t))
        tid += 1
        t += 0.0025
    for _ in range(370):                      # phase B: gap 0.125 ms
        reqs.append(_dil_request(tid, 64, t))
        tid += 1
        t += 0.000125
    return reqs


def test_controller_converges_above_static_m_occupancy_floor():
    """Acceptance: under a drifting Poisson-like rate the m-fill EWMA
    recovers above the static floor (n_c / N_c_max) — the controller grows
    the target rung and age window until launches are tall again."""
    trace = _drifting_requests()       # one trace, byte-identical both runs
    static_srv, static_load = _run_trace(trace, async_pipeline=True)
    adaptive_srv, adaptive_load = _run_trace(trace, async_pipeline=True,
                                             controller=True)
    static_snap = static_srv.telemetry.snapshot()
    adaptive_snap = adaptive_srv.telemetry.snapshot()
    floor = 4 / 128                           # n_c / n_c_max
    cls = adaptive_snap["controller"]["classes"]["dilithium/64"]
    assert cls["target_rows"] == LADDER[-1]   # rung climbed off the floor
    assert cls["max_age_s"] > 0.002           # age grew to fill the window
    assert cls["m_occupancy_ewma"] > 1.5 * floor
    # the static path stays pinned at the floor the paper measures
    assert static_snap["dispatch"]["m_occupancy_mean"] == pytest.approx(
        floor, rel=0.35)
    assert (adaptive_snap["dispatch"]["m_occupancy_mean"]
            > 1.5 * static_snap["dispatch"]["m_occupancy_mean"])
    # fewer, taller launches — same rows
    assert (adaptive_snap["dispatch"]["dispatches"]
            < static_snap["dispatch"]["dispatches"])
    # and bit-for-bit the same per-tenant results
    assert set(adaptive_load.outputs) == set(static_load.outputs)
    for tid, row in static_load.outputs.items():
        np.testing.assert_array_equal(adaptive_load.outputs[tid], row)


# --- tentpole: holdback SLO safety ----------------------------------------------

def _bursty_requests():
    """2-row bursts every 4 ms (each closes by age below target) with two
    long 30 ms silences that strand a held batch past its priced window."""
    reqs, t, tid = [], 0.0, 0
    for burst in range(40):
        reqs.append(_dil_request(tid, 64, t))
        reqs.append(_dil_request(tid + 1, 64, t + 0.0002))
        tid += 2
        t += 0.030 if burst in (15, 31) else 0.004
    return reqs


def test_holdback_audited_and_never_breaches_slo():
    """Acceptance: λ-holdback trades p50 for M fill but the SLO gate's
    deadline survives — no held batch may push the admission-visible
    queue-wait p99 past the deadline, and every hold is audited as exactly
    one win, loss, or drain flush."""
    slo = 0.05
    server, load = _run_trace(
        _bursty_requests(), async_pipeline=True, controller=True,
        holdback_lambda=5.0, slo_deadline_s=slo, holdback_slo_fraction=0.5,
        **SLO_PRICED)
    snap = server.telemetry.snapshot()
    hb = snap["holdback"]
    assert hb["held"] >= 3, hb
    assert hb["wins"] >= 1, hb
    assert hb["losses"] >= 1, hb
    assert hb["wins"] + hb["losses"] + hb["flushed"] == hb["held"], hb
    # pricing bound: no realised hold may exceed its SLO share
    assert hb["hold_s_max"] <= 0.5 * slo + 1e-9, hb
    # the admission-visible p99 (queue wait, virtual clock) survives
    assert snap["queue_wait"]["p99_s"] <= slo, snap["queue_wait"]
    assert all(h.done() and not h.rejected for h in load.handles)


def test_holdback_win_merges_partner_into_one_launch():
    """A predicted partner arriving inside the window merges with the held
    batch into one tall launch (the M-fill win the holdback pays p50 for)."""
    server, _ = _run_trace(_bursty_requests(), async_pipeline=True,
                           controller=True, holdback_lambda=5.0,
                           slo_deadline_s=0.05, **SLO_PRICED)
    snap = server.telemetry.snapshot()
    assert snap["holdback"]["wins"] >= 1
    assert snap["dispatch"]["merged_dispatches"] >= 1
    assert any(r.n_batches > 1 for r in server.telemetry.dispatches)


# --- tentpole: depth-k launch ring ----------------------------------------------

def test_ring_holds_k_flights_and_drain_retires_all():
    """inflight_depth = 3 with every submit closing a batch: the ring fills
    to exactly k outstanding launch groups, and drain retires them all."""
    server = CryptoServer(_cfg(n_c=1, async_pipeline=True, inflight_depth=3),
                          coscheduler=COS)
    handles = [server.submit(_dil_request(i, 64, i * 1e-4), now=i * 1e-4)
               for i in range(6)]
    # every submit launched a 1-row batch; the ring holds the newest 3
    assert server.inflight_groups == 3
    assert sum(h.done() for h in handles) == 3     # oldest 3 gathered
    server.drain(0.01)
    assert server.inflight_groups == 0
    assert all(h.done() for h in handles)
    eng = server.cos.engine_for("dilithium", 64)
    for h in handles:
        iso = np.zeros((1, 64), np.uint32)
        iso[0] = h.request.coeffs
        np.testing.assert_array_equal(h.result(), eng.oracle_np(iso)[0])


def test_ring_splits_per_class_and_drain_retires_all():
    """Bursty multi-class closes ride the ring concurrently (one flight per
    workload class), and drain leaves zero in-flight groups.  (The JAX
    test's cluster drain barrier is in ``tests/test_torch_cluster.py``.)"""
    server = CryptoServer(_cfg(async_pipeline=True, inflight_depth=2,
                               max_age_s=0.002), coscheduler=COS)
    now = 0.0
    for i in range(3):                        # 3 rows in each of 2 classes
        server.submit(_dil_request(10 + i, 64, now), now=now)
        server.submit(_dil_request(20 + i, 100, now), now=now)
    server.pump(0.002)                        # age-close both classes at once
    assert server.inflight_groups == 2        # one flight per class in flight
    server.drain(0.003)
    assert server.inflight_groups == 0


def test_ring_busy_class_cannot_starve_quiet_class():
    """A class that keeps launching must not pin another class's in-flight
    results in the ring: the quiet class's oldest flight is materialised at
    the next serving event it doesn't launch into."""
    server = CryptoServer(_cfg(n_c=1, async_pipeline=True, inflight_depth=2),
                          coscheduler=COS)
    hb = server.submit(_dil_request(0, 100, 0.0), now=0.0)   # class (dil, 128)
    assert not hb.done()                   # in flight, ring not over depth
    ha = [server.submit(_dil_request(1 + i, 64, 1e-4 * (i + 1)),
                        now=1e-4 * (i + 1)) for i in range(4)]
    # every submit launched class (dil, 64); the (dil, 128) flight was
    # gathered at the first event it sat out — no drain needed
    assert hb.done()
    server.drain(0.01)
    assert server.inflight_groups == 0
    assert all(h.done() for h in ha)


def test_controller_consumes_class_local_depth_not_global():
    """The controller's queue model must see the class's own backlog — a
    busy neighbour class's pending rows must not inflate the depth EWMA
    (which would snap the idle class's target rung to the ladder top)."""
    server = CryptoServer(_cfg(controller=True), coscheduler=COS)
    for i in range(3):                     # 3 rows pile up in (dil, 64)
        server.submit(_dil_request(i, 64, 0.0), now=0.0)
    for i in range(4):                     # (dil, 128) closes full → dispatch
        server.submit(_dil_request(10 + i, 100, 0.0), now=0.0)
    assert server.batcher.depth == 3       # the neighbour backlog is global…
    cls = server.telemetry.snapshot()["controller"]["classes"]["dilithium/128"]
    assert cls["updates"] == 1
    assert cls["depth_ewma"] == 0.0        # …but this class saw its own: 0
    server.drain(0.01)


# --- tentpole: replay parity (single host) -------------------------------------

def _parity_kw(seed):
    return dict(duration_s=0.01, rate_hz=1024, seed=seed, d_uniform=256)


def test_closed_loop_serving_matches_offline_replay_bitforbit():
    """Acceptance: controller + holdback + depth-k ring through the full
    online runtime equals the static-config offline replay bit-for-bit
    (single host; the JAX test's 2-host cluster is in
    ``tests/test_torch_cluster.py``)."""
    kw = _parity_kw(29)
    offline_results, n_ops, _ = serve_crypto(validate=False, coscheduler=COS,
                                             **kw)
    offline = {}
    for res in offline_results:
        offline.update(res.outputs)
    COS.drain_dispatch_log()      # keep replay launches out of serve telemetry

    load, snap, _ = serve_crypto_online(
        max_age_s=0.002, validate=False, merge_dispatch=True,
        row_ladder_max=LADDER[-1], async_pipeline=True, controller=True,
        holdback_lambda=1.5, inflight_depth=2, coscheduler=COS, **kw)
    assert set(load.outputs) == set(offline) and n_ops == len(offline)
    for tid, row in offline.items():
        np.testing.assert_array_equal(load.outputs[tid], row)
    assert snap["controller"]["updates"] > 0


# --- the controller against the JAX controller ----------------------------------

def _observations(seed):
    """A seeded sequence of dispatch observations over three classes:
    bursts, starvation, deep backlogs and gossiped cluster depth."""
    rng = np.random.default_rng(seed)
    keys = [("dilithium", 64), ("dilithium", 256), ("bn254", 64)]
    now, out = 0.0, []
    for _ in range(200):
        now += float(rng.exponential(0.002))
        depth = int(rng.choice([0, 1, 3, 12, 200]))
        cluster = (None if rng.random() < 0.7
                   else float(rng.uniform(0.0, 80.0)))
        out.append((keys[int(rng.integers(0, 3))], int(rng.integers(1, 17)),
                    depth, now, cluster))
    return out


@pytest.mark.parametrize("seed, kw", [
    (0, {}),
    (1, dict(alpha=1.0, gain=0.5)),
    (2, dict(slo_deadline_s=0.02, holdback_lambda=1.5,
             occupancy_close=0.5, m_fill_target=0.7)),
])
def test_controller_decisions_equal_jax_on_the_same_observations(seed, kw):
    base = dict(ladder=(8, 16, 32, 64, 128), n_c=8, max_age_s=0.005, **kw)
    port, ref = AdaptiveController(**base), JController(**base)
    for key, live, depth, now, cluster in _observations(seed):
        for ctl in (port, ref):
            ctl.observe_dispatch(key, live_rows=live, queue_depth=depth,
                                 now=now, cluster_depth=cluster)
        assert port.target_rows(key) == ref.target_rows(key)
        assert port.max_age_s(key) == ref.max_age_s(key)
        assert port.holdback_window_s(key, 0.001) == \
            ref.holdback_window_s(key, 0.001)
    assert port.decisions == ref.decisions > 0
    assert port.snapshot() == ref.snapshot()


# --- compilation_cache_dir is recorded only -------------------------------------

def test_compilation_cache_dir_is_recorded_and_not_created(tmp_path):
    cache_dir = tmp_path / "kernel-cache"
    server = CryptoServer(_cfg(n_c=2, compilation_cache_dir=str(cache_dir)),
                          coscheduler=COS)
    assert server.config.compilation_cache_dir == str(cache_dir)
    assert not cache_dir.exists()
    h1 = server.submit(_dil_request(0, 64), now=0.0)
    h2 = server.submit(_dil_request(1, 64), now=0.0)
    assert h1.done() and h2.done()
    eng = server.cos.engine_for("dilithium", 64)
    iso = np.zeros((1, 64), np.uint32)
    iso[0] = h1.request.coeffs
    np.testing.assert_array_equal(h1.result(), eng.oracle_np(iso)[0])
    assert not cache_dir.exists()
