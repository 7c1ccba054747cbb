"""The online serving runtime of the port (``repro_torch.serve``,
``serve_crypto_online``) on the CPU, against the JAX package's.

Same Poisson trace and payloads (n_c = 4, 0.01 s at 1,024 req/s) through the
port's online server, the port's offline replay and the JAX online server:
every tenant row equal, bit for bit.  Under ``deterministic_timing`` the
port's OpenMetrics text, alert log and telemetry snapshot equal the JAX
server's.  Also the mixed eager/lazy fold counters, the fast path's launch
ring (drained, and every host buffer read after its event), the launch
census of ``validate=True`` and a traced run's causal chains.  All
comparisons are exact.  The last sections are the unit tests of
``tests/test_serve_runtime.py`` (submit, flush and drain, admission,
telemetry) against the port's server.
"""
import json
import sys

import numpy as np
import pytest
import torch

from repro.core.scheduler import PoissonTrace as JTrace
from repro.core.scheduler.coscheduler import SliceCoScheduler as JSlice
from repro.serve import CryptoServer as JServer
from repro.serve import LoadGenerator as JLoad
from repro.serve import ServeConfig as JConfig
from repro_torch.core.scheduler import PoissonTrace
from repro_torch.core.scheduler import coscheduler as TCOS
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2
from repro_torch.launch import serve as TL
from repro_torch.obs import validate_chrome_trace, validate_openmetrics
from repro_torch.core import field as F
from repro_torch.core.scheduler import TenantRequest
from repro_torch.serve import (CryptoServer, LoadGenerator, RejectedError,
                               ServeConfig)
from repro_torch.serve.admission import TokenBucket
from repro_torch.serve.server import coscheduler_from_config
from repro_torch.serve.telemetry import LatencyHistogram

TRACE = dict(duration_s=0.01, rate_hz=1024, seed=5)
ONLINE_CFG = dict(n_c=4, max_age_s=0.002)
ONLINE = dict(TRACE, **ONLINE_CFG)
# The deterministic configuration both servers run: modelled service time,
# metrics scraped every millisecond of the virtual clock.
DETERMINISTIC = dict(ONLINE_CFG, deterministic_timing=True, metrics=True,
                     metrics_period_s=0.001)
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
FAST_PATH = dict(row_ladder_max=16, async_pipeline=True, controller=True,
                 inflight_depth=2, holdback_lambda=1.5)

# One co-scheduler per side for the module, as tests/test_serve_runtime.py
# shares one: the JAX side's compiled programs are reused.
J_COS = JSlice()
T_COS = TCOS.SliceCoScheduler(device="cpu")


def _run(server_cls, config_cls, load_cls, trace_cls, cos, **cfg):
    server = server_cls(config_cls(**cfg), coscheduler=cos)
    load = load_cls(trace_cls(**TRACE), seed=TRACE["seed"]).run(server)
    return server, load


@pytest.fixture(scope="module")
def jax_run():
    """The JAX server on the trace (validation off: its HLO validator
    compiles every class at the merge cap, which this comparison does not
    need)."""
    return _run(JServer, JConfig, JLoad, JTrace, J_COS, validate=False,
                **DETERMINISTIC)


@pytest.fixture(scope="module")
def port_run():
    """The port's server on the same trace, with the launch census on."""
    return _run(CryptoServer, ServeConfig, LoadGenerator, PoissonTrace, T_COS,
                validate=True, **DETERMINISTIC)


def _rows(results):
    out = {}
    for r in results:
        out.update(r.outputs)
    return out


def _assert_same_rows(port, ref):
    assert set(port) == set(ref) and ref
    for tid, row in ref.items():
        assert port[tid].dtype == np.uint32
        np.testing.assert_array_equal(port[tid], row)


def test_online_matches_offline_and_jax_per_tenant(jax_run, port_run):
    load, snap, _ = TL.serve_crypto_online(device="cpu", **ONLINE)
    assert not load.rejected and load.n_served == len(load.handles)
    assert set(snap["per_workload"]) == {"dilithium", "bn254"}
    offline, n_ops, _ = TL.serve_crypto(device="cpu", n_c=4, **TRACE)
    assert n_ops == load.n_served
    _assert_same_rows(load.outputs, _rows(offline))
    _assert_same_rows(load.outputs, jax_run[1].outputs)
    _assert_same_rows(port_run[1].outputs, jax_run[1].outputs)


def _comparable(snap: dict) -> dict:
    """A telemetry snapshot without its one package-specific key: the
    launch census by device, whose keys name devices each package's way
    ("0" for JAX device 0, "cpu" for the torch device)."""
    snap = json.loads(json.dumps(snap))
    snap["dispatch"].pop("by_device")
    return snap


def test_deterministic_exports_equal_jax(jax_run, port_run):
    """metrics_text, the alert log and the telemetry snapshot (JSON, sorted
    keys) equal the JAX server's.  Left out: the launch census by device
    (device naming, see ``_comparable``).  Tracing is off in both runs, so
    no section carries the tracer's wall-clock anchor."""
    (j_srv, _), (t_srv, _) = jax_run, port_run
    assert t_srv.metrics.scrapes == j_srv.metrics.scrapes > 5
    assert t_srv.metrics_text() == j_srv.metrics_text()
    assert list(t_srv.alerts.log) == list(j_srv.alerts.log)
    t_snap, j_snap = t_srv.telemetry.snapshot(), j_srv.telemetry.snapshot()
    assert set(t_snap["dispatch"]["by_device"]) == {"cpu"}
    assert json.dumps(_comparable(t_snap), sort_keys=True) == \
        json.dumps(_comparable(j_snap), sort_keys=True)
    assert "trace" not in t_snap


def test_mixed_eager_lazy_fold_counters_and_close_reasons():
    """Lazy Dilithium next to eager BN254 in one server: rows equal to the
    all-eager offline replay; lazy Dilithium (256 bucket, tile 171: two
    passes) folds once per batch, eager BN254 (64 bucket, one pass, nine
    channels) nine times per batch; the split by close reason adds up."""
    kw = dict(TRACE, seed=11, d_uniform=256)
    offline, n_ops, _ = TL.serve_crypto(
        coscheduler=TCOS.SliceCoScheduler(accum="int32_native", d_tile=171,
                                          device="cpu"), **kw)
    load, snap, _ = TL.serve_crypto_online(
        n_c=4, max_age_s=0.002, device="cpu", **MIXED, **kw)
    assert load.n_served == n_ops
    _assert_same_rows(load.outputs, _rows(offline))
    assert snap["per_workload"]["dilithium"]["reduction"] == "lazy"
    assert snap["per_workload"]["bn254"]["reduction"] == "eager"
    n_dil = snap["per_workload"]["dilithium"]["batches"]
    n_bn = snap["per_workload"]["bn254"]["batches"]
    stalls = snap["reduction_stalls"]
    assert n_dil > 0 and n_bn > 0
    assert stalls["deferred_folds"] == n_dil
    assert stalls["eager_folds"] == 9 * n_bn
    by = stalls["by_close_reason"]
    assert set(by) == set(snap["close_reasons"])
    assert sum(v["eager_folds"] for v in by.values()) == stalls["eager_folds"]
    assert sum(v["deferred_folds"] for v in by.values()) == \
        stalls["deferred_folds"]


class _Event:
    """Stands in for the CUDA event that marks a result on the host."""

    def __init__(self):
        self.synced = False

    def synchronize(self):
        self.synced = True


class _HostBuffer:
    """Stands in for a launch slot's pinned output: reading it before its
    event has been synchronised fails the test."""

    def __init__(self, view, event):
        self.view, self.event = view, event

    def copy(self):
        assert self.event.synced, "host buffer read before its event"
        return self.view.copy()


def _watched(cos, monkeypatch) -> list:
    """Give every launch of ``cos`` a stand-in event and host output in its
    launch slot, as on CUDA; returns the list of events handed out."""
    events, real = [], cos._launch

    def launch(group):
        g, prog, slot = real(group)
        events.append(_Event())
        slot.event, slot.pending = events[-1], True
        view = slot.out_view
        if isinstance(view, _HostBuffer):    # the slot's last stand-in
            view = view.view
        slot.out_view = _HostBuffer(view, events[-1])
        return g, prog, slot

    monkeypatch.setattr(cos, "_launch", launch)
    return events


def test_fast_path_ring_drains_and_reads_each_buffer_after_its_event(
        monkeypatch):
    """Configuration (b): ladder, async pipeline, controller, a depth-2
    ring and λ-holdback.  The rows equal the offline replay's, the ring is
    empty after the drain, and every host buffer was read after its
    event."""
    cfg = ServeConfig(validate=False, **ONLINE_CFG, **FAST_PATH)
    cos = coscheduler_from_config(cfg, device="cpu")
    assert cos.row_ladder == (8, 16)
    events = _watched(cos, monkeypatch)
    server = CryptoServer(cfg, coscheduler=cos)
    load = LoadGenerator(PoissonTrace(**TRACE), seed=TRACE["seed"]).run(server)
    assert server.inflight_groups == 0
    snap = server.telemetry.snapshot()
    assert snap["controller"]["updates"] > 0
    assert len(events) == snap["dispatch"]["dispatches"] > 0
    assert all(e.synced for e in events)
    offline, _, _ = TL.serve_crypto(device="cpu", n_c=4, **TRACE)
    _assert_same_rows(load.outputs, _rows(offline))


def test_recover_inflight_synchronises_every_flight(monkeypatch):
    """With a depth-2 ring holding launched groups, ``recover_inflight``
    gathers every one (each after its event) and resolves its handles;
    ``quiesce`` then stops admission and the drain leaves nothing."""
    cfg = ServeConfig(validate=False, n_c=1, async_pipeline=True,
                      inflight_depth=2)
    cos = TCOS.SliceCoScheduler(device="cpu")
    events = _watched(cos, monkeypatch)
    server = CryptoServer(cfg, coscheduler=cos)
    trace = LoadGenerator(PoissonTrace(uniform_degree=64, **TRACE),
                          seed=5).trace
    # one class, so the ring holds the newest two of four flights
    dil = [r for r in trace if r.workload == "dilithium"][:4]
    handles = [server.submit(r, now=0.001 * i) for i, r in enumerate(dil)]
    pending = sum(not h.done() for h in handles)
    assert server.inflight_groups == 2 and pending == 2
    assert server.recover_inflight(0.01) == pending
    assert server.inflight_groups == 0
    assert all(h.done() for h in handles)
    assert len(events) == 4 and all(e.synced for e in events)
    server.quiesce(0.02)
    late = server.submit(trace[-1], now=0.02)
    assert late.rejected and late.decision.reason == "draining"
    server.drain(0.03)
    assert server.inflight_groups == 0



def test_launch_census_runs_outside_the_dispatch_record():
    """validate=True runs one e2e per class on the dispatched form and
    counts its K1/K2 calls: the same telemetry, launch heights and dispatch
    log as validate=False, and exactly the census's kernel calls more."""
    runs = {}
    for validate in (False, True):
        cos = TCOS.SliceCoScheduler(device="cpu", **MIXED)
        server = CryptoServer(ServeConfig(validate=validate, **ONLINE_CFG,
                                          **MIXED), coscheduler=cos)
        before = (K1.calls, K2.calls)
        load = LoadGenerator(PoissonTrace(uniform_degree=256, **TRACE),
                             seed=5).run(server)
        runs[validate] = (cos, server, load,
                          (K1.calls - before[0], K2.calls - before[1]))
    (c0, s0, l0, k0), (c1, s1, l1, k1) = runs[False], runs[True]
    _assert_same_rows(l1.outputs, l0.outputs)
    assert c1.trace_counts == c0.trace_counts
    assert s1._validated == set(c1.trace_counts)
    assert s1.telemetry.snapshot()["dispatch"] == \
        s0.telemetry.snapshot()["dispatch"]
    census = np.sum([TCOS.expected_kernel_calls(c1.engine_for(*key))
                     for key in s1._validated], axis=0)
    assert (k1[0] - k0[0], k1[1] - k0[1]) == tuple(census)


def test_launch_census_raises_on_a_tampered_fold_profile(monkeypatch):
    cos = TCOS.SliceCoScheduler(device="cpu", **MIXED)
    eng = cos.engine_for("dilithium", 256)
    assert TCOS.expected_kernel_calls(eng) == (2, 1)     # 2 passes, 1 window
    monkeypatch.setitem(eng.fold_profile, "n_folds", 2)
    server = CryptoServer(ServeConfig(validate=True, **ONLINE_CFG, **MIXED),
                          coscheduler=cos)
    gen = LoadGenerator(PoissonTrace(uniform_degree=256, **TRACE),
                        seed=5)
    with pytest.raises(RuntimeError, match="launch census failed for "
                                           "dilithium/d256"):
        gen.run(server)


def test_traced_run_has_a_full_chain_per_request(tmp_path):
    trace_path = tmp_path / "trace.json.gz"
    metrics_path = tmp_path / "metrics.om"
    load, snap, _ = TL.serve_crypto_online(
        device="cpu", coscheduler=T_COS, trace_out=str(trace_path),
        metrics_out=str(metrics_path), validate=False, **ONLINE)
    stats = validate_chrome_trace(str(trace_path))
    assert stats["requests"] == load.n_served > 0
    assert stats["launches"] == snap["dispatch"]["dispatches"]
    assert stats["rejects"] == 0
    assert validate_openmetrics(str(metrics_path))["samples"] > 0
    assert snap["trace"]["dropped"] == 0


def test_cli_online_mode_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--mode", "crypto-online", "--device", "cpu",
        "--duration", "0.005", "--rate", "1024", "--max-age-ms", "2",
        "--telemetry-out", str(out)])
    TL.main()
    text = capsys.readouterr().out
    assert "online: served" in text and "on cpu" in text
    assert "latency: p50=" in text and "dispatch: " in text
    snap = json.loads(out.read_text())
    assert snap["requests_served"] > 0
    assert set(snap["latency"]) >= {"p50_s", "p95_s", "p99_s"}


def test_online_server_needs_cuda_by_default():
    """Without a CUDA device the default device raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.serve_crypto_online(duration_s=0.001)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CryptoServer(ServeConfig())


# --- the unit tests of tests/test_serve_runtime.py, on the port's server -------

RNG = np.random.default_rng(3)


def _cfg(**kw):
    kw.setdefault("validate", False)
    kw.setdefault("n_c", 4)
    kw.setdefault("max_age_s", 0.01)
    return ServeConfig(**kw)


def _server(**kw):
    return CryptoServer(_cfg(**kw), coscheduler=T_COS)


def _dil_request(tid, d, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


# --- submit / flush / drain ----------------------------------------------------

def test_submit_age_flush_drain():
    server = _server()
    h1 = server.submit(_dil_request(0, 100, 0.000), now=0.000)
    h2 = server.submit(_dil_request(1, 80, 0.002), now=0.002)
    assert not h1.done() and not h2.done()
    assert server.pump(0.005) == 0           # age trigger not reached
    assert server.pump(0.010) == 1           # 10ms after first row → flush
    assert h1.done() and h2.done()
    eng = T_COS.engine_for("dilithium", 128)  # pow2 bucket of 100
    for h, d in ((h1, 100), (h2, 80)):
        iso = np.zeros((1, 128), np.uint32)
        iso[0, :d] = h.request.coeffs
        np.testing.assert_array_equal(h.result(), eng.oracle_np(iso)[0])
    assert h1.latency_s >= 0.010             # queued the full age window
    # drain resolves stragglers and stops admission
    h3 = server.submit(_dil_request(2, 64, 0.02), now=0.02)
    assert server.drain(0.021) == 1 and h3.done()
    h4 = server.submit(_dil_request(3, 64, 0.03), now=0.03)
    assert h4.rejected and h4.decision.reason == "draining"


def test_close_on_full():
    server = _server(n_c=2)
    h1 = server.submit(_dil_request(0, 64), now=0.0)
    assert not h1.done()
    h2 = server.submit(_dil_request(1, 64), now=0.0)
    assert h1.done() and h2.done()           # N_c rows → closed on add
    assert server.telemetry.batches[0].close_reason == "full"


def test_close_on_occupancy():
    server = _server(n_c=8, occupancy_close=0.5)
    handles = [server.submit(_dil_request(i, 256), now=0.0) for i in range(4)]
    # 4 × 256 / (8 × 256) = 0.5 ⇒ the 4th add crosses the threshold
    assert all(h.done() for h in handles)
    assert server.telemetry.batches[0].close_reason == "occupancy"
    assert server.telemetry.batches[0].n_c == 4


def test_next_deadline_tracks_oldest_row():
    server = _server(max_age_s=0.01)
    assert server.next_deadline() is None
    server.submit(_dil_request(0, 64), now=0.004)
    assert server.next_deadline() == pytest.approx(0.014)


def test_same_tenant_multiple_rows_in_one_batch():
    """A tenant with several requests in one stacked batch gets each of its
    own rows back (routing is by row position, not tenant id)."""
    server = _server(n_c=2)
    r1, r2 = _dil_request(7, 64), _dil_request(7, 100)
    h1 = server.submit(r1, now=0.0)
    h2 = server.submit(r2, now=0.0)
    server.drain(0.001)
    eng64 = T_COS.engine_for("dilithium", 64)
    eng128 = T_COS.engine_for("dilithium", 128)
    iso1 = np.zeros((1, 64), np.uint32)
    iso1[0, :64] = r1.coeffs
    iso2 = np.zeros((1, 128), np.uint32)
    iso2[0, :100] = r2.coeffs
    np.testing.assert_array_equal(h1.result(), eng64.oracle_np(iso1)[0])
    np.testing.assert_array_equal(h2.result(), eng128.oracle_np(iso2)[0])
    # same bucket as well: two d=64 rows from one tenant stay distinct
    r3, r4 = _dil_request(9, 64), _dil_request(9, 64)
    server2 = _server(n_c=2)
    h3 = server2.submit(r3, now=0.0)
    h4 = server2.submit(r4, now=0.0)
    iso3 = np.zeros((1, 64), np.uint32)
    iso3[0] = r3.coeffs
    iso4 = np.zeros((1, 64), np.uint32)
    iso4[0] = r4.coeffs
    np.testing.assert_array_equal(h3.result(), eng64.oracle_np(iso3)[0])
    np.testing.assert_array_equal(h4.result(), eng64.oracle_np(iso4)[0])
    # resubmitting an in-flight request object is rejected, not double-served
    server3 = _server(n_c=4)
    r5 = _dil_request(11, 64)
    server3.submit(r5, now=0.0)
    dup = server3.submit(r5, now=0.0)
    assert dup.rejected and dup.decision.reason == "duplicate"


# --- admission control ---------------------------------------------------------

def test_admission_rejects_queue_full():
    server = _server(n_c=64, max_age_s=10.0, max_pending=4)
    handles = [server.submit(_dil_request(i, 64), now=0.0) for i in range(6)]
    ok = [h for h in handles if not h.rejected]
    bad = [h for h in handles if h.rejected]
    assert len(ok) == 4 and len(bad) == 2
    assert all(h.decision.reason == "queue_full" for h in bad)
    assert all(h.decision.retry_after_s > 0 for h in bad)
    with pytest.raises(RejectedError):
        bad[0].result()
    snap = server.telemetry.snapshot()
    assert snap["admission"]["rejected"] == 2
    assert snap["admission"]["by_reason"]["queue_full"] == 2
    # draining still serves the admitted four
    server.drain(0.001)
    assert all(h.done() and not h.rejected for h in ok)


def test_admission_rate_limits_noisy_tenant():
    server = _server(n_c=64, max_age_s=10.0,
                     tenant_rate_hz=10.0, tenant_burst=1)
    h1 = server.submit(_dil_request(0, 64, 0.0), now=0.0)
    h2 = server.submit(_dil_request(0, 64, 0.01), now=0.01)   # 10ms later
    h3 = server.submit(_dil_request(1, 64, 0.01), now=0.01)   # other tenant
    assert not h1.rejected
    assert h2.rejected and h2.decision.reason == "rate_limited"
    assert not h3.rejected                    # per-tenant isolation
    # bucket refills at 10 Hz → admitted again 100ms later
    h4 = server.submit(_dil_request(0, 64, 0.12), now=0.12)
    assert not h4.rejected


def test_admission_slo_gate():
    server = _server(n_c=64, max_age_s=10.0, slo_deadline_s=0.1)
    server.admission.service_rate = 10.0      # pretend: 10 ops/s slice
    h1 = server.submit(_dil_request(0, 64), now=0.0)
    h2 = server.submit(_dil_request(1, 64), now=0.0)
    h3 = server.submit(_dil_request(2, 64), now=0.0)
    assert not h1.rejected and not h2.rejected
    # pending=2 ⇒ predicted wait 0.2s > 0.1s SLO ⇒ fast-fail
    assert h3.rejected and h3.decision.reason == "slo_miss"


def test_backpressure_signal():
    server = _server(n_c=64, max_age_s=10.0, max_pending=10)
    for i in range(7):
        server.submit(_dil_request(i, 64), now=0.0)
    assert not server.under_backpressure
    server.submit(_dil_request(7, 64), now=0.0)
    assert server.under_backpressure          # 8 ≥ 0.8 × 10


def test_token_bucket_refill():
    tb = TokenBucket(rate_hz=10.0, burst=2.0)
    assert tb.try_take(0.0) and tb.try_take(0.0)
    assert not tb.try_take(0.0)
    assert tb.time_until() == pytest.approx(0.1)
    assert not tb.try_take(0.05)              # half a token accrued
    assert tb.try_take(0.11)
    tb2 = TokenBucket(rate_hz=10.0, burst=2.0)
    tb2.try_take(0.0)
    assert tb2.try_take(100.0) and tb2.try_take(100.0)  # refill caps at burst
    assert not tb2.try_take(100.0)


# --- telemetry -----------------------------------------------------------------

def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    for v in range(1, 101):
        h.observe(v / 1000.0)
    assert h.percentile(50) == pytest.approx(0.0505)
    assert h.percentile(99) == pytest.approx(0.09901)
    assert h.percentile(100) == pytest.approx(0.1)
    s = h.summary()
    assert s["count"] == 100 and s["p95_s"] > s["p50_s"]
    assert LatencyHistogram().summary()["p99_s"] == 0.0


def test_telemetry_json_roundtrip(tmp_path):
    out = tmp_path / "telemetry.json"
    load, snap, _ = TL.serve_crypto_online(
        duration_s=0.008, rate_hz=1024, seed=2, validate=False,
        max_age_s=0.002, telemetry_out=str(out), coscheduler=T_COS)
    disk = json.loads(out.read_text())
    assert disk == json.loads(json.dumps(snap))   # snapshot is JSON-faithful
    for key in ("k_occupancy_mean", "m_occupancy_mean", "queue_depth_mean",
                "queue_depth_max", "close_reasons", "per_workload"):
        assert key in disk
    for q in ("p50_s", "p95_s", "p99_s"):
        assert disk["latency"][q] >= 0.0
    assert disk["batches"] > 0
    assert disk["requests_served"] == load.n_served
    assert disk["admission"]["admitted"] == len(load.handles)


def test_loadgen_pumps_between_arrivals():
    """Sparse arrivals: every age deadline between two arrivals fires before
    the next submit, so latency never exceeds max_age + service share."""
    reqs = [_dil_request(0, 64, 0.000), _dil_request(1, 64, 0.050)]
    server = _server(n_c=8, max_age_s=0.005)
    gen = LoadGenerator(reqs, attach=False)
    load = gen.run(server)
    assert load.n_served == 2
    reasons = [b.close_reason for b in server.telemetry.batches]
    assert reasons == ["age", "drain"]
    # the first request left the queue at its age deadline (t=0.005), not at
    # the next arrival (t=0.05) — queue wait is virtual-clock exact
    assert server.telemetry.queue_wait.percentile(100) == pytest.approx(0.005)
