"""Continuous metrics, SLO burn-rate alerting and the controller flight
recorder of the port — the unit tests of ``tests/test_metrics_alerts.py``
against the port's modules, on the deterministic virtual clock and the CPU.

Where the JAX package has the same function, the same inputs go through
both: the closed-form burn rates, the alert engine's transitions, and a
whole ``deterministic_timing`` serving run (controller, SLO gate, alert
rules), whose scraped series, OpenMetrics text and alert log equal the JAX
server's on the same requests.

Left out: the cluster runs (fleet scrape determinism, gossip-silence
sensing), which are in ``tests/test_torch_cluster.py``, and the ``perf_report`` script's
drift check, which reads the JAX package's benchmark records.
"""
import gzip
import json

import numpy as np
import pytest

from repro.core.scheduler import TenantRequest as JRequest
from repro.core.scheduler.coscheduler import SliceCoScheduler as JSlice
from repro.obs import alerts as JA
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve import CryptoServer as JServer
from repro.serve import ServeConfig as JConfig
from repro_torch.core import field as F
from repro_torch.core.scheduler import TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.obs import (chrome_trace, read_text, validate_chrome_trace,
                             validate_openmetrics, write_text)
from repro_torch.obs.alerts import (AlertEngine, BurnRateRule, ThresholdRule,
                                    default_cluster_rules,
                                    default_serve_rules, merge_alert_sections)
from repro_torch.obs.metrics import MetricsRegistry, expose_registries
from repro_torch.serve import CryptoServer, ServeConfig

RNG = np.random.default_rng(41)

# One co-scheduler for the module: engines and planes are reused.
COS = SliceCoScheduler(device="cpu")


def _dil_request(tid, d, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


def _cfg(**kw):
    kw.setdefault("validate", False)
    kw.setdefault("n_c", 4)
    kw.setdefault("max_age_s", 0.005)
    kw.setdefault("metrics", True)
    kw.setdefault("metrics_period_s", 0.001)
    kw.setdefault("deterministic_timing", True)
    return ServeConfig(**kw)


# --- registry ------------------------------------------------------------------

def test_registry_cadence_and_monotone_timestamps():
    r = MetricsRegistry(period_s=0.01, capacity=16)
    ticks = []
    r.add_collector(lambda now: ticks.append(now) or [("g", (), 1.0)])
    assert r.scrape(0.0)
    assert not r.maybe_scrape(0.005)          # inside the period: gated
    assert r.maybe_scrape(0.0199999)          # >= period elapsed
    assert not r.scrape(0.0199999)            # same instant: no double sample
    assert not r.scrape(0.01)                 # going backwards: refused
    assert r.scrapes == 2 and len(ticks) == 2
    assert [ts for ts, _ in r.series("g")] == [0.0, 0.0199999]


def test_registry_ring_bounds_and_dropped_points():
    r = MetricsRegistry(period_s=0.001, capacity=4)
    for i in range(9):
        r.observe("c", (), float(i), float(i))
    assert len(r.series("c")) == 4
    assert r.dropped_points == 5
    assert r.series("c")[0] == (5.0, 5.0)     # oldest retained
    snap = r.snapshot()
    assert snap["samples"] == 4 and snap["dropped_points"] == 5


def test_window_delta_clamps_to_oldest_and_needs_two_samples():
    r = MetricsRegistry(period_s=0.001, capacity=16)
    r.observe("c", (), 0.0, 10.0)
    assert r.window_delta("c", (), 0.0, 1.0) is None
    for i in range(1, 5):
        r.observe("c", (), float(i), 10.0 + 2.0 * i)
    assert r.window_delta("c", (), 4.0, 2.0) == (4.0, 2.0)
    # window wider than the ring span: clamped to the oldest point
    assert r.window_delta("c", (), 4.0, 100.0) == (8.0, 4.0)


def test_exposition_is_valid_openmetrics_and_hosts_are_labelled():
    a = MetricsRegistry(period_s=0.001, host=0)
    b = MetricsRegistry(period_s=0.001, host=1)
    for reg, base in ((a, 1.0), (b, 2.0)):
        reg.describe("repro_x_total", kind="counter", help_text="an x")
        for i in range(3):
            reg.observe("repro_x_total", (), float(i), base * i)
    text = expose_registries([a, b])
    stats = validate_openmetrics(text)
    assert stats == {"families": 1, "series": 2, "samples": 6}
    assert text.count("# TYPE repro_x_total counter") == 1
    assert 'host="0"' in text and 'host="1"' in text
    assert text.endswith("# EOF\n")


def test_validate_openmetrics_rejects_bad_documents():
    with pytest.raises(ValueError):
        validate_openmetrics("# TYPE x counter\nx 1 0\n")   # missing EOF
    with pytest.raises(ValueError):                         # counter decrease
        validate_openmetrics("# TYPE x counter\nx 2 0\nx 1 1\n# EOF\n")
    with pytest.raises(ValueError):                         # ts not increasing
        validate_openmetrics("# TYPE x gauge\nx 1 5\nx 2 5\n# EOF\n")


# --- burn-rate math vs closed form ---------------------------------------------

def test_burn_rate_matches_closed_form():
    r = MetricsRegistry(period_s=1.0, capacity=256)
    jr = JRegistry(period_s=1.0, capacity=256)
    miss_rate, budget = 0.3, 0.05
    for i in range(61):
        for reg in (r, jr):
            reg.observe("den", (), float(i), float(i))
            reg.observe("num", (), float(i), miss_rate * i)
    rule = BurnRateRule(name="b", num=("num", ()), den=("den", ()),
                        budget=budget, windows=((30.0, 5.0, 2.0),))
    j_rule = JA.BurnRateRule(name="b", num=("num", ()), den=("den", ()),
                             budget=budget, windows=((30.0, 5.0, 2.0),))
    for w in (5.0, 30.0):
        assert rule.burn(r, 60.0, w) == pytest.approx(miss_rate / budget)
        assert rule.burn(r, 60.0, w) == j_rule.burn(jr, 60.0, w)
    hit, worst = rule.condition(r, 60.0)
    assert hit and worst == pytest.approx(miss_rate / budget)
    assert (hit, worst) == j_rule.condition(jr, 60.0)
    # below the factor on both windows: no hit, worst still reported
    calm = BurnRateRule(name="c", num=("num", ()), den=("den", ()),
                        budget=budget, windows=((30.0, 5.0, 10.0),))
    hit, worst = calm.condition(r, 60.0)
    assert not hit and worst == pytest.approx(miss_rate / budget)


def test_burn_rate_pair_demands_both_windows():
    r = MetricsRegistry(period_s=1.0, capacity=256)
    # heavy historic burn that stopped 10 ticks ago: long window still hot,
    # short window clean — the pair must NOT fire (not burning *now*)
    for i in range(51):
        r.observe("den", (), float(i), float(i))
        r.observe("num", (), float(i), float(min(i, 40)))
    rule = BurnRateRule(name="b", num=("num", ()), den=("den", ()),
                        budget=0.05, windows=((40.0, 5.0, 2.0),))
    assert rule.burn(r, 50.0, 40.0) > 2.0
    assert rule.burn(r, 50.0, 5.0) == 0.0
    hit, _ = rule.condition(r, 50.0)
    assert not hit


# --- alert state machine -------------------------------------------------------

def _threshold_walk(registry_cls, rule_cls, engine_cls):
    """A threshold rule driven through a blip and a sustained breach;
    returns the engine and the states seen after each evaluation."""
    r = registry_cls(period_s=0.01, capacity=64)
    rule = rule_cls(name="hot", series=("g", ()), op=">", value=5.0,
                    for_s=0.02)
    eng = engine_cls(r, (rule,))
    states = []
    # missing series first, then a blip shorter than for_s, then a
    # sustained breach and its end
    for t, g in ((0.0, None), (0.01, 9.0), (0.02, 1.0), (0.03, 9.0),
                 (0.04, 9.0), (0.05, 9.0), (0.06, 9.0), (0.07, 1.0)):
        if g is not None:
            r.observe("g", (), t, g)
        eng.evaluate(t)
        states.append(eng.state("hot"))
    return eng, states


def test_alert_transitions_pending_firing_resolved_and_cancelled():
    eng, states = _threshold_walk(MetricsRegistry, ThresholdRule, AlertEngine)
    # undefined signal stays inactive; the blip goes pending then is
    # cancelled, never firing; the breach fires once for_s has elapsed
    assert states == ["inactive", "pending", "inactive", "pending",
                      "pending", "firing", "firing", "inactive"]
    kinds = [e["transition"] for e in eng.log]
    assert kinds == ["pending", "cancelled", "pending", "firing", "resolved"]
    snap = eng.snapshot()
    assert snap["rules"]["hot"]["fired"] == 1
    assert snap["rules"]["hot"]["resolved"] == 1
    assert snap["events_total"] == 5
    j_eng, j_states = _threshold_walk(JRegistry, JA.ThresholdRule,
                                      JA.AlertEngine)
    assert (states, list(eng.log), snap) == \
        (j_states, list(j_eng.log), j_eng.snapshot())


def test_alert_engine_rejects_duplicate_rule_names():
    r = MetricsRegistry(period_s=0.01)
    dup = ThresholdRule(name="x", series=("g", ()), op=">", value=0.0)
    with pytest.raises(ValueError):
        AlertEngine(r, (dup, dup))


def test_default_rule_sets_cover_the_contracted_signals():
    serve = {r.name for r in default_serve_rules(max_age_s=0.005,
                                                 slo_deadline_s=0.01)}
    assert serve == {"slo_burn", "p99_latency", "m_occupancy_floor",
                     "arithmetic_stall_share"}
    cluster = {r.name for r in default_cluster_rules(staleness_bound_s=0.004)}
    assert cluster == {"gossip_silence", "gossip_staleness", "failover_shed"}


def test_merge_alert_sections_counts_firing_hosts():
    mk = lambda state, fired: {"rules": {"slo_burn": {
        "state": state, "fired": fired, "resolved": 0, "severity": "page"}},
        "events_total": fired}
    merged = merge_alert_sections([mk("firing", 2), mk("inactive", 1), None])
    assert merged["hosts"] == 2
    assert merged["rules"]["slo_burn"]["fired"] == 3
    assert merged["rules"]["slo_burn"]["hosts_firing"] == 1
    assert merged["events_total"] == 3
    assert merge_alert_sections([None, {}]) == {}


# --- induced overload: fire AND resolve on a real serve run --------------------

def _overload_rules():
    """One tight window pair so a ~20 ms virtual run can both fire and
    resolve the admission burn alert."""
    return (BurnRateRule(
        name="slo_burn",
        num=("repro_admission_slo_miss_total", ()),
        den=("repro_admission_decisions_total", ()),
        budget=0.05, windows=((0.01, 0.004, 1.0),)),)


def _run_overload(tmp_path=None):
    # n_c far above the offered burst and a long age trigger: admitted
    # requests pool in the open batch, so the SLO gate's predicted wait
    # (pending / service-rate, init 1024 rows/s) crosses the 2 ms deadline
    # after a couple of admits and every later decision is a miss.
    cfg = _cfg(n_c=64, max_age_s=0.05, slo_deadline_s=0.002,
               tracing=True, alert_rules=_overload_rules())
    srv = CryptoServer(cfg, coscheduler=COS)
    t = 0.0
    handles = []
    for i in range(40):
        t = i * 0.0005
        handles.append(srv.submit(_dil_request(i, 64, t), now=t))
    rejected = sum(1 for h in handles if h.rejected)
    # offered load stops; keep the serving clock ticking so scrapes continue,
    # the age trigger flushes the pooled batch, and the alert can resolve
    for k in range(1, 41):
        srv.pump(0.02 + 0.002 * k)
    srv.drain(0.11)
    return srv, rejected


def test_induced_overload_fires_and_resolves_slo_burn():
    srv, rejected = _run_overload()
    assert rejected > 10                      # the overload actually rejected
    snap = srv.alerts.snapshot()
    rule = snap["rules"]["slo_burn"]
    assert rule["fired"] >= 1
    assert rule["resolved"] >= 1
    assert rule["state"] == "inactive"        # resolved by the end
    kinds = [e["transition"] for e in srv.alerts.log]
    assert kinds.index("firing") < kinds.index("resolved")
    # the firing instant is on the Perfetto timeline, on the alerts track
    trace = chrome_trace(srv.trace_events())
    validate_chrome_trace(trace)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "i"}
    assert "alert_firing:slo_burn" in names
    assert "alert_resolved:slo_burn" in names
    # and the telemetry snapshot carries both sections
    tsnap = srv.telemetry.snapshot()
    assert tsnap["metrics"]["scrapes"] == srv.metrics.scrapes
    assert tsnap["alerts"]["rules"]["slo_burn"]["fired"] == rule["fired"]


# --- virtual-clock determinism -------------------------------------------------

def _deterministic_run(seed=5, *, request=TenantRequest, config=ServeConfig,
                       server=CryptoServer, cos=COS):
    """48 Dilithium arrivals through a controller + SLO-gated server under
    ``deterministic_timing``; the package's classes are parameters, so the
    JAX server can take the same requests."""
    rng = np.random.default_rng(seed)
    reqs = [(i, request(
        i, "dilithium", 64, i * 0.0008,
        np.asarray(rng.integers(0, F.DILITHIUM_Q, 64, dtype=np.uint64),
                   np.uint32))) for i in range(48)]
    cfg = config(validate=False, n_c=4, max_age_s=0.005, metrics=True,
                 metrics_period_s=0.001, deterministic_timing=True,
                 controller=True, row_ladder_max=32, slo_deadline_s=0.01,
                 max_pending=64)
    srv = server(cfg, coscheduler=cos)
    for i, req in reqs:
        srv.submit(req, now=req.arrival_time)
    srv.drain(0.06)
    return srv


def test_two_runs_scrape_bit_identical_series_and_alert_logs():
    a, b = _deterministic_run(), _deterministic_run()
    assert a.metrics.scrapes > 5
    assert a.metrics_text() == b.metrics_text()
    assert list(a.alerts.log) == list(b.alerts.log)
    assert json.dumps(a.alerts.snapshot(), sort_keys=True) == \
        json.dumps(b.alerts.snapshot(), sort_keys=True)


def test_deterministic_run_equals_the_jax_servers():
    """The same requests through the JAX server: the modelled service time
    is the same cycle model, so the scraped series, the exposition, the
    alert log and the controller's flight recorder are equal."""
    port = _deterministic_run()
    ref = _deterministic_run(request=JRequest, config=JConfig,
                             server=JServer, cos=JSlice())
    assert port.metrics.scrapes == ref.metrics.scrapes > 5
    assert port.metrics_text() == ref.metrics_text()
    assert list(port.alerts.log) == list(ref.alerts.log)
    assert json.dumps(port.alerts.snapshot(), sort_keys=True) == \
        json.dumps(ref.alerts.snapshot(), sort_keys=True)
    assert json.dumps(port.controller.snapshot(), sort_keys=True) == \
        json.dumps(ref.controller.snapshot(), sort_keys=True)
    # the whole telemetry snapshot but the launch census by device, whose
    # keys name devices the packages' own way ("0" for JAX device 0,
    # "cpu" for the torch device)
    snaps = [srv.telemetry.snapshot() for srv in (port, ref)]
    assert set(snaps[0]["dispatch"].pop("by_device")) == {"cpu"}
    assert set(snaps[1]["dispatch"].pop("by_device")) == {"0"}
    assert json.dumps(snaps[0], sort_keys=True) == \
        json.dumps(snaps[1], sort_keys=True)


# --- controller flight recorder ------------------------------------------------

def test_flight_recorder_captures_setpoint_changes():
    cfg = _cfg(controller=True, row_ladder_max=64, n_c=8, max_age_s=0.002,
               tracing=True, max_pending=4096)
    srv = CryptoServer(cfg, coscheduler=COS)
    # a hard burst then starvation: the controller must move the target
    # rung at least once in each direction
    t = 0.0
    for i in range(120):
        t = i * 0.0001
        srv.submit(_dil_request(i, 64, t), now=t)
    for k in range(1, 30):
        srv.pump(t + 0.002 * k)
    srv.drain(t + 0.08)
    ctl = srv.controller
    assert ctl.decisions >= 1
    assert len(ctl.flight) == min(ctl.decisions, ctl.flight.maxlen)
    for rec in ctl.flight:
        assert rec.reason in ("starving", "overloaded", "queue_model")
        assert (rec.target_rows, rec.max_age_s, rec.occupancy_close) != \
            (rec.target_rows_from, rec.max_age_from_s, rec.occupancy_from)
    fr = ctl.snapshot()["flight_recorder"]
    assert fr["decisions"] == ctl.decisions
    assert len(fr["records"]) == len(ctl.flight)
    assert fr["records"][-1]["ts"] >= fr["records"][0]["ts"]
    # every recorded decision also landed as a setpoint instant on the trace
    trace = chrome_trace(srv.trace_events())
    setpoints = [e for e in trace["traceEvents"]
                 if e["ph"] == "i" and e["name"] == "setpoint"]
    assert len(setpoints) == ctl.decisions
    assert setpoints[0]["args"]["reason"] in ("starving", "overloaded",
                                              "queue_model")


def test_flight_recorder_ring_is_bounded():
    from repro_torch.serve.controller import AdaptiveController
    ctl = AdaptiveController(ladder=(8, 16, 32), n_c=8, max_age_s=0.002,
                             recorder_capacity=4)
    for i in range(12):
        # alternate starvation and overload so every observation moves a
        # setpoint (the age lever oscillates) and appends a record
        depth = 0 if i % 2 == 0 else 10_000
        ctl.observe_dispatch(("dilithium", 64), now=0.01 * (i + 1),
                             live_rows=2, queue_depth=depth)
    assert ctl.decisions > 4
    assert len(ctl.flight) == 4               # ring stays bounded
    assert ctl.snapshot()["flight_recorder"]["capacity"] == 4


# --- gzip transparency ---------------------------------------------------------

def test_trace_and_metrics_gzip_roundtrip(tmp_path):
    srv, _ = _run_overload()
    tpath = str(tmp_path / "trace.json.gz")
    mpath = str(tmp_path / "metrics.om.gz")
    srv.write_trace(tpath)
    srv.write_metrics(mpath)
    with gzip.open(tpath, "rt") as f:      # really gzip on disk
        json.load(f)
    stats = validate_chrome_trace(tpath)   # validator reads .gz directly
    assert stats["requests"] > 0
    mstats = validate_openmetrics(mpath)
    assert mstats["samples"] > 0
    assert read_text(mpath) == srv.metrics_text()
    # plain-path round trip through the same helpers
    plain = str(tmp_path / "metrics.om")
    write_text(plain, srv.metrics_text())
    assert validate_openmetrics(plain) == mstats


