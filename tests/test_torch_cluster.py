"""The multi-host cluster of the port (``repro_torch.cluster``,
``serve_crypto_cluster``) on the CPU, against the JAX package's.

The unit tests of ``tests/test_cluster.py`` against the port's modules
(router, gossip, gossip-gated admission, drain barrier, snapshot merge), and
the cluster cases the port's other suites left for this slice (fleet scrape
determinism and gossip-silence sensing from ``tests/test_metrics_alerts.py``,
the traced fleet and the sketched histogram merge from ``tests/test_obs.py``,
the closed-loop cluster from ``tests/test_controller.py``).  Where both
packages have the function, the same seeded inputs go through both.

Parity: the same Poisson trace (0.01 s at 1,024 req/s, seed 5, degrees
uniform at 256, n_c = 4, the mixed eager/lazy configuration) through the
port's cluster at N ∈ {1, 2, 4} hosts, with and without a kill/recover
fault plan, the port's single-host replay and the JAX single-host replay:
every tenant row equal, bit for bit.  Under ``deterministic_timing`` the
port's 2-host ``ClusterServer.snapshot()`` and fleet OpenMetrics text equal
the JAX cluster's; device ids are torch device strings in the port and
integer ids in JAX, so the ``devices`` and ``dispatch_overlap`` sections and
the launch census by device are compared by count.  All comparisons are
exact.  One co-scheduler per package serves every host of every cluster
here (``coscheduler_factory``), as in ``tests/test_cluster.py``.
"""
import json
import sys

import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterServer as JClusterServer
from repro.cluster import merge_snapshots as j_merge_snapshots
from repro.cluster import stable_tenant_hash as j_stable_tenant_hash
from repro.cluster import TenantHashRouter as JRouter
from repro.core.scheduler import PoissonTrace as JTrace
from repro.core.scheduler.coscheduler import SliceCoScheduler as JSlice
from repro.launch.serve import serve_crypto as j_serve_crypto
from repro.serve import LoadGenerator as JLoad
from repro.serve import ServeConfig as JConfig
from repro.serve import telemetry as JT
from repro_torch.cluster import (ClusterConfig, ClusterServer, GossipBus,
                                 TenantHashRouter, load_imbalance,
                                 merge_snapshots, stable_tenant_hash)
from repro_torch.cluster.telemetry import _merge_histograms
from repro_torch.core import field as F
from repro_torch.core.scheduler import PoissonTrace, TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.launch import serve as TL
from repro_torch.obs import validate_chrome_trace, validate_openmetrics
from repro_torch.obs.alerts import default_serve_rules
from repro_torch.serve import LoadGenerator, ServeConfig
from repro_torch.serve import telemetry as TT
from repro_torch.serve.telemetry import (BatchRecord, LatencyHistogram,
                                         Telemetry)

RNG = np.random.default_rng(17)

# The mixed eager/lazy configuration (tests/test_cluster.py's parity cell).
MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
TRACE = dict(duration_s=0.01, rate_hz=1024, seed=5)
PARITY = dict(TRACE, d_uniform=256)
ONLINE_CFG = dict(n_c=4, max_age_s=0.002)
FAULT_PLAN = "kill@0.5:h1,recover@0.9:h1"
# The deterministic configuration both clusters run: modelled service time,
# metrics scraped every millisecond of the virtual clock.
DETERMINISTIC = dict(ONLINE_CFG, deterministic_timing=True, metrics=True,
                     metrics_period_s=0.001, validate=False, **MIXED)

# One co-scheduler per package for the module, shared by every host.  The
# JAX one is pinned to its first device, so that its device sections count
# one device whatever the process's JAX device count is (as the port's
# "cpu").
J_COS = JSlice(devices=[0], **MIXED)
T_COS = SliceCoScheduler(device="cpu", **MIXED)


def _dil_request(tid, d, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


def _tenant_on_host(router, host, start=0):
    tid = start
    while router.host_for(tid) != host:
        tid += 1
    return tid


def _rows(results) -> dict:
    out = {}
    for r in results:
        out.update(r.outputs)
    return out


def _assert_same_rows(port: dict, ref: dict):
    assert set(port) == set(ref) and ref
    for tid, row in ref.items():
        assert port[tid].dtype == np.uint32
        np.testing.assert_array_equal(port[tid], row)


def _cluster(n_hosts=2, **serve_kw) -> ClusterServer:
    serve_kw.setdefault("validate", False)
    return ClusterServer(ClusterConfig(n_hosts=n_hosts, device="cpu",
                                       serve=ServeConfig(**serve_kw)),
                         coscheduler_factory=lambda h: T_COS)


@pytest.fixture(scope="module")
def jax_replay() -> dict:
    """The JAX single-host offline replay of the parity trace."""
    results, _, _ = j_serve_crypto(coscheduler=J_COS, validate=False, n_c=4,
                                   **PARITY)
    return _rows(results)


# --- ingress router ------------------------------------------------------------

def test_router_stable_and_pinned():
    r = TenantHashRouter(4, pinned={7: 2})
    # process-independent: CRC32, not salted hash()
    assert stable_tenant_hash(123) == 0x884863D2           # crc32(b"123")
    assert stable_tenant_hash("123") == stable_tenant_hash(123)
    assert all(r.host_for(t) == r.host_for(t) for t in range(100))
    assert r.host_for(7) == 2                       # pin overrides the hash
    parts = r.partition(range(1000))
    assert sorted(sum(parts.values(), [])) == list(range(1000))
    assert all(len(v) > 150 for v in parts.values())   # near-uniform spread
    with pytest.raises(ValueError):
        TenantHashRouter(2, pinned={0: 5})
    with pytest.raises(ValueError):
        TenantHashRouter(0)


def test_router_equals_jax():
    """Hash, owner, the top-3 choices and the partition of the JAX router,
    for int and str tenants, with a pin."""
    tenants = list(range(500)) + [f"tenant-{i}" for i in range(50)]
    r, j = TenantHashRouter(5, pinned={3: 4}), JRouter(5, pinned={3: 4})
    assert [stable_tenant_hash(t) for t in tenants] == \
        [j_stable_tenant_hash(t) for t in tenants]
    assert [r.host_for(t) for t in tenants] == [j.host_for(t) for t in tenants]
    assert [r.choices(t, 3) for t in tenants] == \
        [j.choices(t, 3) for t in tenants]
    assert r.partition(tenants) == j.partition(tenants)


def test_cluster_routes_by_tenant_hash_and_pinning():
    cfg = ClusterConfig(n_hosts=3, pinned={99: 1}, device="cpu",
                        serve=ServeConfig(n_c=64, max_age_s=10.0,
                                          validate=False))
    cluster = ClusterServer(cfg, coscheduler_factory=lambda h: T_COS)
    for tid in (0, 1, 2, 3, 99):
        cluster.submit(_dil_request(tid, 64), now=0.0)
    expect = [0, 0, 0]
    for tid in (0, 1, 2, 3):
        expect[cluster.router.host_for(tid)] += 1
    expect[1] += 1                                   # the pinned tenant
    assert [h.batcher.depth for h in cluster.hosts] == expect
    assert cluster.snapshot()["routing"]["per_host_submissions"] == expect


# --- gossip --------------------------------------------------------------------

def test_gossip_period_gating_and_staleness_bound():
    g = GossipBus(2, period_s=0.01, staleness_factor=2.0)
    assert g.staleness_bound_s == pytest.approx(0.02)
    assert g.maybe_publish(1, 10, now=0.0)
    assert not g.maybe_publish(1, 20, now=0.005)     # inside the period
    assert g.maybe_publish(1, 20, now=0.01)
    # fresh digest is used and its staleness recorded
    v = g.cluster_view(0, local_depth=3, now=0.025)
    assert v.peer_depth == 20 and v.contributing_hosts == 2
    assert v.max_staleness_s == pytest.approx(0.015)
    assert v.total_depth == 23 and v.per_host_equiv == pytest.approx(11.5)
    # past the bound the digest is dropped, never consumed
    v2 = g.cluster_view(0, local_depth=3, now=0.031)
    assert v2.peer_depth == 0 and v2.stale_dropped == 1
    assert v2.per_host_equiv == pytest.approx(3.0)
    snap = g.snapshot()
    assert snap["stale_drops"] == 1
    assert snap["used_staleness_max_s"] <= snap["staleness_bound_s"]


def test_gossip_dead_host_pruned_after_one_drop():
    """A host that stops publishing costs exactly one stale drop, ever: the
    first view that ages its digest past the bound also prunes it, so later
    views neither consume nor re-drop it.  Republishing revives the host."""
    g = GossipBus(3, period_s=0.01, staleness_factor=2.0)
    g.publish(1, 5, now=0.0)
    g.publish(2, 7, now=0.0)
    v = g.cluster_view(0, local_depth=0, now=0.01)
    assert v.peer_depth == 12 and v.stale_dropped == 0
    # host 1 dies; host 2 keeps publishing; views every period for 1 s
    for i in range(2, 102):
        now = 0.01 * i
        g.maybe_publish(2, 7, now=now)
        v = g.cluster_view(0, local_depth=0, now=now)
    assert v.peer_depth == 7 and v.contributing_hosts == 2
    snap = g.snapshot()
    assert snap["stale_drops"] == 1
    assert snap["pruned_digests"] == 1
    # a pruned host that publishes again is simply fresh
    g.publish(1, 3, now=1.02)
    v = g.cluster_view(0, local_depth=0, now=1.025)
    assert v.peer_depth == 10 and v.stale_dropped == 0
    assert g.snapshot()["revives"] == 1


def test_gossip_gated_admission_rejects_on_cluster_depth():
    """The SLO gate rejects on cluster-wide depth that local-only state
    would admit, and never consumes a digest older than period × 2."""
    period = 0.01
    cfg = ClusterConfig(
        n_hosts=2, gossip_period_s=period, device="cpu",
        serve=ServeConfig(n_c=64, max_age_s=10.0, validate=False,
                          slo_deadline_s=0.1))
    cluster = ClusterServer(cfg, coscheduler_factory=lambda h: T_COS)
    for srv in cluster.hosts:
        srv.admission.service_rate = 100.0           # pin the EWMA: 100 ops/s
        srv.admission.ewma_alpha = 0.0
    # host 1 is the victim we overload; its local SLO gate is off so that
    # the point is host 0's gate acting on gossiped cluster state
    cluster.hosts[1].admission.slo_deadline_s = None
    t_cold = _tenant_on_host(cluster.router, 0)
    tid = 0
    for _ in range(30):
        tid = _tenant_on_host(cluster.router, 1, start=tid)
        h = cluster.submit(_dil_request(tid, 64), now=0.0)
        assert not h.rejected
        tid += 1
    assert cluster.hosts[1].batcher.depth == 30
    # t=0.02: host 0 sees cluster depth 30/2 = 15 rows → 0.15 s predicted
    # wait > 0.1 s SLO → cluster rejection
    h = cluster.submit(_dil_request(t_cold, 64), now=0.02)
    assert h.rejected and h.decision.reason == "cluster_slo_miss"
    assert h.decision.retry_after_s == pytest.approx(0.15)
    local = cluster.hosts[0].admission.admit(
        _dil_request(t_cold + 10, 64), 0.02,
        pending=cluster.hosts[0].batcher.depth)
    assert local.admitted
    # a digest aged inside the bound is still used ...
    h2 = cluster.hosts[0].submit(_dil_request(t_cold + 20, 64), now=0.035)
    assert h2.rejected and h2.decision.reason == "cluster_slo_miss"
    # ... one aged past it is dropped, and local-only state admits
    h3 = cluster.hosts[0].submit(_dil_request(t_cold + 30, 64), now=0.045)
    assert not h3.rejected
    g = cluster.snapshot()["gossip"]
    assert g["stale_drops"] >= 1
    assert g["used_staleness_max_s"] == pytest.approx(0.015)
    assert g["used_staleness_max_s"] <= g["staleness_bound_s"]
    by = cluster.hosts[0].telemetry.snapshot()["admission"]["by_reason"]
    assert by["cluster_slo_miss"] == 2


# --- distributed drain barrier -------------------------------------------------

def test_drain_barrier_quiesces_fleet_then_flushes():
    cluster = _cluster(3, n_c=64, max_age_s=10.0)
    handles = []
    for host in range(3):
        tid = _tenant_on_host(cluster.router, host)
        handles.append(cluster.submit(_dil_request(tid, 64), now=0.0))
    assert not cluster.drained
    flushed = cluster.drain(0.001)
    assert flushed == 3 and cluster.drained
    assert all(h.done() and not h.rejected for h in handles)
    # post-barrier ingress is rejected on every host, not just one
    for host in range(3):
        tid = _tenant_on_host(cluster.router, host, start=1000)
        h = cluster.submit(_dil_request(tid, 64), now=0.002)
        assert h.rejected and h.decision.reason == "draining"
    bar = cluster.snapshot()["drain_barrier"]
    assert bar["complete"] and bar["hosts"] == 3
    assert bar["batches_flushed"] == 3 and bar["inflight_groups"] == 0
    assert bar["quiesced_at"] <= bar["drained_at"]


def test_ring_quiesce_retires_cluster_wide():
    """Depth-2 rings on two hosts with the controller: the drain barrier
    leaves zero launch groups in flight on any host."""
    trace = [_dil_request(i, 64, i * 0.0002) for i in range(40)]
    load, snap, _ = TL.serve_crypto_cluster(
        hosts=2, trace=trace, validate=False, n_c=4, max_age_s=0.002,
        row_ladder_max=16, async_pipeline=True, inflight_depth=2,
        controller=True, device="cpu", coscheduler_factory=lambda h: T_COS)
    bar = snap["drain_barrier"]
    assert bar["complete"] and bar["inflight_groups"] == 0
    assert all(h.done() and not h.rejected for h in load.handles)


# --- cluster vs single-host parity ---------------------------------------------

@pytest.mark.parametrize("n_hosts,fault_plan", [
    (1, None), (2, None), (4, None), (2, FAULT_PLAN), (4, FAULT_PLAN)])
def test_cluster_drain_matches_single_host_replay(jax_replay, n_hosts,
                                                  fault_plan):
    """Draining an N-host cluster (and one whose host 1 is killed mid-trace
    and recovered) yields the port's single-host replay's and the JAX
    single-host replay's rows, bit for bit, with mixed eager/lazy classes;
    nothing is lost."""
    offline, n_ops, _ = TL.serve_crypto(coscheduler=T_COS, validate=False,
                                        n_c=4, **PARITY)
    offline = _rows(offline)
    _assert_same_rows(offline, jax_replay)
    load, snap, _ = TL.serve_crypto_cluster(
        hosts=n_hosts, validate=False, fault_plan=fault_plan, device="cpu",
        coscheduler_factory=lambda h: T_COS, **ONLINE_CFG, **MIXED,
        **PARITY)
    assert n_ops == len(offline) == len(load.handles)
    _assert_same_rows(load.outputs, jax_replay)
    m = snap["merged"]
    assert m["requests_served"] == n_ops
    assert m["per_workload"]["dilithium"]["reduction"] == "lazy"
    assert m["per_workload"]["bn254"]["reduction"] == "eager"
    assert snap["n_hosts"] == n_hosts and len(snap["per_host"]) == n_hosts
    bar = snap["drain_barrier"]
    assert bar["complete"] and bar["inflight_groups"] == 0
    fo = snap["failover"]
    assert fo["lost"] == 0 and fo["limbo_pending"] == 0
    if fault_plan:
        assert fo["summary"]["kills"] == 1 and fo["summary"]["cordons"] == 1
        assert fo["host_states"] == {h: "serving" for h in range(n_hosts)}
    if n_hosts > 1:
        assert sum(1 for s in snap["per_host"]
                   if s["requests_served"] > 0) > 1


def test_closed_loop_cluster_matches_offline_replay():
    """Controller, holdback and a depth-2 ring on a 2-host cluster: the
    static offline replay's rows, both controllers running."""
    kw = dict(duration_s=0.01, rate_hz=1024, seed=29, d_uniform=256)
    offline, n_ops, _ = TL.serve_crypto(coscheduler=T_COS, validate=False,
                                        **kw)
    load, snap, _ = TL.serve_crypto_cluster(
        hosts=2, max_age_s=0.002, validate=False, row_ladder_max=16,
        async_pipeline=True, controller=True, holdback_lambda=1.5,
        inflight_depth=2, device="cpu", coscheduler_factory=lambda h: T_COS,
        **MIXED, **kw)
    _assert_same_rows(load.outputs, _rows(offline))
    m = snap["merged"]
    assert m["requests_served"] == n_ops
    assert "holdback" in m and m["controller"]["hosts"] == 2
    assert snap["drain_barrier"]["inflight_groups"] == 0


def _jax_cluster(n_hosts, **kw):
    # launches of earlier offline replays stay out of the served telemetry
    J_COS.drain_dispatch_log()
    cluster = JClusterServer(
        JClusterConfig(n_hosts=n_hosts, serve=JConfig(**DETERMINISTIC), **kw),
        coscheduler_factory=lambda h: J_COS)
    JLoad(JTrace(uniform_degree=256, **TRACE), seed=TRACE["seed"]).run(cluster)
    return cluster


def _port_cluster(n_hosts, **kw):
    T_COS.drain_dispatch_log()
    cluster = ClusterServer(
        ClusterConfig(n_hosts=n_hosts, device="cpu",
                      serve=ServeConfig(**DETERMINISTIC), **kw),
        coscheduler_factory=lambda h: T_COS)
    LoadGenerator(PoissonTrace(uniform_degree=256, **TRACE),
                  seed=TRACE["seed"]).run(cluster)
    return cluster


def _without_device_names(snap: dict) -> dict:
    """A cluster snapshot with every device name replaced by its count:
    the ``devices`` and ``dispatch_overlap`` sections and each launch census
    by device ("0" for JAX device 0, "cpu" for the torch device)."""
    snap = json.loads(json.dumps(snap))
    for s in [snap["merged"], *snap["per_host"]]:
        s["dispatch"]["by_device"] = len(s["dispatch"]["by_device"])
    dv = snap["devices"]
    dv["per_host"] = [len(p) for p in dv["per_host"]]
    ov = snap["dispatch_overlap"]
    ov["per_host_devices"] = {h: len(d)
                              for h, d in ov["per_host_devices"].items()}
    for ev in snap["failover"]["events"]:
        if "device_ids" in ev:
            ev["device_ids"] = len(ev["device_ids"])
    return snap


def test_deterministic_cluster_snapshot_equals_jax():
    """Two hosts, modelled service time, metrics on: the whole snapshot
    (merged, per-host, gossip, routing, failover, drain barrier, fleet
    metrics and alerts) and the fleet OpenMetrics text equal the JAX
    cluster's; the device sections agree in their counts."""
    j, t = _jax_cluster(2), _port_cluster(2)
    j_snap, t_snap = j.snapshot(), t.snapshot()
    assert t_snap["devices"]["per_host"] == [["cpu"], ["cpu"]]
    assert t.metrics.scrapes == j.metrics.scrapes > 5
    assert t.metrics_text() == j.metrics_text()
    for key in ("merged", "per_host", "gossip", "routing", "failover",
                "drain_barrier", "cluster_metrics", "cluster_alerts"):
        assert json.dumps(_without_device_names(t_snap)[key],
                          sort_keys=True) == \
            json.dumps(_without_device_names(j_snap)[key],
                       sort_keys=True), key
    assert json.dumps(_without_device_names(t_snap), sort_keys=True) == \
        json.dumps(_without_device_names(j_snap), sort_keys=True)
    assert t_snap["merged"]["requests_served"] > 0
    assert t_snap["drain_barrier"]["complete"]


def test_cluster_scrape_and_alert_logs_bit_identical_across_runs():
    """Two runs of one deterministic 2-host cluster scrape the same series
    and log the same alerts, fleet-wide and per host."""
    def run():
        rng = np.random.default_rng(9)
        cluster = _cluster(2, n_c=4, max_age_s=0.004, slo_deadline_s=0.02,
                           metrics=True, metrics_period_s=0.001,
                           deterministic_timing=True)
        for i in range(48):
            t = i * 0.0008
            coeffs = np.asarray(rng.integers(0, F.DILITHIUM_Q, 64,
                                             dtype=np.uint64), np.uint32)
            cluster.submit(TenantRequest(i, "dilithium", 64, t, coeffs),
                           now=t)
        cluster.drain(0.06)
        return cluster

    a, b = run(), run()
    assert a.metrics is not None and a.metrics.scrapes > 0
    assert a.metrics_text() == b.metrics_text()
    assert list(a.alerts.log) == list(b.alerts.log)
    for ha, hb in zip(a.hosts, b.hosts):
        assert list(ha.alerts.log) == list(hb.alerts.log)
    assert validate_openmetrics(a.metrics_text())["samples"] > 0
    assert a.metrics.latest("repro_gossip_silence_seconds_max") is not None
    merged = a.snapshot()["merged"]
    assert merged["metrics"]["hosts"] == 2
    assert set(merged["alerts"]["rules"]) == {
        r.name for r in default_serve_rules(max_age_s=0.004,
                                            slo_deadline_s=0.02)}


def test_gossip_silence_alert_senses_a_dead_host():
    cluster = _cluster(2, n_c=4, max_age_s=0.004, metrics=True,
                       metrics_period_s=0.001, deterministic_timing=True)
    # a dead host is simulated at the bus: both publish once, then host 1
    # goes silent while host 0 keeps its digests fresh
    cluster.gossip.publish(0, 3, 0.0)
    cluster.gossip.publish(1, 3, 0.0)
    bound = cluster.gossip.staleness_bound_s
    for k in range(1, 10):
        t = 0.002 * k
        cluster.gossip.maybe_publish(0, 3, t)
        assert cluster.metrics.scrape(t)
        cluster.alerts.evaluate(t)
        if t <= bound:
            assert cluster.alerts.state("gossip_silence") == "inactive"
    assert cluster.alerts.state("gossip_silence") == "firing"
    assert cluster.metrics.latest("repro_gossip_silence_seconds_max") > bound
    assert cluster.metrics.latest("repro_gossip_silence_seconds",
                                  (("peer", "1"),)) > bound
    cluster.gossip.publish(1, 3, 0.02)
    cluster.metrics.scrape(0.0205)
    cluster.alerts.evaluate(0.0205)
    assert cluster.alerts.state("gossip_silence") == "inactive"
    assert cluster.alerts.snapshot()["rules"]["gossip_silence"]["resolved"] == 1


def test_silence_survives_digest_prune_until_republish():
    """The staleness prune drops a dead host's digest, but its publish
    silence keeps growing: ``gossip_silence`` stays firing after the prune
    and resolves only on a republish."""
    cluster = _cluster(2, n_c=4, max_age_s=0.004, metrics=True,
                       metrics_period_s=0.001, deterministic_timing=True)
    bus = cluster.gossip
    bus.publish(0, 3, 0.0)
    bus.publish(1, 3, 0.0)
    bound = bus.staleness_bound_s
    t = bound + 0.001
    bus.publish(0, 3, t)
    bus.cluster_view(0, 3, t)
    assert bus.pruned_digests == 1 and 1 not in bus._digests
    assert bus.silence_s(t)[1] == pytest.approx(t)
    cluster.metrics.scrape(t)
    cluster.alerts.evaluate(t)
    assert cluster.alerts.state("gossip_silence") == "firing"
    for k in (2.0, 4.0, 8.0):
        tk = bound * k + 0.001
        bus.maybe_publish(0, 3, tk)
        cluster.metrics.scrape(tk)
        cluster.alerts.evaluate(tk)
        assert cluster.alerts.state("gossip_silence") == "firing"
        assert bus.silence_s(tk)[1] == pytest.approx(tk)
    tr = bound * 8.0 + 0.002
    bus.publish(1, 3, tr)
    cluster.metrics.scrape(tr)
    cluster.alerts.evaluate(tr)
    assert cluster.alerts.state("gossip_silence") == "inactive"


def test_cluster_traced_fleet(tmp_path):
    # per-host co-schedulers (the default construction): a shared one would
    # share its tracer hook too, the last host's
    cluster = ClusterServer(ClusterConfig(
        n_hosts=2, device="cpu",
        serve=ServeConfig(validate=False, n_c=4, max_age_s=0.004,
                          tracing=True)))
    assert cluster.hosts[0].cos is not cluster.hosts[1].cos
    handles = []
    for i in range(8):
        t = i * 0.001
        handles.append(cluster.submit(_dil_request(i, 64, t), now=t))
        cluster.pump(t)
    cluster.drain(0.05)
    assert all(h.done() and not h.rejected for h in handles)
    path = tmp_path / "fleet.json"
    cluster.write_trace(str(path))
    doc = json.load(open(path))
    assert validate_chrome_trace(doc)["requests"] == 8
    # per-host process tracks are distinct and the drain barrier span rides
    # the cluster-control process
    pids = {e["pid"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert {2, 3} <= pids
    barrier = [e for e in doc["traceEvents"] if e["name"] == "drain_barrier"]
    assert {e["ph"] for e in barrier} == {"B", "E"}
    assert all(e["pid"] == 1 for e in barrier)
    pen = cluster.snapshot()["merged"]["penalty"]
    assert abs(sum(pen["dilithium"]["shares"].values()) - 1.0) <= 1e-9


def test_cluster_without_device_raises_without_a_gpu():
    """The cluster's default device is CUDA: without a GPU its construction
    and ``serve_crypto_cluster`` raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterServer(ClusterConfig(n_hosts=2,
                                    serve=ServeConfig(validate=False)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterServer(ClusterConfig(n_hosts=2, device_parallel=True,
                                    serve=ServeConfig(validate=False)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.serve_crypto_cluster(hosts=2, duration_s=0.001)


def test_cli_cluster_mode_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "c.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--mode", "crypto-online", "--device", "cpu", "--hosts",
        "3", "--duration", "0.01", "--rate", "1024", "--max-age-ms", "2",
        "--seed", "5", "--gossip-period-ms", "2", "--fault-plan",
        FAULT_PLAN, "--shed-watermark", "0.9", "--device-parallel",
        "--telemetry-out", str(out)])
    TL.main()
    lines = capsys.readouterr().out.splitlines()
    heads = [line.split(":")[0].split(" ")[0] for line in lines]
    assert heads == ["cluster[3", "per-host", "gossip", "latency",
                     "drain", "devices", "failover", "cluster"]
    assert lines[0].startswith("cluster[3 hosts]: served ")
    assert "on cpu" in lines[0]
    assert "complete=True, in-flight=0" in lines[4]
    assert "limb_matmul=0 mont_fold=0" in lines[4]
    assert lines[5].startswith("devices: per-host [['cpu'], ['cpu'], "
                               "['cpu']] (1 distinct)")
    assert "lost=0 (must be 0)" in lines[6]
    snap = json.loads(out.read_text())
    assert snap["n_hosts"] == 3 and snap["drain_barrier"]["complete"]
    assert snap["failover"]["lost"] == 0


# --- telemetry merge -----------------------------------------------------------

def _random_telemetry(mod, rng, n_batches,
                      reason_pool=("full", "age", "drain")):
    """Seeded per-host telemetry built with ``mod`` (the port's or the JAX
    package's ``serve.telemetry``); the same ``rng`` state gives the same
    records in both."""
    t = mod.Telemetry()
    for _ in range(n_batches):
        workload = rng.choice(["dilithium", "bn254"])
        lazy = workload == "dilithium"
        t.record_batch(mod.BatchRecord(
            workload=str(workload), d_bucket=int(rng.choice([64, 256])),
            n_c=int(rng.integers(1, 9)),
            close_reason=str(rng.choice(reason_pool)),
            m_occupancy=float(rng.uniform(0, 1)),
            k_occupancy=float(rng.uniform(0, 1)),
            queue_depth=int(rng.integers(0, 50)),
            service_s=float(rng.uniform(0, 1e-2)),
            age_s=float(rng.uniform(0, 1e-2)),
            reduction="lazy" if lazy else "eager",
            n_folds=1 if lazy else 9))
        t.record_admission(str(rng.choice(["ok", "ok", "queue_full"])))
    for _ in range(4 * n_batches):
        t.observe_latency(float(rng.uniform(0, 0.1)),
                          queue_wait_s=float(rng.uniform(0, 0.05)))
    return t


def test_merge_snapshots_matches_concatenated_records():
    """Merging K per-host snapshots reproduces the quantiles and counters of
    the concatenated records (exact samples path, 1e-9 relative), and equals
    the JAX package's merge of the same records, bit for bit."""
    parts = [_random_telemetry(TT, np.random.default_rng(23 + i), n)
             for i, n in enumerate((7, 13, 5))]
    j_parts = [_random_telemetry(JT, np.random.default_rng(23 + i), n)
               for i, n in enumerate((7, 13, 5))]
    combined = Telemetry()
    for t in parts:
        for rec in t.batches:
            combined.record_batch(rec)
        for reason, n in t.admission_counts.items():
            for _ in range(n):
                combined.record_admission(reason)
        for lat, qw in zip(t.latency.samples, t.queue_wait.samples):
            combined.observe_latency(lat, queue_wait_s=qw)
    merged = merge_snapshots([t.snapshot(include_samples=True)
                              for t in parts])
    want = combined.snapshot()
    rel = 1e-9
    for key in ("batches", "requests_served", "queue_depth_max"):
        assert merged[key] == want[key], key
    for key in ("k_occupancy_mean", "m_occupancy_mean", "queue_depth_mean",
                "service_s_total"):
        assert merged[key] == pytest.approx(want[key], rel=rel), key
    assert merged["close_reasons"] == want["close_reasons"]
    assert merged["reduction_stalls"] == want["reduction_stalls"]
    assert merged["admission"] == want["admission"]
    for hist in ("latency", "queue_wait"):
        assert merged[hist]["merged_exact"] is True
        for q in ("count", "mean_s", "p50_s", "p95_s", "p99_s", "max_s"):
            assert merged[hist][q] == pytest.approx(want[hist][q], rel=rel)
    imb = merged["load_imbalance"]
    assert imb["per_host_requests"] == [t.snapshot()["requests_served"]
                                        for t in parts]
    assert imb["max_over_mean"] >= 1.0
    j_merged = j_merge_snapshots([t.snapshot(include_samples=True)
                                  for t in j_parts])
    assert json.dumps(merged, sort_keys=True) == \
        json.dumps(j_merged, sort_keys=True)


def test_merge_without_samples_is_flagged_approximate():
    parts = [_random_telemetry(TT, np.random.default_rng(29 + i), 4)
             for i in range(2)]
    j_parts = [_random_telemetry(JT, np.random.default_rng(29 + i), 4)
               for i in range(2)]
    merged = merge_snapshots([t.snapshot() for t in parts])   # no samples
    assert merged["latency"]["merged_exact"] is False
    assert merged["latency"]["max_s"] == pytest.approx(
        max(t.latency.percentile(100) for t in parts))
    assert merged["latency"]["count"] == sum(len(t.latency) for t in parts)
    assert json.dumps(merged, sort_keys=True) == json.dumps(
        j_merge_snapshots([t.snapshot() for t in j_parts]), sort_keys=True)


def test_merge_mixed_cross_host_reduction_modes():
    a, b = Telemetry(), Telemetry()
    rec = dict(workload="dilithium", d_bucket=64, n_c=1, close_reason="full",
               m_occupancy=0.5, k_occupancy=0.5, queue_depth=0,
               service_s=1e-3, age_s=1e-3)
    a.record_batch(BatchRecord(reduction="lazy", n_folds=1, **rec))
    a.record_batch(BatchRecord(reduction="lazy", n_folds=1, **rec))
    b.record_batch(BatchRecord(reduction="eager", n_folds=9, **rec))
    merged = merge_snapshots([a.snapshot(), b.snapshot()])
    w = merged["per_workload"]["dilithium"]
    assert w["reduction_batches"] == {"lazy": 2, "eager": 1}
    assert w["reduction"] == "mixed"
    agree = merge_snapshots([a.snapshot(), a.snapshot()])
    assert agree["per_workload"]["dilithium"]["reduction"] == "lazy"


def test_merge_degenerate_hosts():
    """Hosts that served nothing: zero batches, empty histograms, and
    snapshots missing whole sections."""
    busy, idle = Telemetry(), Telemetry()
    busy.record_batch(BatchRecord(
        workload="dilithium", d_bucket=64, n_c=2, close_reason="full",
        m_occupancy=0.5, k_occupancy=0.75, queue_depth=1,
        service_s=1e-3, age_s=1e-3, reduction="eager", n_folds=9))
    busy.observe_latency(0.01, queue_wait_s=0.002)
    merged = merge_snapshots([busy.snapshot(include_samples=True),
                              idle.snapshot(include_samples=True)])
    assert merged["batches"] == 1 and merged["requests_served"] == 2
    assert merged["latency"]["count"] == 1
    assert merged["latency"]["merged_exact"] is True
    assert merged["k_occupancy_mean"] == pytest.approx(0.75)
    w = merged["per_workload"]["dilithium"]
    assert w["batches"] == 1 and w["reduction"] == "eager"
    empty = merge_snapshots([idle.snapshot(), idle.snapshot()])
    assert empty["batches"] == 0 and empty["per_workload"] == {}
    assert empty["latency"]["count"] == 0
    assert empty["penalty"] == {}


def test_merge_legacy_host_sections():
    """Hosts predating a section (no penalty ledger, a scalar ``reduction``
    label instead of per-mode counts) contribute what they have."""
    busy = Telemetry()
    busy.record_batch(BatchRecord(
        workload="dilithium", d_bucket=64, n_c=1, close_reason="full",
        m_occupancy=0.5, k_occupancy=0.5, queue_depth=0,
        service_s=1e-3, age_s=1e-3, reduction="eager", n_folds=9))
    legacy = busy.snapshot(include_samples=True)
    legacy.pop("penalty", None)
    legacy["per_workload"]["dilithium"].pop("reduction_batches", None)
    merged = merge_snapshots([busy.snapshot(include_samples=True), legacy])
    w = merged["per_workload"]["dilithium"]
    assert w["reduction_batches"] == {"eager": 2}
    assert w["reduction"] == "eager"
    assert merged["batches"] == 2


def test_merge_histograms_sketch_paths():
    xs = [float(x) for x in RNG.lognormal(-4.0, 0.7, 40)]
    exact_a, exact_b = LatencyHistogram(), LatencyHistogram()
    sk = LatencyHistogram(sketch_bound=4)
    for x in xs[:20]:
        exact_a.observe(x)
    for x in xs[20:]:
        exact_b.observe(x)
        sk.observe(x)
    m = _merge_histograms([exact_a.summary(True), exact_b.summary(True)])
    assert m["merged_exact"] is True and m["count"] == 40
    whole = LatencyHistogram()
    for x in xs:
        whole.observe(x)
    assert m["p99_s"] == pytest.approx(whole.percentile(99), rel=1e-9)
    m = _merge_histograms([exact_a.summary(True), sk.summary(True)])
    assert m["merged_exact"] is False and m["count"] == 40
    assert m["mean_s"] == pytest.approx(np.mean(xs))
    assert m["max_s"] == max(xs)
    assert m["p50_s"] == pytest.approx(
        whole.percentile(50), rel=LatencyHistogram.GAMMA - 1.0 + 0.05)
    bad = sk.summary(True)
    bad["sketch"] = dict(bad["sketch"], gamma=2.0)
    with pytest.raises(ValueError, match="gamma mismatch"):
        _merge_histograms([exact_a.summary(True), bad])


def test_load_imbalance_metrics():
    even = load_imbalance([10, 10, 10])
    assert even["max_over_mean"] == pytest.approx(1.0)
    assert even["cv"] == pytest.approx(0.0)
    hot = load_imbalance([30, 0, 0])
    assert hot["max_over_mean"] == pytest.approx(3.0)
    assert load_imbalance([0, 0])["max_over_mean"] == 1.0
