"""Host-failure recovery and the device-parallel fleet of the port
(``repro_torch.cluster.failover``, ``ClusterConfig.device_parallel``) on the
CPU, against the JAX package's.

The chaos contract of ``tests/test_failover.py``, held against the port:
kill one of N hosts mid-run and the fleet (a) loses no admitted request and
double-serves none (journal replay + request-id dedup), (b) remaps only the
dead host's tenants (rendezvous hashing), and (c) produces per-tenant rows
bit for bit equal to the no-failure replay of the same trace, and to the JAX
package's single-host replay.  Under ``deterministic_timing`` the port's
failover snapshot and fleet OpenMetrics text equal the JAX cluster's (device
ids compared by count: torch device strings in the port, integer ids in
JAX).  The gather-ring rescue of a killed host reads every flight's host
buffer only after its event.

Then the CPU-runnable cases of ``tests/test_device_parallel.py``: the device
partition, the dispatch-overlap audit, and device mode (every host pinned to
``"cpu"``) equal to simulated mode bit for bit, with and without a kill.
Everything runs on the deterministic virtual clock.
"""
import json

import numpy as np
import pytest
import torch

from repro.cluster import FaultPlan as JFaultPlan
from repro.core.scheduler.coscheduler import SliceCoScheduler as JSlice
from repro.launch.serve import serve_crypto as j_serve_crypto
from repro.launch.serve import serve_crypto_cluster as j_serve_crypto_cluster
from repro_torch import device as D
from repro_torch.cluster import (ClusterConfig, ClusterServer, FaultEvent,
                                 FaultPlan, IntakeJournal, TenantHashRouter,
                                 rendezvous_score, stable_tenant_hash,
                                 summarize_failover)
from repro_torch.core import field as F
from repro_torch.core import workloads as WK
from repro_torch.core.scheduler import TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.device import partition_devices
from repro_torch.launch.serve import serve_crypto, serve_crypto_cluster
from repro_torch.obs.validate import validate_chrome_trace
from repro_torch.serve import CryptoServer, ServeConfig
from repro_torch.serve.telemetry import DispatchOverlapAuditor

RNG = np.random.default_rng(41)

MIXED = dict(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"})
# One co-scheduler per package for the module (both sides of each
# chaos-parity pair, every host).  The JAX one is pinned to its first
# device so that its device sections count one device, as the port's "cpu".
CLUSTER_COS = SliceCoScheduler(device="cpu", **MIXED)
J_COS = JSlice(devices=[0], **MIXED)

CHAOS_KW = dict(duration_s=0.02, rate_hz=4096, seed=7, d_uniform=256,
                validate=False, n_c=8, max_age_s=0.002, **MIXED)
# Fractions of the run: kill h1 at 0.35 (7 ms), recover at 0.85 (17 ms).
# Silence crosses the 4 ms staleness bound ~11 ms in, so the fleet cordons
# via gossip_silence well before the recover.
CHAOS_PLAN = "kill@0.35:h1,recover@0.85:h1"


def _dil_request(tid, d, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


def _tenant_on_host(router, host, start=0, skip=()):
    for tid in range(start, start + 100_000):
        if router.host_for(tid) == host and tid not in skip:
            return tid
    raise AssertionError(f"no tenant routes to host {host} "
                         f"(cordoned? live={router.live_hosts})")


def _cluster(n_hosts, fault_plan=None, **serve_kw) -> ClusterServer:
    serve_kw.setdefault("validate", False)
    serve_kw.setdefault("n_c", 8)
    serve_kw.setdefault("max_age_s", 10.0)
    return ClusterServer(ClusterConfig(n_hosts=n_hosts, fault_plan=fault_plan,
                                       device="cpu",
                                       serve=ServeConfig(**serve_kw)),
                         coscheduler_factory=lambda h: CLUSTER_COS)


def _rows(results) -> dict:
    out = {}
    for r in results:
        out.update(r.outputs)
    return out


def _assert_same_rows(port: dict, ref: dict):
    assert set(port) == set(ref) and ref
    for tid, row in ref.items():
        np.testing.assert_array_equal(port[tid], row)


@pytest.fixture(scope="module")
def jax_chaos_replay() -> dict:
    """The JAX single-host offline replay of the chaos trace."""
    kw = {k: v for k, v in CHAOS_KW.items()
          if k in ("duration_s", "rate_hz", "seed", "d_uniform", "n_c")}
    results, _, _ = j_serve_crypto(coscheduler=J_COS, validate=False, **kw)
    return _rows(results)


# --- fault plans ---------------------------------------------------------------

def test_fault_plan_parse_scale_describe_roundtrip():
    spec = "kill@0.5:h1, recover@0.9:h1,pause@0.25:h0"
    plan = FaultPlan.parse(spec)
    assert plan.describe() == "pause@0.25:h0,kill@0.5:h1,recover@0.9:h1"
    assert plan.describe() == JFaultPlan.parse(spec).describe()
    assert len(plan) == 3 and plan.remaining == 3
    abs_plan = plan.scaled(0.02)
    assert [e.t for e in abs_plan.events] == pytest.approx(
        [0.005, 0.01, 0.018])
    assert abs_plan.describe() == JFaultPlan.parse(spec).scaled(0.02).describe()
    assert [e.kind for e in abs_plan.events] == ["pause", "kill", "recover"]
    with pytest.raises(ValueError):
        plan.scaled(0.0)
    for bad in ("kill@0.5", "reboot@0.5:h1", "kill@0.5:1", "kill@-1:h0"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        FaultEvent(t=0.1, kind="explode", host=0)
    with pytest.raises(ValueError):
        FaultEvent(t=-0.1, kind="kill", host=0)
    with pytest.raises(ValueError):
        FaultEvent(t=0.1, kind="kill", host=-1)
    with pytest.raises(TypeError):
        FaultPlan(["kill@0.5:h1"])


def test_fault_plan_due_is_consumed_once_and_ordered():
    plan = FaultPlan([FaultEvent(0.01, "kill", 1),
                      FaultEvent(0.018, "recover", 1)])
    assert plan.due(0.005) == []
    ev = plan.due(0.01)
    assert [e.kind for e in ev] == ["kill"] and plan.remaining == 1
    assert plan.due(0.01) == []
    assert plan.due(0.018, inclusive=False) == []
    assert [e.kind for e in plan.due(0.018)] == ["recover"]
    assert plan.remaining == 0
    same = FaultPlan([FaultEvent(0.01, "kill", 0),
                      FaultEvent(0.01, "recover", 0)])
    assert [e.kind for e in same.due(0.01)] == ["kill", "recover"]


# --- rendezvous router ---------------------------------------------------------

def test_rendezvous_minimal_migration_and_restore():
    """Cordoning one host remaps only its tenants; restore is the exact
    inverse."""
    tenants = list(range(300)) + [f"tenant-{i}" for i in range(50)]
    for n in (2, 3, 4, 6):
        r = TenantHashRouter(n)
        before = {t: r.host_for(t) for t in tenants}
        for dead in (0, n - 1):
            second = {t: r.choices(t, 2)[1] for t in tenants
                      if before[t] == dead}
            assert r.cordon(dead)
            assert not r.cordon(dead)
            after = {t: r.host_for(t) for t in tenants}
            for t in tenants:
                if before[t] != dead:
                    assert after[t] == before[t], (n, dead, t)
                else:
                    assert after[t] == second[t] != dead
            assert r.restore(dead)
            assert not r.restore(dead)
            assert {t: r.host_for(t) for t in tenants} == before


def test_rendezvous_scores_pins_and_successor():
    r = TenantHashRouter(4, pinned={7: 2})
    th = stable_tenant_hash(7)
    assert r.host_for(7) == 2
    r.cordon(2)
    fallback = max({0, 1, 3}, key=lambda h: (rendezvous_score(th, h), h))
    assert r.host_for(7) == fallback != 2
    assert 2 not in r.live_hosts and not r.is_live(2)
    r.restore(2)
    assert r.host_for(7) == 2
    for t in range(50):
        top = r.choices(t, 2)
        if t != 7:
            assert top[0] == r.host_for(t)
        assert len(set(top)) == 2
    for dead in range(4):
        s = r.successor(dead)
        assert s != dead and s in r.live_hosts
        assert r.successor(dead) == s
    with pytest.raises(ValueError):
        r.restore(9)
    one = TenantHashRouter(2)
    one.cordon(0)
    with pytest.raises(RuntimeError):
        one.cordon(1)
    with pytest.raises(RuntimeError):
        one.successor(1)


# --- intake journal & rid dedup ------------------------------------------------

class _Handle:
    def __init__(self, done=False):
        self._done = done

    def done(self):
        return self._done


def test_intake_journal_pending_and_compaction():
    j = IntakeJournal(0)
    live = [j.record(i, f"t{i}", object(), _Handle(), "ok", 0.0)
            for i in range(3)]
    for i in range(70):
        j.record(100 + i, "settled", object(), _Handle(done=True), "ok", 0.0)
    assert j.recorded == 73
    assert [e.rid for e in j.pending()] == [0, 1, 2]
    assert j.pending_tenants() == {"t0", "t1", "t2"}
    j.compact()
    assert j.compacted == 70 and len(j.entries) == 3
    live[0].replayed = True
    assert [e.rid for e in j.pending()] == [1, 2]
    snap = j.snapshot()
    assert snap["pending"] == 2 and snap["compacted"] == 70


def test_replay_admitted_is_idempotent_and_skips_settled():
    def server():
        return CryptoServer(ServeConfig(n_c=8, max_age_s=10.0,
                                        validate=False),
                            coscheduler=CLUSTER_COS)

    dead, survivor = server(), server()
    reqs = [_dil_request(t, 256) for t in (1, 2, 3)]
    for i, r in enumerate(reqs):
        r.request_id = 100 + i
    handles = [dead.submit(r, now=0.0) for r in reqs]
    entries = list(zip(reqs, handles))
    assert survivor.replay_admitted(entries, 0.01) == (3, 0)
    assert survivor.replay_admitted(entries, 0.02) == (0, 3)
    survivor.drain(0.03)
    assert all(h.done() and not h.rejected for h in handles)
    assert server().replay_admitted(entries, 0.04) == (0, 3)


# --- gather-ring rescue --------------------------------------------------------

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


def test_cordon_rescues_the_dead_hosts_ring_after_each_event(monkeypatch):
    """Host 1 of 2 holds a depth-2 async ring of launched groups when it is
    killed; the silence-driven cordon gathers both flights (each host
    buffer read after its event), resolves their handles with the oracle's
    rows, and replays nothing."""
    cos = SliceCoScheduler(device="cpu")
    events = _watched(cos, monkeypatch)
    cluster = ClusterServer(
        ClusterConfig(n_hosts=2, fault_plan="kill@0.0005:h1", device="cpu",
                      serve=ServeConfig(n_c=1, max_age_s=10.0,
                                        validate=False, async_pipeline=True,
                                        inflight_depth=2)),
        coscheduler_factory=lambda h: cos)
    fo = cluster.failover
    tid, reqs, handles = 0, [], []
    for i in range(4):
        tid = _tenant_on_host(cluster.router, 1, start=tid + 1)
        reqs.append(_dil_request(tid, 64))
        handles.append(cluster.submit(reqs[-1], now=0.0001 * i))
    srv = cluster.hosts[1]
    assert srv.inflight_groups == 2
    assert sum(not h.done() for h in handles) == 2
    cluster.pump(0.006)                 # kill applied, silence → cordon
    assert fo.state[1] == "dead" and 1 in fo.cordoned
    assert fo.recovered == 2 and fo.replayed == 0 and fo.lost() == 0
    assert srv.inflight_groups == 0
    assert len(events) == 4 and all(e.synced for e in events)
    eng = WK.DilithiumEngine(64, device="cpu")
    for r, h in zip(reqs, handles):
        assert h.done() and not h.rejected
        np.testing.assert_array_equal(
            h.result(), eng.oracle_np(r.coeffs[None, :])[0])
    cluster.drain(0.01)
    ev = [e for e in fo.events if e["kind"] == "cordon"]
    assert ev[0]["recovered"] == 2 and ev[0]["device_ids"] == ["cpu"]


def test_recover_inflight_rescues_launched_groups():
    """Async-pipeline launches the dead host never gathered are
    materialised, not recomputed."""
    server = CryptoServer(ServeConfig(n_c=1, max_age_s=10.0, validate=False,
                                      async_pipeline=True),
                          coscheduler=SliceCoScheduler(device="cpu"))
    reqs = [_dil_request(t, 64) for t in (1, 2)]
    handles = [server.submit(r, now=0.0) for r in reqs]
    assert server.inflight_groups > 0
    unresolved = [h for h in handles if not h.done()]
    assert unresolved
    assert server.recover_inflight(0.001) == len(unresolved)
    assert server.inflight_groups == 0
    eng = WK.DilithiumEngine(64, device="cpu")
    for r, h in zip(reqs, handles):
        assert h.done() and not h.rejected
        np.testing.assert_array_equal(
            h.result(), eng.oracle_np(r.coeffs[None, :])[0])


# --- limbo & pause semantics ---------------------------------------------------

def test_dead_host_limbo_delivers_at_cordon():
    cluster = _cluster(2, fault_plan="kill@0.0005:h1")
    fo = cluster.failover
    t0 = _tenant_on_host(cluster.router, 0)
    t1 = _tenant_on_host(cluster.router, 1)
    assert not cluster.submit(_dil_request(t0, 256), now=0.0).rejected
    # t=0.001: the owner is dead but uncordoned → the LB's limbo queue
    h_limbo = cluster.submit(_dil_request(t1, 256), now=0.001)
    assert fo.state[1] == "dead"
    assert not h_limbo.done() and not h_limbo.rejected
    assert len(fo.limbo) == 1 and fo.lost() == 1
    # t=0.006: silence crosses the bound → cordon delivers the limbo queue
    cluster.pump(0.006)
    assert 1 in fo.cordoned
    assert fo.limbo_delivered == 1 and not fo.limbo and fo.lost() == 0
    assert cluster.hosts[0].batcher.depth == 2
    cluster.drain(0.01)
    assert h_limbo.done() and not h_limbo.rejected
    ev = [e for e in fo.events if e["kind"] == "cordon"]
    assert len(ev) == 1 and ev[0]["cause"] == "gossip_silence"
    assert ev[0]["limbo_delivered"] == 1


def test_pause_cordons_reroute_only_and_keeps_serving():
    cluster = _cluster(2, fault_plan="pause@0.0005:h1,recover@0.008:h1")
    fo = cluster.failover
    t1 = _tenant_on_host(cluster.router, 1)
    t1b = _tenant_on_host(cluster.router, 1, skip={t1})
    held = cluster.submit(_dil_request(t1, 256), now=0.0)
    cluster.pump(0.001)
    assert fo.state[1] == "paused"
    cluster.pump(0.006)
    ev = [e for e in fo.events if e["kind"] == "cordon"]
    assert len(ev) == 1 and ev[0]["mode"] == "reroute_only"
    assert ev[0]["replayed"] == 0 and fo.replayed == 0
    assert cluster.hosts[1].batcher.depth == 1
    rerouted = cluster.submit(_dil_request(t1b, 256), now=0.0065)
    assert not rerouted.rejected
    assert cluster.hosts[0].batcher.depth == 1
    cluster.pump(0.009)
    assert fo.state[1] == "serving" and not fo.cordoned
    assert cluster.router.live_hosts == (0, 1)
    cluster.drain(0.01)
    assert held.done() and rerouted.done() and fo.lost() == 0


# --- transient load shedding ---------------------------------------------------

def test_shed_watermark_sticky_sheds_and_p2c_diverts():
    owner = TenantHashRouter(3).host_for(0)
    cluster = ClusterServer(
        ClusterConfig(n_hosts=3, pinned={999: owner}, shed_watermark=0.5,
                      device="cpu",
                      serve=ServeConfig(n_c=16, max_age_s=10.0,
                                        validate=False, max_pending=20)),
        coscheduler_factory=lambda h: CLUSTER_COS)
    fo = cluster.failover
    for _ in range(12):
        assert not cluster.submit(_dil_request(0, 256), now=0.0).rejected
    fo._transient_until = 1.0                 # as _cordon would have set it
    shed = cluster.submit(_dil_request(0, 256), now=0.01)
    assert shed.rejected and shed.decision.reason == "shed"
    assert shed.decision.retry_after_s == pytest.approx(1.0 - 0.01)
    pinned = cluster.submit(_dil_request(999, 256), now=0.0101)
    assert pinned.rejected and pinned.decision.reason == "shed"
    t_b = _tenant_on_host(cluster.router, owner, skip={0, 999})
    second = [h for h in cluster.router.choices(t_b, 2) if h != owner][0]
    diverted = cluster.submit(_dil_request(t_b, 256), now=0.0102)
    assert not diverted.rejected
    assert cluster.hosts[second].batcher.depth == 1
    assert fo.sheds == 2 and fo.diverted == 1
    by = cluster.hosts[owner].telemetry.snapshot()["admission"]["by_reason"]
    assert by["shed"] == 2
    snap = cluster.snapshot()["failover"]
    assert snap["sheds"] == 2 and snap["diverted"] == 1
    assert snap["transient_until"] == 1.0
    late = cluster.submit(_dil_request(0, 256), now=2.0)
    assert not late.rejected


# --- chaos parity ---------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [2, 4])
def test_kill_recover_chaos_matches_no_failure_replay(jax_chaos_replay,
                                                      n_hosts):
    """Kill 1 of N hosts mid-trace (recover later): per-tenant rows are bit
    for bit those of the no-failure run and of the JAX single-host replay,
    nothing is lost or double-served, and the cordon was silence-driven."""
    base, _, _ = serve_crypto_cluster(
        hosts=n_hosts, coscheduler_factory=lambda h: CLUSTER_COS,
        device="cpu", **CHAOS_KW)
    chaos, snap, _ = serve_crypto_cluster(
        hosts=n_hosts, coscheduler_factory=lambda h: CLUSTER_COS,
        fault_plan=CHAOS_PLAN, device="cpu", **CHAOS_KW)
    _assert_same_rows(chaos.outputs, base.outputs)
    _assert_same_rows(chaos.outputs, jax_chaos_replay)
    fo = snap["failover"]
    s = fo["summary"]
    assert s["kills"] == 1 and s["recovers"] == 1
    assert s["cordons_by_cause"].get("gossip_silence", 0) >= 1
    assert s["replayed"] > 0 and s["deduped"] == 0
    assert fo["lost"] == 0 and fo["limbo_pending"] == 0
    assert fo["host_states"] == {h: "serving" for h in range(n_hosts)}
    assert snap["routing"]["live_hosts"] == list(range(n_hosts))
    assert snap["drain_barrier"]["complete"]
    assert snap["drain_barrier"]["serving_hosts"] == n_hosts
    assert summarize_failover(fo["events"]) == s


def test_chaos_trace_validates_and_silence_alert_fires_and_resolves(tmp_path):
    """The traced chaos run exports a causally valid trace in which
    gossip_silence fires during the outage and resolves after rejoin, and
    the fleet metrics carry the failover series."""
    trace_path = tmp_path / "chaos_trace.json"
    metrics_path = tmp_path / "chaos_metrics.prom"
    _, snap, _ = serve_crypto_cluster(
        hosts=2, coscheduler_factory=lambda h: CLUSTER_COS,
        fault_plan=CHAOS_PLAN, trace_out=str(trace_path),
        metrics_out=str(metrics_path), device="cpu",
        telemetry_out=str(tmp_path / "chaos_telemetry.json"), **CHAOS_KW)
    assert snap["failover"]["lost"] == 0
    assert validate_chrome_trace(str(trace_path))["requests"] > 0
    with open(trace_path) as f:
        names = [ev["name"] for ev in json.load(f)["traceEvents"]]
    for name in ("fault:kill", "fault:recover", "failover:h1",
                 "alert_firing:gossip_silence",
                 "alert_resolved:gossip_silence"):
        assert name in names, name
    text = metrics_path.read_text()
    assert "repro_cluster_replayed_total" in text
    assert "repro_cluster_sheds_total" in text


def _comparable_failover(snap: dict) -> dict:
    """The failover section with each cordon's device ids replaced by their
    count (torch device strings in the port, integer ids in JAX)."""
    fo = json.loads(json.dumps(snap["failover"]))
    for ev in fo["events"]:
        if "device_ids" in ev:
            ev["device_ids"] = len(ev["device_ids"])
    return fo


def test_failover_snapshot_equals_jax_under_deterministic_timing(tmp_path):
    """The chaos run with modelled service time and metrics on: the port's
    failover section (events, summary, journals, counters), drain barrier,
    routing and gossip audit, and the fleet OpenMetrics text, equal the
    JAX cluster's."""
    kw = dict(CHAOS_KW, hosts=2, fault_plan=CHAOS_PLAN,
              deterministic_timing=True, metrics_period_s=0.001)
    J_COS.drain_dispatch_log()
    CLUSTER_COS.drain_dispatch_log()
    _, j_snap, _ = j_serve_crypto_cluster(
        coscheduler_factory=lambda h: J_COS,
        metrics_out=str(tmp_path / "j.om"), **kw)
    _, t_snap, _ = serve_crypto_cluster(
        coscheduler_factory=lambda h: CLUSTER_COS, device="cpu",
        metrics_out=str(tmp_path / "t.om"), **kw)
    assert t_snap["failover"]["replayed"] > 0
    assert t_snap["failover"]["lost"] == 0
    assert [e["device_ids"] for e in t_snap["failover"]["events"]
            if e["kind"] == "cordon"] == [["cpu"]]
    assert json.dumps(_comparable_failover(t_snap), sort_keys=True) == \
        json.dumps(_comparable_failover(j_snap), sort_keys=True)
    for key in ("drain_barrier", "routing", "gossip"):
        assert t_snap[key] == j_snap[key], key
    assert (tmp_path / "t.om").read_text() == (tmp_path / "j.om").read_text()


# --- mid-drain failure ----------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [2, 4])
def test_drain_barrier_completes_with_mid_barrier_kill(n_hosts):
    """A kill scripted at exactly the drain instant lands between quiesce
    and flush; the dead host's journal replays onto the already-draining
    survivors and the barrier still resolves every admitted request."""
    cluster = _cluster(n_hosts,
                       fault_plan=FaultPlan([FaultEvent(0.001, "kill", 1)]))
    handles, victims, seen = [], 0, set()
    for host in range(n_hosts):
        for _ in range(2):
            tid = _tenant_on_host(cluster.router, host, skip=seen)
            seen.add(tid)
            handles.append(cluster.submit(_dil_request(tid, 256), now=0.0))
            victims += host == 1
    assert all(not h.rejected for h in handles)
    flushed = cluster.drain(0.001)
    assert flushed > 0 and cluster.drained
    assert all(h.done() and not h.rejected for h in handles)
    fo = cluster.failover
    ev = [e for e in fo.events if e["kind"] == "cordon"]
    assert len(ev) == 1 and ev[0]["cause"] == "drain_probe"
    assert fo.replayed == victims and fo.lost() == 0
    bar = cluster.snapshot()["drain_barrier"]
    assert bar["complete"] and bar["hosts"] == n_hosts
    assert bar["serving_hosts"] == n_hosts - 1
    assert bar["inflight_groups"] == 0


# --- device-parallel fleet -------------------------------------------------------

def test_partition_devices_shapes(monkeypatch):
    """Near-even contiguous chunks with at least as many devices as parts,
    round-robin singletons with fewer, and the CPU as one device.  (Four
    CUDA devices are stood in for by the device count alone: partitioning
    names devices, it touches none.)"""
    with pytest.raises(ValueError):
        partition_devices(0, devices="cpu")
    assert partition_devices(3, devices="cpu") == [[torch.device("cpu")]] * 3
    monkeypatch.setattr(D, "_cuda_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert partition_devices(1) == [cuda]
    assert partition_devices(2) == [cuda[:2], cuda[2:]]
    assert partition_devices(3) == [cuda[:2], [cuda[2]], [cuda[3]]]
    assert partition_devices(4) == [[d] for d in cuda]
    assert partition_devices(9) == [[cuda[i % 4]] for i in range(9)]
    assert partition_devices(2, devices=["cuda:3", "cuda:1"]) == \
        [[cuda[3]], [cuda[1]]]


def test_cluster_partitions_devices_and_reports_them():
    """``device_parallel`` with ``device="cpu"``: each host's own
    co-scheduler is pinned to the CPU, and the snapshot says so."""
    cluster = ClusterServer(ClusterConfig(n_hosts=4, device_parallel=True,
                                          device="cpu"))
    assert cluster.device_partition == [[torch.device("cpu")]] * 4
    assert len({id(srv.cos) for srv in cluster.hosts}) == 4
    snap = cluster.snapshot()
    dv = snap["devices"]
    assert dv["device_parallel"]
    assert dv["per_host"] == [["cpu"]] * 4 and dv["distinct"] == 1
    assert "dispatch_overlap" in snap
    plain = ClusterServer(ClusterConfig(n_hosts=2, device="cpu"))
    assert plain.device_partition is None
    pd = plain.snapshot()["devices"]
    assert not pd["device_parallel"] and pd["distinct"] == 1


def test_overlap_auditor_event_order():
    aud = DispatchOverlapAuditor()
    f0, f1, f2 = object(), object(), object()
    aud.on_launch(0, f0, [{"devices": ("cuda:0",)}])
    aud.on_launch(1, f1, [{"devices": ("cuda:1",)}])    # disjoint: clean
    snap = aud.snapshot()
    assert snap["cross_host_shared_launches"] == 0
    assert snap["launch_concurrency_max"] == 2
    aud.on_launch(2, f2, [{"devices": ("cuda:0",)}])    # host 0 in flight
    assert aud.snapshot()["cross_host_shared_launches"] == 1
    for f in (f0, f1, f2):
        aud.on_gather(f)
    snap = aud.snapshot()
    assert snap["inflight_launches"] == 0
    assert snap["launches"] == 3 and snap["flights"] == 3
    assert snap["cross_host_queue_share"] == pytest.approx(1 / 3)
    assert snap["per_host_devices"] == {"0": ["cuda:0"], "1": ["cuda:1"],
                                        "2": ["cuda:0"]}


def test_overlap_auditor_reset_drops_dead_host():
    aud = DispatchOverlapAuditor()
    aud.on_launch(0, object(), [{"devices": ("cuda:0",)}])
    aud.on_launch(1, object(), [{"devices": ("cuda:1",)}])
    aud.on_reset(0)
    assert aud.snapshot()["inflight_launches"] == 1
    aud.on_launch(2, object(), [{"devices": ("cuda:0",)}])
    assert aud.snapshot()["cross_host_shared_launches"] == 0


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_device_mode_matches_simulated_oracle(n_hosts):
    """Pinning each host slice to its own device (here every host's is the
    CPU) changes where programs run, never what they compute: the rows are
    bit for bit the single-host replay's and the simulated cluster's."""
    kw = dict(duration_s=0.01, rate_hz=1024, seed=5, d_uniform=256,
              validate=False)
    offline, n_ops, _ = serve_crypto(coscheduler=CLUSTER_COS, **kw)
    pinned = SliceCoScheduler(device=["cpu"], **MIXED)
    load, snap, _ = serve_crypto_cluster(
        hosts=n_hosts, n_c=8, max_age_s=0.002, device_parallel=True,
        device="cpu", coscheduler_factory=lambda h: pinned, **MIXED, **kw)
    sim, _, _ = serve_crypto_cluster(
        hosts=n_hosts, n_c=8, max_age_s=0.002, device="cpu",
        coscheduler_factory=lambda h: CLUSTER_COS, **MIXED, **kw)
    assert n_ops == len(load.handles)
    _assert_same_rows(load.outputs, _rows(offline))
    _assert_same_rows(load.outputs, sim.outputs)
    assert snap["drain_barrier"]["complete"]
    assert snap["devices"]["per_host"] == [["cpu"]] * n_hosts
    ov = snap["dispatch_overlap"]
    assert ov["launches"] > 0 and ov["inflight_launches"] == 0
    assert ov["launch_concurrency_max"] == 1
    if n_hosts == 1:
        assert ov["cross_host_queue_share"] == 0.0


def test_device_mode_parity_under_kill_recover():
    """The chaos plan composed with device pinning (each host its own
    co-scheduler on the CPU): lossless, and the simulated fleet's rows."""
    kw = dict(duration_s=0.01, rate_hz=4096, seed=0, d_uniform=64,
              validate=False)
    shared = SliceCoScheduler(device="cpu")
    load_sim, _, _ = serve_crypto_cluster(
        hosts=4, n_c=8, max_age_s=0.002, device="cpu",
        coscheduler_factory=lambda h: shared, **kw)
    load_f, snap_f, _ = serve_crypto_cluster(
        hosts=4, n_c=8, max_age_s=0.002, device_parallel=True, device="cpu",
        fault_plan="kill@0.5:h1,recover@0.9:h1", **kw)
    fo = snap_f["failover"]
    assert fo["lost"] == 0 and fo["limbo_pending"] == 0, fo
    assert fo["summary"]["cordons"] >= 1
    assert all(h.done() for h in load_f.handles)
    _assert_same_rows(load_f.outputs, load_sim.outputs)
