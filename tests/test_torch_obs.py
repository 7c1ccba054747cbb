"""Observability of the port (``repro_torch.obs``, telemetry histograms and
traced serving) — the unit tests of ``tests/test_obs.py`` against the port's
modules, and, where the JAX package has the same function, the same seeded
inputs through both with equal results.

Left out: the cluster tests (fleet traces, cross-host histogram merges),
which are in ``tests/test_torch_cluster.py``.  Everything runs on the virtual clock on
the CPU; the traced serving runs use the port's server with the plain
PyTorch versions of the kernels.
"""
import json
import time

import numpy as np
import pytest

from repro import obs as JO
from repro.serve import telemetry as JT
from repro_torch import obs as TO
from repro_torch.core import field as F
from repro_torch.core.scheduler import TenantRequest
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
from repro_torch.obs import (PenaltyLedger, Tracer, chrome_trace,
                             host_spans, launch_cycles,
                             merge_penalty_sections, validate_chrome_trace)
from repro_torch.obs.ledger import SHARE_KEYS
from repro_torch.obs.tracing import ID_STRIDE
from repro_torch.serve import CryptoServer, ServeConfig
from repro_torch.serve import telemetry as TT
from repro_torch.serve.telemetry import BatchRecord, LatencyHistogram, Telemetry

RNG = np.random.default_rng(29)

# One co-scheduler per configuration for the module: engines and uploaded
# planes are reused across tests.
COS = SliceCoScheduler(device="cpu")
LAZY_COS = SliceCoScheduler(accum="int32_native", d_tile=171,
                            reduction_by_workload={"dilithium": "lazy"},
                            device="cpu")


def _dil_request(tid, d, t=0.0):
    coeffs = np.asarray(RNG.integers(0, F.DILITHIUM_Q, d, dtype=np.uint64),
                        np.uint32)
    return TenantRequest(tid, "dilithium", d, t, coeffs)


def _cfg(**kw):
    kw.setdefault("validate", False)
    kw.setdefault("n_c", 4)
    kw.setdefault("max_age_s", 0.01)
    kw.setdefault("tracing", True)
    return ServeConfig(**kw)


# --- tracer ring buffer --------------------------------------------------------

def test_tracer_ring_bounds_and_drop_count():
    tr = Tracer(capacity=4)
    for i in range(7):
        tr.instant(f"e{i}", float(i))
    assert len(tr.events) == 4
    assert tr.dropped == 3
    assert [e["name"] for e in tr.event_dicts()] == ["e3", "e4", "e5", "e6"]
    snap = tr.snapshot()
    assert snap == {"events": 4, "dropped": 3, "capacity": 4}
    drained = tr.drain()
    assert len(drained) == 4 and not tr.events
    assert tr.dropped == 3          # the drop audit survives a drain
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_tracer_ids_unique_across_hosts():
    """Causal IDs never collide in a concatenated fleet trace, and follow
    the JAX tracer's sequence."""
    t_none, t0, t1 = Tracer(), Tracer(host=0), Tracer(host=1)
    ids = [t_none.next_id(), t_none.next_id(),
           t0.next_id(), t0.next_id(), t1.next_id()]
    assert ids == [1, 2, ID_STRIDE + 1, ID_STRIDE + 2, 2 * ID_STRIDE + 1]
    j_none, j0, j1 = JO.Tracer(), JO.Tracer(host=0), JO.Tracer(host=1)
    assert ids == [j_none.next_id(), j_none.next_id(),
                   j0.next_id(), j0.next_id(), j1.next_id()]


def test_tracer_host_spans_stamped_on_perf_counter():
    """Host spans are sync B/E pairs on the "host" track, stamped with
    ``time.perf_counter()`` as they happen (nothing re-bases them), with
    the causal id in the id slot and no args."""
    tr = Tracer()
    t0 = time.perf_counter()
    tr.host_begin("sched.launch", 7)
    tr.host_end("sched.launch", 7)
    t1 = time.perf_counter()
    b, e = tr.event_dicts()
    assert (b["ph"], e["ph"]) == ("B", "E")
    assert b["track"] == e["track"] == "host"
    assert b["id"] == e["id"] == 7
    assert "args" not in b and "args" not in e
    assert t0 <= b["ts"] <= e["ts"] <= t1
    assert not hasattr(tr, "anchor") and not hasattr(tr, "wall_now")


# --- Perfetto export -----------------------------------------------------------

def _fleet_events(mod):
    """The same event sequence recorded by ``mod``'s tracers."""
    tr0, tr1 = mod.Tracer(host=0), mod.Tracer(host=1)
    tr0.begin("window", 1, "warmup", 0.001, track="serve")
    tr0.end("window", 1, "warmup", 0.002, track="serve")
    tr0.counter("queue_depth", 0.001, 3.0)
    tr1.instant("coalesce", 0.0015, track="batcher", args={"rows": 4})
    control = mod.Tracer(host=None)
    control.emit("B", "drain_barrier", 0.003, track="cluster")
    control.emit("E", "drain_barrier", 0.004, track="cluster")
    return tr0.event_dicts() + tr1.event_dicts() + control.event_dicts()


def test_chrome_trace_pid_tid_mapping_and_metadata():
    doc = chrome_trace(_fleet_events(TO), label="fleet")
    rows = doc["traceEvents"]
    # host None → pid 1; host h → pid h+2 (host 0 never collides w/ control)
    pids = {r["pid"] for r in rows}
    assert pids == {1, 2, 3}
    names = {(r["pid"], r["args"]["name"]) for r in rows
             if r["ph"] == "M" and r["name"] == "process_name"}
    assert names == {(1, "fleet"), (2, "fleet host 0"), (3, "fleet host 1")}
    # one thread_name metadata row per (pid, track)
    threads = [r for r in rows if r["ph"] == "M"
               and r["name"] == "thread_name"]
    assert len(threads) == len({(r["pid"], r["tid"]) for r in threads})
    span = next(r for r in rows if r["ph"] == "b")
    assert span["ts"] == pytest.approx(1000.0)      # seconds → µs
    assert span["cat"] == "window" and span["id"] == 1
    inst = next(r for r in rows if r["ph"] == "i")
    assert inst["s"] == "t"
    ctr = next(r for r in rows if r["ph"] == "C")
    assert ctr["args"]["value"] == 3.0
    validate_chrome_trace(doc)      # the export itself must be schema-valid


@pytest.mark.parametrize("label", ["fleet", "repro.serve"])
def test_chrome_trace_equals_jax_on_the_same_events(label):
    port = _fleet_events(TO)
    ref = _fleet_events(JO)
    assert port == ref
    assert chrome_trace(port, label=label) == JO.chrome_trace(ref, label=label)


# --- validator negative cases --------------------------------------------------

def _ev(ph, name, pid=1, tid=1, ts=0.0, **kw):
    return {"ph": ph, "name": name, "pid": pid, "tid": tid, "ts": ts, **kw}


def _chain(*, close_request=True, enqueue=True, close_batch=True,
           launch=True, close_launch=True):
    events = [_ev("b", "req", cat="request", id=1),
              _ev("b", "batch", cat="batch", id=2)]
    if close_batch:
        # the close event's roster is the submit → batch causal link
        events.append(_ev("e", "batch", cat="batch", id=2, ts=0.001,
                          args={"rids": [1] if enqueue else []}))
    if launch:
        events.append(_ev("i", "launch_batches",
                          args={"lid": 3, "bids": [2]}))
        events.append(_ev("b", "launch", cat="launch", id=3))
        if close_launch:
            events.append(_ev("e", "launch", cat="launch", id=3, ts=0.002))
    if close_request:
        events.append(_ev("e", "complete", cat="request", id=1, ts=0.003))
    return {"traceEvents": events}


def test_validator_accepts_full_chain():
    stats = validate_chrome_trace(_chain())
    assert stats == {"events": 7, "requests": 1, "rejects": 0,
                     "batches": 1, "launches": 1}
    assert stats == JO.validate_chrome_trace(_chain())


@pytest.mark.parametrize("broken, match", [
    (dict(close_request=False), "unbalanced"),
    (dict(enqueue=False), "no enqueue link"),
    (dict(close_batch=False), "unbalanced"),
    (dict(launch=False), "never reached a launch"),
    (dict(close_launch=False), "unbalanced"),
])
def test_validator_rejects_broken_chains(broken, match):
    with pytest.raises(ValueError, match=match):
        validate_chrome_trace(_chain(**broken))
    with pytest.raises(ValueError, match=match):
        JO.validate_chrome_trace(_chain(**broken))


@pytest.mark.parametrize("doc, match", [
    ({"traceEvents": [{"name": "x"}]}, "missing 'ph'"),
    ({"traceEvents": [_ev("Z", "x")]}, "unknown phase"),
    ({"traceEvents": [_ev("i", "x", ts=-1.0)]}, "bad ts"),
    ({"traceEvents": [_ev("e", "x", cat="launch", id=9)]}, "without open 'b'"),
    ({"traceEvents": [_ev("E", "x")]}, "empty stack"),
    ({"traceEvents": [_ev("B", "x")]}, "unclosed sync"),
    ({"traceEvents": [_ev("B", "x"), _ev("B", "y"), _ev("E", "x"),
                      _ev("E", "y")]}, "must nest LIFO"),
    ({"traceEvents": [_ev("C", "x", args={})]}, "missing args.value"),
    ([], "traceEvents"),
])
def test_validator_structural_errors(doc, match):
    with pytest.raises(ValueError, match=match):
        validate_chrome_trace(doc)


# --- penalty ledger ------------------------------------------------------------

DIL_PROFILE = {"reduction": "eager", "data_limbs": 3, "tw_limbs": 3,
               "n_channels": 1, "n_folds": 9, "n_diag": 1}


def test_ledger_shares_conserve():
    led = PenaltyLedger(m_tile=128)
    led.observe_launch(workload="dilithium", d=128, live_rows=5,
                       launched_rows=8, n_batches=2, service_s=1e-3,
                       profile=DIL_PROFILE, k_occupancy=0.8)
    led.observe_launch(workload="dilithium", d=256, live_rows=8,
                       launched_rows=8, n_batches=1, service_s=0.0,
                       profile=DIL_PROFILE)
    snap = led.snapshot()
    w = snap["dilithium"]
    assert w["launches"] == 2 and w["batches"] == 3
    assert w["live_rows"] == 13 and w["launched_rows"] == 16
    assert w["reduction_modes"] == {"eager": 2}
    assert abs(sum(w["shares"].values()) - 1.0) <= 1e-9
    assert w["cycles"]["total"] == pytest.approx(
        sum(w["cycles"][k] for k in SHARE_KEYS))
    # every bin is non-negative and padding dominates at 5/128 M fill
    assert all(w["cycles"][k] >= 0.0 for k in SHARE_KEYS)
    assert w["cycles"]["spatial_pad"] > w["cycles"]["mxu_productive"]
    assert PenaltyLedger().snapshot() == {}


def test_merge_penalty_sections_exact():
    a, b = PenaltyLedger(), PenaltyLedger()
    a.observe_launch(workload="dilithium", d=128, live_rows=4,
                     launched_rows=8, n_batches=1, service_s=2e-3,
                     profile=DIL_PROFILE)
    b.observe_launch(workload="dilithium", d=128, live_rows=7,
                     launched_rows=8, n_batches=2, service_s=1e-3,
                     profile={**DIL_PROFILE, "reduction": "lazy",
                              "n_folds": 1})
    b.observe_launch(workload="bn254", d=64, live_rows=2, launched_rows=2,
                     n_batches=1, service_s=1e-3,
                     profile={**DIL_PROFILE, "data_limbs": 4, "tw_limbs": 4,
                              "n_channels": 9})
    sa, sb = a.snapshot(), b.snapshot()
    merged = merge_penalty_sections([sa, None, sb, {}])
    assert set(merged) == {"dilithium", "bn254"}
    dil = merged["dilithium"]
    assert dil["launches"] == 2 and dil["batches"] == 3
    assert dil["reduction_modes"] == {"eager": 1, "lazy": 1}
    for k in SHARE_KEYS:        # raw bins add exactly, no float re-derivation
        assert dil["cycles"][k] == (sa["dilithium"]["cycles"][k]
                                    + sb["dilithium"]["cycles"][k])
    for w in merged.values():
        assert abs(sum(w["shares"].values()) - 1.0) <= 1e-9
    assert merged == JO.merge_penalty_sections([sa, None, sb, {}])


def _profile_grid():
    """Profiles of every shape the server prices: both workloads, both
    reductions, a spread of fold counts and diagonals."""
    rng = np.random.default_rng(43)
    grid = []
    for workload, limbs, channels in (("dilithium", 3, 1), ("bn254", 4, 9)):
        for reduction in ("eager", "lazy"):
            for _ in range(6):
                grid.append((workload, {
                    "reduction": reduction, "data_limbs": limbs,
                    "tw_limbs": limbs, "n_channels": channels,
                    "n_folds": int(rng.integers(1, 40)),
                    "n_diag": int(rng.integers(1, 9))}))
    return grid


def test_launch_cycles_and_ledger_equal_jax_over_a_grid_of_profiles():
    """The cycle model (the paper's modelled TPU v4) is kept bit for bit:
    the same launches price to the same cycles, ``device_s`` and ledger
    snapshot in both packages."""
    rng = np.random.default_rng(47)
    port, ref = PenaltyLedger(m_tile=128), JO.PenaltyLedger(m_tile=128)
    for workload, prof in _profile_grid():
        d = int(rng.choice([64, 128, 256, 512, 2048]))
        launched = int(rng.integers(1, 300))
        live = int(rng.integers(0, launched + 1))
        kw = dict(d=d, live_rows=live, launched_rows=launched, profile=prof,
                  m_tile=int(rng.choice([8, 128])))
        got, want = launch_cycles(**kw), JO.launch_cycles(**kw)
        assert got == want and got["device_s"] > 0.0
        obs = dict(workload=workload, d=d, live_rows=live,
                   launched_rows=launched, n_batches=int(rng.integers(1, 4)),
                   service_s=float(rng.uniform(0.0, 2e-3)), profile=prof,
                   k_occupancy=float(rng.uniform(0.1, 1.0)))
        port.observe_launch(**obs)
        ref.observe_launch(**obs)
    port.observe_host_gap("bn254", 3e-4)
    ref.observe_host_gap("bn254", 3e-4)
    assert port.snapshot() == ref.snapshot()


# --- sketch histograms ---------------------------------------------------------

def test_histogram_sketch_collapse_and_bounds():
    h = LatencyHistogram(sketch_bound=8)
    xs = [float(x) for x in RNG.lognormal(-4.0, 1.0, 50)]
    for x in xs:
        h.observe(x)
    assert h.sketching and len(h) == 50
    s = h.summary()
    assert s["count"] == 50
    assert s["mean_s"] == pytest.approx(np.mean(xs))
    assert s["max_s"] == max(xs)
    srt, g = np.sort(xs), LatencyHistogram.GAMMA * (1 + 1e-12)
    for q in (50, 95, 99):
        # bucket midpoint sits within one GAMMA ratio of the order
        # statistics bracketing the exact (interpolated) quantile
        rank = (q / 100.0) * (len(xs) - 1)
        lo, hi = srt[int(np.floor(rank))], srt[int(np.ceil(rank))]
        assert lo / g <= h.percentile(q) <= hi * g
    with pytest.raises(RuntimeError, match="collapsed"):
        h.samples
    state = h.sketch_state()
    assert state["gamma"] == LatencyHistogram.GAMMA
    assert sum(state["buckets"].values()) + state["zero"] == 50
    assert all(isinstance(k, str) for k in state["buckets"])
    with pytest.raises(ValueError):
        LatencyHistogram(sketch_bound=0)


@pytest.mark.parametrize("bound", [None, 8, 64])
def test_histogram_summary_equals_jax(bound):
    xs = [float(x) for x in np.random.default_rng(53).lognormal(-4.0, 1.0, 80)]
    xs += [0.0, -1e-9]
    port, ref = LatencyHistogram(sketch_bound=bound), \
        JT.LatencyHistogram(sketch_bound=bound)
    for x in xs:
        port.observe(x)
        ref.observe(x)
    assert port.summary(True) == ref.summary(True)
    for q in (0, 50, 95, 99, 100):
        assert port.percentile(q) == ref.percentile(q)


def test_histogram_zero_and_exact_mode_unchanged():
    h = LatencyHistogram(sketch_bound=2)
    for x in (0.0, -1e-9, 0.01, 0.02):
        h.observe(x)
    assert h.sketching
    assert h.percentile(0) == 0.0           # virtual-clock zeros stay zeros
    exact = LatencyHistogram()              # no bound → reservoir forever
    for x in range(1000):
        exact.observe(x / 1000.0)
    assert not exact.sketching and len(exact.samples) == 1000


def test_telemetry_sketch_bound_plumbed():
    t = Telemetry(sketch_bound=2)
    for x in (0.01, 0.02, 0.03):
        t.observe_latency(x, queue_wait_s=x / 2)
    snap = t.snapshot(include_samples=True)
    assert "sketch" in snap["latency"] and "samples" not in snap["latency"]
    server = CryptoServer(_cfg(tracing=False, latency_sketch_bound=7),
                          coscheduler=COS)
    assert server.telemetry.latency.sketch_bound == 7


def test_per_workload_reduction_counts_not_first_batch_wins():
    """The per-workload ``reduction`` counts per mode, as the JAX
    telemetry's does."""
    rec = dict(workload="dilithium", d_bucket=64, n_c=1, close_reason="full",
               m_occupancy=0.5, k_occupancy=0.5, queue_depth=0,
               service_s=1e-3, age_s=1e-3)
    snaps = []
    for mod in (TT,
                JT):
        t = mod.Telemetry()
        t.record_batch(mod.BatchRecord(reduction="eager", n_folds=9, **rec))
        t.record_batch(mod.BatchRecord(reduction="lazy", n_folds=1, **rec))
        t.record_batch(mod.BatchRecord(reduction="lazy", n_folds=1, **rec))
        snaps.append(t.snapshot())
    w = snaps[0]["per_workload"]["dilithium"]
    assert w["reduction_batches"] == {"eager": 1, "lazy": 2}
    assert w["reduction"] == "mixed"
    assert snaps[0] == snaps[1]
    u = Telemetry()
    u.record_batch(BatchRecord(reduction="lazy", n_folds=1, **rec))
    assert u.snapshot()["per_workload"]["dilithium"]["reduction"] == "lazy"


# --- end-to-end traced serving -------------------------------------------------

def _run_traced(server, n_requests=10, dt=0.0015, end=0.1):
    handles = []
    for i in range(n_requests):
        t = i * dt
        handles.append(server.submit(
            _dil_request(i, 64 if i % 2 else 100, t), now=t))
        server.pump(t)
    server.drain(end)
    return handles


def test_traced_serve_sync_full_causal_chain(tmp_path):
    server = CryptoServer(_cfg(), coscheduler=COS)
    handles = _run_traced(server)
    assert all(h.done() and not h.rejected for h in handles)
    path = tmp_path / "trace.json"
    server.write_trace(str(path))
    stats = validate_chrome_trace(json.load(open(path)))
    assert stats["requests"] == len(handles)
    assert stats["rejects"] == 0
    assert stats["batches"] > 0 and stats["launches"] > 0
    snap = server.telemetry.snapshot()
    assert snap["trace"]["events"] == stats["events"] - sum(
        1 for e in json.load(open(path))["traceEvents"] if e["ph"] == "M")
    assert snap["trace"]["dropped"] == 0
    json.dumps(snap)                # the whole snapshot stays JSON-safe


def test_traced_serve_async_rings_holdback():
    """The hardest dispatch shape — zero-sync pipeline, depth-2 launch
    rings, adaptive controller, λ-holdback — still yields complete causal
    chains once drained."""
    # the modelled service time: the CPU's wall time of the plain versions
    # moves with the machine's load, and the SLO gate prices waits from it
    server = CryptoServer(
        _cfg(async_pipeline=True, inflight_depth=2, controller=True,
             holdback_lambda=0.5, slo_deadline_s=1.0, max_age_s=0.004,
             deterministic_timing=True),
        coscheduler=COS)
    handles = _run_traced(server, n_requests=20, dt=0.001)
    assert all(h.done() and not h.rejected for h in handles)
    stats = validate_chrome_trace(chrome_trace(server.trace_events()))
    assert stats["requests"] == 20
    assert stats["launches"] > 0
    names = {e["name"] for e in server.trace_events()}
    assert "queue_depth" in names           # counter track present


def test_traced_reject_needs_no_chain():
    server = CryptoServer(_cfg(), coscheduler=COS)
    server.drain(0.0)
    h = server.submit(_dil_request(0, 64), now=0.001)
    assert h.rejected
    stats = validate_chrome_trace(chrome_trace(server.trace_events()))
    assert stats["rejects"] == 1 and stats["requests"] == 0


def test_trace_capacity_plumbed_and_write_requires_tracing(tmp_path):
    server = CryptoServer(_cfg(trace_capacity=8), coscheduler=COS)
    assert server.tracer.capacity == 8
    off = CryptoServer(_cfg(tracing=False), coscheduler=COS)
    assert off.trace_events() == []
    with pytest.raises(RuntimeError, match="tracing is off"):
        off.write_trace(str(tmp_path / "never.json"))


def test_penalty_ledger_e2e_conserves_including_lazy():
    server = CryptoServer(
        _cfg(accum="int32_native", d_tile=171,
             reduction_by_workload={"dilithium": "lazy"}),
        coscheduler=LAZY_COS)
    handles = _run_traced(server, n_requests=8)
    assert all(h.done() and not h.rejected for h in handles)
    pen = server.telemetry.snapshot()["penalty"]
    assert set(pen) == {"dilithium"}
    w = pen["dilithium"]
    assert w["reduction_modes"] == {"lazy": w["launches"]}
    assert w["live_rows"] == 8
    assert abs(sum(w["shares"].values()) - 1.0) <= 1e-9
    assert w["cycles"]["total"] > 0.0


# --- host spans on the wall clock ----------------------------------------------

def _run_wall(server, n_requests=20):
    """Requests submitted on the wall clock (``now`` is perf_counter, as a
    live caller's), each followed by a pump, then a drain."""
    handles = []
    for i in range(n_requests):
        handles.append(server.submit(
            _dil_request(i, 64 if i % 3 else 100), now=time.perf_counter()))
        server.pump(time.perf_counter())
    server.drain(time.perf_counter())
    return handles


def _spans_by(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("kw", [{}, {"async_pipeline": True,
                                     "inflight_depth": 2}],
                         ids=["sync", "async_depth2"])
def test_wall_clock_host_spans_nest_and_cover_every_launch(kw):
    """A traced wall-clock run exports a valid trace whose host spans nest
    LIFO; every launch has exactly one sched.launch, sched.stage,
    sched.replay, sched.gather, sched.wait and sched.unpack carrying its
    id; each launch span starts inside its sched.launch and ends inside
    its sched.gather, all on one clock."""
    server = CryptoServer(_cfg(**kw), coscheduler=COS)
    handles = _run_wall(server)
    assert all(h.done() and not h.rejected for h in handles)
    events = server.trace_events()
    doc = chrome_trace(events)
    stats = validate_chrome_trace(doc)      # B/E nest LIFO, names matched
    assert stats["requests"] == len(handles)
    host = [e for e in events if e["track"] == "host"]
    assert {e["ph"] for e in host} == {"B", "E"}
    spans = host_spans(events)
    assert len(spans) * 2 == len(host)      # every span closed
    lids = [e["id"] for e in events if e["ph"] == "b" and e["cat"] == "launch"]
    assert lids and len(set(lids)) == len(lids)
    for name in ("sched.launch", "sched.stage", "sched.replay",
                 "sched.gather", "sched.wait", "sched.unpack"):
        assert sorted(s[1] for s in _spans_by(spans, name)) == sorted(lids)
    assert not _spans_by(spans, "sched.capture")    # every program cached
    launch = {s[1]: s for s in _spans_by(spans, "sched.launch")}
    gather = {s[1]: s for s in _spans_by(spans, "sched.gather")}
    for e in events:
        if e.get("cat") != "launch":
            continue
        outer = launch[e["id"]] if e["ph"] == "b" else gather[e["id"]]
        assert outer[2] <= e["ts"] <= outer[3]
    submits = _spans_by(spans, "serve.submit")
    assert len(submits) == len(handles)
    assert all(s[4] == 0 for s in submits)          # top level
    names = {s[0] for s in spans}
    assert {"serve.admit", "serve.batch", "serve.dispatch", "serve.pump",
            "serve.poll", "serve.drain", "serve.finish",
            "obs.ledger"} <= names
    # one sched.launch per DispatchRecord, each under a serve.dispatch
    assert len(launch) == len(server.telemetry.dispatches)
    assert all(s[4] >= 1 for s in launch.values())
    # the request ids in serve.submit's slot are the request spans' ids
    reqs = {e["id"] for e in events if e["ph"] == "b" and e["cat"] == "request"}
    assert {s[1] for s in submits} == reqs


def test_host_spans_self_time():
    """Self time is a span less its children; a span cut by attach or
    detach (an E with no B, a B with no E) is left out."""
    ev = [("E", "cut", 0.5), ("B", "a", 1.0), ("B", "b", 1.5),
          ("E", "b", 2.0), ("B", "c", 2.0), ("E", "c", 2.25),
          ("E", "a", 3.0), ("B", "open", 4.0)]
    events = [{"ph": ph, "name": n, "ts": ts, "track": "host", "host": None}
              for ph, n, ts in ev]
    events.append({"ph": "i", "name": "x", "ts": 1.2, "track": "serve",
                   "host": None})
    spans = host_spans(events)
    assert [(s[0], s[2], s[3], s[4], s[5]) for s in spans] == [
        ("b", 1.5, 2.0, 1, 0.5), ("c", 2.0, 2.25, 1, 0.25),
        ("a", 1.0, 3.0, 0, 1.25)]


def test_attach_tracer_at_runtime_and_detach():
    """A tracer attached between events records a window whose host spans
    are whole; ``attach_tracer(None)`` between events records nothing
    more, in the server, the batcher or the co-scheduler."""
    server = CryptoServer(_cfg(tracing=False), coscheduler=COS)
    _run_wall(server, n_requests=5)
    server.submit(_dil_request(99, 64), now=time.perf_counter())  # open batch
    tr = Tracer()
    server.attach_tracer(tr)
    assert server.batcher.tracer is tr and COS.tracer is tr
    assert server.telemetry.snapshot()["trace"]["capacity"] == tr.capacity
    _run_wall(server, n_requests=9)
    spans = host_spans(tr.event_dicts())
    assert 2 * len(spans) == sum(1 for e in tr.events if e[3] == "host")
    assert len(_spans_by(spans, "serve.submit")) == 9
    # the batch that opened before the attach closes without a dangling end
    assert all(e[5] for e in tr.events if e[0] == "e" and e[4] == "batch")
    server.attach_tracer(None)
    n = len(tr.events)
    _run_wall(server, n_requests=6)
    assert len(tr.events) == n
    assert server.tracer is None and server.batcher.tracer is None
    assert COS.tracer is None
    assert "trace" not in server.telemetry.snapshot()


def test_server_without_tracer_emits_no_span():
    """A server built untraced on a co-scheduler a traced server used takes
    the stale tracer off it: nothing more reaches the first tracer."""
    traced = CryptoServer(_cfg(), coscheduler=COS)
    _run_wall(traced, n_requests=4)
    n = len(traced.tracer.events)
    assert n > 0
    off = CryptoServer(_cfg(tracing=False), coscheduler=COS)
    handles = _run_wall(off, n_requests=12)
    assert all(h.done() for h in handles)
    assert len(traced.tracer.events) == n
    assert off.trace_events() == []
    assert COS.tracer is None and off.batcher.tracer is None
    assert all(getattr(h.request, "trace_id", None) is None for h in handles)
