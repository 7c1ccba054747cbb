"""Multi-host sharded serving: the cluster event loop.

``ClusterServer`` shards :class:`repro_torch.serve.CryptoServer` across N
simulated host slices, each owning its own
:class:`~repro_torch.core.scheduler.coscheduler.SliceCoScheduler` (its own
engines, captured-program cache, and device-group assignment):

    submit ──▶ tenant-hash router ──▶ host h: admission ──▶ batcher ──▶
                    │                      ▲       ▲         dispatch
                    │                      │       │ adaptive controller
                    │                      │       │ (close policy setpoint)
                    └── gossip bus ────────┴───────┘ per-host-equivalent
                        cluster depth (bounded staleness)

With ``ServeConfig.controller`` each host runs its own adaptive occupancy
controller, but the gossiped per-host-equivalent cluster depth folds into
every host's setpoint: a host whose local queue looks shallow still raises
its target rung when the fleet is deep, because merge partners routed to it
are already en route.

The cluster exposes the same explicit-clock surface as a single server
(``submit(req, now)`` / ``pump(now)`` / ``next_deadline()`` /
``drain(now)``), so the existing :class:`repro_torch.serve.LoadGenerator` drives
an N-host cluster unchanged, deterministically, under the virtual clock.

**Drain barrier.**  ``drain`` is two-phase: first *every* host is quiesced
(ingress rejected fleet-wide), only then is any host flushed, and finally
the barrier record is collected into telemetry.  Quiescing all before
flushing any means no request can slip onto an already-drained host, so a
cluster drain yields bit-for-bit the same per-tenant results as a
single-host replay of the same trace (row semantics make each tenant's
arithmetic independent of batch composition; the router only changes the
grouping).

This is the JAX package's ``repro.cluster.cluster`` with one change: the
hosts' co-schedulers are built on ``ClusterConfig.device`` (CUDA unless it
says ``"cpu"``; without a GPU the default raises, nothing falls back).  On
CUDA every host dispatches through its own captured programs, and all of
them replay on one stream in dispatch order: the cluster loop is
single-threaded, and the programs of every host on a device share that
device's graph pool (``core/scheduler/program.py``).  Device ids in the
``devices`` section are torch device strings (``"cuda:0"``, ``"cpu"``)
where the JAX package has integer ids.
"""
from __future__ import annotations

import dataclasses
import json
import time

from repro_torch.device import partition_devices
from repro_torch.obs.alerts import AlertEngine, default_cluster_rules
from repro_torch.obs.export import write_chrome_trace, write_text
from repro_torch.obs.metrics import MetricsRegistry, expose_registries
from repro_torch.obs.tracing import Tracer
from repro_torch.serve.server import (CryptoServer, ResponseHandle,
                                      ServeConfig, coscheduler_from_config)
from repro_torch.serve.telemetry import DispatchOverlapAuditor
from repro_torch.cluster.failover import FailoverCoordinator, FaultPlan
from repro_torch.cluster.gossip import GossipBus
from repro_torch.cluster.router import TenantHashRouter
from repro_torch.cluster.telemetry import merge_snapshots


@dataclasses.dataclass
class ClusterConfig:
    n_hosts: int = 2
    gossip_period_s: float = 0.002
    gossip_staleness_factor: float = 2.0   # digest usable for period × factor
    pinned: dict | None = None             # tenant_id -> host overrides
    # Deterministic fault injection: a FaultPlan (or a parseable
    # "kill@T:hN,..." spec with times in absolute virtual-clock seconds —
    # CLI front-ends pre-scale fraction-of-duration specs) applied on the
    # tick edge.  None serves failure-free.
    fault_plan: FaultPlan | str | None = None
    # Watermark-based load shedding during a failover redistribution
    # transient: fraction of serve.max_pending above which a tenant's owner
    # is considered saturated — non-sticky tenants divert power-of-two to
    # their rendezvous alternate, the rest shed with reason "shed".  None
    # (default) never sheds.
    shed_watermark: float | None = None
    shed_transient_s: float | None = None  # None → 2 × staleness bound
    # Device-parallel fleet: partition ``device``'s devices across the host
    # slices (repro_torch.device.partition_devices: None or a bare "cuda"
    # means every CUDA device) and pin each host's programs, operands, and
    # twiddle planes to its own slice, so host i's launches queue behind
    # host i's — not the whole fleet's.  With fewer devices than hosts the
    # slices share devices round-robin.  False
    # (default) keeps the single-queue simulated mode, the deterministic
    # oracle device mode is proven bit-for-bit against.
    device_parallel: bool = False
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    # The hosts' device spec, as every entry point of the port takes it:
    # None means every CUDA device (and raises without one), "cpu" the
    # plain PyTorch versions.
    device: object = None


class ClusterServer:
    """N host slices behind one tenant-hash ingress.

    ``coscheduler_factory(host_id)`` overrides per-host co-scheduler
    construction — tests use it to share one program cache across
    hosts (bit-identical results, no per-host captures); production
    construction gives every host its own.
    """

    def __init__(self, config: ClusterConfig | None = None, *,
                 coscheduler_factory=None):
        self.config = cfg = config or ClusterConfig()
        self.router = TenantHashRouter(cfg.n_hosts, pinned=cfg.pinned)
        self.gossip = GossipBus(cfg.n_hosts, period_s=cfg.gossip_period_s,
                                staleness_factor=cfg.gossip_staleness_factor)
        self.hosts: list[CryptoServer] = []
        # Device partition: host h's slice of the process's devices (None
        # columns in simulated mode).  A coscheduler_factory overrides cos
        # construction entirely — a device-parallel factory is expected to
        # pin its own devices (the tests share one pinned co-scheduler per
        # device to keep capture time linear in devices, not hosts).
        self.device_partition = (partition_devices(cfg.n_hosts,
                                                   devices=cfg.device)
                                 if cfg.device_parallel else None)
        # One fleet-wide launch-overlap auditor across every host: the
        # device-pinning audit trail (per-host device ids, launch
        # concurrency, cross-host queue sharing) in snapshot().
        self.dispatch_audit = DispatchOverlapAuditor()
        for h in range(cfg.n_hosts):
            if coscheduler_factory is not None:
                cos = coscheduler_factory(h)
            else:
                # Each host gets the full dispatch fast path (super-batching,
                # row ladder, donation) from the shared serve config.
                cos = coscheduler_from_config(
                    cfg.serve, host=h,
                    device=(self.device_partition[h]
                            if self.device_partition else cfg.device))
            srv = CryptoServer(cfg.serve, coscheduler=cos)
            srv.host_id = h
            srv.dispatch_auditor = self.dispatch_audit
            srv.cluster_depth_fn = self._make_depth_fn(h)
            if srv.tracer is not None and srv.tracer.host is None:
                # A factory-built co-scheduler may not carry its host id;
                # tag the tracer here so fleet-trace events keep their
                # per-host process track.  (Note: sharing ONE co-scheduler
                # across hosts also shares its tracer hook — last host
                # wins — so traced clusters should use per-host
                # co-schedulers, the default construction.)
                srv.tracer.host = h
            if srv.metrics is not None and srv.metrics.host is None:
                # Same backfill for the metrics registry: the host label is
                # what keeps per-host series distinguishable (and the fleet
                # exposition parseable) after the registries merge.
                srv.metrics.host = h
                srv.alerts.host = h
            self.hosts.append(srv)
        self._submissions = [0] * cfg.n_hosts
        self._barrier: dict | None = None
        # Cluster-control tracer (host=None → its own Perfetto process):
        # carries the drain-barrier span over the fleet timeline.
        self.tracer = Tracer(host=None) if cfg.serve.tracing else None
        # Fleet-level metrics + alerting: per-host registries come with the
        # shared serve config; this registry (host=None, like the control
        # tracer) holds the gossip-side series — publish/view audit, per-host
        # publish silence — and its engine runs the dead-host sensing rules.
        self.metrics = None
        self.alerts = None
        if cfg.serve.metrics:
            self.metrics = MetricsRegistry(
                period_s=cfg.serve.metrics_period_s,
                capacity=cfg.serve.metrics_capacity, host=None)
            self._describe_metrics()
            self.metrics.add_collector(self._metrics_samples)
            self.alerts = AlertEngine(
                self.metrics,
                default_cluster_rules(
                    staleness_bound_s=self.gossip.staleness_bound_s),
                tracer=self.tracer, host=None)
        # Failure handling: fault injection, silence-driven cordon, journal
        # replay, transient shedding (repro_torch.cluster.failover).
        plan = cfg.fault_plan
        if isinstance(plan, str):
            plan = FaultPlan.parse(plan)
        self.failover = FailoverCoordinator(
            self, plan, shed_watermark=cfg.shed_watermark,
            shed_transient_s=cfg.shed_transient_s)

    # --- gossip wiring --------------------------------------------------------

    def _make_depth_fn(self, host_id: int):
        def depth_fn(now: float) -> float:
            # pending_load, not batcher.depth: held and in-flight rows
            # occupy the slice just as queued ones do (holdback-aware
            # admission), locally and in the published digests alike.
            view = self.gossip.cluster_view(
                host_id, self.hosts[host_id].pending_load, now)
            return view.per_host_equiv
        return depth_fn

    def _tick(self, now: float):
        """One fleet control edge: apply due fault-plan events, run every
        due gossip publish (period-gated, *serving* hosts only — a killed
        or paused host is exactly a host that stops publishing), then
        silence-driven cordon sensing and the fleet metrics scrape."""
        self.failover.apply_due(now)
        for h, srv in enumerate(self.hosts):
            if self.failover.publishing(h):
                if self.gossip.maybe_publish(
                        h, srv.pending_load, now,
                        open_batches=srv.batcher.open_batches):
                    self.failover.journals[h].compact()
        self.failover.sense(now)
        if self.metrics is not None and self.metrics.maybe_scrape(now):
            self.alerts.evaluate(now)

    # --- fleet metrics --------------------------------------------------------

    def _describe_metrics(self):
        m = self.metrics
        m.describe("repro_gossip_publishes_total", "counter",
                   "Digest publishes across the fleet.")
        m.describe("repro_gossip_views_total", "counter",
                   "Bounded-staleness view merges.")
        m.describe("repro_gossip_stale_drops_total", "counter",
                   "Digests dropped at read time for exceeding the bound.")
        m.describe("repro_gossip_silence_seconds", "gauge",
                   "Per-host publish silence (dead-host sensing signal).")
        m.describe("repro_gossip_silence_seconds_max", "gauge",
                   "Worst publish silence across the fleet.")
        m.describe("repro_gossip_used_staleness_seconds_max", "gauge",
                   "Oldest digest any decision actually consumed.")
        m.describe("repro_cluster_queue_rows", "gauge",
                   "Fleet pending load (sum of per-host pending_load).")
        m.describe("repro_cluster_ingress_total", "counter",
                   "Requests tagged at cluster ingress (failover rids).")
        m.describe("repro_cluster_sheds_total", "counter",
                   "Requests shed during a failover redistribution "
                   "transient (burn-rate numerator for failover_shed).")
        m.describe("repro_cluster_replayed_total", "counter",
                   "Journal entries replayed onto survivors after a cordon.")
        m.describe("repro_cluster_live_hosts", "gauge",
                   "Hosts currently in the rendezvous live set.")
        m.describe("repro_cluster_limbo_requests", "gauge",
                   "Requests parked for a dead-but-uncordoned owner.")

    def _metrics_samples(self, now: float):
        bus = self.gossip
        out = [
            ("repro_gossip_publishes_total", (), bus.publishes),
            ("repro_gossip_views_total", (), bus.views),
            ("repro_gossip_stale_drops_total", (), bus.stale_drops),
            ("repro_gossip_used_staleness_seconds_max", (),
             bus._used_staleness_max),
            ("repro_cluster_queue_rows", (),
             sum(srv.pending_load for srv in self.hosts)),
            ("repro_cluster_ingress_total", (), self.failover.ingress),
            ("repro_cluster_sheds_total", (), self.failover.sheds),
            ("repro_cluster_replayed_total", (), self.failover.replayed),
            ("repro_cluster_live_hosts", (), len(self.router.live_hosts)),
            ("repro_cluster_limbo_requests", (), len(self.failover.limbo)),
        ]
        silence = bus.silence_s(now)
        if silence:
            for hid, age in silence.items():
                out.append(("repro_gossip_silence_seconds",
                            (("peer", str(hid)),), age))
            out.append(("repro_gossip_silence_seconds_max", (),
                        max(silence.values())))
        return out

    def metrics_text(self) -> str:
        """One OpenMetrics document for the fleet: per-host registries
        (samples host-labelled) merged with the cluster-level registry."""
        if self.metrics is None:
            raise RuntimeError("metrics are off — set ServeConfig(metrics="
                               "True) in the cluster config")
        regs = [srv.metrics for srv in self.hosts if srv.metrics is not None]
        regs.append(self.metrics)
        return expose_registries(regs)

    def write_metrics(self, path: str) -> str:
        """Write the fleet exposition (gzip when path ends in .gz)."""
        text = self.metrics_text()
        write_text(path, text)
        return text

    # --- the CryptoServer-shaped surface --------------------------------------

    def submit(self, req, now: float | None = None):
        now = time.monotonic() if now is None else now
        self._tick(now)
        self.failover.tag(req)
        return self._submit_routed(req, now)

    def _submit_routed(self, req, now: float,
                       handle: ResponseHandle | None = None):
        """Route one tagged request through the failover coordinator and
        land it: on its owner host (journaled when admitted), in the limbo
        retry queue (owner dead, cordon pending), or shed.  ``handle``
        threads an existing caller handle through a limbo re-delivery."""
        kind, host, decision = self.failover.route(req, now)
        if kind == "host":
            self._submissions[host] += 1
            h = self.hosts[host].submit(req, now=now, handle=handle)
            if not h.rejected:
                self.failover.journals[host].record(
                    rid=req.request_id, tenant_id=req.tenant_id,
                    request=req, handle=h, reason="ok", recorded_at=now)
            return h
        if handle is None:
            handle = ResponseHandle(req, submitted_at=now)
        if kind == "limbo":
            self.failover.hold_limbo(host, req, handle)
        else:  # shed
            handle._reject(decision, at=now)
            self.failover.note_shed(host, req, now)
        return handle

    def submit_many(self, reqs, now: float | None = None, nows=None):
        """Batch ingress: shard one arrival batch by the rendezvous router
        and feed each host's share through its vectorised ``submit_many``
        edge (arrival order preserved within a host; handles returned in the
        original batch order).  Requests routed to limbo or shed by the
        failover coordinator are pulled out of the batch individually."""
        now = time.monotonic() if now is None else now
        if nows is None:
            nows = [now] * len(reqs)
        self._tick(float(nows[0]) if len(reqs) else now)
        shard_pos: dict[int, list[int]] = {}
        handles = [None] * len(reqs)
        for p, req in enumerate(reqs):
            self.failover.tag(req)
            kind, host, decision = self.failover.route(req, float(nows[p]))
            if kind == "host":
                shard_pos.setdefault(host, []).append(p)
                continue
            t = float(nows[p])
            handle = ResponseHandle(req, submitted_at=t)
            if kind == "limbo":
                self.failover.hold_limbo(host, req, handle)
            else:
                handle._reject(decision, at=t)
                self.failover.note_shed(host, req, t)
            handles[p] = handle
        for host, positions in shard_pos.items():
            self._submissions[host] += len(positions)
            hs = self.hosts[host].submit_many(
                [reqs[p] for p in positions],
                nows=[nows[p] for p in positions])
            journal = self.failover.journals[host]
            for p, h in zip(positions, hs):
                handles[p] = h
                if not h.rejected:
                    journal.record(
                        rid=reqs[p].request_id, tenant_id=reqs[p].tenant_id,
                        request=reqs[p], handle=h, reason="ok",
                        recorded_at=float(nows[p]))
        return handles

    def pump(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        self._tick(now)
        return sum(srv.pump(now) for h, srv in enumerate(self.hosts)
                   if self.failover.serving(h))

    def next_deadline(self) -> float | None:
        # A dead host's deadlines are unreachable until it recovers — the
        # pump loop must not spin on them (its queued work is replayed or
        # recovered at cordon).
        deadlines = [d for h, srv in enumerate(self.hosts)
                     if self.failover.serving(h)
                     and (d := srv.next_deadline()) is not None]
        return min(deadlines) if deadlines else None

    @property
    def under_backpressure(self) -> bool:
        return any(srv.under_backpressure
                   for h, srv in enumerate(self.hosts)
                   if self.failover.serving(h))

    def drain(self, now: float | None = None) -> int:
        """Distributed two-phase drain barrier (see module docstring).

        Failure-aware: fault-plan events scripted *before* the drain
        instant apply pre-barrier (and any dead host is force-cordoned —
        the barrier's flush RPC fails fast, a stronger signal than gossip
        silence); an event scripted at exactly the drain instant lands
        *mid*-barrier, between quiesce and flush, and its journal is
        replayed onto the (already-draining) survivors so the barrier
        still completes with every admitted request resolved."""
        now = time.monotonic() if now is None else now
        fo = self.failover
        # Pre-barrier tick: strictly-earlier fault events, gossip, sensing.
        fo.apply_due(now, inclusive=False)
        for h, srv in enumerate(self.hosts):
            if fo.publishing(h):
                self.gossip.maybe_publish(
                    h, srv.pending_load, now,
                    open_batches=srv.batcher.open_batches)
        fo.sense(now)
        fo.cordon_dead(now)
        if self.tracer is not None:
            self.tracer.emit("B", "drain_barrier", now, track="cluster",
                             args={"hosts": len(self.hosts)})
        # Phase 1 — quiesce: fleet-wide ingress stop before any flush
        # (paused hosts are reachable on the data plane and quiesce too).
        for h, srv in enumerate(self.hosts):
            if fo.serving(h):
                srv.quiesce(now)
        self._barrier = {"quiesced_at": now,
                         "hosts": len(self.hosts),
                         "complete": False}
        # Mid-barrier seam: a kill scripted at the drain instant fires
        # here, after quiesce — its journal replays onto survivors whose
        # ingress is already stopped (replay_admitted bypasses draining).
        fo.apply_due(now)
        fo.cordon_dead(now, cause="drain_probe")
        # Phase 2 — drain: flush every live host's open batches, holdback
        # pens, and launch rings (depth-k flights retired inside srv.drain).
        flushed = sum(srv.drain(now) for h, srv in enumerate(self.hosts)
                      if fo.serving(h))
        # Phase 3 — collect: the barrier record lands in telemetry.  The
        # in-flight census is the ring-drain audit — a complete barrier must
        # leave zero launch groups outstanding on any host (a reset dead
        # host holds none by construction).
        self._barrier.update(
            drained_at=now, batches_flushed=flushed,
            serving_hosts=sum(1 for h in range(len(self.hosts))
                              if fo.serving(h)),
            inflight_groups=sum(srv.inflight_groups for srv in self.hosts),
            complete=True)
        if self.tracer is not None:
            self.tracer.emit("E", "drain_barrier", now, track="cluster",
                             args={"batches_flushed": flushed})
        # Terminal fleet scrape: the post-drain state (zero in-flight, final
        # silence ages) is always sampled, mirroring each host's own drain
        # scrape (a same-instant repeat is a no-op by ring monotonicity).
        if self.metrics is not None and self.metrics.scrape(now):
            self.alerts.evaluate(now)
        return flushed

    @property
    def drained(self) -> bool:
        return bool(self._barrier and self._barrier["complete"])

    # --- telemetry ------------------------------------------------------------

    def snapshot(self, include_samples: bool = False) -> dict:
        """Cluster snapshot: merged fleet metrics + per-host + gossip audit.

        Per-host snapshots always carry raw samples internally so the merged
        quantiles are exact; ``include_samples`` controls whether they stay
        in the exported per-host sections.
        """
        host_snaps = [srv.telemetry.snapshot(include_samples=True)
                      for srv in self.hosts]
        merged = merge_snapshots(host_snaps)
        if not include_samples:
            for snap in host_snaps:
                snap["latency"].pop("samples", None)
                snap["queue_wait"].pop("samples", None)
        out = {
            "n_hosts": len(self.hosts),
            "merged": merged,
            "per_host": host_snaps,
            "gossip": self.gossip.snapshot(),
            "routing": {
                "per_host_submissions": list(self._submissions),
                "pinned_tenants": len(self.router.pinned),
                "live_hosts": list(self.router.live_hosts),
            },
            "failover": self.failover.snapshot(),
            "drain_barrier": self._barrier,
            "devices": {
                "device_parallel": bool(self.config.device_parallel),
                "per_host": [list(srv.cos.device_ids())
                             for srv in self.hosts],
                "distinct": len({d for srv in self.hosts
                                 for d in srv.cos.device_ids()}),
            },
            "dispatch_overlap": self.dispatch_audit.snapshot(),
        }
        if self.metrics is not None:
            out["cluster_metrics"] = self.metrics.snapshot()
            out["cluster_alerts"] = self.alerts.snapshot()
        return out

    def write_json(self, path: str, include_samples: bool = False) -> dict:
        snap = self.snapshot(include_samples=include_samples)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        return snap

    # --- fleet trace ----------------------------------------------------------

    def trace_events(self) -> list[dict]:
        """One merged fleet trace: every host's buffered events (host-tagged,
        so each host keeps its own Perfetto process track) plus the cluster-
        control events, in timestamp order."""
        events = [] if self.tracer is None else self.tracer.event_dicts()
        for srv in self.hosts:
            events.extend(srv.trace_events())
        # Per-host streams stay in emission order (span begins precede their
        # ends); Perfetto orders by timestamp itself, so no global sort that
        # could interleave a sub-µs-inverted begin/end pair.
        return events

    def write_trace(self, path: str) -> dict:
        """Export the merged fleet trace as Chrome-trace JSON."""
        if self.tracer is None:
            raise RuntimeError("tracing is off — set ServeConfig(tracing="
                               "True) in the cluster config to record")
        return write_chrome_trace(path, self.trace_events(),
                                  label="repro_torch.cluster")
