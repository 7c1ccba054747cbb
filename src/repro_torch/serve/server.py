"""The online serving event loop.

``CryptoServer`` turns the offline measurement pipeline into a server:

    submit(request) ──▶ admission ──▶ continuous batcher ──▶ co-scheduled
                                                             dispatch
         ▲                                                       │
         └──────────────── ResponseHandle.result() ◀─────────────┘

Time is explicit: every entry point takes ``now`` (seconds).  Tests and the
load generator drive a virtual clock from trace timestamps (deterministic,
faster than real time); live callers pass ``time.monotonic()``.  Dispatch
itself is measured in wall time regardless, so service-time telemetry is
real even under a virtual clock: on CUDA a dispatch's service time runs from
the launch (host staging, then one replay of the class's captured program:
the K1/K2 kernels and BN254's ``rns_to_field``) to the event that marks its
result on the host.

Per-tenant results are bit-for-bit identical to the offline
``serve_crypto`` replay on the same trace: row semantics make each tenant's
output independent of batch composition, and the batcher reuses the Tier-1
bucketing, so only the grouping differs.

This is the JAX package's ``repro.serve.server`` with three changes: the
co-scheduler takes a ``device`` (``coscheduler_from_config``), the
structural validator in ``_validate_once`` reads the class's captured CUDA
graph node by node in place of the HLO (:mod:`repro_torch.core.validator`),
and
``compilation_cache_dir`` is recorded only: the CUDA kernels are cached on
disk by source hash, and the co-scheduler's programs are CUDA graphs, which
do not persist across processes, so every process captures its own (warm
start captures them at boot).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import validator as V
from repro_torch.core.scheduler.coscheduler import (SliceCoScheduler,
                                                    check_launch_census,
                                                    default_row_ladder)
from repro_torch.core.scheduler.rectangular import packing_metrics
from repro_torch.obs.alerts import AlertEngine, default_serve_rules
from repro_torch.obs.ledger import PenaltyLedger, launch_cycles
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionDecision)
from repro_torch.serve.batcher import (CLOSE_DRAIN, ClosedBatch,
                                       ContinuousBatcher)
from repro_torch.serve.controller import AdaptiveController
from repro_torch.serve.telemetry import (BatchRecord, DispatchRecord,
                                         Telemetry)

PENDING, DONE, REJECTED = "pending", "done", "rejected"


class RejectedError(RuntimeError):
    def __init__(self, decision: AdmissionDecision):
        super().__init__(f"request rejected: {decision.reason} "
                         f"(retry after {decision.retry_after_s:.4f}s)")
        self.decision = decision


class ResponseHandle:
    """Future-style handle returned by ``CryptoServer.submit``."""

    def __init__(self, request, submitted_at: float):
        self.request = request
        self.submitted_at = submitted_at
        self.completed_at: float | None = None
        self.state = PENDING
        self._value = None
        self._decision: AdmissionDecision | None = None

    def done(self) -> bool:
        return self.state != PENDING

    @property
    def rejected(self) -> bool:
        return self.state == REJECTED

    @property
    def decision(self) -> AdmissionDecision | None:
        return self._decision

    def result(self):
        if self.state == REJECTED:
            raise RejectedError(self._decision)
        if self.state == PENDING:
            raise RuntimeError("result() before dispatch — call "
                               "server.pump(now)/drain() first")
        return self._value

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def _resolve(self, value, completed_at: float):
        self._value = value
        self.completed_at = completed_at
        self.state = DONE

    def _reject(self, decision: AdmissionDecision, at: float):
        self._decision = decision
        self.completed_at = at
        self.state = REJECTED


@dataclasses.dataclass
class ServeConfig:
    # batching
    n_c: int = 8
    bucket_granularity: int | None = None   # None → power-of-two buckets
    max_age_s: float = 0.01
    occupancy_close: float | None = None
    pad_rows: bool = True
    # admission
    max_pending: int = 1024
    tenant_rate_hz: float | None = None
    tenant_burst: float = 8.0
    slo_deadline_s: float | None = None
    # columnar_admission — tenant bucket state as one numpy structured array
    # behind a dense-index interner, enabling the vectorised submit_many
    # batch edge.  Decisions are bit-identical to the scalar per-tenant
    # TokenBucket dict (False), which stays as the property-tested oracle.
    columnar_admission: bool = True
    # dispatch
    accum: str = "fp32_mantissa"
    validate: bool = True
    n_c_max: int = 128          # M-dimension occupancy denominator (paper)
    # reduction discipline (paper §7.2.1): default mode plus per-workload-
    # class overrides, e.g. {"dilithium": "lazy"} co-schedules κ-amortised
    # Dilithium batches next to strictly-eager BN254 batches.  ``kappa``
    # bounds the deferral window (None → whole transform, checked against
    # κ_max at trace time); ``d_tile`` overrides the staging-pass width so
    # the paper's pass structure survives the roomier int32 accumulator.
    reduction: str = "eager"
    reduction_by_workload: dict | None = None
    kappa: int | None = None
    d_tile: int | None = None
    # warm start: (workload, d_bucket) pairs whose programs are captured at
    # boot (engines built, planes uploaded) so the first dispatch of each
    # listed class captures nothing (shapes are N_c-row operands; requires
    # pad_rows — or a row ladder, whose rungs are all captured instead).
    # None skips warm start.
    warm_start: list | None = None
    # dispatch fast path (all bit-for-bit neutral):
    #   merge_dispatch — super-batch same-(workload, bucket) closed batches
    #     along M into one tall launch;
    #   row_ladder_max — pad launch heights up a geometric rung ladder
    #     (8→16→…→row_ladder_max) so trace counts are bounded by the ladder
    #     size; the batcher then emits live-row (mergeable) operands and the
    #     co-scheduler pads once, on the merged operand.  None disables;
    #   donate — recorded only: each program's static input is the
    #     donated buffer, written by every launch;
    #   async_pipeline — zero-sync two-phase dispatch: launch now, gather at
    #     the *next* serving event (pump/submit/drain), so the pump loop
    #     never blocks on a device→host copy between launches.  Queued
    #     batches that close while a launch is in flight merge into the next
    #     one.  Latency telemetry then dates completions at the gathering
    #     event's clock.
    merge_dispatch: bool = True
    row_ladder_max: int | None = None
    donate: bool = False
    async_pipeline: bool = False
    # closed-loop control plane (all bit-for-bit neutral — only grouping and
    # timing change, never row arithmetic):
    #   controller — adapt the per-class close policy (target ladder rung,
    #     max_age, occupancy threshold) from the dispatch telemetry EWMA
    #     instead of the static values above, which become the loop's
    #     initial values and floor/ceiling bounds;
    #   holdback_lambda — cross-event merge holdback: a short closed batch
    #     may wait up to λ × (predicted merge-partner ETA) for a same-class
    #     partner, capped by the SLO budget so the admission-visible p99 is
    #     never breached (0 disables; requires the controller's queue model
    #     and merge_dispatch);
    #   inflight_depth — depth-k multi-flight launch ring: up to k launch
    #     groups per workload class stay in flight before a gather blocks,
    #     so disjoint program classes keep the device saturated under
    #     bursty closes (1 reproduces the PR-4 single-flight pipeline
    #     exactly; >1 requires async_pipeline).
    controller: bool = False
    controller_alpha: float = 0.3
    controller_gain: float = 0.25
    m_fill_target: float = 0.5
    max_age_floor_s: float | None = None   # None → max_age_s / 4
    max_age_ceil_s: float | None = None    # None → max_age_s × 8 (SLO-capped)
    occupancy_floor: float | None = None   # None → occupancy_close / 2
    occupancy_ceil: float = 0.95
    holdback_lambda: float = 0.0
    holdback_slo_fraction: float = 0.5
    inflight_depth: int = 1
    # observability (repro_torch.obs): request-lifecycle tracing into a bounded
    # ring buffer (submit/enqueue/launch/complete spans with causal IDs,
    # exportable as Chrome-trace JSON via server.trace_events()).  Off by
    # default — the per-event cost is one dict append, but the buffer is
    # only useful to callers that export it.  The penalty ledger is always
    # on: it prices launches from telemetry the server already computes.
    tracing: bool = False
    trace_capacity: int = 1 << 16
    # Continuous metrics + alerting (repro_torch.obs.metrics / repro_torch.obs.alerts):
    # a collector-driven registry scraped on a fixed serving-clock cadence
    # from telemetry / controller / penalty ledger, with an AlertEngine
    # evaluating multi-window burn-rate and threshold rules after every
    # scrape.  ``alert_rules`` overrides the stock rule set (None → the
    # default_serve_rules scaled off max_age_s / slo_deadline_s).
    metrics: bool = False
    metrics_period_s: float = 0.005
    metrics_capacity: int = 4096
    alert_rules: tuple | None = None
    # Replace the wall-clock service-time measurement with the penalty
    # ledger's modeled device time ((mxu+vpu)/DEVICE_HZ per launch).  Every
    # downstream wall-derived quantity — admission service-rate EWMA,
    # request latencies, penalty host_gap, scraped series, alert logs —
    # then depends only on the virtual clock and the trace, so two
    # identical runs are bit-identical end to end.  Off by default: real
    # deployments want measured time.
    deterministic_timing: bool = False
    # bound the latency/queue-wait reservoirs: past this many samples each
    # histogram collapses to a log-bucket sketch (bounded memory, ≤ ~4.5%
    # relative quantile error; count/mean/max stay exact).  None = exact
    # reservoir forever (the default — serving runs here are bounded).
    latency_sketch_bound: int | None = None
    # The JAX package's persistent compile cache directory.  Recorded only:
    # the CUDA kernels are already cached on disk by source hash, and the
    # programs are CUDA graphs, which do not persist across processes.  The
    # directory is not created.
    compilation_cache_dir: str | None = None


def coscheduler_from_config(cfg: ServeConfig, host: int | None = None,
                            device=None) -> SliceCoScheduler:
    """The default Tier-2 co-scheduler for a serving config.  ``device`` is
    the co-scheduler's device spec: None means every CUDA device (and raises
    without one), ``"cpu"`` the plain PyTorch versions."""
    ladder = (default_row_ladder(cfg.row_ladder_max)
              if cfg.row_ladder_max else None)
    return SliceCoScheduler(
        accum=cfg.accum, reduction=cfg.reduction,
        reduction_by_workload=cfg.reduction_by_workload,
        kappa=cfg.kappa, d_tile=cfg.d_tile, merge=cfg.merge_dispatch,
        row_ladder=ladder, donate=cfg.donate, host=host, device=device)


class CryptoServer:
    def __init__(self, config: ServeConfig | None = None, *,
                 coscheduler: SliceCoScheduler | None = None,
                 telemetry: Telemetry | None = None):
        self.config = cfg = config or ServeConfig()
        if cfg.inflight_depth < 1:
            raise ValueError(f"inflight_depth must be ≥ 1, got "
                             f"{cfg.inflight_depth}")
        if cfg.inflight_depth > 1 and not cfg.async_pipeline:
            raise ValueError(
                "inflight_depth > 1 needs async_pipeline: the launch ring "
                "only exists between serving events — a synchronous "
                "dispatch gathers every launch before returning")
        if cfg.holdback_lambda < 0:
            raise ValueError(f"holdback_lambda must be ≥ 0, got "
                             f"{cfg.holdback_lambda}")
        if cfg.holdback_lambda > 0 and not cfg.controller:
            raise ValueError(
                "holdback_lambda > 0 needs controller=True: the holdback "
                "window is priced from the controller's per-class queue "
                "model (arrival-rate EWMA + target rung)")
        if cfg.holdback_lambda > 0 and not cfg.merge_dispatch:
            raise ValueError(
                "holdback_lambda > 0 needs merge_dispatch: holding a batch "
                "for a merge partner is pointless if same-class batches "
                "never coalesce along M")
        self.cos = coscheduler or coscheduler_from_config(cfg)
        self.controller = None
        if cfg.controller:
            self.controller = AdaptiveController(
                ladder=self.cos.row_ladder or (cfg.n_c,),
                n_c=cfg.n_c, max_age_s=cfg.max_age_s,
                occupancy_close=cfg.occupancy_close, n_c_max=cfg.n_c_max,
                alpha=cfg.controller_alpha, gain=cfg.controller_gain,
                m_fill_target=cfg.m_fill_target,
                max_age_floor_s=cfg.max_age_floor_s,
                max_age_ceil_s=cfg.max_age_ceil_s,
                occupancy_floor=cfg.occupancy_floor,
                occupancy_ceil=cfg.occupancy_ceil,
                holdback_lambda=cfg.holdback_lambda,
                holdback_slo_fraction=cfg.holdback_slo_fraction,
                slo_deadline_s=cfg.slo_deadline_s)
        # Observability: one host-tagged tracer shared by the server, the
        # batcher, and the co-scheduler (so launch spans and lifecycle spans
        # land on one timeline with one causal-ID sequence).
        self.tracer = None
        if cfg.tracing:
            self.tracer = Tracer(capacity=cfg.trace_capacity,
                                 host=self.cos.host)
        # Always (re)assign, so a shared co-scheduler handed from a traced
        # run to an untraced one doesn't keep feeding the stale tracer.
        self.cos.tracer = self.tracer
        # With a row ladder the batcher emits mergeable (live-row) operands
        # and the co-scheduler pads once, on the merged operand — padding to
        # N_c here as well would interleave dead rows into super-batches.
        self.batcher = self._make_batcher()
        self.admission = AdmissionController(
            max_pending=cfg.max_pending, tenant_rate_hz=cfg.tenant_rate_hz,
            tenant_burst=cfg.tenant_burst, slo_deadline_s=cfg.slo_deadline_s,
            columnar=cfg.columnar_admission)
        self.telemetry = telemetry or Telemetry(
            sketch_bound=cfg.latency_sketch_bound)
        if self.controller is not None:
            self.telemetry.attach_section("controller",
                                          self.controller.snapshot)
        # The live penalty ledger (paper §7 decomposition as a snapshot
        # section): every launch's modeled cycles split into MXU-productive /
        # arithmetic-stall / spatial-pad / host-gap bins.
        self.ledger = PenaltyLedger(m_tile=cfg.n_c_max)
        self.telemetry.attach_section("penalty", self.ledger.snapshot)
        if self.tracer is not None:
            self.telemetry.attach_section("trace", self.tracer.snapshot)
        # Continuous metrics + alerting: collector-driven scrape at the
        # serving-clock cadence; the alert engine evaluates right after
        # every scrape so alert timestamps are scrape timestamps.
        self.metrics = None
        self.alerts = None
        if cfg.metrics:
            self.metrics = MetricsRegistry(period_s=cfg.metrics_period_s,
                                           capacity=cfg.metrics_capacity,
                                           host=self.cos.host)
            self._describe_metrics()
            self.metrics.add_collector(self._metrics_samples)
            rules = (cfg.alert_rules if cfg.alert_rules is not None
                     else default_serve_rules(
                         max_age_s=cfg.max_age_s,
                         slo_deadline_s=cfg.slo_deadline_s))
            self.alerts = AlertEngine(self.metrics, rules,
                                      tracer=self.tracer, host=self.cos.host)
            self.telemetry.attach_section("metrics", self.metrics.snapshot)
            self.telemetry.attach_section("alerts", self.alerts.snapshot)
        # Zero-sync pipeline state: batches validated + staged but not yet
        # launched, per-class launch rings of in-flight groups awaiting
        # gather (inflight_depth == 1 keeps the whole event's staged set in
        # one flight under the single ``None`` key — the PR-4 single-flight
        # pipeline exactly), and the merge-holdback pen of closed batches
        # priced to wait for a partner.
        self._staged: list[ClosedBatch] = []
        # ring key -> deque of (launch seq, closed, InflightDispatch,
        # launch log, launch_s)
        self._rings: dict = collections.OrderedDict()
        self._launch_seq = 0
        # class key -> (ClosedBatch, release_at, held_at, hid)
        self._held: dict[tuple, tuple] = {}
        # Pending handles keyed by request identity: O(1) resolve, pruned on
        # completion (a long-lived server must not accumulate history), and
        # correct when one tenant has several rows in flight.
        self._handles: dict[int, ResponseHandle] = {}
        # Fleet-assigned request ids ever admitted here — the exactly-once
        # dedup filter for failover replay: a journal entry delivered twice
        # (or re-delivered to a rebooted host) is rejected as a duplicate.
        # Deliberately durable across reset_after_failure, like the journal.
        self._seen_rids: set = set()
        self._ledger_profiles: dict[tuple, dict] = {}
        self._req_span_names: dict[str, str] = {}
        self._validated: set[tuple] = set()
        self._draining = False
        # Cluster hook: when set (by repro_torch.cluster), called as
        # fn(now) and must return the per-host-equivalent cluster queue
        # depth (or None when no sufficiently fresh gossip digest exists).
        # The SLO gate then operates on bounded-staleness *cluster* state.
        self.cluster_depth_fn = None
        # Cluster hooks: the owning host slice's id and the fleet-shared
        # DispatchOverlapAuditor (both set by repro_torch.cluster; None when
        # this server runs standalone — the hot path then pays one
        # ``is None``).
        self.host_id = self.cos.host
        self.dispatch_auditor = None
        self.warm_traces = 0
        if cfg.warm_start:
            if not cfg.pad_rows and self.cos.row_ladder is None:
                raise ValueError(
                    "warm_start requires pad_rows (or a row ladder): "
                    "unpadded batches stack row-count-dependent operand "
                    "shapes, so warmed N_c-row launch shapes would never "
                    "be reused")
            self.warm_traces = self.cos.precompile(cfg.warm_start, cfg.n_c)

    def _make_batcher(self) -> ContinuousBatcher:
        """Construct the continuous batcher from the config — used at boot
        and by ``reset_after_failure`` (a rebooted host gets a fresh one)."""
        cfg = self.config
        return ContinuousBatcher(
            n_c=cfg.n_c, bucket_granularity=cfg.bucket_granularity,
            max_age_s=cfg.max_age_s, occupancy_close=cfg.occupancy_close,
            pad_rows=cfg.pad_rows and self.cos.row_ladder is None,
            controller=self.controller, tracer=self.tracer)

    # --- ingress --------------------------------------------------------------

    def submit(self, req, now: float | None = None, *,
               handle: ResponseHandle | None = None) -> ResponseHandle:
        now = time.monotonic() if now is None else now
        # ``handle`` lets the cluster's failover path re-deliver a request
        # that already has a caller-held handle (limbo retry) — the decision
        # resolves/rejects that handle instead of allocating a second one.
        if handle is None:
            handle = ResponseHandle(req, submitted_at=now)
        rid = getattr(req, "request_id", None)
        if self._draining:
            decision = AdmissionDecision(False, "draining")
        elif id(req) in self._handles or (rid is not None
                                          and rid in self._seen_rids):
            decision = AdmissionDecision(False, "duplicate")
        else:
            # Only consult gossip when the SLO gate can act on it — the view
            # merge is O(n_hosts) per submission, and reading digests no
            # decision consumes would pollute the gossip staleness audit.
            cluster_pending = (
                self.cluster_depth_fn(now)
                if (self.cluster_depth_fn is not None
                    and self.admission.slo_deadline_s is not None) else None)
            decision = self.admission.admit(req, now,
                                            pending=self.pending_load,
                                            cluster_pending=cluster_pending)
        self.telemetry.record_admission(decision.reason)
        tr = self.tracer
        if not decision.admitted:
            if tr is not None:
                tr.instant("reject", now,
                           args={"workload": req.workload,
                                 "reason": decision.reason})
            handle._reject(decision, at=now)
            return handle
        if tr is not None:
            # The request span opens at submit and closes at completion; the
            # causal ID rides on the request object so the batcher can link
            # it to the batch it lands in.
            tid = tr.next_id()
            req.trace_id = tid
            # Name carries the workload, the batch span carries the d
            # bucket, the span length is the latency — no per-request args
            # dict or f-string (this is the hottest emitter in the stack).
            name = self._req_span_names.get(req.workload)
            if name is None:
                name = self._req_span_names.setdefault(
                    req.workload, "req:" + req.workload)
            tr.begin("request", tid, name, now)
        if rid is not None:
            self._seen_rids.add(rid)
        self._handles[id(req)] = handle
        self._dispatch(self.batcher.add(req, now), now)
        return handle

    def submit_many(self, reqs, now: float | None = None,
                    nows=None) -> list[ResponseHandle]:
        """Batch ingress: admit one arrival batch through the vectorised
        admission path, then stack every admitted row and advance the
        dispatch pipeline once for the whole batch.

        ``nows`` gives per-request clocks (arrival order, e.g. trace
        timestamps); ``now`` (or the wall clock) stamps the whole batch when
        absent.  Decisions equal the scalar per-request ``submit`` loop at
        the same batch edge bit for bit, with two deliberate batch-edge
        semantics: the gossiped cluster depth is sampled once per batch, and
        a request object repeated *within* one batch is rejected as a
        duplicate regardless of the first occurrence's decision (across
        batches, resubmitting a rejected request stays allowed, as with
        ``submit``).  Closed batches dispatch together at the batch's last
        clock — age/occupancy grouping may differ from per-request
        submission, but row semantics keep per-tenant results bit-identical
        regardless of grouping."""
        if nows is None:
            t = time.monotonic() if now is None else now
            nows_arr = np.full(len(reqs), float(t))
        else:
            nows_arr = np.asarray(nows, np.float64)
            if len(nows_arr) != len(reqs):
                raise ValueError(f"nows has {len(nows_arr)} entries for "
                                 f"{len(reqs)} requests")
        handles = [ResponseHandle(r, submitted_at=float(t))
                   for r, t in zip(reqs, nows_arr)]
        if not handles:
            return handles
        tr = self.tracer
        if self._draining:
            d = AdmissionDecision(False, "draining")
            for h, t in zip(handles, nows_arr):
                h._reject(d, at=float(t))
            self.telemetry.record_admissions({"draining": len(reqs)})
            return handles
        live_pos, dup_pos, seen, seen_rids = [], [], set(), set()
        for p, r in enumerate(reqs):
            oid = id(r)
            rid = getattr(r, "request_id", None)
            if (oid in self._handles or oid in seen
                    or (rid is not None and (rid in self._seen_rids
                                             or rid in seen_rids))):
                dup_pos.append(p)
            else:
                seen.add(oid)
                if rid is not None:
                    seen_rids.add(rid)
                live_pos.append(p)
        if dup_pos:
            d = AdmissionDecision(False, "duplicate")
            for p in dup_pos:
                handles[p]._reject(d, at=float(nows_arr[p]))
                if tr is not None:
                    tr.instant("reject", float(nows_arr[p]),
                               args={"workload": reqs[p].workload,
                                     "reason": "duplicate"})
        if not live_pos:
            self.telemetry.record_admissions({"duplicate": len(dup_pos)})
            return handles
        cluster_pending = (
            self.cluster_depth_fn(float(nows_arr[live_pos[0]]))
            if (self.cluster_depth_fn is not None
                and self.admission.slo_deadline_s is not None) else None)
        dec = self.admission.admit_batch(
            np.asarray([reqs[p].tenant_id for p in live_pos]),
            nows_arr[live_pos], pending=self.pending_load,
            cluster_pending=cluster_pending)
        counts = dec.counts()
        if dup_pos:
            counts["duplicate"] = len(dup_pos)
        self.telemetry.record_admissions(counts)
        closed: list[ClosedBatch] = []
        admitted = dec.admitted
        for j, p in enumerate(live_pos):
            req, t = reqs[p], float(nows_arr[p])
            if not admitted[j]:
                d = dec.decision(j)
                if tr is not None:
                    tr.instant("reject", t, args={"workload": req.workload,
                                                  "reason": d.reason})
                handles[p]._reject(d, at=t)
                continue
            if tr is not None:
                tid = tr.next_id()
                req.trace_id = tid
                name = self._req_span_names.get(req.workload)
                if name is None:
                    name = self._req_span_names.setdefault(
                        req.workload, "req:" + req.workload)
                tr.begin("request", tid, name, t)
            rid = getattr(req, "request_id", None)
            if rid is not None:
                self._seen_rids.add(rid)
            self._handles[id(req)] = handles[p]
            closed.extend(self.batcher.add(req, t))
        self._dispatch(closed, float(nows_arr[-1]))
        return handles

    @property
    def pending_load(self) -> int:
        """Rows occupying the slice that a new admission must queue behind:
        the batcher's open depth, rows parked in the holdback pen, and rows
        launched but not yet gathered on the async ring.  This is what the
        queue/SLO gates price waits from — ``batcher.depth`` alone is blind
        to held and in-flight rows, so λ-aggressive/async configs would
        admit load the slice cannot carry."""
        load = self.batcher.depth
        if self._held:
            load += sum(cb.batch.n_c for cb, _, _, _ in self._held.values())
        for ring in self._rings.values():
            for _, part, _, _, _ in ring:
                load += sum(cb.batch.n_c for cb in part)
        return load

    @property
    def under_backpressure(self) -> bool:
        """Soft signal for clients to slow down before rejections start."""
        return self.admission.backpressure(self.pending_load)

    # --- clock-driven flushing ------------------------------------------------

    def pump(self, now: float | None = None) -> int:
        """Close and dispatch every age-expired batch; returns batches flushed.
        Under the async pipeline this is also the gathering edge: any launch
        left in flight by a previous event is materialised here."""
        now = time.monotonic() if now is None else now
        closed = self.batcher.poll(now)
        self._dispatch(closed, now)
        return len(closed)

    def next_deadline(self) -> float | None:
        """When pump() next has work — live loops sleep until this instant.
        Holdback release deadlines count: a held batch must be launched at
        its priced window's edge even if no new request ever arrives."""
        deadline = self.batcher.next_deadline()
        for _, release_at, _, _ in self._held.values():
            deadline = (release_at if deadline is None
                        else min(deadline, release_at))
        return deadline

    @property
    def inflight_groups(self) -> int:
        """Launch groups in flight (launched, not yet gathered) across every
        per-class ring — 0 after any drain, by the quiesce contract."""
        return sum(len(ring) for ring in self._rings.values())

    def quiesce(self, now: float | None = None):
        """Drain phase 1: stop admitting, keep in-flight rows queued.

        The cluster drain barrier quiesces *every* host before flushing *any*
        host, so no request can be admitted onto an already-drained peer
        mid-barrier — the two-phase split is what makes a cluster drain
        bit-for-bit equivalent to a single-host replay of the same trace."""
        del now  # admission stop is instantaneous; kept for clock symmetry
        self._draining = True

    def drain(self, now: float | None = None) -> int:
        """Graceful shutdown: stop admitting, flush everything in flight.

        Single-host callers use this directly (quiesce + flush in one step);
        the cluster barrier calls ``quiesce`` on all hosts first, then this."""
        now = time.monotonic() if now is None else now
        self.quiesce(now)
        closed = self.batcher.flush(now)
        self._dispatch(closed, now, final=True)
        return len(closed)

    # --- failover (repro_torch.cluster.failover drives these) -----------------

    def recover_inflight(self, now: float) -> int:
        """Gather-ring rescue after a host death: force-gather every launch
        group still on the ring, in launch order, resolving their handles.
        The device had already computed these results when the host process
        died — recovering them beats replaying the rows, and the journal
        then sees their entries as settled.  Returns handles resolved."""
        before = len(self._handles)
        while (ring := self._oldest_ring()) is not None:
            self._finish(*ring.popleft()[1:], now)
        return before - len(self._handles)

    def reset_after_failure(self, now: float):
        """Model the reboot of a killed host: every in-memory structure
        (open batches, staged sets, rings, holdback pen, handle table) is
        gone; the rid-dedup filter, telemetry, and admission state survive
        — they live with the journal, not in host RAM, and a crashed host
        must never hand a tenant fresh token budget.  Dangling request
        trace spans are closed with a ``failover`` end and advertised in a
        ``failover_abandoned`` instant so the trace validator knows their
        causal chain continues on the survivor's replay span."""
        tr = self.tracer
        if tr is not None:
            # Close the open-batch spans the dead batcher holds (their rows
            # are the abandoned requests; the discarded ClosedBatch results
            # never dispatch), then the dangling request spans themselves.
            self.batcher.flush(now)
            rids = []
            for handle in self._handles.values():
                tid = getattr(handle.request, "trace_id", None)
                if tid is not None:
                    tr.end("request", tid, "failover", now)
                    rids.append(tid)
            if rids:
                tr.instant("failover_abandoned", now, track="failover",
                           args={"rids": rids})
        self._handles.clear()
        self._staged.clear()
        self._rings.clear()
        self._held.clear()
        if self.dispatch_auditor is not None:
            # The rings' un-gathered flights died with the host: retire them
            # from the fleet overlap audit or its concurrency counters leak
            # permanently-busy devices.
            self.dispatch_auditor.on_reset(self.host_id)
        self.batcher = self._make_batcher()
        self._draining = False

    def replay_admitted(self, entries, now: float) -> tuple[int, int]:
        """Failover replay edge: re-enter requests a dead peer had already
        admitted.  ``entries`` is ``[(request, handle), ...]`` from that
        peer's intake journal.  Admission is bypassed entirely — the
        requests were admitted and charged once, on the failed host
        (tests/test_ingress_columnar.py pins that bucket levels stay
        bit-identical) — and the draining gate is ignored: the drain
        barrier's contract is *complete everything admitted*, which
        includes rows stranded by a mid-barrier kill.  Idempotent: entries
        whose handle already resolved, or whose request id this host has
        seen, are skipped.  Returns ``(replayed, deduped)``."""
        tr = self.tracer
        closed: list[ClosedBatch] = []
        replayed = deduped = 0
        for req, handle in entries:
            rid = getattr(req, "request_id", None)
            if (handle.done() or id(req) in self._handles
                    or (rid is not None and rid in self._seen_rids)):
                deduped += 1
                continue
            if rid is not None:
                self._seen_rids.add(rid)
            self.telemetry.record_admission("replayed")
            if tr is not None:
                tid = tr.next_id()
                req.trace_id = tid
                tr.begin("request", tid, "replay:" + req.workload, now)
            self._handles[id(req)] = handle
            closed.extend(self.batcher.add(req, now))
            replayed += 1
        if replayed:
            self._dispatch(closed, now)
        return replayed, deduped

    # --- dispatch -------------------------------------------------------------

    def _validate_once(self, batch):
        """Structurally validate the program in its dispatched form, once per
        (workload, d_bucket): int32 operand on the class's device, twiddle
        planes as uploaded and, with merging on, the *maximal* super-batch
        height (the merge cap), so V1–V7 are asserted on the tall merged
        program the fast path actually runs.  On CUDA the e2e is captured
        once with its graph kept and read node by node (a probe outside the
        co-scheduler's program cache: nothing added to ``trace_counts`` or
        ``dispatch_log``); on the CPU it runs eagerly under the launch log.
        Eager programs are held to V1/V2 per pass, lazy ones to one fold per
        κ-window (V6/V7); the co-scheduler's programs of other workloads
        must share no buffer with each other (V5); and the K1/K2 nodes must
        be the calls the fold profile implies (the launch census, checked
        first).  A violation raises and the dispatch aborts."""
        key = (batch.workload, batch.d_bucket)
        if key in self._validated:
            return
        eng = self.cos.engine_for(*key)
        rows = (batch.operand.shape[0] if batch.operand is not None
                else batch.n_c)
        if self.cos.merge:
            rows = max(rows, self.cos.merge_rows_max)
        shape = self.cos.operand_shape(batch.workload, batch.d_bucket, rows)
        args = (torch.zeros(shape, dtype=torch.int32,
                            device=self.cos.device_for(batch.workload)),
                self.cos.device_planes_for(*key))

        donate = (0,) if self.cos.donate else ()

        def _e2e(operand, planes):
            return eng.e2e(operand, planes=planes)

        rep = V.validate_fn(_e2e, *args, donate_argnums=donate,
                            **V.checks_for(eng, self.cos.reduction_for(
                                batch.workload)))
        rep.add(V.disjoint_programs(
            (w, prog) for w, d in self.cos.trace_counts
            for prog in self.cos.jitted_for(w, d).values()))
        check_launch_census(eng, rep.n_dots, rep.n_folds,
                            f"{batch.workload}/d{batch.d_bucket}")
        rep.raise_if_failed()
        self._validated.add(key)

    def _class_key(self, cb: ClosedBatch) -> tuple:
        return (cb.batch.workload, cb.batch.d_bucket)

    def _ledger_profile(self, workload: str, d: int) -> dict:
        """Engine fold profile + limb counts — the penalty ledger's static
        per-class pricing inputs (cached: this sits on the dispatch path)."""
        key = (workload, d)
        prof = self._ledger_profiles.get(key)
        if prof is None:
            eng = self.cos.engine_for(workload, d)
            prof = dict(eng.fold_profile)
            prof["data_limbs"] = eng.wclass.data_limbs
            prof["tw_limbs"] = eng.wclass.tw_limbs
            self._ledger_profiles[key] = prof
        return prof

    # --- metrics scrape -------------------------------------------------------

    def _describe_metrics(self):
        """Family metadata for everything `_metrics_samples` can emit."""
        m = self.metrics
        m.describe("repro_admission_decisions_total", "counter",
                   "Admission decisions (all reasons).")
        m.describe("repro_admission_rejected_total", "counter",
                   "Rejected admissions by reason.")
        m.describe("repro_admission_slo_miss_total", "counter",
                   "Rejections by the local or cluster SLO gate.")
        m.describe("repro_requests_served_total", "counter",
                   "Requests resolved through dispatched batches.")
        m.describe("repro_batches_closed_total", "counter",
                   "Closed batches by close reason.")
        m.describe("repro_service_seconds_total", "counter",
                   "Accumulated dispatch service time.", wall=True)
        m.describe("repro_queue_depth", "gauge",
                   "Open batcher rows at the last scrape.")
        m.describe("repro_pending_load", "gauge",
                   "Rows queued, held, or in flight (the admission view).")
        m.describe("repro_inflight_groups", "gauge",
                   "Launch groups on the async ring awaiting gather.")
        m.describe("repro_dispatch_m_occupancy", "gauge",
                   "Mean achieved per-launch M occupancy (live/N_c_max).")
        m.describe("repro_latency_seconds", "gauge",
                   "Request latency quantiles.", wall=True)
        m.describe("repro_queue_wait_seconds", "gauge",
                   "Queue-wait quantiles.", wall=True)
        m.describe("repro_penalty_share", "gauge",
                   "Modeled-cycle share per penalty bin (all workloads).",
                   wall=True)
        m.describe("repro_penalty_arithmetic_stall_share", "gauge",
                   "Arithmetic-stall share of total modeled cycles.",
                   wall=True)
        m.describe("repro_controller_decisions_total", "counter",
                   "Flight-recorder entries (setpoint changes).")
        m.describe("repro_controller_target_rows", "gauge",
                   "Adaptive target ladder rung per class.")
        m.describe("repro_controller_max_age_seconds", "gauge",
                   "Adaptive age trigger per class.")

    def _metrics_samples(self, now: float):
        """The scrape collector: O(series) reads of running state, no event
        walks (``Telemetry.live`` exists so this never touches the record
        lists).  Gauges that are undefined before their first event (M
        occupancy, penalty shares) are withheld rather than emitted as 0 —
        an absent series keeps threshold alerts inactive instead of firing
        on a cold start."""
        del now
        ac = self.telemetry.admission_counts
        live = self.telemetry.live
        out = [
            ("repro_admission_decisions_total", (), sum(ac.values())),
            ("repro_admission_slo_miss_total", (),
             ac.get("slo_miss", 0) + ac.get("cluster_slo_miss", 0)),
            ("repro_requests_served_total", (), live["requests_served"]),
            ("repro_service_seconds_total", (), live["service_s_total"]),
            ("repro_queue_depth", (), self.batcher.depth),
            ("repro_pending_load", (), self.pending_load),
            ("repro_inflight_groups", (), self.inflight_groups),
        ]
        for reason, n in ac.items():
            if reason != "ok":
                out.append(("repro_admission_rejected_total",
                            (("reason", reason),), n))
        for reason, n in live["close_reasons"].items():
            out.append(("repro_batches_closed_total",
                        (("reason", reason),), n))
        if live["dispatches"]:
            out.append(("repro_dispatch_m_occupancy", (),
                        live["m_occupancy_sum"] / live["dispatches"]))
        if len(self.telemetry.latency):
            for q in (50, 95, 99):
                out.append(("repro_latency_seconds", (("q", f"p{q}"),),
                            self.telemetry.latency.percentile(q)))
                out.append(("repro_queue_wait_seconds", (("q", f"p{q}"),),
                            self.telemetry.queue_wait.percentile(q)))
        # Penalty bins aggregated across workloads: the alertable version of
        # the ledger's per-workload decomposition.
        bins = {k: 0.0 for k in ("mxu_productive", "arithmetic_stall",
                                 "spatial_pad", "host_gap")}
        for w in self.ledger._w.values():
            for k in bins:
                bins[k] += w["cycles"][k]
        total = sum(bins.values())
        if total > 0.0:
            for k, v in bins.items():
                out.append(("repro_penalty_share", (("bin", k),), v / total))
            out.append(("repro_penalty_arithmetic_stall_share", (),
                        bins["arithmetic_stall"] / total))
        if self.controller is not None:
            out.append(("repro_controller_decisions_total", (),
                        self.controller.decisions))
            for (w, b), _ in self.controller._state.items():
                cls = (("class", f"{w}/{b}"),)
                out.append(("repro_controller_target_rows", cls,
                            self.controller.target_rows((w, b))))
                out.append(("repro_controller_max_age_seconds", cls,
                            self.controller.max_age_s((w, b))))
        return out

    def _scrape_metrics(self, now: float, final: bool = False):
        """Cadence-gated scrape + alert evaluation — the `_dispatch` tail
        hook.  ``final`` (drain) forces one terminal scrape so the last
        events of a run are always sampled (strict timestamp monotonicity
        in the registry makes a same-instant force a no-op)."""
        if self.metrics is None:
            return
        scraped = (self.metrics.scrape(now) if final
                   else self.metrics.maybe_scrape(now))
        if scraped and self.alerts is not None:
            self.alerts.evaluate(now)

    # --- observability export -------------------------------------------------

    def metrics_text(self) -> str:
        """OpenMetrics exposition of the full scraped ring (backfill
        flavour: every retained sample, virtual-clock timestamps)."""
        if self.metrics is None:
            raise RuntimeError("metrics are off — construct the server with "
                               "ServeConfig(metrics=True)")
        return self.metrics.expose_text()

    def write_metrics(self, path: str) -> str:
        """Write the OpenMetrics exposition (gzip when path ends in .gz)."""
        from repro_torch.obs.export import write_text
        text = self.metrics_text()
        write_text(path, text)
        return text

    def trace_events(self) -> list[dict]:
        """The tracer's buffered events (empty when tracing is off)."""
        return [] if self.tracer is None else self.tracer.event_dicts()

    def write_trace(self, path: str) -> dict:
        """Export the buffered trace as Chrome-trace JSON (Perfetto-ready).
        Requires ``tracing=True`` in the config."""
        if self.tracer is None:
            raise RuntimeError("tracing is off — construct the server with "
                               "ServeConfig(tracing=True) to record a trace")
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(path, self.trace_events())

    def _apply_holdback(self, closed: list[ClosedBatch], now: float,
                        final: bool) -> list[ClosedBatch]:
        """The λ-priced merge holdback: decide, per newly closed batch,
        whether to stage it now or hold it for a predicted merge partner —
        and release every previously held batch whose partner arrived (win),
        whose priced window expired (loss), or that a drain flushes.

        Holding changes grouping only — row semantics keep the eventual
        merged launch bit-for-bit equal to launching immediately — so the
        only cost is the held rows' latency, which the pricing bounds."""
        if not self._held and (self.controller is None
                               or self.config.holdback_lambda <= 0):
            return closed
        tr = self.tracer

        def _release(held_at, hid, outcome):
            self.telemetry.record_holdback(outcome, hold_s=now - held_at)
            if tr is not None:
                tr.end("holdback", hid, "hold", now, track="holdback",
                       args={"outcome": outcome})

        out: list[ClosedBatch] = []
        if final:
            for cb, _, held_at, hid in self._held.values():
                _release(held_at, hid, "flushed")
                out.append(cb)
            self._held.clear()
        else:
            for key in [k for k, (_, rel, _, _) in self._held.items()
                        if rel <= now]:
                cb, _, held_at, hid = self._held.pop(key)
                _release(held_at, hid, "losses")
                out.append(cb)
        for cb in closed:
            key = self._class_key(cb)
            held = self._held.pop(key, None)
            if held is not None:
                # The predicted partner materialised: launch both together
                # (launch_mixed coalesces them along M into one tall group).
                _release(held[2], held[3], "wins")
                out.append(held[0])
                out.append(cb)
                continue
            if (final or cb.reason == CLOSE_DRAIN
                    or cb.batch.n_c >= self.controller.target_rows(key)):
                out.append(cb)       # already at target height — nothing to
                continue             # gain from waiting
            window = self.controller.holdback_window_s(key, cb.age_s)
            if window > 0.0:
                self.telemetry.record_holdback("held", rows=cb.batch.n_c)
                hid = 0
                if tr is not None:
                    hid = tr.next_id()
                    tr.begin("holdback", hid,
                             f"hold:{key[0]}/d{key[1]}", now,
                             track="holdback",
                             args={"rows": cb.batch.n_c,
                                   "window_s": window})
                self._held[key] = (cb, now + window, now, hid)
            else:
                out.append(cb)
        return out

    def _ring_for(self, key) -> collections.deque:
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = collections.deque()
        return ring

    def _launch_staged(self, staged: list[ClosedBatch]) -> set:
        """Enqueue the staged set onto the launch ring(s) and return the
        ring keys launched.  Depth 1 keeps the whole event in one flight
        (cross-class groups share one launch_mixed — the PR-4 pipeline);
        depth > 1 cuts per workload class so each class ring can hold k of
        *its own* groups in flight."""
        if self.config.inflight_depth == 1:
            parts = [(None, staged)]
        else:
            by_class: dict = {}
            parts = []
            for cb in staged:
                key = self._class_key(cb)
                if key not in by_class:
                    by_class[key] = []
                    parts.append((key, by_class[key]))
                by_class[key].append(cb)
        for key, part in parts:
            self._launch_seq += 1
            self._ring_for(key).append((self._launch_seq, part,
                                        *self._launch(part)))
        return {key for key, _ in parts}

    def _oldest_ring(self) -> collections.deque | None:
        live = [ring for ring in self._rings.values() if ring]
        if not live:
            return None
        return min(live, key=lambda ring: ring[0][0])

    def _dispatch(self, closed: list[ClosedBatch], now: float,
                  final: bool = False):
        """Stage newly closed batches and advance the dispatch pipeline.

        Synchronous mode launches + gathers in place (one blocking edge per
        serving event, as before).  Async mode launches now and defers the
        gather, so the caller returns while the device computes and the D2H
        copy streams; batches closed while a launch is in flight merge into
        the next one (M-axis super-batching fed by the pipeline itself).
        With ``inflight_depth`` k, up to k launch groups per workload class
        ride the ring while that class keeps launching; a class that did
        not launch this event has its oldest flight materialised instead,
        so every handle resolves at the next serving event its class goes
        quiet — a busy neighbour class can never starve another class's
        in-flight results.  ``final`` forces a full flush (drain): holdback
        pen emptied, every ring retired in launch order, zero groups left
        in flight."""
        tr = self.tracer
        if tr is not None:
            # Pin wall-clock emitters (launch spans) to this serving event's
            # clock so the whole trace shares one timeline.
            tr.anchor(now)
        if self.config.validate:
            for cb in closed:
                self._validate_once(cb.batch)
        self._staged.extend(self._apply_holdback(closed, now, final))
        if not self.config.async_pipeline:
            if self._staged:
                staged, self._staged = self._staged, []
                self._finish(staged, *self._launch(staged), now)
        else:
            launched_keys = set()
            if self._staged:
                staged, self._staged = self._staged, []
                launched_keys = self._launch_staged(staged)
            if final:
                # Retire the full ring in launch order — drain leaves
                # nothing in flight (the cluster barrier counts on it).
                while (ring := self._oldest_ring()) is not None:
                    self._finish(*ring.popleft()[1:], now)
            else:
                depth = self.config.inflight_depth
                for key, ring in self._rings.items():
                    # Gather *after* the new launches are enqueued: the
                    # device starts the next group while the host
                    # materialises these.
                    while len(ring) > depth:
                        self._finish(*ring.popleft()[1:], now)
                    if key not in launched_keys and ring:
                        self._finish(*ring.popleft()[1:], now)
        if tr is not None and (closed or final):
            # Counters are a sampled timeline, not causal data: sampling at
            # batch-close/drain boundaries keeps the sawtooth visible at the
            # granularity that matters while costing O(batches), not
            # O(requests), events (the tracing-overhead gate in
            # bench_dispatch counts on this).
            tr.counter("queue_depth", now, self.batcher.depth)
            tr.counter("inflight_groups", now, self.inflight_groups)
            tr.counter("held_batches", now, len(self._held))
        # Metrics ride the same event edge: every submit/pump/drain passes
        # through here, so a cadence check per event is the whole hot-path
        # cost (the ≤5% rows/s gate in bench_dispatch counts on this).
        self._scrape_metrics(now, final=final)

    def _launch(self, staged: list[ClosedBatch]):
        t0 = time.perf_counter()
        flight = self.cos.launch_mixed([cb.batch for cb in staged])
        launch_s = time.perf_counter() - t0
        # Claim the launch records now — a peer host sharing this
        # co-scheduler may launch before we gather.
        log = self.cos.drain_dispatch_log()
        if self.dispatch_auditor is not None:
            self.dispatch_auditor.on_launch(self.host_id, flight, log)
        return flight, log, launch_s

    def _finish(self, closed: list[ClosedBatch], flight, log: list,
                launch_s: float, now: float):
        # Service time = launch enqueue + blocking gather.  The async idle
        # gap between the two events is deliberately excluded: feeding it to
        # the admission EWMA would inflate the per-row service estimate by
        # the event spacing and make the SLO gate reject load the slice can
        # trivially carry.
        t1 = time.perf_counter()
        results = self.cos.gather(flight)
        service_s = launch_s + time.perf_counter() - t1
        if self.dispatch_auditor is not None:
            self.dispatch_auditor.on_gather(flight)
        if self.config.deterministic_timing:
            # Substitute the ledger's modeled device time for the wall
            # measurement: the one wall-clock leak into the serving loop,
            # replaced so latencies, admission EWMAs, penalty bins, scraped
            # series, and alert logs are functions of the trace alone.
            service_s = sum(
                launch_cycles(
                    d=e["d_bucket"], live_rows=e["live_rows"],
                    launched_rows=e["launched_rows"],
                    profile=self._ledger_profile(e["workload"],
                                                 e["d_bucket"]),
                    m_tile=self.config.n_c_max)["device_s"]
                for e in log)
        # Attribute wall time to batches by live-row share (one synchronised
        # launch group; per-batch device timing is not observable from here).
        total_rows = sum(cb.batch.n_c for cb in closed) or 1
        self.admission.observe_service(total_rows, service_s)
        tr = self.tracer
        if tr is not None:
            # Causal middle link: which closed batches rode which launch.
            for group, *_ in flight.groups:
                tr.instant("launch_batches", now, track="device",
                           args={"lid": group.lid,
                                 "bids": [closed[idx].batch_id
                                          for idx, _, _, _ in group.members]})
        cluster_depth = None
        if self.controller is not None and self.cluster_depth_fn is not None:
            # Fold the gossiped fleet depth into the control setpoint (the
            # bounded-staleness contract is enforced inside the view merge,
            # so the controller can never consume an over-age digest).
            cluster_depth = self.cluster_depth_fn(now)
        # Packing metrics before the launch loop: the penalty ledger prices
        # each launch's K under-fill from the live-row-weighted mean K
        # occupancy of the batches that rode its class.
        batch_metrics = []
        class_k: dict = {}
        for cb in closed:
            batch = cb.batch
            eng = self.cos.engine_for(batch.workload, batch.d_bucket)
            d_max = (eng.plan.d_max if hasattr(eng, "plan")
                     else eng.plans[0].d_max)
            m = packing_metrics(batch.degrees, batch.d_bucket, d_max,
                                n_c_max=self.config.n_c_max)
            batch_metrics.append((cb, eng, m))
            acc = class_k.setdefault((batch.workload, batch.d_bucket),
                                     [0.0, 0])
            acc[0] += m.k_occupancy * batch.n_c
            acc[1] += batch.n_c
        total_live = sum(e["live_rows"] for e in log) or 1
        for entry in log:
            live, launched = entry["live_rows"], entry["launched_rows"]
            key = (entry["workload"], entry["d_bucket"])
            if self.controller is not None:
                # Per-class backlog: the global batcher depth would let a
                # busy neighbour class snap this class's target rung to the
                # ladder top and mis-price its holdback windows.
                self.controller.observe_dispatch(
                    key, live_rows=live,
                    queue_depth=self.batcher.class_depth(key), now=now,
                    cluster_depth=cluster_depth)
                if tr is not None:
                    w, b = key
                    tr.counter(f"target_rows[{w}/d{b}]", now,
                               self.controller.target_rows(key))
                    tr.counter(f"max_age_s[{w}/d{b}]", now,
                               self.controller.max_age_s(key))
                    dec = self.controller.last_decision
                    if dec is not None:
                        # Flight-recorder echo on the timeline: the counter
                        # tracks show *what* the setpoints did, the instant
                        # says *why* (the law branch that moved them).
                        tr.instant("setpoint", now, track="counters",
                                   args={"class": dec.cls,
                                         "reason": dec.reason,
                                         "target_rows": dec.target_rows,
                                         "max_age_s": dec.max_age_s})
            self.telemetry.record_dispatch(DispatchRecord(
                workload=entry["workload"], d_bucket=entry["d_bucket"],
                n_batches=entry["n_batches"], live_rows=live,
                launched_rows=launched,
                m_occupancy=min(1.0, live / self.config.n_c_max),
                m_fill=live / launched if launched else 0.0,
                donated=entry["donated"],
                devices=tuple(entry.get("devices", ()))))
            acc = class_k.get(key)
            self.ledger.observe_launch(
                workload=entry["workload"], d=entry["d_bucket"],
                live_rows=live, launched_rows=launched,
                n_batches=entry["n_batches"],
                service_s=service_s * live / total_live,
                profile=self._ledger_profile(*key),
                k_occupancy=(acc[0] / acc[1]) if acc and acc[1] else 1.0)
        for (cb, eng, m), res in zip(batch_metrics, results):
            batch = cb.batch
            share = service_s * batch.n_c / total_rows
            self.telemetry.record_batch(BatchRecord(
                workload=batch.workload, d_bucket=batch.d_bucket,
                n_c=batch.n_c, close_reason=cb.reason,
                m_occupancy=m.m_occupancy, k_occupancy=m.k_occupancy,
                queue_depth=self.batcher.depth, service_s=share,
                age_s=cb.age_s,
                reduction=eng.fold_profile["reduction"],
                n_folds=eng.fold_profile["n_folds"]))
            completed = now + share
            for i, r in enumerate(batch.requests):
                handle = self._handles.pop(id(r), None)
                if handle is None:       # direct batcher use, no submit()
                    continue
                # route by row position — a tenant may own several rows
                handle._resolve(res.rows[i], completed)
                self.telemetry.observe_latency(
                    handle.latency_s, queue_wait_s=now - handle.submitted_at)
                rid = getattr(r, "trace_id", None)
                if tr is not None and rid is not None:
                    tr.end("request", rid, "complete", completed)
