"""Serving telemetry: occupancy, queue depth, and latency distributions.

Every closed batch contributes one :class:`BatchRecord` carrying the Tier-1
packing metrics (K/M systolic occupancy — the paper's Table-5 quantities) at
the moment of dispatch, plus the queue depth it left behind and its measured
service time.  Per-request latencies feed a histogram reporting p50/p95/p99.
Snapshots are plain dicts, exportable to JSON for ``BENCH_*`` tracking.
"""
from __future__ import annotations

import dataclasses
import json
import math


class LatencyHistogram:
    """Latency reservoir with interpolated percentiles.

    Exact by default: serving runs here are bounded (seconds of trace,
    thousands of requests), so exact samples beat bucketed approximations.
    For traces that outgrow the reservoir, pass ``sketch_bound``: once the
    sample count exceeds it the reservoir collapses into log-spaced buckets
    (ratio :data:`GAMMA` per bucket → ≤ ~4.5% relative quantile error) with
    bounded memory; count / mean / max stay exact in either mode.  The
    cluster merge (:mod:`repro_torch.cluster.telemetry`) stays exact only while
    every host is still exact — any sketched host flips ``merged_exact``
    off and the merge proceeds bucket-wise.
    """

    GAMMA = 2.0 ** 0.125     # 12 buckets per octave of latency

    def __init__(self, sketch_bound: int | None = None):
        if sketch_bound is not None and sketch_bound < 1:
            raise ValueError(f"sketch_bound must be ≥ 1, got {sketch_bound}")
        self.sketch_bound = sketch_bound
        self._samples: list[float] = []
        self._sorted = True
        self._buckets: dict[int, int] | None = None   # log-bucket counts
        self._zero = 0          # samples ≤ 0 (virtual clocks produce them)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    @property
    def sketching(self) -> bool:
        return self._buckets is not None

    def _bucket_of(self, x: float) -> int:
        return math.floor(math.log(x) / math.log(self.GAMMA))

    def _collapse(self):
        """Exact reservoir → log-bucket sketch (one-way, on overflow)."""
        self._buckets = {}
        for x in self._samples:
            if x <= 0.0:
                self._zero += 1
            else:
                b = self._bucket_of(x)
                self._buckets[b] = self._buckets.get(b, 0) + 1
        self._samples = []
        self._sorted = True

    def observe(self, seconds: float):
        x = float(seconds)
        self._count += 1
        self._sum += x
        self._max = max(self._max, x)
        if self._buckets is not None:
            if x <= 0.0:
                self._zero += 1
            else:
                b = self._bucket_of(x)
                self._buckets[b] = self._buckets.get(b, 0) + 1
            return
        self._samples.append(x)
        self._sorted = False
        if (self.sketch_bound is not None
                and len(self._samples) > self.sketch_bound):
            self._collapse()

    def __len__(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """Quantile, q in [0, 100]: linear-interpolated over exact samples,
        or the geometric bucket midpoint once sketching."""
        if not self._count:
            return 0.0
        if self._buckets is not None:
            rank = (q / 100.0) * (self._count - 1)
            seen = self._zero
            if rank < seen:
                return 0.0
            for b in sorted(self._buckets):
                seen += self._buckets[b]
                if rank < seen:
                    return min(self.GAMMA ** (b + 0.5), self._max)
            return self._max
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        s = self._samples
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    @property
    def samples(self) -> list[float]:
        """Sorted copy of the raw samples (the exactly-mergeable
        representation) — unavailable once collapsed to a sketch."""
        if self._buckets is not None:
            raise RuntimeError("histogram collapsed to a sketch at "
                               f"sketch_bound={self.sketch_bound}: exact "
                               "samples are gone; merge via the 'sketch' "
                               "summary section instead")
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        return list(self._samples)

    def sketch_state(self) -> dict:
        """The mergeable bucket representation (JSON-safe string keys)."""
        return {"gamma": self.GAMMA, "zero": self._zero,
                "buckets": {str(b): n
                            for b, n in sorted(self._buckets.items())}}

    def summary(self, include_samples: bool = False) -> dict:
        n = self._count
        out = {
            "count": n,
            "mean_s": (self._sum / n) if n else 0.0,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
            "max_s": self._max if n else 0.0,
        }
        if include_samples:
            # Cluster mode: per-host snapshots carry the raw samples so the
            # merged cluster quantiles are exact (quantiles of summaries are
            # not mergeable; quantiles of concatenated samples are).  A
            # sketched host exports its buckets instead — still mergeable,
            # no longer exact.
            if self._buckets is not None:
                out["sketch"] = self.sketch_state()
            else:
                out["samples"] = self.samples
        return out


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One launch group (possibly several merged batches).

    Where :class:`BatchRecord` carries the *planned* packing of one closed
    batch, this carries the *achieved* M fill of what actually hit the
    device after super-batching and row-ladder padding — the quantity
    ``bench_serve``/``bench_dispatch`` track to show the recovered M
    occupancy (paper §7: M collapses to 6.25% at N_c = 8 on v4).
    """
    workload: str
    d_bucket: int
    n_batches: int           # stacked batches merged into this launch
    live_rows: int           # tenant rows (excludes ladder padding)
    launched_rows: int       # operand height on the device (ladder rung)
    m_occupancy: float       # live_rows / n_c_max — post-merge M occupancy
    m_fill: float            # live_rows / launched_rows — ladder-pad density
    donated: bool = False    # operand buffer donated to the program
    devices: tuple = ()      # device ids the launch was enqueued on (empty
                             # for records predating device pinning)


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    workload: str
    d_bucket: int
    n_c: int                 # live tenant rows (excludes shape-padding rows)
    close_reason: str        # "full" | "age" | "occupancy" | "drain"
    m_occupancy: float
    k_occupancy: float
    queue_depth: int         # pending requests left behind at dispatch
    service_s: float
    age_s: float             # oldest-request residency when the batch closed
    reduction: str = "eager"  # fold discipline of this batch's program
    n_folds: int = 0         # static VPU-fold (reduction-stall) count of the
                             # dispatched program: n_passes·C eager,
                             # ⌈n_passes/κ⌉·C deferred (paper §7.2.1)


class Telemetry:
    """Accumulates serving events; ``snapshot()`` is the export surface."""

    HOLDBACK_EVENTS = ("held", "wins", "losses", "flushed")

    def __init__(self, sketch_bound: int | None = None):
        self.batches: list[BatchRecord] = []
        self.dispatches: list[DispatchRecord] = []
        self.latency = LatencyHistogram(sketch_bound=sketch_bound)
        self.queue_wait = LatencyHistogram(sketch_bound=sketch_bound)
        self.admission_counts: dict[str, int] = {}
        self._queue_depth_sum = 0
        self._queue_depth_max = 0
        # Merge-holdback audit: every hold must end as exactly one win
        # (a partner arrived inside the priced window), loss (the window
        # expired first), or flush (drain released it).
        self.holdback = {k: 0 for k in self.HOLDBACK_EVENTS}
        self.holdback.update(held_rows=0, hold_s_sum=0.0, hold_s_max=0.0)
        # Extra snapshot sections attached by the serving layer (e.g. the
        # adaptive controller's state) — name -> zero-arg provider.
        self._sections: dict = {}
        # O(1) running counters for the metrics scrape path: snapshot() walks
        # every event record (fine once per run, too hot per scrape), so the
        # scrape collectors read these instead.
        self.live = {
            "requests_served": 0,      # Σ n_c over closed batches
            "batches": 0,
            "service_s_total": 0.0,
            "close_reasons": {},       # reason -> count
            "dispatches": 0,
            "live_rows": 0,
            "launched_rows": 0,
            "m_occupancy_sum": 0.0,    # over DispatchRecords
        }

    def attach_section(self, name: str, provider):
        """Register a callable whose result is exported under ``name`` in
        every snapshot (the controller uses this to publish its setpoints
        without telemetry knowing its shape)."""
        self._sections[name] = provider

    def detach_section(self, name: str):
        """Stop exporting ``name`` (no error if it was never attached)."""
        self._sections.pop(name, None)

    # --- event sinks ----------------------------------------------------------

    def record_batch(self, rec: BatchRecord):
        self.batches.append(rec)
        self._queue_depth_sum += rec.queue_depth
        self._queue_depth_max = max(self._queue_depth_max, rec.queue_depth)
        live = self.live
        live["requests_served"] += rec.n_c
        live["batches"] += 1
        live["service_s_total"] += rec.service_s
        live["close_reasons"][rec.close_reason] = (
            live["close_reasons"].get(rec.close_reason, 0) + 1)

    def record_dispatch(self, rec: DispatchRecord):
        self.dispatches.append(rec)
        live = self.live
        live["dispatches"] += 1
        live["live_rows"] += rec.live_rows
        live["launched_rows"] += rec.launched_rows
        live["m_occupancy_sum"] += rec.m_occupancy

    def record_admission(self, reason: str):
        self.admission_counts[reason] = self.admission_counts.get(reason, 0) + 1

    def record_admissions(self, counts: dict):
        """Bulk admission decisions (one arrival batch): same ledger as
        :meth:`record_admission`, one update per reason per batch instead of
        one per request — the batch ingress edge's O(1) telemetry cost."""
        for reason, k in counts.items():
            self.admission_counts[reason] = (
                self.admission_counts.get(reason, 0) + int(k))

    def record_holdback(self, event: str, *, rows: int = 0,
                        hold_s: float = 0.0):
        """``held`` when a batch enters holdback; ``wins``/``losses``/
        ``flushed`` when it leaves (with its realised hold duration)."""
        if event not in self.HOLDBACK_EVENTS:
            raise ValueError(f"unknown holdback event {event!r} "
                             f"(want one of {self.HOLDBACK_EVENTS})")
        self.holdback[event] += 1
        if event == "held":
            self.holdback["held_rows"] += rows
        else:
            self.holdback["hold_s_sum"] += hold_s
            self.holdback["hold_s_max"] = max(self.holdback["hold_s_max"],
                                              hold_s)

    def observe_latency(self, seconds: float, *, queue_wait_s: float = None):
        self.latency.observe(seconds)
        if queue_wait_s is not None:
            self.queue_wait.observe(queue_wait_s)

    # --- export ---------------------------------------------------------------

    def snapshot(self, include_samples: bool = False) -> dict:
        n_b = len(self.batches)
        per_workload: dict[str, dict] = {}
        for rec in self.batches:
            w = per_workload.setdefault(rec.workload, {
                "batches": 0, "requests": 0, "k_occupancy_sum": 0.0,
                "m_occupancy_sum": 0.0, "reduction_batches": {},
                "folds": 0})
            w["batches"] += 1
            w["requests"] += rec.n_c
            w["k_occupancy_sum"] += rec.k_occupancy
            w["m_occupancy_sum"] += rec.m_occupancy
            w["folds"] += rec.n_folds
            w["reduction_batches"][rec.reduction] = (
                w["reduction_batches"].get(rec.reduction, 0) + 1)
        for w in per_workload.values():
            w["k_occupancy_mean"] = w.pop("k_occupancy_sum") / w["batches"]
            w["m_occupancy_mean"] = w.pop("m_occupancy_sum") / w["batches"]
            # Derived label: the single fold discipline when the class is
            # uniform, "mixed" otherwise (a class can change discipline
            # mid-run, e.g. a reconfigured slice — the old field silently
            # reported whichever mode the first batch happened to use).
            modes = sorted(w["reduction_batches"])
            w["reduction"] = modes[0] if len(modes) == 1 else "mixed"
        reasons: dict[str, int] = {}
        for rec in self.batches:
            reasons[rec.close_reason] = reasons.get(rec.close_reason, 0) + 1
        # Reduction-stall counters: each VPU fold is a reduction stall of the
        # MXU pipeline; the eager/deferred split per close reason is the κ-
        # amortisation audit surface (paper §7.2.1).
        stalls = {"eager_folds": 0, "deferred_folds": 0,
                  "by_close_reason": {}}
        for rec in self.batches:
            kind = "eager_folds" if rec.reduction == "eager" else "deferred_folds"
            stalls[kind] += rec.n_folds
            by = stalls["by_close_reason"].setdefault(
                rec.close_reason, {"eager_folds": 0, "deferred_folds": 0})
            by[kind] += rec.n_folds
        # Dispatch fast path: achieved per-launch M fill after merging +
        # ladder padding (one DispatchRecord per launch group;
        # several BatchRecords may map onto one of these).
        n_d = len(self.dispatches)
        live = sum(r.live_rows for r in self.dispatches)
        launched = sum(r.launched_rows for r in self.dispatches)
        dispatch = {
            "dispatches": n_d,
            "merged_dispatches": sum(1 for r in self.dispatches
                                     if r.n_batches > 1),
            "batches_per_dispatch_mean": (
                sum(r.n_batches for r in self.dispatches) / n_d) if n_d else 0.0,
            "live_rows": live,
            "launched_rows": launched,
            "pad_fraction": (1.0 - live / launched) if launched else 0.0,
            "m_occupancy_mean": (sum(r.m_occupancy for r in self.dispatches)
                                 / n_d) if n_d else 0.0,
            "m_fill_mean": (sum(r.m_fill for r in self.dispatches) / n_d)
                           if n_d else 0.0,
            "donated": sum(1 for r in self.dispatches if r.donated),
        }
        # Per-device launch census (device-parallel fleets): which device
        # ids this host's programs were enqueued on, and how many live rows
        # each carried — the attribution basis for per-device busy time.
        by_device: dict[str, dict] = {}
        for r in self.dispatches:
            for dev in r.devices:
                slot = by_device.setdefault(
                    str(dev), {"launches": 0, "live_rows": 0})
                slot["launches"] += 1
                slot["live_rows"] += r.live_rows
        dispatch["by_device"] = by_device
        admitted = self.admission_counts.get("ok", 0)
        rejected = sum(v for k, v in self.admission_counts.items() if k != "ok")
        extra = {name: provider() for name, provider in self._sections.items()}
        return {
            **extra,
            "holdback": dict(self.holdback),
            "batches": n_b,
            "requests_served": sum(r.n_c for r in self.batches),
            "k_occupancy_mean": (sum(r.k_occupancy for r in self.batches) / n_b)
                                if n_b else 0.0,
            "m_occupancy_mean": (sum(r.m_occupancy for r in self.batches) / n_b)
                                if n_b else 0.0,
            "queue_depth_mean": (self._queue_depth_sum / n_b) if n_b else 0.0,
            "queue_depth_max": self._queue_depth_max,
            "service_s_total": sum(r.service_s for r in self.batches),
            "close_reasons": reasons,
            "reduction_stalls": stalls,
            "dispatch": dispatch,
            "per_workload": per_workload,
            "latency": self.latency.summary(include_samples),
            "queue_wait": self.queue_wait.summary(include_samples),
            "admission": {"admitted": admitted, "rejected": rejected,
                          "by_reason": dict(self.admission_counts)},
        }

    def write_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        return snap


class DispatchOverlapAuditor:
    """Fleet-level launch-overlap audit for device-parallel clusters.

    The cluster layer attaches one auditor across all host slices; each
    host reports program launches (``on_launch``) and retirements
    (``on_gather`` / ``on_reset``).  Every quantity is computed from the
    *event order* of launches on the shared virtual clock, so the audit is
    deterministic and testable:

    * ``launch_concurrency`` — distinct devices with un-gathered launches
      at each launch instant (mean/max).  >1 means host i's launches
      genuinely overlap host j's on separate queues.
    * ``cross_host_queue_share`` — fraction of launches enqueued while
      another host already had an un-gathered launch on the *same*
      device.  High in simulated shared-device mode; exactly 0.0 by
      construction when every host is pinned to its own device.
    """

    def __init__(self):
        self._inflight: dict[int, list] = {}   # id(flight) -> [(host, devs)]
        self.launches = 0
        self.flights = 0
        self.cross_host_shared = 0
        self._concurrency_sum = 0
        self.concurrency_max = 0
        self.per_host_devices: dict = {}       # host -> set of device ids

    def on_launch(self, host, flight, entries: list[dict]):
        """Register one ``launch_mixed`` flight: ``entries`` are the
        co-scheduler's dispatch-log records for exactly this flight."""
        units = []
        for e in entries:
            devs = frozenset(e.get("devices", ()))
            self.launches += 1
            self.per_host_devices.setdefault(host, set()).update(devs)
            for others in self._inflight.values():
                if any(h != host and (devs & d) for h, d in others):
                    self.cross_host_shared += 1
                    break
            units.append((host, devs))
        if units:
            self.flights += 1
            self._inflight[id(flight)] = units
            busy = set()
            for u in self._inflight.values():
                for _, devs in u:
                    busy |= devs
            self._concurrency_sum += len(busy)
            self.concurrency_max = max(self.concurrency_max, len(busy))

    def on_gather(self, flight):
        self._inflight.pop(id(flight), None)

    def on_reset(self, host):
        """A host was torn down without gathering (failover reset): its
        in-flight launches are gone, not merely late — drop them so the
        concurrency audit does not leak permanently-busy devices."""
        for key, units in list(self._inflight.items()):
            kept = [(h, d) for h, d in units if h != host]
            if kept:
                self._inflight[key] = kept
            else:
                del self._inflight[key]

    def snapshot(self) -> dict:
        n = self.launches
        return {
            "launches": n,
            "flights": self.flights,
            "cross_host_shared_launches": self.cross_host_shared,
            "cross_host_queue_share": (self.cross_host_shared / n) if n
                                      else 0.0,
            "launch_concurrency_mean": (
                self._concurrency_sum / self.flights) if self.flights
                else 0.0,
            "launch_concurrency_max": self.concurrency_max,
            "inflight_launches": sum(len(u) for u in
                                     self._inflight.values()),
            "per_host_devices": {str(h): sorted(d) for h, d in
                                 sorted(self.per_host_devices.items(),
                                        key=lambda kv: str(kv[0]))},
        }
