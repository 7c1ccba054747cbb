"""Cluster telemetry: merging per-host snapshots into fleet-level metrics.

Each host exports the same JSON snapshot a single-host server does; the
cluster layer merges K of them into one document.  Counters and sums merge
exactly.  Means merge exactly because each snapshot carries its weight
(batch / request counts).  Quantiles do **not** merge from summaries — the
p99 of per-host p99s is not the cluster p99 — so per-host snapshots in
cluster mode carry their raw latency samples and the merge recomputes
quantiles over the concatenation:

* with samples present (``merged_exact: true``): merged quantiles equal the
  quantiles of the concatenated per-request records up to float round-off
  (the documented tolerance is 1e-9 relative);
* without samples (``merged_exact: false``): quantiles fall back to a
  count-weighted mean of the per-host quantiles — an approximation whose
  error grows with cross-host spread; ``max_s`` stays exact (max of maxes).

Load imbalance is the cluster-only signal: requests per host, the
max/mean ratio (1.0 = perfectly even), and the coefficient of variation.
A single hot tenant drives max/mean toward the host count — the spatial
collapse regime the paper prices out per pod (§7).
"""
from __future__ import annotations

import math

from repro_torch.obs.alerts import merge_alert_sections
from repro_torch.obs.ledger import merge_penalty_sections
from repro_torch.serve.telemetry import LatencyHistogram

MERGE_TOLERANCE_REL = 1e-9   # documented float-roundoff bound (exact path)


def _merge_counter_dicts(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _weighted_mean(pairs) -> float:
    """pairs: (value, weight).  0.0 when all weights are zero."""
    total = sum(w for _, w in pairs)
    if not total:
        return 0.0
    return sum(v * w for v, w in pairs) / total


def _sketch_quantile(buckets: dict, zero: int, count: int, max_s: float,
                     gamma: float, q: float) -> float:
    """Quantile of a merged log-bucket sketch: cumulative walk to the rank,
    geometric bucket midpoint as the representative value."""
    if not count:
        return 0.0
    rank = (q / 100.0) * (count - 1)
    seen = zero
    if rank < seen:
        return 0.0
    for b in sorted(buckets):
        seen += buckets[b]
        if rank < seen:
            return min(gamma ** (b + 0.5), max_s)
    return max_s


def _merge_histograms(summaries: list[dict]) -> dict:
    """Merge per-host latency/queue-wait summaries (see module docstring).
    Degenerate hosts (empty or missing summaries) contribute nothing."""
    summaries = [s for s in summaries if s]
    if not summaries:
        return {"count": 0, "mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0,
                "p99_s": 0.0, "max_s": 0.0, "merged_exact": True}
    if all("samples" in s for s in summaries):
        h = LatencyHistogram()
        for s in summaries:
            for v in s["samples"]:
                h.observe(v)
        merged = h.summary()
        merged["merged_exact"] = True
        return merged
    if all(("samples" in s) or ("sketch" in s) for s in summaries):
        # ≥1 host collapsed to a log-bucket sketch: merge bucket-wise (exact
        # hosts are bucketed on the fly), keep count/mean/max exact, and
        # flip merged_exact off — quantiles now carry the sketch's bounded
        # relative error.
        gamma = LatencyHistogram.GAMMA
        for s in summaries:
            g = s.get("sketch", {}).get("gamma", gamma)
            if abs(g - gamma) > 1e-12:
                raise ValueError(f"sketch gamma mismatch: host exported "
                                 f"{g}, merge expects {gamma}")
        buckets: dict[int, int] = {}
        zero = count = 0
        total = max_s = 0.0
        for s in summaries:
            n = s.get("count", 0)
            count += n
            total += s.get("mean_s", 0.0) * n
            max_s = max(max_s, s.get("max_s", 0.0))
            if "sketch" in s:
                zero += s["sketch"].get("zero", 0)
                for b, c in s["sketch"].get("buckets", {}).items():
                    buckets[int(b)] = buckets.get(int(b), 0) + c
            else:
                for v in s["samples"]:
                    if v <= 0.0:
                        zero += 1
                    else:
                        b = math.floor(math.log(v) / math.log(gamma))
                        buckets[b] = buckets.get(b, 0) + 1
        merged = {"count": count, "mean_s": (total / count) if count else 0.0,
                  "max_s": max_s, "merged_exact": False}
        for q, key in ((50, "p50_s"), (95, "p95_s"), (99, "p99_s")):
            merged[key] = _sketch_quantile(buckets, zero, count, max_s,
                                           gamma, q)
        return merged
    counts = [s.get("count", 0) for s in summaries]
    merged = {"count": sum(counts),
              "mean_s": _weighted_mean(
                  [(s.get("mean_s", 0.0), c) for s, c in zip(summaries,
                                                             counts)]),
              "max_s": max((s.get("max_s", 0.0) for s in summaries),
                           default=0.0),
              "merged_exact": False}
    for q in ("p50_s", "p95_s", "p99_s"):
        merged[q] = _weighted_mean(
            [(s.get(q, 0.0), c) for s, c in zip(summaries, counts)])
    return merged


def _merge_per_workload(snaps: list[dict]) -> dict:
    """Per-mode batch counts merge exactly across hosts — a fleet may
    legitimately run one class eager on some hosts and κ-deferred on others
    (or flip mid-run), so the merge reports the counts and derives the
    ``reduction`` label (single mode, or "mixed") instead of rejecting the
    disagreement.  Hosts predating ``reduction_batches`` are synthesised
    from their single ``reduction`` label."""
    out: dict = {}
    for snap in snaps:
        for wname, w in snap.get("per_workload", {}).items():
            m = out.setdefault(wname, {
                "batches": 0, "requests": 0, "folds": 0,
                "reduction_batches": {},
                "_k_sum": 0.0, "_m_sum": 0.0})
            batches = w.get("batches", 0)
            modes = w.get("reduction_batches")
            if modes is None:
                modes = {w.get("reduction", "eager"): batches}
            for mode, n in modes.items():
                m["reduction_batches"][mode] = (
                    m["reduction_batches"].get(mode, 0) + n)
            m["batches"] += batches
            m["requests"] += w.get("requests", 0)
            m["folds"] += w.get("folds", 0)
            m["_k_sum"] += w.get("k_occupancy_mean", 0.0) * batches
            m["_m_sum"] += w.get("m_occupancy_mean", 0.0) * batches
    for m in out.values():
        b = m["batches"] or 1
        m["k_occupancy_mean"] = m.pop("_k_sum") / b
        m["m_occupancy_mean"] = m.pop("_m_sum") / b
        modes = sorted(k for k, v in m["reduction_batches"].items() if v)
        m["reduction"] = modes[0] if len(modes) == 1 else (
            "mixed" if modes else "eager")
    return out


def _merge_dispatch(snaps: list[dict]) -> dict:
    """Merge the per-host dispatch-fast-path sections (counters sum; means
    are dispatch-weighted; pad_fraction is recomputed from the merged row
    totals so it stays exact).  Hosts predating the section contribute
    nothing."""
    parts = [s.get("dispatch") for s in snaps]
    parts = [p for p in parts if p]
    out = {"dispatches": 0, "merged_dispatches": 0, "live_rows": 0,
           "launched_rows": 0, "donated": 0}
    for p in parts:
        for k in out:
            out[k] += p.get(k, 0)
    weights = [p.get("dispatches", 0) for p in parts]
    for key in ("batches_per_dispatch_mean", "m_occupancy_mean",
                "m_fill_mean"):
        out[key] = _weighted_mean(
            [(p.get(key, 0.0), w) for p, w in zip(parts, weights)])
    out["pad_fraction"] = (1.0 - out["live_rows"] / out["launched_rows"]
                           if out["launched_rows"] else 0.0)
    by_device: dict = {}
    for p in parts:
        for dev, slot in p.get("by_device", {}).items():
            m = by_device.setdefault(dev, {"launches": 0, "live_rows": 0})
            m["launches"] += slot.get("launches", 0)
            m["live_rows"] += slot.get("live_rows", 0)
    out["by_device"] = by_device
    return out


def _merge_holdback(snaps: list[dict]) -> dict:
    """Merge the per-host λ-holdback audits: event counters and held rows
    sum, the realised hold durations keep their fleet-wide max and total.
    Hosts predating the section contribute nothing."""
    out = {"held": 0, "wins": 0, "losses": 0, "flushed": 0,
           "held_rows": 0, "hold_s_sum": 0.0, "hold_s_max": 0.0}
    for snap in snaps:
        h = snap.get("holdback")
        if not h:
            continue
        for k in ("held", "wins", "losses", "flushed", "held_rows",
                  "hold_s_sum"):
            out[k] += h.get(k, 0)
        out["hold_s_max"] = max(out["hold_s_max"], h.get("hold_s_max", 0.0))
    return out


def _merge_controller(snaps: list[dict]) -> dict | None:
    """Fleet summary of the per-host adaptive controllers (None when no host
    runs one).  Setpoints are host-local by design — each host's loop reacts
    to its own slice — so the merge reports the update-weighted fleet means
    and extrema, not a single merged setpoint."""
    parts = [s.get("controller") for s in snaps]
    parts = [p for p in parts if p]
    if not parts:
        return None
    updates = [p.get("updates", 0) for p in parts]
    class_states = [c for p in parts for c in p.get("classes", {}).values()]
    weights = [c.get("updates", 0) for c in class_states]
    return {
        "hosts": len(parts),
        "updates": sum(updates),
        "cluster_depth_max": max(p.get("cluster_depth_max", 0.0)
                                 for p in parts),
        "m_occupancy_ewma_mean": _weighted_mean(
            [(c.get("m_occupancy_ewma", 0.0), w)
             for c, w in zip(class_states, weights)]),
        "target_rows_max": max((c.get("target_rows", 0)
                                for c in class_states), default=0),
        "max_age_s_max": max((c.get("max_age_s", 0.0)
                              for c in class_states), default=0.0),
    }


def _merge_reduction_stalls(snaps: list[dict]) -> dict:
    out = {"eager_folds": 0, "deferred_folds": 0, "by_close_reason": {}}
    for snap in snaps:
        stalls = snap.get("reduction_stalls")
        if not stalls:
            continue
        out["eager_folds"] += stalls.get("eager_folds", 0)
        out["deferred_folds"] += stalls.get("deferred_folds", 0)
        for reason, by in stalls.get("by_close_reason", {}).items():
            slot = out["by_close_reason"].setdefault(
                reason, {"eager_folds": 0, "deferred_folds": 0})
            slot["eager_folds"] += by.get("eager_folds", 0)
            slot["deferred_folds"] += by.get("deferred_folds", 0)
    return out


def load_imbalance(per_host_requests: list[int]) -> dict:
    """Fleet skew metrics over per-host served-request counts."""
    n = len(per_host_requests)
    mean = sum(per_host_requests) / n if n else 0.0
    if mean == 0.0:
        return {"per_host_requests": list(per_host_requests),
                "max_over_mean": 1.0, "cv": 0.0}
    var = sum((r - mean) ** 2 for r in per_host_requests) / n
    return {
        "per_host_requests": list(per_host_requests),
        "max_over_mean": max(per_host_requests) / mean,
        "cv": math.sqrt(var) / mean,
    }


def summarize_failover(events: list[dict]) -> dict:
    """Roll a failover coordinator's event log up into fleet counts: fault
    injections by kind, cordons by cause, and the recovery-side aggregates
    (replayed / recovered / deduped / limbo-delivered) summed over cordon
    events.  The summary is what lands in ``snapshot()["failover"]`` — the
    raw event list rides alongside for forensics."""
    out = {"kills": 0, "pauses": 0, "recovers": 0, "cordons": 0,
           "cordons_by_cause": {}, "replayed": 0, "recovered": 0,
           "deduped": 0, "limbo_delivered": 0}
    for ev in events:
        kind = ev.get("kind")
        if kind == "kill":
            out["kills"] += 1
        elif kind == "pause":
            out["pauses"] += 1
        elif kind == "recover":
            out["recovers"] += 1
        elif kind == "cordon":
            out["cordons"] += 1
            cause = ev.get("cause", "unknown")
            out["cordons_by_cause"][cause] = (
                out["cordons_by_cause"].get(cause, 0) + 1)
            for k in ("replayed", "recovered", "deduped", "limbo_delivered"):
                out[k] += ev.get(k, 0)
    return out


def merge_snapshots(snaps: list[dict]) -> dict:
    """Merge K per-host telemetry snapshots into one cluster snapshot.

    The merged document has the same schema as a single-host snapshot (so
    downstream BENCH_* tooling needs no cluster special-case) plus
    ``latency.merged_exact`` / ``queue_wait.merged_exact`` flags and a
    ``load_imbalance`` section.
    """
    if not snaps:
        raise ValueError("merge_snapshots needs at least one host snapshot")
    # Every lookup below is defensive: a degenerate host (zero batches,
    # empty histograms, predates a section) contributes zeros, never a
    # KeyError — the fleet merge must survive a host that served nothing.
    batches = [s.get("batches", 0) for s in snaps]
    admission = [s.get("admission", {}) for s in snaps]
    merged = {
        "batches": sum(batches),
        "requests_served": sum(s.get("requests_served", 0) for s in snaps),
        "k_occupancy_mean": _weighted_mean(
            [(s.get("k_occupancy_mean", 0.0), b)
             for s, b in zip(snaps, batches)]),
        "m_occupancy_mean": _weighted_mean(
            [(s.get("m_occupancy_mean", 0.0), b)
             for s, b in zip(snaps, batches)]),
        "queue_depth_mean": _weighted_mean(
            [(s.get("queue_depth_mean", 0.0), b)
             for s, b in zip(snaps, batches)]),
        "queue_depth_max": max((s.get("queue_depth_max", 0) for s in snaps),
                               default=0),
        "service_s_total": sum(s.get("service_s_total", 0.0) for s in snaps),
        "close_reasons": _merge_counter_dicts(s.get("close_reasons", {})
                                              for s in snaps),
        "reduction_stalls": _merge_reduction_stalls(snaps),
        "dispatch": _merge_dispatch(snaps),
        "holdback": _merge_holdback(snaps),
        "per_workload": _merge_per_workload(snaps),
        "penalty": merge_penalty_sections(
            [s.get("penalty") for s in snaps]),
        "latency": _merge_histograms([s.get("latency") for s in snaps]),
        "queue_wait": _merge_histograms([s.get("queue_wait")
                                         for s in snaps]),
        "admission": {
            "admitted": sum(a.get("admitted", 0) for a in admission),
            "rejected": sum(a.get("rejected", 0) for a in admission),
            "by_reason": _merge_counter_dicts(a.get("by_reason", {})
                                              for a in admission),
        },
        "load_imbalance": load_imbalance(
            [s.get("requests_served", 0) for s in snaps]),
        "n_hosts": len(snaps),
    }
    controller = _merge_controller(snaps)
    if controller is not None:
        merged["controller"] = controller
    alerts = merge_alert_sections([s.get("alerts") for s in snaps])
    if alerts:
        merged["alerts"] = alerts
    metrics = _merge_metrics_audit(snaps)
    if metrics is not None:
        merged["metrics"] = metrics
    return merged


def _merge_metrics_audit(snaps: list[dict]) -> dict | None:
    """Fleet sum of the per-host registry audits (None when no host scrapes
    — hosts predating the section contribute nothing)."""
    parts = [s.get("metrics") for s in snaps]
    parts = [p for p in parts if p]
    if not parts:
        return None
    return {
        "hosts": len(parts),
        "scrapes": sum(p.get("scrapes", 0) for p in parts),
        "series": sum(p.get("series", 0) for p in parts),
        "samples": sum(p.get("samples", 0) for p in parts),
        "dropped_points": sum(p.get("dropped_points", 0) for p in parts),
    }
