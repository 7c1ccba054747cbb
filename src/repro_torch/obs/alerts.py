"""SLO alerting over scraped series: multi-window burn rates + thresholds.

Rules evaluate against a `MetricsRegistry` ring at scrape cadence and drive a
``inactive → pending → firing → resolved`` state machine per rule.  Burn-rate
rules follow the multi-window multi-burn-rate pattern: each ``(long_s,
short_s, factor)`` window pair demands the error-budget burn exceed ``factor``
over *both* the long window (sustained burn) and the short window (still
burning now); pairs are OR-ed so a fast pair pages on hard overload while a
slow pair catches low-grade budget leaks.  Transitions append to a bounded
event log and are emitted as Tracer instants on the ``alerts`` track, so
firings land on the Perfetto timeline next to the dispatch spans that caused
them.

Everything here is driven off the serving clock — with a deterministic
registry (see `repro_torch.obs.metrics`), two identical runs produce bit-identical
alert event logs.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"


def _series_ref(ref):
    name, labels = ref
    return name, labels


@dataclass(frozen=True)
class ThresholdRule:
    """Fire when ``series <op> value`` holds continuously for ``for_s``.

    ``series`` is ``(metric_name, labels)``.  A missing series means the
    signal is undefined (e.g. occupancy before the first dispatch) — the rule
    stays inactive rather than firing on an absent denominator.
    """

    name: str
    series: tuple
    op: str
    value: float
    for_s: float = 0.0
    severity: str = "page"

    def __post_init__(self):
        if self.op not in (">", "<"):
            raise ValueError(f"threshold op must be '>' or '<': {self.op!r}")

    def observed(self, registry, now):
        del now
        sname, labels = _series_ref(self.series)
        return registry.latest(sname, labels)

    def condition(self, registry, now):
        v = self.observed(registry, now)
        if v is None:
            return False, None
        hit = v > self.value if self.op == ">" else v < self.value
        return hit, v


@dataclass(frozen=True)
class BurnRateRule:
    """Multi-window multi-burn-rate over a ratio of two counter series.

    ``num`` / ``den`` are ``(metric_name, labels)`` counter references;
    ``budget`` is the error budget as a fraction (0.05 = 5% of events may be
    bad); ``windows`` is a tuple of ``(long_s, short_s, factor)`` pairs.
    Burn over a window W is ``(Δnum/Δden) / budget`` using ring deltas
    clamped to the oldest retained sample.
    """

    name: str
    num: tuple
    den: tuple
    budget: float
    windows: tuple = field(default_factory=tuple)
    for_s: float = 0.0
    severity: str = "page"

    def __post_init__(self):
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1]: {self.budget}")
        if not self.windows:
            raise ValueError("burn-rate rule needs at least one window pair")

    def burn(self, registry, now, window_s: float):
        nname, nlabels = _series_ref(self.num)
        dname, dlabels = _series_ref(self.den)
        dn = registry.window_delta(nname, nlabels, now, window_s)
        dd = registry.window_delta(dname, dlabels, now, window_s)
        if dn is None or dd is None or dd[0] <= 0:
            return None
        return (dn[0] / dd[0]) / self.budget

    def condition(self, registry, now):
        worst = None
        hit = False
        for long_s, short_s, factor in self.windows:
            b_long = self.burn(registry, now, long_s)
            b_short = self.burn(registry, now, short_s)
            if b_long is None or b_short is None:
                continue
            pair = min(b_long, b_short)
            if worst is None or pair > worst:
                worst = pair
            if b_long > factor and b_short > factor:
                hit = True
        return hit, worst


class AlertEngine:
    """Pending→firing→resolved state machine over a rule set.

    ``evaluate(now)`` is called right after each scrape.  Transitions:

    - condition becomes true  → ``pending`` (logged);
    - pending held ``for_s``  → ``firing`` (logged + tracer instant);
    - pending, condition false → ``cancelled`` (back to inactive);
    - firing, condition false → ``resolved`` (logged + tracer instant).

    The event log is a bounded ring; totals survive eviction.
    """

    def __init__(self, registry, rules, *, tracer=None, capacity: int = 1024,
                 host: int | None = None):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self.registry = registry
        self.rules = tuple(rules)
        self.tracer = tracer
        self.host = host
        self.log = deque(maxlen=int(capacity))
        self.events_total = 0
        self.fired = {r.name: 0 for r in self.rules}
        self.resolved = {r.name: 0 for r in self.rules}
        self._state = {r.name: {"state": INACTIVE, "since": None, "value": None}
                       for r in self.rules}

    # --- transitions ---------------------------------------------------------

    def _log(self, now, rule, transition, value):
        event = {"ts": float(now), "rule": rule.name,
                 "transition": transition,
                 "value": None if value is None else float(value)}
        self.log.append(event)
        self.events_total += 1
        if transition == "firing":
            self.fired[rule.name] += 1
        elif transition == "resolved":
            self.resolved[rule.name] += 1
        if self.tracer is not None and transition in ("firing", "resolved"):
            self.tracer.instant(f"alert_{transition}:{rule.name}", now,
                                track="alerts",
                                args={"rule": rule.name,
                                      "severity": rule.severity,
                                      "value": event["value"]})
        return event

    def evaluate(self, now: float) -> list:
        """Evaluate every rule at ``now``; returns this call's transitions."""
        out = []
        for rule in self.rules:
            st = self._state[rule.name]
            hit, value = rule.condition(self.registry, now)
            st["value"] = value
            if st["state"] == INACTIVE:
                if hit:
                    st["state"] = PENDING
                    st["since"] = float(now)
                    out.append(self._log(now, rule, "pending", value))
            if st["state"] == PENDING:
                if not hit:
                    st["state"] = INACTIVE
                    st["since"] = None
                    out.append(self._log(now, rule, "cancelled", value))
                elif now - st["since"] >= rule.for_s:
                    st["state"] = FIRING
                    out.append(self._log(now, rule, "firing", value))
            elif st["state"] == FIRING and not hit:
                st["state"] = INACTIVE
                st["since"] = None
                out.append(self._log(now, rule, "resolved", value))
        return out

    # --- introspection -------------------------------------------------------

    def state(self, rule_name: str) -> str:
        return self._state[rule_name]["state"]

    def snapshot(self) -> dict:
        return {
            "rules": {
                r.name: {
                    "state": self._state[r.name]["state"],
                    "since": self._state[r.name]["since"],
                    "last_value": self._state[r.name]["value"],
                    "severity": r.severity,
                    "fired": self.fired[r.name],
                    "resolved": self.resolved[r.name],
                }
                for r in self.rules
            },
            "events_total": self.events_total,
            "log": list(self.log),
        }


def default_serve_rules(*, max_age_s: float, slo_deadline_s: float | None = None):
    """The stock single-host rule set, scaled off the batcher age trigger.

    - ``slo_burn``: admission SLO-miss rate burn (fast pair pages on hard
      overload, slow pair catches sustained low-grade rejection);
    - ``p99_latency``: request latency ceiling;
    - ``m_occupancy_floor``: the paper's M-axis collapse, live;
    - ``arithmetic_stall_share``: Montgomery-fold stall cycles dominating the
      modeled-cycle budget.
    """
    ma = float(max_age_s)
    lat_ceiling = 5.0 * slo_deadline_s if slo_deadline_s is not None else 50.0 * ma
    return (
        BurnRateRule(
            name="slo_burn",
            num=("repro_admission_slo_miss_total", ()),
            den=("repro_admission_decisions_total", ()),
            budget=0.05,
            windows=((10.0 * ma, 2.5 * ma, 8.0), (40.0 * ma, 10.0 * ma, 2.0)),
        ),
        ThresholdRule(
            name="p99_latency",
            series=("repro_latency_seconds", (("q", "p99"),)),
            op=">", value=lat_ceiling, for_s=2.0 * ma,
        ),
        ThresholdRule(
            name="m_occupancy_floor",
            series=("repro_dispatch_m_occupancy", ()),
            op="<", value=0.02, for_s=20.0 * ma, severity="ticket",
        ),
        ThresholdRule(
            name="arithmetic_stall_share",
            series=("repro_penalty_arithmetic_stall_share", ()),
            op=">", value=0.9, for_s=20.0 * ma, severity="ticket",
        ),
    )


def default_cluster_rules(*, staleness_bound_s: float,
                          shed_budget: float = 0.05):
    """Fleet-level rules: a silent host is a dead host (detection — the
    failover coordinator cordons on the same signal), plus the recovery
    side: ``failover_shed`` burns when the redistribution transient sheds
    more than ``shed_budget`` of cluster ingress (both counters come from
    the coordinator; absent series — no failover layer — keep it inactive).
    """
    bound = float(staleness_bound_s)
    return (
        ThresholdRule(
            name="gossip_silence",
            series=("repro_gossip_silence_seconds_max", ()),
            op=">", value=bound, for_s=0.0,
        ),
        ThresholdRule(
            name="gossip_staleness",
            series=("repro_gossip_used_staleness_seconds_max", ()),
            op=">", value=0.8 * bound, for_s=0.0, severity="ticket",
        ),
        BurnRateRule(
            name="failover_shed",
            num=("repro_cluster_sheds_total", ()),
            den=("repro_cluster_ingress_total", ()),
            budget=shed_budget,
            windows=((8.0 * bound, 2.0 * bound, 2.0),),
        ),
    )


def merge_alert_sections(sections) -> dict:
    """Merge per-host `AlertEngine.snapshot()` dicts for fleet telemetry:
    per-rule fired/resolved totals summed, a census of hosts currently
    firing, and the union event count."""
    sections = [s for s in sections if s]
    if not sections:
        return {}
    rules: dict[str, dict] = {}
    for snap in sections:
        for name, st in snap.get("rules", {}).items():
            agg = rules.setdefault(name, {"fired": 0, "resolved": 0,
                                          "hosts_firing": 0,
                                          "severity": st.get("severity")})
            agg["fired"] += st.get("fired", 0)
            agg["resolved"] += st.get("resolved", 0)
            if st.get("state") == FIRING:
                agg["hosts_firing"] += 1
    return {
        "rules": rules,
        "events_total": sum(s.get("events_total", 0) for s in sections),
        "hosts": len(sections),
    }
