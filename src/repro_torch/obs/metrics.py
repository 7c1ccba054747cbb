"""Continuous metrics: bounded time-series rings + OpenMetrics exposition.

The registry is *collector-driven*: the hot path never mutates it.  Producers
(`CryptoServer`, `ClusterServer`) register collector callables that read O(1)
running counters out of `Telemetry` / `PenaltyLedger` / `AdaptiveController` /
`GossipBus`; `maybe_scrape(now)` fires on a fixed serving-clock cadence and
appends one sample per series into a bounded ring.  Because every scrape
timestamp comes off the virtual serving clock and every sampled value is
derived from deterministic state, two identical runs produce bit-identical
series (`ServeConfig.deterministic_timing` removes the one wall-clock leak —
measured dispatch service time — by substituting the penalty-ledger cycle
model).

Exposition uses the OpenMetrics text format in its *backfill* flavour: each
series emits every ringed sample as a ``name{labels} value timestamp`` line
(timestamps are virtual-clock seconds), families carry ``# HELP`` / ``# TYPE``
headers, and the document terminates with ``# EOF``.  That keeps the export a
real parseable format (promtool backfill accepts it) while preserving the
whole ring, not just the latest point.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


Labels = tuple  # tuple[tuple[str, str], ...] — sorted (key, value) pairs

_KINDS = ("counter", "gauge")


@dataclass(frozen=True)
class MetricSpec:
    """Static family metadata: exposition headers + semantics.

    ``wall=True`` marks a series whose values derive from wall-clock
    measurement (excluded from bit-identity checks unless
    ``deterministic_timing`` replaces the measurement with the cycle model).
    """

    name: str
    kind: str = "gauge"
    help_text: str = ""
    wall: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"metric kind must be one of {_KINDS}: {self.kind!r}")


def _canon_labels(labels) -> Labels:
    """Normalise a labels mapping/iterable into a sorted, hashable tuple."""
    if not labels:
        return ()
    if isinstance(labels, dict):
        items = labels.items()
    else:
        items = labels
    return tuple(sorted((str(k), str(v)) for k, v in items))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Deterministic shortest-repr float formatting (bit-identical reruns)."""
    v = float(value)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class MetricsRegistry:
    """Bounded in-memory time-series store scraped on a serving-clock cadence.

    - ``describe(name, ...)`` registers family metadata (idempotent).
    - ``add_collector(fn)`` registers ``fn(now) -> iterable[(name, labels,
      value)]``; collectors run only at scrape time.
    - ``maybe_scrape(now)`` is the hot-path entry: one float compare unless a
      scrape is due.  Scrape timestamps are strictly increasing — a forced
      terminal scrape at an already-sampled instant is a no-op, so drain
      cannot double-sample.
    - Each series is a ``deque(maxlen=capacity)`` of ``(ts, value)``; evicted
      points are counted in ``dropped_points`` so truncation is auditable.
    """

    def __init__(self, *, period_s: float = 0.005, capacity: int = 4096,
                 host: int | None = None):
        if period_s <= 0:
            raise ValueError(f"metrics period_s must be > 0: {period_s}")
        if capacity < 2:
            raise ValueError(f"metrics capacity must be >= 2: {capacity}")
        self.period_s = float(period_s)
        self.capacity = int(capacity)
        self.host = host
        self._specs: dict[str, MetricSpec] = {}
        self._series: dict[tuple[str, Labels], deque] = {}
        self._collectors: list = []
        self._last_scrape: float | None = None
        self.scrapes = 0
        self.dropped_points = 0

    # --- registration --------------------------------------------------------

    def describe(self, name: str, kind: str = "gauge", help_text: str = "",
                 wall: bool = False) -> MetricSpec:
        spec = self._specs.get(name)
        if spec is None:
            spec = MetricSpec(name, kind, help_text, wall)
            self._specs[name] = spec
        return spec

    def add_collector(self, fn) -> None:
        self._collectors.append(fn)

    # --- sampling ------------------------------------------------------------

    def observe(self, name: str, labels, ts: float, value: float) -> None:
        """Low-level append of one sample (scrape internals + synthetic tests)."""
        if name not in self._specs:
            self.describe(name)
        key = (name, _canon_labels(labels))
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = deque(maxlen=self.capacity)
        if len(ring) == ring.maxlen:
            self.dropped_points += 1
        ring.append((float(ts), float(value)))

    def maybe_scrape(self, now: float) -> bool:
        if self._last_scrape is not None and now - self._last_scrape < self.period_s:
            return False
        return self.scrape(now)

    def scrape(self, now: float, *, force: bool = False) -> bool:
        """Run every collector and append one point per emitted series.

        ``force`` bypasses the cadence (used for the terminal drain scrape)
        but never the strictly-increasing-timestamp invariant.
        """
        del force  # cadence is the caller's concern; monotonicity is ours
        if self._last_scrape is not None and now <= self._last_scrape:
            return False
        for fn in self._collectors:
            for name, labels, value in fn(now):
                self.observe(name, labels, now, value)
        self._last_scrape = float(now)
        self.scrapes += 1
        return True

    # --- queries -------------------------------------------------------------

    def series(self, name: str, labels=()) -> list:
        ring = self._series.get((name, _canon_labels(labels)))
        return list(ring) if ring is not None else []

    def series_keys(self) -> list:
        return sorted(self._series.keys())

    def latest(self, name: str, labels=()):
        ring = self._series.get((name, _canon_labels(labels)))
        if not ring:
            return None
        return ring[-1][1]

    def window_delta(self, name: str, labels, now: float, window_s: float):
        """``(dv, dt)`` between the newest sample and the newest sample at or
        before ``now - window_s`` (clamped to the oldest retained point).
        Returns ``None`` with fewer than two samples — burn rates need a
        baseline before they can accuse anyone of burning."""
        ring = self._series.get((name, _canon_labels(labels)))
        if ring is None or len(ring) < 2:
            return None
        ts1, v1 = ring[-1]
        cutoff = now - window_s
        ts0, v0 = ring[0]
        for ts, v in ring:
            if ts > cutoff:
                break
            ts0, v0 = ts, v
        if ts1 <= ts0:
            return None
        return (v1 - v0, ts1 - ts0)

    # --- exposition ----------------------------------------------------------

    def expose_text(self) -> str:
        """Full-ring OpenMetrics text for this registry alone."""
        return expose_registries([self])

    def snapshot(self) -> dict:
        return {
            "period_s": self.period_s,
            "capacity": self.capacity,
            "scrapes": self.scrapes,
            "series": len(self._series),
            "samples": sum(len(r) for r in self._series.values()),
            "dropped_points": self.dropped_points,
            "last_scrape": self._last_scrape,
        }


def expose_registries(registries) -> str:
    """Merge one or more registries into a single OpenMetrics document.

    Families are emitted once (headers from the first registry describing
    them); samples from a registry with ``host`` set gain a ``host`` label so
    a fleet's series stay distinguishable after the merge.  Ends with
    ``# EOF`` per the OpenMetrics spec.
    """
    order: list[str] = []
    specs: dict[str, MetricSpec] = {}
    for reg in registries:
        for name, spec in reg._specs.items():
            if name not in specs:
                specs[name] = spec
                order.append(name)
    lines: list[str] = []
    for name in order:
        spec = specs[name]
        if spec.help_text:
            lines.append(f"# HELP {name} {_escape(spec.help_text)}")
        lines.append(f"# TYPE {name} {spec.kind}")
        for reg in registries:
            for (sname, labels), ring in reg._series.items():
                if sname != name:
                    continue
                full = labels
                if reg.host is not None:
                    full = _canon_labels(labels + (("host", str(reg.host)),))
                if full:
                    label_txt = "{" + ",".join(
                        f'{k}="{_escape(v)}"' for k, v in full) + "}"
                else:
                    label_txt = ""
                for ts, value in ring:
                    lines.append(f"{name}{label_txt} {_fmt(value)} {_fmt(ts)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def serve_metrics_http(registries, port: int, host: str = "127.0.0.1"):
    """Start a daemon-thread HTTP endpoint exposing ``/metrics``.

    Wall-clock (``--realtime``) mode only — the virtual clock has no meaning
    to an external scraper.  Returns the ``HTTPServer``; call ``.shutdown()``
    when the run ends.  Stdlib only, by design.
    """
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    regs = list(registries)

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path.rstrip("/") not in ("", "/metrics".rstrip("/"), "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = expose_registries(regs).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/openmetrics-text; version=1.0.0")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # keep stdout clean
            del args

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
