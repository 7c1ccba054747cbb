"""Request-lifecycle tracing: a bounded ring-buffer span/event sink.

One :class:`Tracer` collects every observability event of one host's serving
stack.  Events are plain dicts in a ``deque`` ring buffer (bounded memory; a
full buffer drops the *oldest* events and counts the drops), so the hot path
pays one dict build + append per event and nothing else — no locks, no I/O,
no formatting.  Rendering happens offline in :mod:`repro_torch.obs.export`.

**Clock model.**  The serving stack runs on an explicit clock (virtual trace
seconds in tests/benchmarks, ``time.monotonic`` live), while dispatch is
measured with ``time.perf_counter``.  Every event timestamp lives on the
*serving* clock: lifecycle events pass their ``now`` directly, and wall-clock
emitters (the co-scheduler's launch/gather spans) call :meth:`wall_now`,
which maps ``perf_counter`` through the offset set by :meth:`anchor` at the
enclosing serving event.  Under a virtual clock this anchors real launch
durations at virtual event times — one coherent timeline either way.

**Causal IDs.**  ``next_id()`` hands out monotonically increasing integers
shared by requests, batches, and launches (disjoint by construction), so a
trace can be joined back into submit → batch(roster) → launch → complete
chains; the validator in :mod:`repro_torch.obs.validate` asserts exactly that.

Event phases follow the Chrome ``trace_event`` vocabulary the exporter
targets: ``"i"`` instant, ``"b"``/``"e"`` async span begin/end (async spans
of one category may overlap — requests and depth-k launch rings do),
``"B"``/``"E"`` stack-scoped sync spans, ``"C"`` counter sample.
"""
from __future__ import annotations

import collections
import time

DEFAULT_CAPACITY = 1 << 16

# Host-tagged tracers offset their causal IDs by (host+1)·ID_STRIDE so a
# fleet trace concatenated from per-host buffers never collides request/
# batch/launch IDs across hosts (each host's local sequence stays < stride).
ID_STRIDE = 1 << 40

# Async-span categories with first-class meaning to the exporter/validator.
CAT_REQUEST = "request"
CAT_BATCH = "batch"
CAT_LAUNCH = "launch"


class Tracer:
    """Bounded in-memory event sink for one host's serving stack."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 host: int | None = None):
        if capacity < 1:
            raise ValueError(f"trace capacity must be ≥ 1, got {capacity}")
        self.capacity = capacity
        self.host = host
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._id_base = 0 if host is None else (host + 1) * ID_STRIDE
        self._seq = 0
        self._offset = 0.0

    # --- ids + clock ----------------------------------------------------------

    def next_id(self) -> int:
        """A fresh causal ID (requests, batches, and launches share one
        monotone sequence, so IDs never collide across kinds — and host-
        tagged tracers offset by ID_STRIDE so they never collide across a
        fleet either)."""
        self._seq += 1
        return self._id_base + self._seq

    def anchor(self, now: float):
        """Pin the wall clock to the serving clock: subsequent
        :meth:`wall_now` timestamps are ``perf_counter`` re-based so that the
        instant of this call reads ``now``.  Called once per serving event."""
        self._offset = now - time.perf_counter()

    def wall_now(self) -> float:
        """Current wall instant expressed on the serving clock (see anchor)."""
        return time.perf_counter() + self._offset

    # --- event sinks ----------------------------------------------------------

    # The ring holds flat tuples ``(ph, name, ts, track, cat, id, args)`` —
    # the serving hot path pays one tuple build + deque append per event
    # and nothing else; dict rendering happens offline in event_dicts()
    # (the host tag is per-tracer constant, so it is applied there too).

    def emit(self, ph: str, name: str, ts: float, *, cat: str | None = None,
             id: int | None = None, track: str = "serve",
             args: dict | None = None):
        """Generic sink for the rare phases (sync ``B``/``E`` spans)."""
        if len(self.events) == self.capacity:
            self.dropped += 1       # deque evicts the oldest on append
        self.events.append((ph, name, ts, track, cat, id, args))

    def instant(self, name: str, ts: float, *, track: str = "serve",
                args: dict | None = None):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("i", name, ts, track, None, None, args))

    def begin(self, cat: str, id: int, name: str, ts: float, *,
              track: str = "serve", args: dict | None = None):
        """Async span begin (spans of one category may overlap)."""
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("b", name, ts, track, cat, id, args))

    def end(self, cat: str, id: int, name: str, ts: float, *,
            track: str = "serve", args: dict | None = None):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("e", name, ts, track, cat, id, args))

    def counter(self, name: str, ts: float, value: float, *,
                track: str = "counters"):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("C", name, ts, track, None, None,
                            {"value": value}))

    # --- export surface -------------------------------------------------------

    def _render(self, rec: tuple) -> dict:
        ph, name, ts, track, cat, id, args = rec
        ev = {"ph": ph, "name": name, "ts": ts, "track": track,
              "host": self.host}
        if cat is not None:
            ev["cat"] = cat
        if id is not None:
            ev["id"] = id
        if args:
            ev["args"] = args
        return ev

    def event_dicts(self) -> list[dict]:
        """The buffered events rendered to the dict form the exporter and
        validator consume (offline — never on the serving path)."""
        return [self._render(r) for r in self.events]

    def drain(self) -> list[dict]:
        """Hand the buffered events to the caller and reset the buffer
        (the drop counter survives — it audits the whole run)."""
        out = self.event_dicts()
        self.events.clear()
        return out

    def snapshot(self) -> dict:
        """Ring-buffer audit for the telemetry export."""
        return {"events": len(self.events), "dropped": self.dropped,
                "capacity": self.capacity}
