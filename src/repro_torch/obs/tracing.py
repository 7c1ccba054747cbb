"""Request-lifecycle tracing: a bounded ring-buffer span/event sink.

One :class:`Tracer` collects every observability event of one host's serving
stack.  Events are flat tuples in a ``deque`` ring buffer (bounded memory; a
full buffer drops the *oldest* events and counts the drops), so the hot path
pays one tuple build + append per event and nothing else — no locks, no I/O,
no formatting.  Rendering happens offline in :mod:`repro_torch.obs.export`.

**Two clocks.**  The serving stack runs on an explicit clock (virtual trace
seconds in tests and replays, ``time.perf_counter`` or ``time.monotonic``
live): the lifecycle events (request, batch and holdback spans, instants,
counters) carry the ``now`` of the serving call that made them.  The host
spans (:meth:`host_begin`/:meth:`host_end`, sync ``B``/``E`` on the
``"host"`` track) and the co-scheduler's ``launch:`` spans are stamped with
``time.perf_counter()`` when they happen, never re-based.  On a wall-clock
server the two are one clock (``time.monotonic`` is the same
``CLOCK_MONOTONIC`` as ``perf_counter`` on Linux), so host spans, launch
spans and lifecycle events line up, and a profiler trace that maps
``perf_counter`` onto its own clock can join them.  Under a virtual clock the
host-clock events keep their own timeline, seconds of ``perf_counter`` far
from the trace's; the exporter keeps them on their own tracks.

**Host spans.**  Each server and co-scheduler step between the layers opens
a host span (``serve.submit``, ``serve.admit``, ``sched.launch``,
``sched.wait``, …) that closes before its caller's does, so they nest LIFO
and a span's self time is its length less its children's.  A span puts the
causal id of its request or launch in the ring's id slot and builds no args.
With no tracer attached, each span site costs one ``is None`` test.

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

# The track of the host spans, and their clock (never re-based).
HOST_TRACK = "host"
clock = time.perf_counter


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

    # --- ids ------------------------------------------------------------------

    def next_id(self) -> int:
        """A fresh causal ID (requests, batches, and launches share one
        monotone sequence, so IDs never collide across kinds — and host-
        tagged tracers offset by ID_STRIDE so they never collide across a
        fleet either)."""
        self._seq += 1
        return self._id_base + self._seq

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

    def host_begin(self, name: str, id: int | None = None):
        """Open a host span, stamped now on :data:`clock`.  Close it with
        :meth:`host_end` before the span that encloses it closes."""
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("B", name, clock(), HOST_TRACK, None, id, None))

    def host_end(self, name: str, id: int | None = None):
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(("E", name, clock(), HOST_TRACK, None, id, None))

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
