"""The load generator's two loops, driving ``repro_torch.serve.CryptoServer``
on the wall clock.

Every server call gets ``now`` from :func:`clock`.  A request's result is
stamped ``seen`` after the server call in which it resolved returns, which is
when a caller of the server could first hand it on.

* **closed**: ``concurrency`` clients, each sending its next request as soon
  as its last one is answered (a rejected request answers at once).  Requests
  are submitted one per ``submit`` call, as a front end receives them.
* **open**: requests are due on a fixed schedule and submitted when due, or
  as soon after as the loop is free; ``due`` is kept so that latency counts
  any wait a stall imposes on later requests.

Between requests both loops ``pump`` the server whenever its next age
deadline has passed, or whenever launches are in flight.  With ``spans`` set
(a list), each sleep, submit and pump is recorded as ``(label, start_ns,
end_ns)`` on ``time.perf_counter_ns``.

The loop keeps what it learns of request ``i`` in flat lists (times, the
result row) and drops the request and its handle once answered: holding
every handle would grow the interpreter's tracked objects by two a request,
and the garbage collector's full passes over them would stall the server for
the benchmark's sake.
"""
from __future__ import annotations

import math
import time

from repro_torch.core.scheduler.queue import TenantRequest
from repro_torch.serve.server import ResponseHandle

clock = time.perf_counter
SPIN_S = 0.002          # waits shorter than this spin instead of sleeping


class Handle(ResponseHandle):
    """A response handle that reports its own resolution to the loop."""

    def __init__(self, req, now: float, i: int, sink: list):
        super().__init__(req, submitted_at=now)
        self.i = i
        self._sink = sink

    def _resolve(self, value, completed_at: float):
        super()._resolve(value, completed_at)
        self._sink.append(self)


class Loop:
    """The requests of one stream offered to one server.  Request ``i``'s
    ``due``, ``submitted`` and ``seen`` times (``seen`` is NaN until it is
    answered), its ``rows`` (the result) and whether it was ``rejected``."""

    def __init__(self, server, source, workload: str, spans=None):
        self.server = server
        self.source = source
        self.workload = workload
        self.spans = spans
        self.due: list[float] = []
        self.submitted: list[float] = []
        self.seen: list[float] = []
        self.rows: list = []
        self.rejected: list[bool] = []
        self.outstanding = 0
        self._sink: list[Handle] = []

    def __len__(self) -> int:
        return len(self.due)

    @property
    def n_rejected(self) -> int:
        return sum(self.rejected)

    # --- the three host activities ---------------------------------------------

    def _collect(self):
        if self._sink:
            t = clock()
            for h in self._sink:
                self.seen[h.i] = t
                self.rows[h.i] = h._value
            self.outstanding -= len(self._sink)
            self._sink.clear()

    def pump(self):
        t0 = time.perf_counter_ns() if self.spans is not None else 0
        self.server.pump(clock())
        self._collect()
        if self.spans is not None:
            self.spans.append(("pump", t0, time.perf_counter_ns()))

    def submit(self, due: float | None = None):
        t0 = time.perf_counter_ns() if self.spans is not None else 0
        i = len(self.due)
        d, row = self.source.get(i)
        now = clock()
        req = TenantRequest(tenant_id=i, workload=self.workload, degree=d,
                            arrival_time=now, coeffs=row)
        self.due.append(now if due is None else due)
        self.submitted.append(now)
        self.seen.append(math.nan)
        self.rows.append(None)
        h = Handle(req, now, i, self._sink)
        self.server.submit(req, now, handle=h)
        self.rejected.append(h.rejected)
        if not h.rejected:
            self.outstanding += 1
        self._collect()
        if self.spans is not None:
            self.spans.append(("submit", t0, time.perf_counter_ns()))

    def wait_until(self, t: float):
        t0 = time.perf_counter_ns() if self.spans is not None else 0
        while True:
            rem = t - clock()
            if rem <= 0:
                break
            if rem > SPIN_S:
                time.sleep(rem - SPIN_S / 2)
        if self.spans is not None:
            self.spans.append(("sleep", t0, time.perf_counter_ns()))

    # --- the loops ---------------------------------------------------------------

    def closed(self, concurrency: int, until: float):
        """Keep ``concurrency`` requests outstanding until ``until``."""
        while True:
            now = clock()
            if now >= until:
                return
            dl = self.server.next_deadline()
            if dl is not None and dl <= now:
                self.pump()
            elif self.outstanding < concurrency:
                self.submit()
            elif self.server.inflight_groups:
                self.pump()          # gather what an async launch left
            else:
                self.wait_until(until if dl is None else min(dl, until))

    def open(self, due_times):
        """Submit one request at each of ``due_times`` (absolute, on
        :func:`clock`), or as soon after as the loop is free."""
        for due in due_times:
            while True:
                now = clock()
                dl = self.server.next_deadline()
                if dl is not None and dl <= now:
                    self.pump()
                    continue
                if now >= due:
                    break
                if self.server.inflight_groups:
                    self.pump()
                    continue
                self.wait_until(due if dl is None else min(due, dl))
            self.submit(float(due))

    def settle(self, cap_s: float, *, drain: bool):
        """Answer every outstanding request: pump at each age deadline for
        up to ``cap_s``, then, with ``drain``, drain the server."""
        t_cap = clock() + cap_s
        while self.outstanding > 0 and clock() < t_cap:
            dl = self.server.next_deadline()
            if dl is None:
                before = self.outstanding
                self.pump()
                if self.outstanding == before:
                    break
                continue
            self.wait_until(min(dl, t_cap))
            self.pump()
        if drain and self.outstanding > 0:
            self.server.drain(clock())
            self._collect()
