"""Continuous rectangular batching.

The offline Tier-1 scheduler
(:mod:`repro_torch.core.scheduler.rectangular`) plans
batches from a complete queue snapshot.  Online, requests trickle in, so the
batcher keeps one *open* batch per (workload, degree-bucket) class and closes
it on whichever trigger fires first:

* **full** — N_c rows stacked (M-dimension occupancy target reached);
* **occupancy** — active-cell fraction of the would-be operand crossed the
  configured threshold (useful work dominates padding even with < N_c rows);
* **age** — the oldest row has waited ``max_age_s`` (latency SLO beats
  occupancy once a request has aged);
* **drain** — server shutdown flushes everything.

Closed batches are ordinary :class:`StackedBatch` objects, so Tier-2 dispatch
and the paper's packing metrics apply unchanged.  With ``pad_rows`` (default)
operands are padded with zero rows to the full ``N_c × d̂`` shape so every
batch of a class launches at the same shape; zero rows
transform to zero rows and are never routed back to any tenant.

With ``pad_rows=False`` the batcher emits **mergeable** batches instead:
operands carry live rows only, so the co-scheduler's M-axis super-batching
can stack same-class batches densely (no interior padding rows) and its row
ladder does the shape-stabilising padding once, on the merged operand.  The
serving layer selects this mode automatically when its co-scheduler has a
row ladder.

With a ``controller``
(:class:`repro_torch.serve.controller.AdaptiveController`)
the close policy stops being static: the full trigger fires at the
controller's per-class *target rung* instead of ``n_c``, the age trigger
uses the per-class adapted ``max_age``, and the occupancy threshold (when
configured) is the adapted one — all bounded by the static config values.
``n_c``/``max_age_s``/``occupancy_close`` then act as the loop's initial
values and floors/ceilings rather than as the policy itself.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler.rectangular import (StackedBatch,
                                                     select_bucket,
                                                     stack_rows)

CLOSE_FULL = "full"
CLOSE_AGE = "age"
CLOSE_OCCUPANCY = "occupancy"
CLOSE_DRAIN = "drain"


@dataclasses.dataclass
class _OpenBatch:
    workload: str
    d_bucket: int
    requests: list
    opened_at: float
    sum_degrees: int = 0
    bid: int = 0             # causal batch ID (0 when tracing is off)


@dataclasses.dataclass(frozen=True)
class ClosedBatch:
    batch: StackedBatch
    reason: str
    age_s: float             # oldest-row residency at close time
    batch_id: int = 0        # causal batch ID (0 when tracing is off)


class ContinuousBatcher:
    def __init__(self, *, n_c: int = 8,
                 bucket_granularity: int | None = None,
                 max_age_s: float = 0.01,
                 occupancy_close: float | None = None,
                 pad_rows: bool = True,
                 controller=None, tracer=None):
        self.n_c = n_c
        self.granularity = bucket_granularity
        self.max_age_s = max_age_s
        self.occupancy_close = occupancy_close
        self.pad_rows = pad_rows
        # Optional AdaptiveController: when present, the per-class close
        # policy below asks it for target rows / age / occupancy instead of
        # using the static values (which become the loop's bounds).
        self.controller = controller
        # Optional repro_torch.obs.Tracer: open batches become async "batch" spans
        # whose close event lists the stacked request IDs (the trace's
        # causal middle link — submit → batch roster → launch).
        self.tracer = tracer
        self._open: dict[tuple, _OpenBatch] = {}
        self._depth = 0

    # --- per-class close policy (static or controller-driven) -----------------

    def _target_rows(self, key: tuple) -> int:
        if self.controller is not None:
            return self.controller.target_rows(key)
        return self.n_c

    def _max_age_for(self, key: tuple) -> float:
        if self.controller is not None:
            return self.controller.max_age_s(key)
        return self.max_age_s

    def _occupancy_close_for(self, key: tuple) -> float | None:
        if self.controller is not None:
            return self.controller.occupancy_close(key)
        return self.occupancy_close

    # --- introspection --------------------------------------------------------

    @property
    def depth(self) -> int:
        """Pending (accepted, not yet dispatched) request count."""
        return self._depth

    @property
    def open_batches(self) -> int:
        """Open (workload, bucket) classes awaiting a close trigger."""
        return len(self._open)

    def class_depth(self, key: tuple) -> int:
        """Pending rows of one (workload, d_bucket) class — the per-class
        backlog the adaptive controller's queue model consumes (the global
        ``depth`` would let a busy neighbour class inflate it)."""
        ob = self._open.get(key)
        return len(ob.requests) if ob is not None else 0

    def oldest_age(self, now: float) -> float:
        if not self._open:
            return 0.0
        return max(now - ob.opened_at for ob in self._open.values())

    def bucket_for(self, d: int) -> int:
        return select_bucket(d, self.granularity)

    # --- the three online triggers --------------------------------------------

    def add(self, req, now: float) -> list[ClosedBatch]:
        """Stack one request; return any batch this add closed."""
        key = (req.workload, self.bucket_for(req.degree))
        ob = self._open.get(key)
        tr = self.tracer
        if ob is None:
            ob = self._open[key] = _OpenBatch(
                workload=key[0], d_bucket=key[1], requests=[], opened_at=now)
            if tr is not None:
                ob.bid = tr.next_id()
                tr.begin("batch", ob.bid, f"batch:{key[0]}/d{key[1]}", now,
                         track="batcher",
                         args={"workload": key[0], "d_bucket": key[1]})
        ob.requests.append(req)
        ob.sum_degrees += req.degree
        self._depth += 1
        if self.controller is not None:
            self.controller.observe_arrival(key, now)
        target = self._target_rows(key)
        if len(ob.requests) >= target:
            return [self._close(key, CLOSE_FULL, now)]
        occupancy_close = self._occupancy_close_for(key)
        if occupancy_close is not None:
            occ = ob.sum_degrees / (target * ob.d_bucket)
            if occ >= occupancy_close:
                return [self._close(key, CLOSE_OCCUPANCY, now)]
        return []

    def poll(self, now: float) -> list[ClosedBatch]:
        """Close every open batch whose oldest row has exceeded its class's
        max age (static, or controller-adapted)."""
        # Same float expression as next_deadline(): pumping exactly at the
        # returned deadline must close the batch that produced it.
        due = [key for key, ob in self._open.items()
               if now >= ob.opened_at + self._max_age_for(key)]
        return [self._close(key, CLOSE_AGE, now) for key in due]

    def next_deadline(self) -> float | None:
        """Earliest future instant at which poll() will close something."""
        if not self._open:
            return None
        return min(ob.opened_at + self._max_age_for(key)
                   for key, ob in self._open.items())

    def flush(self, now: float = 0.0) -> list[ClosedBatch]:
        """Close everything (graceful drain)."""
        return [self._close(key, CLOSE_DRAIN, now) for key in list(self._open)]

    def _close(self, key: tuple, reason: str, now: float) -> ClosedBatch:
        ob = self._open.pop(key)
        self._depth -= len(ob.requests)
        if self.controller is not None:
            self.controller.observe_close(key, reason)
        if self.tracer is not None and ob.bid:
            # (bid 0: the batch opened before this tracer was attached.)
            # The close event carries the request-id roster — one list per
            # batch instead of one enqueue instant per request, which is
            # what keeps tracing O(batches) on the per-request hot path.
            self.tracer.end("batch", ob.bid, f"batch:{key[0]}/d{key[1]}",
                            now, track="batcher",
                            args={"reason": reason,
                                  "rows": len(ob.requests),
                                  "rids": [t for r in ob.requests
                                           if (t := getattr(r, "trace_id",
                                                            None))
                                           is not None]})
        operand = stack_rows(ob.requests, ob.d_bucket,
                             n_rows=self.n_c if self.pad_rows else None)
        batch = StackedBatch(workload=ob.workload, d_bucket=ob.d_bucket,
                             requests=ob.requests, operand=operand)
        return ClosedBatch(batch=batch, reason=reason,
                           age_s=max(0.0, now - ob.opened_at),
                           batch_id=ob.bid)
