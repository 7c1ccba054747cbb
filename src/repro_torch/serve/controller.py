"""Adaptive occupancy control: the feedback loop over the dispatch telemetry.

Every knob that decides *when* the continuous batcher closes and *how tall*
the dispatch fast path launches used to be static ``ServeConfig`` values
tuned for one offered load.  The paper's starvation result (M-dimension
occupancy collapsing to 6.25 % at N_c = 8 on v4 while K saturates) makes
those knobs the difference between a starved and a full systolic array — so
when load drifts away from the tuned point, achieved M occupancy collapses
with it.  This module closes the loop:

    dispatch telemetry ──▶ AdaptiveController ──▶ batcher close policy
    (per-launch live rows,      (EWMA per            (target ladder rung,
     queue depth, close       (workload, d_bucket)    max_age, occupancy
     reasons, gossiped         class)                 threshold)
     cluster depth)

**State.**  One :class:`_ClassState` per ``(workload, d_bucket)`` class:
EWMAs of the arrival rate (from inter-arrival gaps), achieved per-launch M
occupancy (live rows / N_c_max — the paper's M-dimension quantity), and
queue depth (local depth folded with the gossiped per-host-equivalent
cluster depth when the host serves inside a fleet).

**Law.**  Three setpoint moves per dispatch observation, all bounded by the
static config values (which remain as initial / floor / ceiling):

* *target rung* — the full-close height is the smallest row-ladder rung that
  the queue model predicts the class can fill within one age window
  (``rate × max_age + backlog``), clamped to ``[n_c, ladder top]``.  Tall
  closes under heavy load are where the recovered M occupancy comes from.
* *age* — starving (occupancy EWMA below target, shallow queue) grows
  ``max_age`` geometrically toward the ceiling: waiting longer is the only
  way to fill rows that have not arrived yet.  A backlog past the target
  rung shrinks it toward the floor: rows are already queued, so closing
  fast *and* tall beats waiting.  At the setpoint the age holds — the
  p50-for-M-fill trade is deliberate and bounded by the ceiling.
* *occupancy threshold* — rides the same branches between its floor and
  ceiling when an occupancy close is configured at all.

**Holdback pricing.**  ``holdback_window_s`` prices the cross-event merge
holdback: a closed-but-short batch may wait for a merge partner for at most
``λ × ETA(partner)`` where the partner ETA is the queue model's time to
assemble another close of the class (``min(max_age, target_rows / rate)``),
*capped by the SLO budget* (``holdback_slo_fraction × slo_deadline − age``)
so a held batch can never breach the admission-visible deadline — the gate
that admitted it priced its wait against the same deadline.  λ = 0 disables
holdback; larger λ trades more p50 for more M fill.

The controller is deliberately dependency-free and clock-explicit: every
entry point takes ``now`` (the serving layer's virtual or wall clock), so
control trajectories are deterministic and unit-testable.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One flight-recorder entry: everything the law saw and everything it
    chose, so "why rung X at t" is machine-answerable from the snapshot.

    ``reason`` is the law branch that moved a setpoint: ``"starving"`` /
    ``"overloaded"`` (the age/occupancy branches) or ``"queue_model"`` (the
    rung re-snap alone, age held).  ``*_from`` are the pre-step setpoints.
    """
    ts: float
    cls: str                      # "{workload}/{d_bucket}"
    reason: str
    rate_hz: float
    m_occupancy_ewma: float
    depth_ewma: float
    queue_depth: int
    cluster_depth: float | None
    predicted_rows: float
    target_rows_from: int
    target_rows: int
    max_age_from_s: float
    max_age_s: float
    occupancy_from: float | None
    occupancy_close: float | None


@dataclasses.dataclass
class _ClassState:
    """Per-(workload, d_bucket) feedback state; all rates in rows/s."""
    rate_hz: float = 0.0            # EWMA arrival rate
    last_arrival: float | None = None
    m_occupancy: float | None = None  # EWMA of per-launch live/N_c_max
    depth: float = 0.0              # EWMA queue depth (cluster-folded)
    target_rows: int = 0            # current full-close height (ladder rung)
    max_age_s: float = 0.0
    occupancy_close: float | None = None
    updates: int = 0                # dispatch observations folded in
    close_reasons: dict = dataclasses.field(default_factory=dict)


class AdaptiveController:
    """Closed-loop setpoints for the continuous batcher + dispatch path.

    The static ``ServeConfig`` values become the *bounds* of the loop:
    ``n_c`` is the target-rung floor and the ladder top its ceiling;
    ``max_age_s`` is the age initial value between ``max_age_floor_s`` and
    ``max_age_ceil_s``; ``occupancy_close`` (when set) moves between
    ``occupancy_floor`` and ``occupancy_ceil``.
    """

    def __init__(self, *, ladder: tuple, n_c: int, max_age_s: float,
                 occupancy_close: float | None = None,
                 n_c_max: int = 128, alpha: float = 0.3,
                 gain: float = 0.25, m_fill_target: float = 0.5,
                 max_age_floor_s: float | None = None,
                 max_age_ceil_s: float | None = None,
                 occupancy_floor: float | None = None,
                 occupancy_ceil: float = 0.95,
                 holdback_lambda: float = 0.0,
                 holdback_slo_fraction: float = 0.5,
                 slo_deadline_s: float | None = None,
                 recorder_capacity: int = 512):
        if not ladder:
            raise ValueError("controller needs a non-empty rung ladder")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        if gain <= 0.0:
            raise ValueError(f"controller gain must be > 0, got {gain}")
        if holdback_lambda < 0.0:
            raise ValueError(f"holdback λ must be ≥ 0, got {holdback_lambda}")
        self.ladder = tuple(ladder)
        self.rung_floor = max(1, min(n_c, self.ladder[-1]))
        self.rung_ceil = self.ladder[-1]
        self.n_c_max = n_c_max
        self.alpha = alpha
        self.gain = gain
        self.m_fill_target = m_fill_target
        self.max_age_init_s = max_age_s
        self.max_age_floor_s = (max_age_floor_s if max_age_floor_s is not None
                                else max_age_s / 4.0)
        ceil = (max_age_ceil_s if max_age_ceil_s is not None
                else max_age_s * 8.0)
        # A held or age-aged batch must stay inside the SLO budget: the age
        # ceiling may never exceed the fraction of the deadline the holdback
        # pricer is allowed to spend.
        if slo_deadline_s is not None:
            ceil = min(ceil, holdback_slo_fraction * slo_deadline_s)
        self.max_age_ceil_s = max(self.max_age_floor_s, ceil)
        self.occupancy_init = occupancy_close
        self.occupancy_floor = (occupancy_floor if occupancy_floor is not None
                                else (occupancy_close / 2.0
                                      if occupancy_close else 0.0))
        self.occupancy_ceil = occupancy_ceil
        self.holdback_lambda = holdback_lambda
        self.holdback_slo_fraction = holdback_slo_fraction
        self.slo_deadline_s = slo_deadline_s
        self._state: dict[tuple, _ClassState] = {}
        self.updates = 0
        self._cluster_depth_max = 0.0
        # Flight recorder: a bounded ring of setpoint-change records plus a
        # lifetime decision count; ``last_decision`` is the record appended
        # by the most recent observe_dispatch, or None if it held.
        self.flight: collections.deque = collections.deque(
            maxlen=max(1, int(recorder_capacity)))
        self.decisions = 0
        self.last_decision: DecisionRecord | None = None

    # --- state access ---------------------------------------------------------

    def _st(self, key: tuple) -> _ClassState:
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _ClassState(
                target_rows=self.rung_floor, max_age_s=self.max_age_init_s,
                occupancy_close=self.occupancy_init)
        return st

    def _snap_rung(self, rows: float) -> int:
        """Smallest ladder rung ≥ rows, clamped to [n_c, ladder top]."""
        for rung in self.ladder:
            if rung >= rows:
                return max(self.rung_floor, rung)
        return self.rung_ceil

    # --- the batcher-facing close policy --------------------------------------

    def target_rows(self, key: tuple) -> int:
        return self._st(key).target_rows

    def max_age_s(self, key: tuple) -> float:
        return self._st(key).max_age_s

    def occupancy_close(self, key: tuple) -> float | None:
        return self._st(key).occupancy_close

    # --- observation sinks ----------------------------------------------------

    def observe_arrival(self, key: tuple, now: float):
        """Fold one arrival into the class's inter-arrival rate EWMA."""
        st = self._st(key)
        if st.last_arrival is not None and now > st.last_arrival:
            inst = 1.0 / (now - st.last_arrival)
            st.rate_hz = (inst if st.rate_hz == 0.0 else
                          (1 - self.alpha) * st.rate_hz + self.alpha * inst)
        st.last_arrival = now

    def observe_close(self, key: tuple, reason: str):
        """Audit which trigger closed each batch (the setpoint's footprint)."""
        st = self._st(key)
        st.close_reasons[reason] = st.close_reasons.get(reason, 0) + 1

    def observe_dispatch(self, key: tuple, *, live_rows: int,
                         queue_depth: int, now: float,
                         cluster_depth: float | None = None):
        """One control step: fold a completed launch into the EWMAs and move
        the class's setpoints (see the module docstring for the law).

        ``now`` timestamps the flight-recorder entry when a setpoint moves;
        the law itself stays event-driven."""
        st = self._st(key)
        prev = (st.target_rows, st.max_age_s, st.occupancy_close)
        a = self.alpha
        m_occ = min(1.0, live_rows / self.n_c_max)
        st.m_occupancy = (m_occ if st.m_occupancy is None else
                          (1 - a) * st.m_occupancy + a * m_occ)
        depth = float(queue_depth)
        if cluster_depth is not None:
            # Gossiped fleet state folds into the *setpoint*, not just the
            # admission gate: a deep cluster queue means merge partners are
            # coming even if this host's local queue looks shallow.  The
            # digest is class-blind (total depth only), so this is a coarse
            # upper bound on the class backlog, never a substitute for it.
            depth = max(depth, float(cluster_depth))
            self._cluster_depth_max = max(self._cluster_depth_max, depth)
        st.depth = (1 - a) * st.depth + a * depth
        # Target rung: what the queue model predicts the class can fill
        # within one age window (arrivals en route + backlog already queued).
        predicted = st.rate_hz * st.max_age_s + st.depth
        st.target_rows = self._snap_rung(predicted)
        starving = (st.m_occupancy < self.m_fill_target
                    and st.depth <= st.target_rows)
        overloaded = st.depth > 2.0 * st.target_rows
        if starving:
            st.max_age_s = min(self.max_age_ceil_s,
                               st.max_age_s * (1.0 + self.gain))
            if st.occupancy_close is not None:
                st.occupancy_close = min(self.occupancy_ceil,
                                         st.occupancy_close * (1.0 + self.gain))
        elif overloaded:
            st.max_age_s = max(self.max_age_floor_s,
                               st.max_age_s * (1.0 - self.gain))
            if st.occupancy_close is not None:
                st.occupancy_close = max(self.occupancy_floor,
                                         st.occupancy_close * (1.0 - self.gain))
        # else: at the setpoint — hold, don't chatter.
        st.updates += 1
        self.updates += 1
        if (st.target_rows, st.max_age_s, st.occupancy_close) != prev:
            reason = ("starving" if starving
                      else "overloaded" if overloaded else "queue_model")
            rec = DecisionRecord(
                ts=float(now), cls=f"{key[0]}/{key[1]}", reason=reason,
                rate_hz=st.rate_hz, m_occupancy_ewma=st.m_occupancy,
                depth_ewma=st.depth, queue_depth=int(queue_depth),
                cluster_depth=(float(cluster_depth)
                               if cluster_depth is not None else None),
                predicted_rows=predicted,
                target_rows_from=prev[0], target_rows=st.target_rows,
                max_age_from_s=prev[1], max_age_s=st.max_age_s,
                occupancy_from=prev[2], occupancy_close=st.occupancy_close)
            self.flight.append(rec)
            self.decisions += 1
            self.last_decision = rec
        else:
            self.last_decision = None

    # --- holdback pricing -----------------------------------------------------

    def holdback_window_s(self, key: tuple, age_s: float) -> float:
        """How long a short closed batch may wait for a merge partner.

        0.0 means "launch now": λ disabled, no rate estimate yet, or the SLO
        budget already spent by the batch's own residency.  Positive values
        are ``min(λ × partner ETA, SLO budget)`` — the λ term prices the
        p50 the class is willing to trade, the budget term guarantees the
        admission-visible deadline survives the wait.
        """
        if self.holdback_lambda <= 0.0:
            return 0.0
        st = self._st(key)
        if st.rate_hz <= 0.0:
            return 0.0
        # Partner ETA: the next close of this class either fills to the
        # target rung (backlog + arrivals at the EWMA rate) or age-closes
        # one inter-arrival gap + one age window from now — whichever the
        # queue model predicts first.
        gap = 1.0 / st.rate_hz
        needed = max(0.0, st.target_rows - st.depth)
        eta = min(needed / st.rate_hz, gap + st.max_age_s)
        if self.slo_deadline_s is not None:
            budget = self.holdback_slo_fraction * self.slo_deadline_s - age_s
        else:
            budget = self.max_age_ceil_s - age_s
        return max(0.0, min(self.holdback_lambda * eta, budget))

    # --- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        classes = {}
        for (workload, d_bucket), st in self._state.items():
            classes[f"{workload}/{d_bucket}"] = {
                "rate_hz": st.rate_hz,
                "m_occupancy_ewma": (st.m_occupancy
                                     if st.m_occupancy is not None else 0.0),
                "depth_ewma": st.depth,
                "target_rows": st.target_rows,
                "max_age_s": st.max_age_s,
                "occupancy_close": st.occupancy_close,
                "updates": st.updates,
                "close_reasons": dict(st.close_reasons),
            }
        return {
            "updates": self.updates,
            "classes": classes,
            "cluster_depth_max": self._cluster_depth_max,
            "flight_recorder": {
                "decisions": self.decisions,
                "capacity": self.flight.maxlen,
                "records": [dataclasses.asdict(r) for r in self.flight],
            },
            "bounds": {
                "rung_floor": self.rung_floor,
                "rung_ceil": self.rung_ceil,
                "max_age_floor_s": self.max_age_floor_s,
                "max_age_init_s": self.max_age_init_s,
                "max_age_ceil_s": self.max_age_ceil_s,
                "occupancy_floor": self.occupancy_floor,
                "occupancy_ceil": self.occupancy_ceil,
                "m_fill_target": self.m_fill_target,
                "holdback_lambda": self.holdback_lambda,
            },
        }
