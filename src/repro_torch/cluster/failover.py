"""Host-failure recovery: deterministic fault injection, cordon, replay.

The cluster layer could *sense* a dead host (``GossipBus.silence_s`` + the
``gossip_silence`` alert); this module makes the fleet *survive* one, with
every step driven by the same virtual clock as the servers so chaos runs
are bit-reproducible:

* :class:`FaultPlan` — scripted ``kill`` / ``pause`` / ``recover`` events
  per host, parsed from ``kill@T:hN,recover@T:hN,...`` specs and applied on
  the ``ClusterServer._tick`` edge (an event is never applied twice, and
  two runs of the same plan on the same trace produce identical fleets);
* :class:`IntakeJournal` — the per-host append-only record of
  admitted-but-undispatched requests (request id, tenant, payload ref,
  admission decision).  The journal is the durability boundary: host RAM
  (open batches, launch rings) dies with the host, the journal does not;
* :class:`FailoverCoordinator` — the control loop: routes ingress around
  known-dead hosts (a limbo retry queue models the LB's failed connection),
  cordons a host when its gossip silence crosses the staleness bound,
  rescues completed-but-ungathered results from the dead host's launch
  rings, **replays** its journal's still-pending entries onto the
  survivors chosen by rendezvous order (idempotently — request-id dedup at
  ``CryptoServer.submit`` edges makes double-delivery harmless), and sheds
  load during the redistribution transient via watermark-gated
  power-of-two-choices on the gossip digest, bounded by tenant stickiness.

Failure semantics, precisely:

* ``kill``  — the host process dies: it stops publishing digests, stops
  serving, and loses all in-memory state.  Its journal and its gather ring
  (device-side results of already-launched groups) survive and are
  recovered at cordon; on ``recover`` the host rejoins empty.
* ``pause`` — a gossip-plane partition only: the host stops publishing but
  keeps serving the requests it holds.  Silence still crosses the bound,
  so the fleet cordons it (new arrivals re-route), but nothing is replayed
  — its in-flight work completes locally and ``recover`` rejoins it with
  state intact.
* ``recover`` — the host publishes a fresh digest immediately (the rejoin
  announce — this is what resolves the ``gossip_silence`` alert) and
  returns to the router's live set.

Exactly-once: every admitted request either completes on its original host
(possibly rescued from the gather ring) or is replayed exactly once onto a
survivor; request-id dedup rejects any second delivery.  The chaos parity
suite (tests/test_torch_failover.py) proves per-tenant results after a
kill/recover run bit-for-bit equal to the no-failure replay.
"""
from __future__ import annotations

import dataclasses
import math
import re

from repro_torch.serve.admission import AdmissionDecision

KILL, PAUSE, RECOVER = "kill", "pause", "recover"
SERVING, DEAD, PAUSED = "serving", "dead", "paused"

_EVENT_RE = re.compile(
    r"^(kill|pause|recover)@([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?):h([0-9]+)$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: apply ``kind`` to ``host`` at virtual time ``t``."""
    t: float
    kind: str
    host: int

    def __post_init__(self):
        if self.kind not in (KILL, PAUSE, RECOVER):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0 (got {self.t})")
        if self.host < 0:
            raise ValueError(f"fault host must be >= 0 (got {self.host})")

    def spec(self) -> str:
        return f"{self.kind}@{self.t:g}:h{self.host}"


class FaultPlan:
    """An ordered, consumed-once script of :class:`FaultEvent`.

    ``due`` pops every event whose time has arrived; the coordinator calls
    it on each tick, so event application is as deterministic as the tick
    stream itself.  CLI specs carry times as *fractions of the run
    duration* (``kill@0.5:h1`` = mid-run) and are materialised with
    :meth:`scaled`; programmatic plans use absolute virtual-clock seconds
    directly.
    """

    def __init__(self, events):
        events = list(events)
        for ev in events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {ev!r}")
        # Stable sort: same-instant events keep author order (a kill
        # scripted before a recover at the same t applies first).
        self.events = tuple(sorted(events, key=lambda e: e.t))
        self._next = 0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``kill@T:hN,recover@T:hN,pause@T:hN`` (comma-separated)."""
        events = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad fault spec {part!r} — expected "
                    f"kill@T:hN / pause@T:hN / recover@T:hN")
            events.append(FaultEvent(t=float(m.group(2)), kind=m.group(1),
                                     host=int(m.group(3))))
        return cls(events)

    def scaled(self, duration_s: float) -> "FaultPlan":
        """Fraction-of-duration times → absolute virtual-clock seconds."""
        if duration_s <= 0:
            raise ValueError(f"duration must be > 0 (got {duration_s})")
        return FaultPlan([FaultEvent(t=e.t * float(duration_s), kind=e.kind,
                                     host=e.host) for e in self.events])

    def due(self, now: float, *, inclusive: bool = True):
        """Pop every unapplied event with ``t <= now`` (``t < now`` when
        ``inclusive`` is False — the drain barrier uses the exclusive form
        so an event scripted at exactly the drain instant lands *mid*
        barrier, after quiesce)."""
        out = []
        while self._next < len(self.events):
            ev = self.events[self._next]
            if ev.t <= now if inclusive else ev.t < now:
                out.append(ev)
                self._next += 1
            else:
                break
        return out

    @property
    def remaining(self) -> int:
        return len(self.events) - self._next

    def __len__(self) -> int:
        return len(self.events)

    def describe(self) -> str:
        return ",".join(e.spec() for e in self.events)


@dataclasses.dataclass
class JournalEntry:
    """One admitted-but-possibly-undispatched request, durably recorded."""
    rid: int                 # fleet-unique request id (dedup key)
    tenant_id: object
    request: object          # payload ref (the TenantRequest itself)
    handle: object           # the caller's ResponseHandle — done() == safe
    reason: str              # admission decision that let it in ("ok")
    recorded_at: float
    replayed: bool = False


class IntakeJournal:
    """Per-host append-only intake journal.

    An entry is *pending* while its handle is unresolved and it has not
    been replayed elsewhere; the pending set is exactly what a survivor
    must replay when this host dies.  ``compact`` drops settled entries so
    a long-lived host's journal stays O(pending), called on the gossip
    publish edge (the same cadence real journals checkpoint at).
    """

    def __init__(self, host: int):
        self.host = host
        self.entries: list[JournalEntry] = []
        self.recorded = 0
        self.compacted = 0

    def record(self, rid: int, tenant_id, request, handle, reason: str,
               recorded_at: float) -> JournalEntry:
        e = JournalEntry(rid=rid, tenant_id=tenant_id, request=request,
                         handle=handle, reason=reason,
                         recorded_at=recorded_at)
        self.entries.append(e)
        self.recorded += 1
        return e

    def pending(self) -> list[JournalEntry]:
        return [e for e in self.entries
                if not e.replayed and not e.handle.done()]

    def pending_tenants(self) -> set:
        """Tenants with live intake here — the stickiness bound: shedding
        never diverts a tenant whose rows are already on this host."""
        return {e.tenant_id for e in self.entries
                if not e.replayed and not e.handle.done()}

    def compact(self):
        settled = [e for e in self.entries
                   if e.replayed or e.handle.done()]
        if len(settled) > 64:
            self.compacted += len(settled)
            self.entries = [e for e in self.entries
                            if not (e.replayed or e.handle.done())]

    def snapshot(self) -> dict:
        return {"host": self.host, "recorded": self.recorded,
                "pending": len(self.pending()),
                "compacted": self.compacted}


class FailoverCoordinator:
    """The fleet's failure-handling control loop (owned by ClusterServer).

    State machine per host: ``serving`` → (``kill``|``pause``) →
    cordoned-on-silence → (``recover``) → ``serving``.  Detection is
    signal-driven — a host is cordoned because its *gossip silence* crossed
    the staleness bound, never because the coordinator peeked at the fault
    plan — so the same code path handles scripted chaos and (in a real
    deployment) genuine silence.
    """

    def __init__(self, cluster, plan: FaultPlan | None = None, *,
                 shed_watermark: float | None = None,
                 shed_transient_s: float | None = None):
        self.cluster = cluster
        self.plan = plan
        n = len(cluster.hosts)
        self.state = {h: SERVING for h in range(n)}
        self.cordoned: set[int] = set()
        self.journals = [IntakeJournal(h) for h in range(n)]
        # (destination host, request, handle): submissions routed to a host
        # that is dead but not yet cordoned — the LB's connection failed and
        # the request sits in its retry queue until cordon re-routes it.
        self.limbo: list[tuple] = []
        self.events: list[dict] = []
        self.shed_watermark = shed_watermark
        bound = cluster.gossip.staleness_bound_s
        self.shed_transient_s = (float(shed_transient_s)
                                 if shed_transient_s is not None
                                 else 2.0 * bound)
        self._transient_until = -math.inf
        self._next_rid = 0
        # fleet counters (exported as cluster metrics + snapshot)
        self.ingress = 0
        self.sheds = 0
        self.diverted = 0
        self.replayed = 0
        self.recovered = 0
        self.deduped = 0
        self.limbo_delivered = 0

    # --- request tagging ------------------------------------------------------

    def tag(self, req):
        """Assign a fleet-unique, monotone request id at ingress (the
        journal/replay dedup key).  A caller-supplied ``request_id`` (e.g.
        an LB retry of the same request object) is preserved."""
        self.ingress += 1
        if getattr(req, "request_id", None) is None:
            req.request_id = self._next_rid
            self._next_rid += 1

    # --- fault plan -----------------------------------------------------------

    def apply_due(self, now: float, *, inclusive: bool = True):
        if self.plan is None:
            return
        for ev in self.plan.due(now, inclusive=inclusive):
            getattr(self, ev.kind)(ev.host, now)

    def kill(self, host: int, now: float):
        """Host process death: publishing stops, serving stops, RAM is
        gone.  Detection and recovery happen later, via silence."""
        if self.state[host] == DEAD:
            return
        self.state[host] = DEAD
        self._event(now, KILL, host)

    def pause(self, host: int, now: float):
        """Gossip-plane partition: the host keeps serving but goes silent."""
        if self.state[host] != SERVING:
            return
        self.state[host] = PAUSED
        self._event(now, PAUSE, host)

    def recover(self, host: int, now: float):
        """Rejoin: publish immediately (resolving the silence alert) and
        return to the live set.  A killed host that somehow recovers before
        the fleet cordoned it is cordoned first — its RAM is gone either
        way, so its journal must be replayed before it serves again."""
        was = self.state[host]
        if was == DEAD and host not in self.cordoned:
            self._cordon(host, now, cause="recover_probe")
        self.state[host] = SERVING
        srv = self.cluster.hosts[host]
        self.cluster.gossip.publish(host, srv.pending_load, now,
                                    open_batches=srv.batcher.open_batches)
        if host in self.cordoned:
            self.cluster.router.restore(host)
            self.cordoned.discard(host)
        self._event(now, RECOVER, host, was=was)

    # --- sensing & cordon -----------------------------------------------------

    def publishing(self, host: int) -> bool:
        return self.state[host] == SERVING

    def serving(self, host: int) -> bool:
        """Data-plane liveness: a paused host still computes and answers."""
        return self.state[host] != DEAD

    def sense(self, now: float):
        """Silence-driven cordon: any host whose publish silence exceeds
        the gossip staleness bound is cut from the router's live set.
        This is the *only* trigger on the normal serving path — the
        coordinator never consults its own fault knowledge to detect."""
        bound = self.cluster.gossip.staleness_bound_s
        for hid, age in self.cluster.gossip.silence_s(now).items():
            if age > bound and hid not in self.cordoned:
                self._cordon(hid, now, cause="gossip_silence")

    def cordon_dead(self, now: float, cause: str = "drain_probe"):
        """Force-cordon every dead-but-uncordoned host — the drain barrier
        uses this: its flush RPC fails fast (connection refused), a
        stronger failure signal than waiting out gossip silence."""
        for host, st in self.state.items():
            if st == DEAD and host not in self.cordoned:
                self._cordon(host, now, cause=cause)

    def _cordon(self, host: int, now: float, cause: str):
        cluster = self.cluster
        cluster.router.cordon(host)
        self.cordoned.add(host)
        tr = cluster.tracer
        silence = cluster.gossip.silence_s(now).get(host, 0.0)
        if tr is not None:
            tr.emit("B", f"failover:h{host}", now, track="failover",
                    args={"cause": cause, "silence_s": silence})
        recovered = replayed = deduped = delivered = 0
        mode = "reroute_only"
        if self.state[host] == DEAD:
            mode = "replay"
            srv = cluster.hosts[host]
            # 1. Gather-ring rescue: results of groups the host launched
            #    before dying are materialised, not recomputed — their
            #    handles resolve and their journal entries read as settled.
            recovered = srv.recover_inflight(now)
            self.recovered += recovered
            # 2. Reboot the dead slice (closes its dangling trace spans and
            #    drops its RAM) *before* replay re-tags the requests with
            #    survivor-side trace ids.
            srv.reset_after_failure(now)
            # 3. Replay the journal's pending entries onto the post-cordon
            #    owners.  Dedup at the submit edge makes this idempotent.
            replayed, deduped = self._replay(host, now)
            # 4. Deliver the LB's limbo queue for this host: never-admitted
            #    requests re-route through normal admission on the owner.
            delivered = self._deliver_limbo(host, now)
            # 5. Price the transient: the detection window is time the dead
            #    host's intake sat unserved — host-gap cycles on the
            #    rendezvous successor's ledger (it runs the recovery).
            successor = cluster.router.successor(host)
            cluster.hosts[successor].ledger.observe_host_gap(
                f"failover:h{host}", silence)
            self._transient_until = max(self._transient_until,
                                        now + self.shed_transient_s)
        if tr is not None:
            tr.emit("E", f"failover:h{host}", now, track="failover",
                    args={"mode": mode, "recovered": recovered,
                          "replayed": replayed, "deduped": deduped,
                          "limbo_delivered": delivered})
        # Forensics for device-parallel fleets: which device slice the dead
        # host's in-flight results lived on (torch device strings).  The
        # gather-ring rescue above works regardless — each flight's pinned
        # host buffer is read only after its CUDA event — but post-mortems
        # need the pin to reason about what the rescue actually pulled
        # across.
        self._event(now, "cordon", host, cause=cause, mode=mode,
                    recovered=recovered, replayed=replayed,
                    deduped=deduped, limbo_delivered=delivered,
                    silence_s=silence,
                    device_ids=list(cluster.hosts[host].cos.device_ids()))

    def _replay(self, host: int, now: float) -> tuple[int, int]:
        cluster = self.cluster
        pending = self.journals[host].pending()
        by_target: dict[int, list[JournalEntry]] = {}
        for e in pending:
            by_target.setdefault(cluster.router.host_for(e.tenant_id),
                                 []).append(e)
        replayed = deduped = 0
        for target, entries in sorted(by_target.items()):
            n_ok, n_dup = cluster.hosts[target].replay_admitted(
                [(e.request, e.handle) for e in entries], now)
            replayed += n_ok
            deduped += n_dup
            for e in entries:
                e.replayed = True
                # Re-journal on the new owner: a later failure of the
                # survivor replays these again (cascade-safe).
                self.journals[target].record(
                    rid=e.rid, tenant_id=e.tenant_id, request=e.request,
                    handle=e.handle, reason=e.reason, recorded_at=now)
        self.replayed += replayed
        self.deduped += deduped
        return replayed, deduped

    def _deliver_limbo(self, host: int, now: float) -> int:
        mine = [(r, h) for d, r, h in self.limbo if d == host]
        self.limbo = [(d, r, h) for d, r, h in self.limbo if d != host]
        for req, handle in mine:
            self.cluster._submit_routed(req, now, handle=handle)
        self.limbo_delivered += len(mine)
        return len(mine)

    # --- ingress routing ------------------------------------------------------

    def route(self, req, now: float):
        """Route one tagged request: ``("host", h, None)`` to submit,
        ``("limbo", h, None)`` to park (owner dead, cordon pending), or
        ``("shed", owner, decision)`` to reject under the transient
        watermark."""
        router = self.cluster.router
        owner = router.host_for(req.tenant_id)
        if self.state[owner] == DEAD:
            return ("limbo", owner, None)
        if self.shed_watermark is not None and now < self._transient_until:
            return self._shed_or_divert(req, owner, now)
        return ("host", owner, None)

    def _depth(self, host: int, now: float) -> float:
        """Power-of-two-choices depth signal: the gossip digest (what a
        real LB would hold), live pending_load when no digest survives."""
        dig = self.cluster.gossip._digests.get(host)
        if dig is not None:
            return float(dig.queue_depth)
        return float(self.cluster.hosts[host].pending_load)

    def _shed_or_divert(self, req, owner: int, now: float):
        wm_rows = self.shed_watermark * self.cluster.config.serve.max_pending
        if self._depth(owner, now) < wm_rows:
            return ("host", owner, None)
        decision = AdmissionDecision(
            False, "shed",
            retry_after_s=max(0.0, self._transient_until - now))
        # Stickiness bound: a tenant with rows already on the owner (or a
        # pin) must not split across hosts mid-transient — shed instead.
        sticky = (req.tenant_id in self.cluster.router.pinned
                  or req.tenant_id in
                  self.journals[owner].pending_tenants())
        if sticky:
            return ("shed", owner, decision)
        alt = self.cluster.router.choices(req.tenant_id, k=2)
        if len(alt) < 2:
            return ("shed", owner, decision)
        second = alt[1] if alt[0] == owner else alt[0]
        if not self.serving(second):
            return ("shed", owner, decision)
        # Power-of-two-choices: least-loaded of {owner, rendezvous
        # alternate}, still bounded by the watermark.
        if self._depth(second, now) >= wm_rows:
            return ("shed", owner, decision)
        self.diverted += 1
        return ("host", second, None)

    def hold_limbo(self, host: int, req, handle):
        self.limbo.append((host, req, handle))

    def note_shed(self, owner: int, req, now: float):
        self.sheds += 1
        srv = self.cluster.hosts[owner]
        srv.telemetry.record_admission("shed")
        if srv.tracer is not None:
            srv.tracer.instant("reject", now,
                               args={"workload": req.workload,
                                     "reason": "shed"})

    # --- drain-time audit -----------------------------------------------------

    def lost(self) -> int:
        """Requests neither settled nor recoverable — must be 0 always:
        limbo entries are delivered at cordon and every journal entry is
        settled or replayed."""
        n = len(self.limbo)
        for host, st in self.state.items():
            if st == DEAD:
                n += len(self.journals[host].pending())
        return n

    # --- audit ----------------------------------------------------------------

    def _event(self, now: float, kind: str, host: int, **details):
        ev = {"t": float(now), "kind": kind, "host": int(host), **details}
        self.events.append(ev)
        tr = self.cluster.tracer
        if tr is not None and kind in (KILL, PAUSE, RECOVER):
            tr.instant(f"fault:{kind}", now, track="failover",
                       args={"host": host})
        return ev

    def snapshot(self) -> dict:
        from repro_torch.cluster.telemetry import summarize_failover
        return {
            "events": list(self.events),
            "summary": summarize_failover(self.events),
            "host_states": {h: s for h, s in sorted(self.state.items())},
            "cordoned": sorted(self.cordoned),
            "journals": [j.snapshot() for j in self.journals],
            "ingress": self.ingress,
            "sheds": self.sheds,
            "diverted": self.diverted,
            "replayed": self.replayed,
            "recovered": self.recovered,
            "deduped": self.deduped,
            "limbo_delivered": self.limbo_delivered,
            "limbo_pending": len(self.limbo),
            "lost": self.lost(),
            "transient_until": (None if self._transient_until == -math.inf
                                else self._transient_until),
        }
