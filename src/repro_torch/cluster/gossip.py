"""Queue-depth gossip with explicitly bounded staleness.

Hosts cannot see each other's queues synchronously — in a real pod each
admission decision would need a cross-host RPC on the critical path.  The
standard fix is gossip: each host periodically publishes a tiny digest
(queue depth, open batches) and every peer keeps the last digest it saw.
Admission then runs on *bounded-staleness* cluster state: a digest is
usable only while ``now - published_at <= period_s × staleness_factor``;
older digests are dropped (and counted), never silently trusted.  The bound
is the contract the acceptance test checks — no admission decision may
consume a digest older than twice the gossip period under the default
factor.

The bus is an in-process simulation of that exchange, driven by the same
virtual clock as the servers, so every staleness scenario (a host that
stops publishing, a clock jump past the bound) is deterministic and
testable on one machine.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HostDigest:
    """What one host tells the fleet about itself — deliberately tiny."""
    host_id: int
    queue_depth: int         # pending (admitted, undispatched) requests
    open_batches: int        # open (workload, bucket) rows awaiting close
    published_at: float      # virtual-clock publish instant


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """Merged picture one host sees at a decision instant.

    ``local`` is always live (a host knows its own queue exactly); peers
    contribute their last *fresh* digest.  ``per_host_equiv`` is the
    mean-field depth the admission SLO gate consumes: total known depth
    averaged over the hosts that contributed, i.e. "if the cluster drained
    evenly, how deep is the queue in front of this request".
    """
    host_id: int
    local_depth: int
    peer_depth: int          # Σ fresh peers' digested depth
    contributing_hosts: int  # self + fresh peers
    stale_dropped: int       # peers whose digest aged past the bound
    max_staleness_s: float   # oldest digest actually used (0 if peers empty)

    @property
    def total_depth(self) -> int:
        return self.local_depth + self.peer_depth

    @property
    def per_host_equiv(self) -> float:
        return self.total_depth / max(1, self.contributing_hosts)


class GossipBus:
    """Periodic digest exchange between the hosts of one cluster."""

    def __init__(self, n_hosts: int, *, period_s: float = 0.002,
                 staleness_factor: float = 2.0):
        if period_s <= 0:
            raise ValueError(f"gossip period must be > 0 (got {period_s})")
        self.n_hosts = n_hosts
        self.period_s = float(period_s)
        self.staleness_factor = float(staleness_factor)
        self._digests: dict[int, HostDigest] = {}
        self._last_pub: dict[int, float] = {}
        # audit counters (exported into the cluster telemetry snapshot)
        self.publishes = 0
        self.views = 0
        self.stale_drops = 0
        self.pruned_digests = 0
        self.revives = 0    # publishes by a host whose digest had been pruned
        self._used_staleness_max = 0.0
        self._used_staleness_sum = 0.0
        self._used_staleness_n = 0

    @property
    def staleness_bound_s(self) -> float:
        """Max digest age any decision may consume (period × factor)."""
        return self.period_s * self.staleness_factor

    # --- publish side ---------------------------------------------------------

    def due(self, host_id: int, now: float) -> bool:
        last = self._last_pub.get(host_id)
        return last is None or now - last >= self.period_s

    def publish(self, host_id: int, queue_depth: int, now: float,
                open_batches: int = 0):
        if host_id in self._last_pub and host_id not in self._digests:
            # A host that had been pruned as dead is publishing again — the
            # rejoin audit the failover recover path asserts on.
            self.revives += 1
        self._digests[host_id] = HostDigest(
            host_id=host_id, queue_depth=int(queue_depth),
            open_batches=int(open_batches), published_at=now)
        self._last_pub[host_id] = now
        self.publishes += 1

    def maybe_publish(self, host_id: int, queue_depth: int, now: float,
                      open_batches: int = 0) -> bool:
        if not self.due(host_id, now):
            return False
        self.publish(host_id, queue_depth, now, open_batches)
        return True

    # --- read side ------------------------------------------------------------

    def cluster_view(self, host_id: int, local_depth: int,
                     now: float) -> ClusterView:
        """Bounded-staleness merge at one decision instant.

        Digests older than ``staleness_bound_s`` are dropped here, at read
        time — dropping at publish time would not catch a peer that simply
        went quiet.  The staleness of every digest actually consumed is
        recorded so telemetry can prove the bound was honored.

        A digest that ages past the bound is *pruned* on the view that first
        drops it: a departed host costs one ``stale_drops`` count total, not
        one per view forever, and the merge scan stays O(live hosts).  A
        pruned host that comes back simply publishes a fresh digest."""
        bound = self.staleness_bound_s
        peer_depth, used, dropped = 0, 0.0, 0
        contributing = 1
        dead = []
        for hid, dig in self._digests.items():
            if hid == host_id:
                continue                     # own queue is read live
            age = now - dig.published_at
            if age > bound:
                dropped += 1
                dead.append(hid)
                continue
            peer_depth += dig.queue_depth
            contributing += 1
            used = max(used, age)
        for hid in dead:
            del self._digests[hid]
        self.pruned_digests += len(dead)
        self.views += 1
        self.stale_drops += dropped
        self._used_staleness_max = max(self._used_staleness_max, used)
        self._used_staleness_sum += used
        self._used_staleness_n += 1
        return ClusterView(host_id=host_id, local_depth=local_depth,
                           peer_depth=peer_depth,
                           contributing_hosts=contributing,
                           stale_dropped=dropped, max_staleness_s=used)

    def silence_s(self, now: float) -> dict[int, float]:
        """Per-host publish silence: ``now - last publish`` for every host
        that has ever published.  The dead-host sensing signal — a host
        whose silence exceeds ``staleness_bound_s`` has no usable digest
        anywhere in the fleet; the failover coordinator cordons on exactly
        this threshold.

        Contract with ``cluster_view``'s pruning: pruning removes a dead
        host's *digest* (``_digests``) only, never its ``_last_pub`` entry,
        so silence keeps growing after the prune and the ``gossip_silence``
        alert stays firing until an actual republish — a cordoned host must
        not read as healthy just because its stale digest was garbage-
        collected (regression-tested in tests/test_torch_cluster.py)."""
        return {hid: max(0.0, now - last)
                for hid, last in self._last_pub.items()}

    # --- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        n = self._used_staleness_n
        return {
            "period_s": self.period_s,
            "staleness_bound_s": self.staleness_bound_s,
            "publishes": self.publishes,
            "views": self.views,
            "stale_drops": self.stale_drops,
            "pruned_digests": self.pruned_digests,
            "revives": self.revives,
            "used_staleness_max_s": self._used_staleness_max,
            "used_staleness_mean_s": (self._used_staleness_sum / n) if n
                                     else 0.0,
        }
