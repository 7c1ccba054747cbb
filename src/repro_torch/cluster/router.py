"""Tenant ingress routing: rendezvous (HRW) hashing over a live-host set.

Every request enters the cluster through one stateless function: tenant →
host.  Stability matters more than balance here — a tenant must land on the
same host for its whole session so per-tenant state (token buckets, open
batch rows) never splits across hosts, and the mapping must be reproducible
across processes and Python runs (``hash()`` is salted per process; CRC32
is not).  Balance comes from the hash's uniformity; skewed *load* (one hot
tenant) is exactly what the gossip layer and adversarial tenant
distributions are there to expose, not something the router hides.

The router is **rendezvous** (highest-random-weight): each live host gets a
deterministic 64-bit score per tenant and the tenant lands on the argmax.
Unlike the old ``hash % n_hosts`` partition, removing one host from the
live set (``cordon``) remaps *only* that host's tenants — every other
tenant's argmax is untouched — so a host failure migrates the minimum
possible state (property-tested in tests/test_torch_failover.py).
``restore`` is the exact inverse: the pre-cordon mapping returns
bit-for-bit.

``pinned`` overrides the hash per tenant — the operational escape hatch for
isolating a noisy tenant on its own host or co-locating tenants that share
captured programs.  A pin to a cordoned host falls back to the rendezvous
choice over the live set (the pin resumes when the host is restored).
"""
from __future__ import annotations

import zlib

_MASK64 = (1 << 64) - 1
_HOST_SALT = 0x9E3779B97F4A7C15     # golden-ratio odd constant
_KEY_SPREAD = 0x100000001B3         # FNV prime lifts the 32-bit CRC to 64


def stable_tenant_hash(tenant_id) -> int:
    """Process-independent 32-bit hash of a tenant id (int or str)."""
    return zlib.crc32(str(tenant_id).encode("utf-8")) & 0xFFFFFFFF


def _mix64(x: int) -> int:
    """splitmix64/murmur3 finalizer: full-avalanche 64-bit mix, pure int."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _MASK64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _MASK64
    x ^= x >> 33
    return x


def rendezvous_score(tenant_hash: int, host: int) -> int:
    """The HRW weight of ``host`` for a tenant (higher wins)."""
    return _mix64((tenant_hash * _KEY_SPREAD) ^ ((host + 1) * _HOST_SALT))


class TenantHashRouter:
    """Rendezvous-hash partition of tenants onto the live subset of
    ``n_hosts`` host slices."""

    def __init__(self, n_hosts: int,
                 pinned: dict | None = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1 (got {n_hosts})")
        self.n_hosts = n_hosts
        self.pinned = dict(pinned or {})
        for tid, host in self.pinned.items():
            if not 0 <= host < n_hosts:
                raise ValueError(f"pinned tenant {tid!r} -> host {host} "
                                 f"outside [0, {n_hosts})")
        self._live = set(range(n_hosts))

    # --- live-set membership --------------------------------------------------

    @property
    def live_hosts(self) -> tuple:
        return tuple(sorted(self._live))

    def is_live(self, host: int) -> bool:
        return host in self._live

    def cordon(self, host: int) -> bool:
        """Remove ``host`` from the live set (its tenants remap; nobody
        else's do).  Idempotent; refuses to cordon the last live host —
        with no survivor there is nowhere to re-route or replay to."""
        if host not in self._live:
            return False
        if len(self._live) == 1:
            raise RuntimeError(f"cannot cordon host {host}: it is the last "
                               f"live host — no survivor to re-route to")
        self._live.discard(host)
        return True

    def restore(self, host: int) -> bool:
        """Return ``host`` to the live set (exact inverse of ``cordon``:
        the pre-cordon tenant mapping comes back bit-for-bit)."""
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} outside [0, {self.n_hosts})")
        if host in self._live:
            return False
        self._live.add(host)
        return True

    # --- tenant → host --------------------------------------------------------

    def host_for(self, tenant_id) -> int:
        pin = self.pinned.get(tenant_id)
        if pin is not None and pin in self._live:
            return pin
        th = stable_tenant_hash(tenant_id)
        # argmax of the HRW score; ties (2^-64 per pair) break on host id.
        return max(self._live,
                   key=lambda h: (rendezvous_score(th, h), h))

    def choices(self, tenant_id, k: int = 2) -> list[int]:
        """The top-``k`` live hosts by rendezvous order for a tenant —
        ``choices(t)[0] == host_for(t)`` absent a pin, and ``choices(t)[1]``
        is the failover / power-of-two-choices alternate: the host the
        tenant would remap to if its owner were cordoned."""
        th = stable_tenant_hash(tenant_id)
        ranked = sorted(self._live,
                        key=lambda h: (rendezvous_score(th, h), h),
                        reverse=True)
        return ranked[:k]

    def successor(self, dead_host: int) -> int:
        """The live host designated (by rendezvous order on the *host* id)
        to coordinate recovery of ``dead_host`` — deterministic fleet-wide
        without any election round."""
        key = stable_tenant_hash(f"host:{dead_host}")
        live = self._live - {dead_host}
        if not live:
            raise RuntimeError(f"no live successor for host {dead_host}")
        return max(live, key=lambda h: (rendezvous_score(key, h), h))

    def partition(self, tenant_ids) -> dict[int, list]:
        """Group tenant ids by destination host (diagnostics / benchmarks)."""
        out: dict[int, list] = {h: [] for h in range(self.n_hosts)}
        for tid in tenant_ids:
            out[self.host_for(tid)].append(tid)
        return out
