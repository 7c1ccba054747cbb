"""Synthetic load generation for the online server.

``attach_payloads`` is the single payload synthesiser shared by the offline
replay (``launch/serve.py``) and the online client, so the two paths consume
byte-identical traces.

``LoadGenerator`` replays a trace against a server (anything with
``submit``/``submit_many``/``pump``/``drain``/``next_deadline``, as
:class:`repro_torch.serve.CryptoServer`) on a virtual clock derived from
arrival timestamps: deterministic, immune to host jitter, and able to model
hours of traffic in seconds of wall time.  Pass ``realtime=True`` to pace
submissions with actual sleeps instead.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import rns as R
from repro_torch.core.scheduler.queue import PoissonTrace, TenantRequest


def attach_payloads(trace: list[TenantRequest], *, seed: int = 0,
                    bn_degree_cap: int = 64) -> list[TenantRequest]:
    """Draw coefficient payloads for a trace (one rng stream, arrival order).

    BN254 degrees are capped (CPU-budget rows, matching the offline replay)
    and ingested to ERNS residue form over the 9-channel chain; Dilithium
    rows stay raw u32.  The rng stream is the JAX package's, draw for draw,
    so both packages replay byte-identical traces.  (The JAX function also
    takes ``accum``, which the residues do not depend on.)
    """
    rng = np.random.default_rng(seed)
    chain = R.make_chain(9)
    for r in trace:
        if r.workload == "dilithium":
            r.coeffs = np.asarray(rng.integers(
                0, 8380417, r.degree, dtype=np.uint64), np.uint32)
        else:
            r.degree = min(r.degree, bn_degree_cap)
            vals = np.array([int(x) for x in
                             rng.integers(0, 2**31, r.degree)], object)
            r.coeffs = R.to_rns_np(vals, chain)
    return trace


@dataclasses.dataclass
class LoadResult:
    outputs: dict            # tenant_id -> result rows (numpy).  Trace
                             # tenants are unique per request; if a tenant
                             # submits several requests, this map keeps the
                             # last — `handles` carries every per-request
                             # result.
    handles: list            # every ResponseHandle, submission order
    rejected: list           # (request, AdmissionDecision) pairs
    duration_s: float        # trace horizon (virtual) or wall time (realtime)

    @property
    def n_served(self) -> int:
        return len(self.outputs)


class LoadGenerator:
    def __init__(self, trace, *, seed: int = 0, accum: str = "fp32_mantissa",
                 attach: bool = True):
        # ``accum`` is the JAX generator's keyword, taken so that callers of
        # both packages read alike; the residues do not depend on it.
        del accum
        if isinstance(trace, PoissonTrace):
            trace = trace.generate()
        self.trace = sorted(trace, key=lambda r: r.arrival_time)
        if attach and any(r.coeffs is None for r in self.trace):
            attach_payloads(self.trace, seed=seed)

    @staticmethod
    def _realtime_advance(server, target: float, t_wall0: float,
                          t_virtual0: float) -> float:
        """Wall-clock wait until ``target``, waking for every server age
        deadline on the way so sparse traces still flush on time (pumping
        with the *current* clock, not a stale deadline)."""
        while True:
            now = time.monotonic() - t_wall0 + t_virtual0
            deadline = server.next_deadline()
            wake = target if deadline is None else min(target, deadline)
            if wake > now:
                time.sleep(wake - now)
                now = time.monotonic() - t_wall0 + t_virtual0
            if deadline is not None and deadline <= now:
                server.pump(now)
            if now >= target:
                return now

    def run(self, server, *, realtime: bool = False,
            arrival_batch: int | None = None) -> LoadResult:
        """Closed loop: submit in arrival order, pump age triggers between
        arrivals, drain at end-of-trace, collect per-tenant results.

        ``arrival_batch`` feeds the trace through the server's vectorised
        ``submit_many`` edge in consecutive chunks of that many arrivals
        (each stamped with its own trace timestamp) instead of one
        ``submit`` per request — the ingress shape the columnar admission
        path is built for.  Age deadlines that elapse before a chunk's first
        arrival are pumped first, as in the per-request path.  Virtual-clock
        only (a real-time pacer would defeat the batching)."""
        if arrival_batch is not None and realtime:
            raise ValueError("arrival_batch batches the virtual clock — "
                             "incompatible with realtime pacing")
        handles, rejected = [], []
        t_wall0 = time.monotonic()
        t_virtual0 = self.trace[0].arrival_time if self.trace else 0.0
        if arrival_batch is not None:
            for lo in range(0, len(self.trace), arrival_batch):
                chunk = self.trace[lo:lo + arrival_batch]
                first = chunk[0].arrival_time
                deadline = server.next_deadline()
                while deadline is not None and deadline <= first:
                    server.pump(deadline)
                    deadline = server.next_deadline()
                hs = server.submit_many(
                    chunk, nows=[r.arrival_time for r in chunk])
                handles.extend(hs)
                rejected.extend((r, h.decision)
                                for r, h in zip(chunk, hs) if h.rejected)
            end = self.trace[-1].arrival_time if self.trace else 0.0
            server.drain(end)
            outputs = {h.request.tenant_id: h.result()
                       for h in handles if h.done() and not h.rejected}
            return LoadResult(outputs=outputs, handles=handles,
                              rejected=rejected, duration_s=end - t_virtual0)
        for req in self.trace:
            if realtime:
                now = self._realtime_advance(server, req.arrival_time,
                                             t_wall0, t_virtual0)
            else:
                now = req.arrival_time
                # fire every age deadline that elapsed before this arrival
                deadline = server.next_deadline()
                while deadline is not None and deadline <= now:
                    server.pump(deadline)
                    deadline = server.next_deadline()
            h = server.submit(req, now=now)
            handles.append(h)
            if h.rejected:
                rejected.append((req, h.decision))
        end = (time.monotonic() - t_wall0 + t_virtual0) if realtime else (
            self.trace[-1].arrival_time if self.trace else 0.0)
        server.drain(end)
        outputs = {h.request.tenant_id: h.result()
                   for h in handles if h.done() and not h.rejected}
        return LoadResult(outputs=outputs, handles=handles, rejected=rejected,
                          duration_s=end - t_virtual0)
