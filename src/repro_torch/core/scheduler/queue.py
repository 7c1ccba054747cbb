"""Ingress queue and synthetic multi-tenant arrival traces (paper §7.4)."""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class TenantRequest:
    tenant_id: int
    workload: str            # "dilithium" | "bn254" | ...
    degree: int              # unpadded degree d_i
    arrival_time: float      # seconds since trace start
    coeffs: np.ndarray | None = None   # optional payload (uint32 [d] or [d, C])


@dataclasses.dataclass(frozen=True)
class PoissonTrace:
    """Synthetic arrival trace: Poisson arrivals, workload mixture, degree law.

    Paper §7.4: λ = 4,096 req/s aggregate, 50:50 Dilithium:BN254 balanced
    mixture, degrees uniform in [64, 512].
    """

    rate_hz: float = 4096.0
    duration_s: float = 1.0
    mixture: tuple = (("dilithium", 0.5), ("bn254", 0.5))
    degree_low: int = 64
    degree_high: int = 512
    uniform_degree: int | None = None   # fixed-degree traces (d=256 headline)
    seed: int = 0

    def generate(self) -> list[TenantRequest]:
        rng = np.random.default_rng(self.seed)
        n = rng.poisson(self.rate_hz * self.duration_s)
        times = np.sort(rng.uniform(0.0, self.duration_s, n))
        names = [m[0] for m in self.mixture]
        probs = np.asarray([m[1] for m in self.mixture])
        kinds = rng.choice(len(names), size=n, p=probs / probs.sum())
        if self.uniform_degree is not None:
            degs = np.full(n, self.uniform_degree)
        else:
            degs = rng.integers(self.degree_low, self.degree_high + 1, n)
        return [TenantRequest(tenant_id=i, workload=names[kinds[i]],
                              degree=int(degs[i]), arrival_time=float(times[i]))
                for i in range(n)]


class IngressQueue:
    """Per-workload-class FIFO queues (type-homogeneity segregation, §4.1)."""

    def __init__(self):
        self._queues: dict[str, deque] = {}

    def push(self, req: TenantRequest):
        self._queues.setdefault(req.workload, deque()).append(req)

    def push_trace(self, trace: list[TenantRequest]):
        for r in trace:
            self.push(r)

    def pop_batch(self, workload: str, n_c: int) -> list[TenantRequest]:
        q = self._queues.get(workload)
        if not q:
            return []
        out = []
        while q and len(out) < n_c:
            out.append(q.popleft())
        return out

    def depth(self, workload: str) -> int:
        return len(self._queues.get(workload, ()))

    @property
    def workloads(self) -> list[str]:
        return [k for k, q in self._queues.items() if q]
