"""Tier 1 — the Rectangular Scheduler (paper §4.1).

Groups same-workload requests into degree buckets, pads each tenant's
``1 × d_i`` vector to the bucket maximum, and stacks ``N_c`` of them into a
dense ``N_c × d̂_max`` operand mapped to the systolic array's M dimension.
Row semantics give cross-tenant arithmetic isolation (Property 5.1); the
packing metrics quantify the paper's Table 5 trade-offs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.scheduler.queue import TenantRequest


@dataclasses.dataclass
class StackedBatch:
    workload: str
    d_bucket: int                    # padded operand degree d̂_max
    requests: list                   # the N_c tenant requests (row order)
    operand: np.ndarray | None       # (N_c, d̂) uint32 (or None if metadata-only)

    @property
    def n_c(self) -> int:
        return len(self.requests)

    @property
    def degrees(self) -> list[int]:
        return [r.degree for r in self.requests]


def bucket_degree(d: int, granularity: int = 64) -> int:
    """Pad degree to the bucket boundary (multiple of `granularity`)."""
    return max(granularity, granularity * math.ceil(d / granularity))


def bucket_pow2(d: int, floor: int = 64) -> int:
    """Power-of-two bucket — every bucket is an NTT-friendly transform size
    for both workload classes (2-adicity: Dilithium ≤ 2^13, BN254 Fr ≤ 2^28).
    Used by the execution path; the granular buckets above are kept for the
    paper's Table-5 packing-metric convention."""
    return max(floor, 1 << (d - 1).bit_length())


def select_bucket(d: int, granularity: int | None = None) -> int:
    """The one bucketing policy shared by offline planning and the online
    batcher: pow2 (execution path) unless a granularity selects the paper's
    Table-5 convention."""
    if granularity is None:
        return bucket_pow2(d)
    return bucket_degree(d, granularity)


@dataclasses.dataclass(frozen=True)
class PackingMetrics:
    batch_fill: float        # Σ d_i / (N_c · d̂)  — active cells per row
    padding_waste: float     # 1 − Σ d_i / (N_c · footprint); footprint =
                             # ⌈d̂/d_max⌉·d_max (paper §7.4: hardware passes
                             # burn full d_max windows — Dilithium d=256 →
                             # 342 footprint → 25% waste)
    staging_overhead: float  # (⌈d̂/d_max⌉ − 1)/⌈d̂/d_max⌉ (re-injection passes)
    m_occupancy: float       # N_c / 128 — M-dimension systolic occupancy
    k_occupancy: float       # in-window K-dimension column occupancy


def packing_metrics(degrees: list[int], d_bucket: int, d_max: int,
                    n_c_max: int = 128) -> PackingMetrics:
    n_c = len(degrees)
    total = n_c * d_bucket
    fill = sum(degrees) / total if total else 0.0
    n_pass = math.ceil(d_bucket / d_max)
    staging = (n_pass - 1) / n_pass
    footprint = n_pass * d_max
    waste = 1.0 - (sum(degrees) / (n_c * footprint)) if n_c else 0.0
    # K occupancy: within active dispatch windows, the fraction of K slots
    # holding non-padded operand cells.  Uniform d == bucket ⇒ 1.0.
    k_occ = fill  # row-stacking makes K-column occupancy == per-row fill
    return PackingMetrics(
        batch_fill=fill, padding_waste=waste, staging_overhead=staging,
        m_occupancy=min(1.0, n_c / n_c_max), k_occupancy=k_occ)


def block_diagonal_zero_fraction(degrees: list[int]) -> float:
    """Structural-zero fraction of the monolithic block-diagonal alternative.

    Stacking N_c polynomials as a (Σd_i) × (Σd_i) block-diagonal operand
    wastes 1 − Σd_i²/(Σd_i)² of the array — the waste Tier 1 eliminates.
    """
    s = sum(degrees)
    if s == 0:
        return 0.0
    return 1.0 - sum(d * d for d in degrees) / (s * s)


def stack_rows(reqs: list, d_bucket: int,
               n_rows: int | None = None) -> np.ndarray | None:
    """Assemble tenant payloads into a dense ``n_rows × d_bucket`` operand.

    Each request's coefficients fill row i up to its degree; the remainder is
    zero padding.  ``n_rows`` > len(reqs) appends all-zero rows so every batch
    of a (workload, bucket) class shares one operand shape — the online
    batcher uses this to keep the co-scheduler's compiled-program cache warm.
    Returns None for metadata-only requests (dry-run / trace replay).
    """
    if not reqs or any(r.coeffs is None for r in reqs):
        return None
    payload = reqs[0].coeffs
    rows = len(reqs) if n_rows is None else max(n_rows, len(reqs))
    shape = (rows, d_bucket) + payload.shape[1:]
    a = np.zeros(shape, np.uint32)
    for i, r in enumerate(reqs):
        a[i, : r.degree] = r.coeffs
    return a


def merge_operands(operands: list[np.ndarray], out: np.ndarray) -> np.ndarray:
    """Concatenate same-class stacked operands along M into ``out``, one
    tall operand (the co-scheduler passes a launch's host operand).

    ``operands`` must share every trailing dimension (same ``(workload,
    d_bucket)`` class guarantees it); the rows of ``out`` below the
    concatenated height are zeroed, which is how the dispatch fast path pads
    a merged super-batch up to its row-ladder rung.  Row semantics
    (Property 5.1) make the merged launch bit-for-bit equal to the
    per-operand launches.
    """
    total = sum(op.shape[0] for op in operands)
    if out.shape[0] < total or out.shape[1:] != operands[0].shape[1:]:
        raise ValueError(f"merge of {total} rows of {operands[0].shape[1:]} "
                         f"into a buffer of shape {out.shape}")
    lo = 0
    for op in operands:
        out[lo:lo + op.shape[0]] = op
        lo += op.shape[0]
    out[lo:] = 0
    return out


class RectangularScheduler:
    """Builds dense stacked operands from a workload-homogeneous queue."""

    def __init__(self, *, n_c: int = 8, bucket_granularity: int | None = None):
        """bucket_granularity=None (default) → power-of-two buckets (always
        NTT-transformable); an int selects the paper's granular buckets
        (metric-compatible with Table 5)."""
        self.n_c = n_c
        self.granularity = bucket_granularity

    def bucket_for(self, d: int) -> int:
        return select_bucket(d, self.granularity)

    def plan_batches(self, requests: list[TenantRequest]) -> list[StackedBatch]:
        """Group by (workload, bucket) and cut into N_c-row stacked batches."""
        groups: dict[tuple, list[TenantRequest]] = {}
        for r in requests:
            key = (r.workload, self.bucket_for(r.degree))
            groups.setdefault(key, []).append(r)
        batches = []
        for (workload, d_bucket), reqs in sorted(groups.items()):
            for lo in range(0, len(reqs), self.n_c):
                chunk = reqs[lo:lo + self.n_c]
                batches.append(StackedBatch(
                    workload=workload, d_bucket=d_bucket, requests=chunk,
                    operand=self._assemble(chunk, d_bucket)))
        return batches

    def _assemble(self, reqs: list[TenantRequest], d_bucket: int):
        return stack_rows(reqs, d_bucket)

    def unstack(self, batch: StackedBatch, result: np.ndarray) -> dict[int, np.ndarray]:
        """Route batched rows back to tenants (isomorphic to isolated eval)."""
        return {r.tenant_id: result[i] for i, r in enumerate(batch.requests)}
