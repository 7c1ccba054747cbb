"""Aegis two-tier scheduling (paper §4), PyTorch port.

Tier 1 — :mod:`rectangular`: degree-bucketed dense row-stacking of tenant
polynomials into ``N_c × d̂_max`` operands, with the paper's packing metrics.

Tier 2 — :mod:`coscheduler`: dispatch of workload-homogeneous batches onto
device groups (Dilithium next to BN254).

:mod:`queue` — ingress queue + Poisson trace synthesis (paper §7.4).
"""
from repro_torch.core.scheduler.queue import TenantRequest, PoissonTrace, IngressQueue
from repro_torch.core.scheduler.rectangular import (RectangularScheduler,
                                                    StackedBatch, packing_metrics,
                                                    bucket_degree, bucket_pow2,
                                                    stack_rows)
from repro_torch.core.scheduler.coscheduler import SliceCoScheduler
