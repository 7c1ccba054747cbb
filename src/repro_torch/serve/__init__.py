"""repro_torch.serve — the online multi-tenant serving runtime of the port.

The JAX package's ``repro.serve``, with the same modules and names:

* :mod:`server`    — ``CryptoServer`` event loop: submit → handle, explicit-
  clock flush policy, graceful drain; on CUDA every staging-pass GEMM is
  the K1 kernel and every fold the K2 kernel;
* :mod:`admission` — queue-bound / per-tenant token-bucket / SLO gates with
  backpressure signalling;
* :mod:`batcher`   — continuous rectangular batcher (close on N_c-full, age
  timeout, or occupancy threshold);
* :mod:`telemetry` — K/M occupancy, queue depth, p50/p95/p99 latency,
  eager-vs-deferred reduction-stall counters, JSON export;
* :mod:`client`    — synthetic load generator (virtual or real-time pacing);
* :mod:`controller` — adaptive occupancy controller: EWMA feedback over the
  dispatch telemetry drives the per-class close policy and prices the
  λ-controlled merge holdback against the SLO gate.

``ServeConfig.reduction_by_workload`` selects the fold discipline per
workload class (paper §7.2.1): lazy (κ-amortised deferred Montgomery
reduction) classes batch and dispatch next to strictly-eager classes, each
with its own engines and launch census (eager: a fold per pass; lazy: one
fold per window).
"""
from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionDecision, BatchDecisions,
                                         TenantInterner, TokenBucket)
from repro_torch.serve.batcher import ClosedBatch, ContinuousBatcher
from repro_torch.serve.client import LoadGenerator, LoadResult, attach_payloads
from repro_torch.serve.controller import AdaptiveController
from repro_torch.serve.server import (CryptoServer, RejectedError,
                                      ResponseHandle, ServeConfig)
from repro_torch.serve.telemetry import BatchRecord, LatencyHistogram, Telemetry

__all__ = [
    "AdmissionController", "AdmissionDecision", "BatchDecisions",
    "TenantInterner", "TokenBucket", "ClosedBatch", "ContinuousBatcher",
    "LoadGenerator", "LoadResult", "attach_payloads", "AdaptiveController",
    "CryptoServer", "RejectedError", "ResponseHandle", "ServeConfig",
    "BatchRecord", "LatencyHistogram", "Telemetry",
]
