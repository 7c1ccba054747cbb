"""repro_torch.cluster — multi-host sharded serving on one machine.

The JAX package's ``repro.cluster``, with the same modules and names, over
the port's own ``serve`` and ``obs`` (nothing of JAX or of ``repro`` is
imported).  The paper's fleet-economics framing (§2, §7: per-pod cost
deficits, multi-tenant spatial collapse) needs cross-host effects to be
measurable: skewed tenant load, admission on stale global queue depth,
coordinated drains.  This package shards the single-host
:mod:`repro_torch.serve` runtime across N simulated host slices, all under
the same deterministic virtual clock:

* :mod:`router`    — tenant ingress by rendezvous (highest-random-weight)
  hashing over the *live* host set (stable CRC32 tenant keys, explicit
  tenant→host pinning overrides, cordon/restore with minimal remapping);
* :mod:`gossip`    — per-host queue-depth digests on a configurable period;
  the SLO admission gate consumes bounded-staleness *cluster* state, and
  staleness is audited, never hidden;
* :mod:`cluster`   — ``ClusterServer``: one ``CryptoServer`` +
  ``SliceCoScheduler`` per host (on ``ClusterConfig.device``: CUDA unless
  it says ``"cpu"``), a two-phase distributed drain barrier (quiesce
  ingress everywhere → drain every host → collect), and the same
  explicit-clock surface as a single server so ``LoadGenerator`` drives a
  cluster unchanged;
* :mod:`failover`  — host-failure recovery: deterministic fault injection
  (``FaultPlan``), silence-driven cordon, per-host intake journals, lossless
  idempotent replay onto rendezvous survivors, and watermark-gated shedding
  during the redistribution transient;
* :mod:`telemetry` — merges K per-host JSON snapshots into cluster-level
  p50/p95/p99 (exact, via raw samples), per-host occupancy, and
  load-imbalance metrics.

Cluster drains are bit-for-bit equivalent to a single-host replay of the
same trace and to the JAX cluster's (``tests/test_torch_cluster.py`` sweeps
N ∈ {1, 2, 4} with mixed eager/lazy reduction classes), and so are
kill/recover chaos runs (``tests/test_torch_failover.py``: surviving-tenant
results bit-equal, no request lost or double-served).  Device ids in
snapshots are torch device strings (``"cuda:0"``), where the JAX package
has integer ids.
"""
from repro_torch.cluster.cluster import ClusterConfig, ClusterServer
from repro_torch.cluster.failover import (FailoverCoordinator, FaultEvent,
                                          FaultPlan, IntakeJournal)
from repro_torch.cluster.gossip import ClusterView, GossipBus, HostDigest
from repro_torch.cluster.router import (TenantHashRouter, rendezvous_score,
                                        stable_tenant_hash)
from repro_torch.cluster.telemetry import (MERGE_TOLERANCE_REL,
                                           load_imbalance, merge_snapshots,
                                           summarize_failover)
