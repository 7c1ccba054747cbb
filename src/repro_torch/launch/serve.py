"""Serving launcher of the port — the offline multi-tenant replay.

``--mode crypto`` replays the Aegis multi-tenant sequencer: Poisson ingress →
Tier-1 rectangular batching → Tier-2 co-scheduled dispatch → per-tenant
results.  On CUDA every staging-pass GEMM is the ``limb_matmul`` kernel and
every fold the ``mont_fold`` kernel.  The JAX package's online and LM modes
are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode crypto --device cuda
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.scheduler import (IngressQueue, PoissonTrace,
                                        RectangularScheduler)
from repro_torch.core.scheduler.coscheduler import (SliceCoScheduler,
                                                    expected_kernel_calls)
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2
from repro_torch.serve.client import attach_payloads


def check_launch_census(eng, k1_calls: int, k2_calls: int, what: str):
    """The port's stand-in for the JAX package's HLO validator: one e2e of
    ``eng`` must have made exactly the kernel calls its ``fold_profile``
    implies (eager: a GEMM and a fold per pass and channel; lazy: a fold
    per window and channel).  Raises on any mismatch."""
    want = expected_kernel_calls(eng)
    if (k1_calls, k2_calls) != want:
        raise RuntimeError(
            f"launch census failed for {what}: limb_matmul/mont_fold calls "
            f"({k1_calls}, {k2_calls}) != ({want[0]}, {want[1]}) from "
            f"fold_profile {eng.fold_profile}")


def serve_crypto(*, duration_s=0.05, rate_hz=2048, n_c=8, d_uniform=None,
                 seed=0, validate=True, accum="fp32_mantissa",
                 coscheduler=None, device=None):
    """Replay a Poisson trace through the two-tier scheduler.

    Returns ``(results, n_ops, seconds)`` with one ``DispatchResult`` per
    stacked batch, as the JAX package's ``serve_crypto``.  Runs on CUDA
    unless ``device="cpu"`` (or a given ``coscheduler``) says otherwise.
    ``validate`` runs the launch census at the first dispatch of every
    ``(workload, d_bucket)``.
    """
    trace = PoissonTrace(rate_hz=rate_hz, duration_s=duration_s,
                         uniform_degree=d_uniform, seed=seed).generate()
    attach_payloads(trace, seed=seed)
    q = IngressQueue()
    q.push_trace(trace)
    sched = RectangularScheduler(n_c=n_c)
    cos = coscheduler or SliceCoScheduler(accum=accum, device=device)
    results, n_ops = [], 0
    t0 = time.time()
    validated = set()
    while q.workloads:
        for w in list(q.workloads):
            reqs = q.pop_batch(w, n_c)
            for batch in sched.plan_batches(reqs):
                key = (w, batch.d_bucket)
                census = validate and key not in validated
                before = (K1.calls, K2.calls)
                results.append(cos.dispatch(batch))
                if census:
                    check_launch_census(
                        cos.engine_for(*key), K1.calls - before[0],
                        K2.calls - before[1], f"{w}/d{batch.d_bucket}")
                    validated.add(key)
                n_ops += batch.n_c
    dt = time.time() - t0
    return results, n_ops, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["crypto"], default="crypto")
    ap.add_argument("--duration", type=float, default=0.05)
    ap.add_argument("--rate", type=float, default=2048)
    ap.add_argument("--n-c", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accum", default="fp32_mantissa",
                    choices=["fp32_mantissa", "int32_native"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args()
    results, n_ops, dt = serve_crypto(duration_s=args.duration,
                                      rate_hz=args.rate, n_c=args.n_c,
                                      seed=args.seed, accum=args.accum,
                                      device=args.device)
    print(f"sequencer: {n_ops} tenant ops in {dt:.2f}s "
          f"({n_ops/dt:.0f} ops/s on {args.device}), "
          f"{len(results)} stacked batches dispatched, launch census passed; "
          f"kernel launches limb_matmul={K1.launches} "
          f"mont_fold={K2.launches}")


if __name__ == "__main__":
    main()
