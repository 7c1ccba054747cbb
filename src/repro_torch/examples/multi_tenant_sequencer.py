"""End-to-end multi-tenant sequencer (the paper's system, serving mode).

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_sequencer \\
        [--duration 0.03] [--device cpu]

Poisson ingress → per-class queues → Tier-1 rectangular stacking →
structural validation → Tier-2 co-scheduled dispatch (one captured program
per launch on the card) → per-tenant results, verified against isolated
bignum evaluation.
"""
import numpy as np

from repro_torch.core import workloads as WK
from repro_torch.device import resolve_device
from repro_torch.examples import check, parser
from repro_torch.launch.serve import serve_crypto


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--duration", type=float, default=0.03)
    ap.add_argument("--rate", type=float, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results, n_ops, dt = serve_crypto(duration_s=args.duration,
                                      rate_hz=args.rate, device=dev)
    print(f"dispatched {n_ops} tenant ops in {len(results)} stacked batches "
          f"in {dt:.2f}s on {dev} (captures and validation included)")

    # verify a Dilithium batch end-to-end against isolated evaluation
    checked = 0
    for res in results:
        if res.batch.workload != "dilithium" or checked:
            continue
        eng = WK.DilithiumEngine(res.batch.d_bucket, device="cpu")
        for r in res.batch.requests[:4]:
            iso = np.zeros((1, res.batch.d_bucket), np.uint32)
            iso[0, : r.degree] = r.coeffs
            check(np.array_equal(res.outputs[r.tenant_id],
                                 eng.oracle_np(iso)[0]),
                  f"tenant {r.tenant_id} corrupted!")
            checked += 1
    check(checked > 0, "no Dilithium batch to check: raise --duration")
    print(f"isolation check: {checked} tenants' batched results are "
          f"isomorphic to isolated evaluation ✓ (Property 5.1)")

    fills = [len(r.batch.requests) for r in results]
    workloads = sorted({r.batch.workload for r in results})
    print(f"batch fill: mean N_c={np.mean(fills):.1f}, workloads={workloads}")
    return {"device": str(dev), "ops": n_ops, "batches": len(results),
            "checked": checked, "workloads": workloads, "ok": True}


if __name__ == "__main__":
    main()
