"""Online multi-tenant serving with live ingress.

    PYTHONPATH=src python -m repro_torch.examples.online_serving \\
        [--duration 0.02] [--device cpu]

Load generator → admission control → continuous rectangular batcher →
co-scheduled dispatch → per-tenant results + telemetry, then one
deliberately overloaded tenant to show rate limiting and backpressure.
"""
import numpy as np

from repro_torch.core import workloads as WK
from repro_torch.core.scheduler import PoissonTrace
from repro_torch.device import resolve_device
from repro_torch.examples import check, parser
from repro_torch.serve import CryptoServer, LoadGenerator, ServeConfig
from repro_torch.serve.client import attach_payloads
from repro_torch.serve.server import coscheduler_from_config


def _server(dev, **kw) -> CryptoServer:
    cfg = ServeConfig(n_c=8, max_age_s=0.005, validate=False, **kw)
    return CryptoServer(cfg, coscheduler=coscheduler_from_config(
        cfg, device=dev))


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--duration", type=float, default=0.02)
    ap.add_argument("--rate", type=float, default=1024)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- serve a Poisson trace through the online runtime --------------------
    server = _server(dev)
    gen = LoadGenerator(PoissonTrace(rate_hz=args.rate,
                                     duration_s=args.duration, seed=7))
    load = gen.run(server)
    snap = server.telemetry.snapshot()
    check(load.n_served == len(load.handles),
          f"served {load.n_served} of {len(load.handles)} requests")
    print(f"served {load.n_served}/{len(load.handles)} requests on {dev} in "
          f"{snap['batches']} batches "
          f"(close reasons: {snap['close_reasons']})")
    print(f"occupancy K={snap['k_occupancy_mean']:.3f} "
          f"M={snap['m_occupancy_mean']:.3f}; "
          f"p50={snap['latency']['p50_s']*1e3:.2f}ms "
          f"p99={snap['latency']['p99_s']*1e3:.2f}ms (service on the host "
          f"clock)")

    # --- verify one tenant against isolated evaluation -----------------------
    done = [h for h in load.handles if h.done() and not h.rejected
            and h.request.workload == "dilithium"]
    check(done, "no Dilithium request served: raise --duration")
    h = done[0]
    eng = WK.DilithiumEngine(server.batcher.bucket_for(h.request.degree),
                             device="cpu")
    iso = np.zeros((1, eng.d), np.uint32)
    iso[0, : h.request.degree] = h.request.coeffs
    check(np.array_equal(h.result(), eng.oracle_np(iso)[0]),
          "the online result differs from isolated evaluation")
    print("isolation check: online batched result == isolated evaluation ✓")

    # --- overload one tenant to trip the rate limiter ------------------------
    server2 = _server(dev, tenant_rate_hz=100.0, tenant_burst=4)
    trace = list(PoissonTrace(rate_hz=512, duration_s=0.05,
                              seed=11).generate())
    for r in trace:
        r.tenant_id = 0                    # one noisy tenant hammers the API
    attach_payloads(trace, seed=11)
    rejections = 0
    for r in trace:
        rejections += server2.submit(r, now=r.arrival_time).rejected
    server2.drain(trace[-1].arrival_time if trace else 0.0)
    counts = server2.telemetry.admission_counts
    check(counts.get("rate_limited", 0) == rejections > 0,
          f"the token bucket limited {counts} of {len(trace)} requests")
    print(f"noisy tenant: {counts.get('ok', 0)} admitted, "
          f"{counts.get('rate_limited', 0)} rate-limited "
          f"(token bucket 100 req/s, burst 4) — neighbours stay unharmed")
    return {"device": str(dev), "served": load.n_served,
            "batches": snap["batches"], "noisy_admitted": counts.get("ok", 0),
            "rate_limited": counts.get("rate_limited", 0), "ok": True}


if __name__ == "__main__":
    main()
