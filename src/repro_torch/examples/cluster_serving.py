"""Multi-host sharded serving (the paper's fleet economics, live).

    PYTHONPATH=src python -m repro_torch.examples.cluster_serving \\
        [--hosts 3] [--device cpu]

Tenant-hash ingress → per-host admission (gossip-informed SLO gate) →
per-host continuous batching → co-scheduled dispatch → two-phase drain
barrier → merged cluster telemetry.  Ends with the adversarial single-hot-
tenant trace that collapses the whole load onto one host.
"""
import math

import numpy as np

from repro_torch.cluster import ClusterConfig, ClusterServer
from repro_torch.core import workloads as WK
from repro_torch.core.scheduler import PoissonTrace
from repro_torch.device import resolve_device
from repro_torch.examples import check, parser
from repro_torch.serve import LoadGenerator, ServeConfig
from repro_torch.serve.server import coscheduler_from_config


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--hosts", type=int, default=3)
    ap.add_argument("--duration", type=float, default=0.02)
    ap.add_argument("--rate", type=float, default=1024)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # One co-scheduler (one cache of captured programs) shared by the
    # simulated hosts keeps this demo fast; production gives each host its
    # own (the default).
    serve_cfg = ServeConfig(n_c=8, max_age_s=0.005, validate=False)
    shared = coscheduler_from_config(serve_cfg, device=dev)
    factory = lambda h: shared  # noqa: E731

    # --- a Poisson trace across the cluster ----------------------------------
    cluster = ClusterServer(
        ClusterConfig(n_hosts=args.hosts, gossip_period_s=0.002,
                      serve=serve_cfg, device=dev),
        coscheduler_factory=factory)
    gen = LoadGenerator(PoissonTrace(rate_hz=args.rate,
                                     duration_s=args.duration, seed=7))
    load = gen.run(cluster)
    snap = cluster.snapshot()
    m = snap["merged"]
    imb = m["load_imbalance"]
    print(f"cluster[{args.hosts} hosts] on {dev}: served {load.n_served}/"
          f"{len(load.handles)} requests in {m['batches']} batches; "
          f"per-host {imb['per_host_requests']} "
          f"(max/mean {imb['max_over_mean']:.2f})")
    g = snap["gossip"]
    check(g["used_staleness_max_s"] <= g["staleness_bound_s"],
          f"gossip staleness {g['used_staleness_max_s']} past its bound "
          f"{g['staleness_bound_s']}")
    print(f"gossip: {g['publishes']} publishes, used staleness "
          f"max {g['used_staleness_max_s']*1e3:.2f}ms "
          f"≤ bound {g['staleness_bound_s']*1e3:.2f}ms")
    bar = snap["drain_barrier"]
    check(bar["complete"] and bar["inflight_groups"] == 0,
          f"drain barrier {bar}")
    print(f"drain barrier: quiesced {bar['hosts']} hosts → flushed "
          f"{bar['batches_flushed']} batches (complete={bar['complete']})")

    # --- cross-host isolation check ------------------------------------------
    done = [h for h in load.handles if h.done() and not h.rejected
            and h.request.workload == "dilithium"]
    check(done, "no Dilithium request served: raise --duration or --rate")
    h = done[0]
    host = cluster.router.host_for(h.request.tenant_id)
    eng = WK.DilithiumEngine(cluster.hosts[host].batcher.bucket_for(
        h.request.degree), device="cpu")
    iso = np.zeros((1, eng.d), np.uint32)
    iso[0, : h.request.degree] = h.request.coeffs
    check(np.array_equal(h.result(), eng.oracle_np(iso)[0]),
          f"tenant {h.request.tenant_id} differs from isolated evaluation")
    print(f"isolation check: tenant {h.request.tenant_id} (host {host}) "
          f"== isolated evaluation ✓")

    # --- adversarial hot tenant: the fleet's capacity is unreachable ---------
    hot = ClusterServer(
        ClusterConfig(n_hosts=args.hosts, serve=serve_cfg, device=dev),
        coscheduler_factory=factory)
    trace = PoissonTrace(rate_hz=args.rate, duration_s=args.duration,
                         seed=11).generate()
    for r in trace:
        r.tenant_id = 0                 # every request from one hot tenant
    LoadGenerator(trace, seed=11).run(hot)
    hot_imb = hot.snapshot()["merged"]["load_imbalance"]
    check(math.isclose(hot_imb["max_over_mean"], args.hosts),
          f"the hot tenant spread over {hot_imb['per_host_requests']}")
    print(f"hot tenant: per-host {hot_imb['per_host_requests']} — "
          f"max/mean {hot_imb['max_over_mean']:.2f} "
          f"({args.hosts - 1} hosts idle while one absorbs the storm)")
    return {"device": str(dev), "hosts": args.hosts,
            "served": load.n_served, "batches": m["batches"],
            "per_host_requests": imb["per_host_requests"],
            "hot_per_host_requests": hot_imb["per_host_requests"],
            "ok": True}


if __name__ == "__main__":
    main()
