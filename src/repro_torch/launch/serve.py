"""Serving launcher of the port — three modes:

* ``--mode crypto``: offline replay of the Aegis multi-tenant sequencer:
  Poisson ingress → Tier-1 rectangular batching → Tier-2 co-scheduled
  dispatch → per-tenant results, with the structural validator
  (:mod:`repro_torch.core.validator`) at the first dispatch of every class;
* ``--mode crypto-online``: the :mod:`repro_torch.serve` runtime — live
  submit → admission → continuous batcher → dispatch closed loop with
  telemetry JSON, Chrome trace and OpenMetrics exports.  With ``--hosts N``
  (N > 1) it serves an N-host :mod:`repro_torch.cluster` instead:
  tenant-hash ingress, gossip (``--gossip-period-ms``), host-failure
  injection and recovery (``--fault-plan``, ``--shed-watermark``), the
  two-phase drain barrier, and with ``--device-parallel`` each host pinned
  to its own slice of the devices;
* ``--mode lm``: batched LM serving (prefill + greedy decode) for any arch
  of :mod:`repro_torch.configs` (``--arch``, default ``olmo_1b`` at its
  full published width; ``--smoke`` for the reduced config) on
  :mod:`repro_torch.models`, with random weights drawn from ``--seed``.

On CUDA every staging-pass GEMM is the ``limb_matmul`` kernel and every fold
the ``mont_fold`` kernel, and each launch group replays one captured CUDA
graph of its class's whole e2e (BN254's reduction included); in cluster
mode every host captures its own programs.  The LM mode runs PyTorch ops
only: the JAX package's LM reaches no Pallas kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode crypto --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --mode crypto-online \
        --device cpu --duration 0.01 --rate 1024 --max-age-ms 2
    PYTHONPATH=src python -m repro_torch.launch.serve --mode crypto-online \
        --device cpu --hosts 3 --duration 0.01 --rate 1024 --max-age-ms 2 \
        --fault-plan kill@0.5:h1,recover@0.9:h1
    PYTHONPATH=src python -m repro_torch.launch.serve --mode crypto-online \
        --device cuda --hosts 4 --duration 0.25 --rate 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        [--arch olmo_1b] [--smoke] [--decode-steps 8] --device cuda|cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config

from repro_torch.core import validator as V
from repro_torch.core.scheduler import (IngressQueue, PoissonTrace,
                                        RectangularScheduler)
from repro_torch.core.scheduler.coscheduler import (SliceCoScheduler,
                                                    check_launch_census)
from repro_torch.device import resolve_device
from repro_torch.kernels.limb_matmul.kernel import COUNTER as K1
from repro_torch.kernels.mont_fold.kernel import COUNTER as K2
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.serve.client import attach_payloads


def lm_prompts(cfg, *, batch=2, prompt_len=16, seed=0, device=None) -> dict:
    """``serve_lm``'s batch: (B, prompt_len) int32 tokens and, for a frontend
    config, (B, max(frontend_len, 4), d_model) float32 embeddings, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    prompts = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int32, device=dev)}
    if cfg.frontend:
        prompts["embeds"] = torch.as_tensor(rng.normal(
            size=(batch, max(cfg.frontend_len, 4), cfg.d_model)),
            dtype=torch.float32, device=dev)
    return prompts


def serve_lm(cfg, *, batch=2, prompt_len=16, decode_steps=8, seed=0,
             device=None, model=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    greedily, ``decode_steps`` tokens in all (the first from the prefill's
    logits), as the JAX package's ``serve_lm``: the prompts (and a frontend
    config's embeddings) come from ``np.random.default_rng(seed)`` in the
    same order, and the cache holds ``prompt_len + decode_steps`` positions.

    ``model=None`` draws an :class:`~repro_torch.models.model.LMModel` from
    ``seed`` on the device (torch's generator: the JAX package's
    distributions, not its values); a model converted from the JAX
    package's parameters (``models.convert.params_from_jax``) gives the JAX
    run's tokens.  Runs on ``cuda`` unless ``device="cpu"``; a given model
    must be of ``cfg`` and on that device.  Decode writes from position
    ``prompt_len``, after a VLM's vision prefix as in the JAX package, and a
    prefix plus prompt longer than the cache raises a ValueError.

    Returns ``(tokens, seconds, stats)``: the (B, decode_steps) int32 tokens
    as numpy, the wall seconds of prefill and decode (the JAX package's two
    results), and ``stats`` with ``prefill_ms``, ``decode_ms_per_token``
    (CUDA events on the card, the host clock on the CPU), peak allocated and
    reserved bytes on the card (None on the CPU) and the device."""
    dev = resolve_device(device)
    if model is None:
        model = M.LMModel(cfg, device=dev, seed=seed)
    elif model.cfg != cfg or model.device != dev:
        raise ValueError(f"model of {model.cfg.name} on {model.device}, "
                         f"asked for {cfg.name} on {dev}")
    prompts = lm_prompts(cfg, batch=batch, prompt_len=prompt_len, seed=seed,
                         device=dev)
    prefill = ST.make_prefill(cfg, max_len=prompt_len + decode_steps)
    decode = ST.make_decode_step(cfg)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks = []

    def mark():
        if on_card:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    t0 = time.time()
    mark()
    logits, cache = prefill(model, prompts)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    mark()
    out = [tok]
    for i in range(decode_steps - 1):
        tok, _, cache = decode(model, cache, tok, prompt_len + i)
        out.append(tok)
    mark()
    toks = torch.cat(out, dim=1).cpu().numpy()
    dt = time.time() - t0
    if on_card:
        torch.cuda.synchronize(dev)
        spans = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        spans = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    stats = {"prefill_ms": spans[0],
             "decode_ms_per_token": (spans[1] / (decode_steps - 1)
                                     if decode_steps > 1 else None),
             "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                      if on_card else None),
             "peak_reserved_bytes": (torch.cuda.max_memory_reserved(dev)
                                     if on_card else None),
             "device": str(dev)}
    return toks, dt, stats


def serve_crypto(*, duration_s=0.05, rate_hz=2048, n_c=8, d_uniform=None,
                 seed=0, validate=True, accum="fp32_mantissa",
                 coscheduler=None, device=None):
    """Replay a Poisson trace through the two-tier scheduler.

    Returns ``(results, n_ops, seconds)`` with one ``DispatchResult`` per
    stacked batch, as the JAX package's ``serve_crypto``.  Runs on CUDA
    unless ``device="cpu"`` (or a given ``coscheduler``) says otherwise.
    ``validate`` runs the structural validator before the first dispatch of
    every ``(workload, d_bucket)``, on its e2e at the launched operand
    shape (on CUDA a capture whose graph is read node by node), and the
    launch census: the K1/K2 nodes against the engine's ``fold_profile``.
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
                if validate and key not in validated:
                    _validate(cos, w, batch)
                    validated.add(key)
                results.append(cos.dispatch(batch))
                n_ops += batch.n_c
    dt = time.time() - t0
    return results, n_ops, dt


def _validate(cos, workload: str, batch):
    """The structural validator on the e2e of ``batch``'s class at its
    launched operand shape, eager or lazy as the co-scheduler folds it, and
    the launch census (checked first).  Raises on a violation."""
    eng = cos.engine_for(workload, batch.d_bucket)
    zeros = torch.zeros(cos.operand_shape(workload, batch.d_bucket,
                                          batch.n_c),
                        dtype=torch.int32, device=cos.device_for(workload))
    rep = V.validate_fn(eng.e2e, zeros,
                        **V.checks_for(eng, cos.reduction_for(workload)))
    check_launch_census(eng, rep.n_dots, rep.n_folds,
                        f"{workload}/d{batch.d_bucket}")
    rep.raise_if_failed()


def serve_crypto_online(*, duration_s=0.05, rate_hz=2048, n_c=8,
                        max_age_s=0.005, d_uniform=None, seed=0,
                        validate=True, accum="fp32_mantissa",
                        reduction="eager", reduction_by_workload=None,
                        kappa=None, d_tile=None,
                        max_pending=1024, tenant_rate_hz=None,
                        slo_deadline_s=None, occupancy_close=None,
                        merge_dispatch=True, row_ladder_max=None,
                        donate=False, async_pipeline=False, warm_start=None,
                        controller=False, holdback_lambda=0.0,
                        inflight_depth=1, compilation_cache_dir=None,
                        telemetry_out=None, trace_out=None,
                        metrics_out=None, metrics_period_s=0.005,
                        metrics_port=None, deterministic_timing=False,
                        realtime=False, coscheduler=None,
                        arrival_batch=None, columnar_admission=True,
                        device="cuda"):
    """Closed loop over the online runtime: load generator → admission →
    continuous batcher → co-scheduled dispatch → per-tenant results, as the
    JAX package's ``serve_crypto_online``.  Returns ``(load, snapshot,
    seconds)``.

    The co-scheduler is built on ``device`` (CUDA unless ``device="cpu"``;
    without a GPU the default raises, nothing falls back), unless a
    ``coscheduler`` is given.  ``trace_out`` switches request-lifecycle
    tracing on and writes the run's Chrome-trace JSON there; ``metrics_out``
    switches the continuous metrics scrape + alert engine on and writes the
    OpenMetrics exposition there (``.gz`` compresses either file);
    ``metrics_port`` additionally serves ``/metrics`` over HTTP on localhost
    for the run's duration (``realtime`` only)."""
    from repro_torch.core.scheduler import PoissonTrace
    from repro_torch.serve import CryptoServer, LoadGenerator, ServeConfig
    from repro_torch.serve.server import coscheduler_from_config

    if metrics_port is not None and not realtime:
        raise ValueError("--metrics-port needs --realtime: the HTTP "
                         "endpoint only makes sense on the wall clock")

    cfg = ServeConfig(n_c=n_c, max_age_s=max_age_s, validate=validate,
                      accum=accum, max_pending=max_pending,
                      reduction=reduction,
                      reduction_by_workload=reduction_by_workload,
                      kappa=kappa, d_tile=d_tile,
                      tenant_rate_hz=tenant_rate_hz,
                      slo_deadline_s=slo_deadline_s,
                      occupancy_close=occupancy_close,
                      merge_dispatch=merge_dispatch,
                      row_ladder_max=row_ladder_max, donate=donate,
                      async_pipeline=async_pipeline, warm_start=warm_start,
                      controller=controller,
                      holdback_lambda=holdback_lambda,
                      inflight_depth=inflight_depth,
                      compilation_cache_dir=compilation_cache_dir,
                      columnar_admission=columnar_admission,
                      tracing=trace_out is not None,
                      metrics=(metrics_out is not None
                               or metrics_port is not None),
                      metrics_period_s=metrics_period_s,
                      deterministic_timing=deterministic_timing)
    if coscheduler is None:
        coscheduler = coscheduler_from_config(cfg, device=device)
    server = CryptoServer(cfg, coscheduler=coscheduler)
    gen = LoadGenerator(PoissonTrace(rate_hz=rate_hz, duration_s=duration_s,
                                     uniform_degree=d_uniform, seed=seed),
                        seed=seed, accum=accum)
    httpd = None
    if metrics_port is not None:
        from repro_torch.obs.metrics import serve_metrics_http
        httpd = serve_metrics_http([server.metrics], metrics_port)
    t0 = time.time()
    try:
        load = gen.run(server, realtime=realtime, arrival_batch=arrival_batch)
    finally:
        if httpd is not None:
            httpd.shutdown()
    dt = time.time() - t0
    snap = (server.telemetry.write_json(telemetry_out) if telemetry_out
            else server.telemetry.snapshot())
    if trace_out:
        server.write_trace(trace_out)
    if metrics_out:
        server.write_metrics(metrics_out)
    return load, snap, dt


def serve_crypto_cluster(*, hosts=2, duration_s=0.05, rate_hz=2048, n_c=8,
                         max_age_s=0.005, d_uniform=None, seed=0,
                         validate=True, accum="fp32_mantissa",
                         reduction="eager", reduction_by_workload=None,
                         kappa=None, d_tile=None, max_pending=1024,
                         tenant_rate_hz=None, slo_deadline_s=None,
                         occupancy_close=None, gossip_period_s=0.002,
                         gossip_staleness_factor=2.0, pinned=None,
                         merge_dispatch=True, row_ladder_max=None,
                         donate=False, async_pipeline=False,
                         warm_start=None, controller=False,
                         holdback_lambda=0.0, inflight_depth=1,
                         compilation_cache_dir=None,
                         telemetry_out=None, trace=None, trace_out=None,
                         metrics_out=None, metrics_period_s=0.005,
                         deterministic_timing=False,
                         realtime=False, coscheduler_factory=None,
                         arrival_batch=None, columnar_admission=True,
                         fault_plan=None, shed_watermark=None,
                         device_parallel=False, device="cuda"):
    """Closed loop over an N-host sharded cluster: tenant-hash ingress →
    per-host admission (gossip-informed SLO gate) → per-host continuous
    batcher → co-scheduled dispatch → two-phase drain barrier → merged
    telemetry, as the JAX package's ``serve_crypto_cluster``.  Returns
    ``(load, snapshot, seconds)``.

    Every host's co-scheduler is built on ``device`` (CUDA unless
    ``device="cpu"``; without a GPU the default raises, nothing falls
    back), unless ``coscheduler_factory(host)`` builds it; under
    ``device_parallel`` each host gets its slice of ``device``'s devices,
    and the default ``"cuda"`` (or None) means every CUDA device.
    ``trace`` overrides the Poisson trace; ``trace_out`` switches
    request-lifecycle tracing on and writes the merged fleet Chrome-trace
    JSON there.

    ``fault_plan`` injects deterministic host failures: a
    ``"kill@T:hN,recover@T:hN,pause@T:hN"`` spec (string times are
    *fractions of the run duration* — ``kill@0.5:h1`` kills host 1 mid-run
    — and are scaled here) or a pre-built
    :class:`repro_torch.cluster.FaultPlan` with absolute virtual-clock
    times.  ``shed_watermark`` arms watermark-gated load shedding during
    failover redistribution transients (fraction of ``max_pending``)."""
    from repro_torch.cluster import ClusterConfig, ClusterServer, FaultPlan
    from repro_torch.core.scheduler import PoissonTrace
    from repro_torch.serve import LoadGenerator, ServeConfig

    if isinstance(fault_plan, str):
        fault_plan = FaultPlan.parse(fault_plan).scaled(duration_s)

    serve_cfg = ServeConfig(
        n_c=n_c, max_age_s=max_age_s, validate=validate, accum=accum,
        max_pending=max_pending, reduction=reduction,
        reduction_by_workload=reduction_by_workload, kappa=kappa,
        d_tile=d_tile, tenant_rate_hz=tenant_rate_hz,
        slo_deadline_s=slo_deadline_s, occupancy_close=occupancy_close,
        merge_dispatch=merge_dispatch, row_ladder_max=row_ladder_max,
        donate=donate, async_pipeline=async_pipeline, warm_start=warm_start,
        controller=controller, holdback_lambda=holdback_lambda,
        inflight_depth=inflight_depth,
        compilation_cache_dir=compilation_cache_dir,
        columnar_admission=columnar_admission,
        tracing=trace_out is not None,
        metrics=metrics_out is not None,
        metrics_period_s=metrics_period_s,
        deterministic_timing=deterministic_timing)
    cluster = ClusterServer(
        ClusterConfig(n_hosts=hosts, gossip_period_s=gossip_period_s,
                      gossip_staleness_factor=gossip_staleness_factor,
                      pinned=pinned, fault_plan=fault_plan,
                      shed_watermark=shed_watermark,
                      device_parallel=device_parallel, serve=serve_cfg,
                      device=device),
        coscheduler_factory=coscheduler_factory)
    gen = LoadGenerator(
        trace if trace is not None else
        PoissonTrace(rate_hz=rate_hz, duration_s=duration_s,
                     uniform_degree=d_uniform, seed=seed),
        seed=seed, accum=accum)
    t0 = time.time()
    load = gen.run(cluster, realtime=realtime, arrival_batch=arrival_batch)
    dt = time.time() - t0
    snap = (cluster.write_json(telemetry_out) if telemetry_out
            else cluster.snapshot())
    if trace_out:
        cluster.write_trace(trace_out)
    if metrics_out:
        cluster.write_metrics(metrics_out)
    return load, snap, dt


def _launched(before: tuple) -> str:
    """K1/K2 launches since ``before`` (the counters at the run's start), so
    that the line reports the run's own whatever ran earlier in the
    process."""
    return (f"limb_matmul={K1.launches - before[0]} "
            f"mont_fold={K2.launches - before[1]}")


def _print_cluster(args, load, snap, dt, before):
    m = snap["merged"]
    served = sum(1 for h in load.handles if h.done() and not h.rejected)
    print(f"cluster[{args.hosts} hosts]: served {served}/"
          f"{len(load.handles)} requests ({len(load.rejected)} rejected) "
          f"in {dt:.2f}s wall on {args.device}, {m['batches']} batches "
          f"[{', '.join(f'{k}:{v}' for k, v in m['close_reasons'].items())}]")
    imb = m["load_imbalance"]
    print(f"per-host requests {imb['per_host_requests']} "
          f"(max/mean {imb['max_over_mean']:.2f}, cv {imb['cv']:.2f}); "
          f"occupancy K={m['k_occupancy_mean']:.3f} "
          f"M={m['m_occupancy_mean']:.3f}")
    g = snap["gossip"]
    print(f"gossip: {g['publishes']} publishes, {g['views']} views, "
          f"{g['stale_drops']} stale drops, "
          f"used staleness max {g['used_staleness_max_s']*1e3:.2f}ms "
          f"(bound {g['staleness_bound_s']*1e3:.2f}ms)")
    lat = m["latency"]
    print(f"latency (merged, exact={lat['merged_exact']}): "
          f"p50={lat['p50_s']*1e3:.2f}ms p95={lat['p95_s']*1e3:.2f}ms "
          f"p99={lat['p99_s']*1e3:.2f}ms")
    bar = snap["drain_barrier"]
    print(f"drain barrier: {bar['hosts']} hosts quiesced → "
          f"{bar['batches_flushed']} batches flushed, "
          f"complete={bar['complete']}, "
          f"in-flight={bar['inflight_groups']}; kernel launches "
          f"{_launched(before)}")
    if args.device_parallel:
        dv, ov = snap["devices"], snap["dispatch_overlap"]
        print(f"devices: per-host {dv['per_host']} "
              f"({dv['distinct']} distinct); overlap: "
              f"{ov['launches']} launches, concurrency "
              f"mean {ov['launch_concurrency_mean']:.2f} / "
              f"max {ov['launch_concurrency_max']}, cross-host queue "
              f"share {ov['cross_host_queue_share']:.3f}")
    if args.fault_plan or args.shed_watermark is not None:
        fo = snap["failover"]
        s = fo["summary"]
        print(f"failover: {s['kills']} kills / {s['pauses']} pauses / "
              f"{s['recovers']} recovers → {s['cordons']} cordons; "
              f"requests replayed={fo['replayed']} "
              f"recovered={fo['recovered']} deduped={fo['deduped']} "
              f"shed={fo['sheds']} diverted={fo['diverted']} "
              f"lost={fo['lost']} (must be 0)")
    if args.controller:
        ctl, hb = m["controller"], m["holdback"]
        print(f"controller[{ctl['hosts']} hosts]: {ctl['updates']} "
              f"updates, m-occ EWMA mean "
              f"{ctl['m_occupancy_ewma_mean']:.3f}, top rung "
              f"{ctl['target_rows_max']}, age max "
              f"{ctl['max_age_s_max']*1e3:.1f}ms; holdback "
              f"{hb['held']} held → {hb['wins']} wins / "
              f"{hb['losses']} losses / {hb['flushed']} flushed")
    if args.metrics_out:
        met, al = m.get("metrics", {}), m.get("alerts", {})
        fired = sum(r["fired"] for r in al.get("rules", {}).values())
        print(f"metrics: {met.get('scrapes', 0)} scrapes / "
              f"{met.get('series', 0)} series across "
              f"{met.get('hosts', 0)} hosts; alerts: "
              f"{al.get('events_total', 0)} transitions, {fired} firings "
              f"→ {args.metrics_out}")
    if args.telemetry_out:
        print(f"cluster telemetry JSON → {args.telemetry_out}")
    if args.trace_out:
        print(f"fleet trace → {args.trace_out} (open in ui.perfetto.dev)")


def _print_online(args, load, snap, dt, before):
    lat = snap["latency"]
    print(f"online: served {load.n_served}/{len(load.handles)} requests "
          f"({len(load.rejected)} rejected) in {dt:.2f}s wall on "
          f"{args.device}, {snap['batches']} batches "
          f"[{', '.join(f'{k}:{v}' for k, v in snap['close_reasons'].items())}]")
    print(f"occupancy: K={snap['k_occupancy_mean']:.3f} "
          f"M={snap['m_occupancy_mean']:.3f}, "
          f"queue depth mean={snap['queue_depth_mean']:.1f} "
          f"max={snap['queue_depth_max']}")
    print(f"latency: p50={lat['p50_s']*1e3:.2f}ms "
          f"p95={lat['p95_s']*1e3:.2f}ms p99={lat['p99_s']*1e3:.2f}ms")
    stalls = snap["reduction_stalls"]
    print(f"reduction stalls: eager={stalls['eager_folds']} "
          f"deferred={stalls['deferred_folds']}")
    disp = snap["dispatch"]
    print(f"dispatch: {disp['dispatches']} launches "
          f"({disp['merged_dispatches']} merged, "
          f"{disp['batches_per_dispatch_mean']:.2f} batches/launch), "
          f"M-occ {disp['m_occupancy_mean']:.3f} "
          f"M-fill {disp['m_fill_mean']:.3f}; kernel launches "
          f"{_launched(before)}")
    if args.controller:
        ctl, hb = snap["controller"], snap["holdback"]
        classes = ", ".join(
            f"{name}: rung {c['target_rows']} "
            f"age {c['max_age_s']*1e3:.1f}ms "
            f"m-occ {c['m_occupancy_ewma']:.3f}"
            for name, c in ctl["classes"].items())
        print(f"controller: {ctl['updates']} updates [{classes}]; "
              f"holdback {hb['held']} held → {hb['wins']} wins / "
              f"{hb['losses']} losses / {hb['flushed']} flushed")
    if args.metrics_out or args.metrics_port:
        met, al = snap.get("metrics", {}), snap.get("alerts", {})
        states = {name: r["state"] for name, r in
                  al.get("rules", {}).items() if r["state"] != "inactive"}
        fired = sum(r["fired"] for r in al.get("rules", {}).values())
        print(f"metrics: {met.get('scrapes', 0)} scrapes / "
              f"{met.get('series', 0)} series; alerts: "
              f"{al.get('events_total', 0)} transitions, {fired} firings"
              + (f", non-inactive {states}" if states else "")
              + (f" → {args.metrics_out}" if args.metrics_out else ""))
    if args.telemetry_out:
        print(f"telemetry JSON → {args.telemetry_out}")
    if args.trace_out:
        print(f"trace → {args.trace_out} (open in ui.perfetto.dev)")


def _lm_stats(cfg, stats) -> str:
    decode = stats["decode_ms_per_token"]
    line = (f"{cfg.name} ({cfg.dtype}) on {stats['device']}: prefill "
            f"{stats['prefill_ms']:.3f} ms, decode "
            + ("-" if decode is None else f"{decode:.3f}") + " ms/token")
    if stats["peak_allocated_bytes"] is None:
        return line + ", peak memory not measured (CPU)"
    return line + (f", peak memory {stats['peak_allocated_bytes'] / 2**20:.1f}"
                   f" MiB allocated, {stats['peak_reserved_bytes'] / 2**20:.1f}"
                   f" MiB reserved")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["crypto", "crypto-online", "lm"],
                    default="crypto")
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--duration", type=float, default=0.05)
    ap.add_argument("--rate", type=float, default=2048)
    ap.add_argument("--n-c", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accum", default="fp32_mantissa",
                    choices=["fp32_mantissa", "int32_native"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument("--max-age-ms", type=float, default=5.0)
    ap.add_argument("--hosts", type=int, default=1,
                    help="shard crypto-online serving across N simulated "
                         "host slices (tenant-hash ingress + gossip + "
                         "distributed drain barrier)")
    ap.add_argument("--gossip-period-ms", type=float, default=2.0,
                    help="queue-depth digest exchange period (cluster mode)")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic host-failure injection (cluster "
                         "mode): comma-separated kill@T:hN / pause@T:hN / "
                         "recover@T:hN events, T a fraction of the run "
                         "duration — e.g. 'kill@0.5:h1,recover@0.9:h1'")
    ap.add_argument("--shed-watermark", type=float, default=None,
                    help="arm watermark load shedding during failover "
                         "transients: fraction of max-pending above which "
                         "non-sticky tenants divert (power-of-two) and "
                         "sticky ones shed")
    ap.add_argument("--device-parallel", action="store_true",
                    help="partition --device's devices across the host "
                         "slices and pin each host's programs/operands/"
                         "twiddle planes to its own slice (cluster mode; "
                         "with fewer devices than hosts, round-robin; "
                         "the default 'cuda' means every card, 'cuda:N' "
                         "that card alone)")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    help="per-tenant token-bucket rate (req/s)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="reject requests predicted to queue past this deadline")
    ap.add_argument("--telemetry-out", default=None,
                    help="write the telemetry snapshot JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="record request-lifecycle tracing and write the "
                         "Chrome-trace/Perfetto JSON here (crypto-online "
                         "and cluster modes; open in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="scrape continuous metrics + run the alert engine "
                         "and write the OpenMetrics exposition here "
                         "(crypto-online and cluster modes; .gz compresses)")
    ap.add_argument("--metrics-period-ms", type=float, default=5.0,
                    help="serving-clock scrape cadence for --metrics-out")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve GET /metrics on this localhost port for "
                         "the run's duration (requires --realtime)")
    ap.add_argument("--deterministic-timing", action="store_true",
                    help="replace measured dispatch wall time with the "
                         "paper's modelled TPU v4 cycle time so latencies, "
                         "EWMAs, metrics series, and alert logs are "
                         "bit-identical across reruns of the same trace")
    ap.add_argument("--realtime", action="store_true",
                    help="pace submissions in wall time (default: virtual clock)")
    ap.add_argument("--reduction", default="eager", choices=["eager", "lazy"],
                    help="default fold discipline for every workload class")
    ap.add_argument("--reduction-by-workload", default=None,
                    help="per-class overrides, e.g. 'dilithium=lazy,bn254=eager'")
    ap.add_argument("--kappa", type=int, default=None,
                    help="lazy deferral window depth (None = whole transform)")
    ap.add_argument("--d-tile", type=int, default=None,
                    help="staging-pass tile width override (e.g. 171 keeps the "
                         "fp32-era pass structure under --accum int32_native)")
    ap.add_argument("--no-merge", action="store_true",
                    help="disable M-axis super-batching of same-class batches")
    ap.add_argument("--row-ladder-max", type=int, default=None,
                    help="pad launch heights up the rungs 8→16→…→MAX "
                         "(bounds the distinct launch heights per class)")
    ap.add_argument("--donate", action="store_true",
                    help="recorded only: each captured program's static "
                         "input is the donated buffer")
    ap.add_argument("--async-pipeline", action="store_true",
                    help="zero-sync dispatch: launch now, gather at the next "
                         "serving event")
    ap.add_argument("--controller", action="store_true",
                    help="closed-loop close policy: adapt per-class target "
                         "rung / max-age / occupancy from dispatch telemetry "
                         "(static config values become the loop's bounds)")
    ap.add_argument("--holdback-lambda", type=float, default=0.0,
                    help="cross-event merge holdback aggressiveness (0 "
                         "disables; requires --controller; SLO-priced)")
    ap.add_argument("--inflight-depth", type=int, default=1,
                    help="depth-k multi-flight launch ring per workload "
                         "class (k>1 requires --async-pipeline)")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="recorded only: the CUDA kernels are cached on "
                         "disk by source hash")
    ap.add_argument("--arrival-batch", type=int, default=None,
                    help="feed the trace through the vectorised submit_many "
                         "ingress edge in chunks of this many arrivals "
                         "(virtual clock only)")
    ap.add_argument("--scalar-admission", action="store_true",
                    help="per-tenant TokenBucket dict instead of the "
                         "columnar (structured-array) admission state — the "
                         "bit-identical oracle path")
    args = ap.parse_args(argv)

    reduction_by_workload = None
    if args.reduction_by_workload:
        try:
            reduction_by_workload = dict(
                kv.split("=", 1) for kv in args.reduction_by_workload.split(","))
        except ValueError:
            ap.error("--reduction-by-workload expects 'class=mode[,class=mode]'"
                     f", e.g. 'dilithium=lazy' (got "
                     f"{args.reduction_by_workload!r})")

    if args.mode == "lm":
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        toks, dt, stats = serve_lm(cfg, decode_steps=args.decode_steps,
                                   seed=args.seed, device=args.device)
        print(f"decoded {toks.shape} tokens in {dt:.2f}s")
        print(_lm_stats(cfg, stats))
        return
    before = (K1.launches, K2.launches)
    if args.mode == "crypto-online" and args.hosts > 1:
        load, snap, dt = serve_crypto_cluster(
            hosts=args.hosts, duration_s=args.duration, rate_hz=args.rate,
            n_c=args.n_c, max_age_s=args.max_age_ms / 1e3, seed=args.seed,
            tenant_rate_hz=args.tenant_rate,
            slo_deadline_s=None if args.slo_ms is None else args.slo_ms / 1e3,
            accum=args.accum, reduction=args.reduction,
            reduction_by_workload=reduction_by_workload,
            kappa=args.kappa, d_tile=args.d_tile,
            gossip_period_s=args.gossip_period_ms / 1e3,
            merge_dispatch=not args.no_merge,
            row_ladder_max=args.row_ladder_max, donate=args.donate,
            async_pipeline=args.async_pipeline,
            controller=args.controller,
            holdback_lambda=args.holdback_lambda,
            inflight_depth=args.inflight_depth,
            compilation_cache_dir=args.compilation_cache_dir,
            telemetry_out=args.telemetry_out, trace_out=args.trace_out,
            metrics_out=args.metrics_out,
            metrics_period_s=args.metrics_period_ms / 1e3,
            deterministic_timing=args.deterministic_timing,
            realtime=args.realtime, arrival_batch=args.arrival_batch,
            columnar_admission=not args.scalar_admission,
            fault_plan=args.fault_plan, shed_watermark=args.shed_watermark,
            device_parallel=args.device_parallel, device=args.device)
        _print_cluster(args, load, snap, dt, before)
        return
    if args.mode == "crypto-online":
        load, snap, dt = serve_crypto_online(
            duration_s=args.duration, rate_hz=args.rate, n_c=args.n_c,
            max_age_s=args.max_age_ms / 1e3, seed=args.seed,
            tenant_rate_hz=args.tenant_rate,
            slo_deadline_s=None if args.slo_ms is None else args.slo_ms / 1e3,
            accum=args.accum, reduction=args.reduction,
            reduction_by_workload=reduction_by_workload,
            kappa=args.kappa, d_tile=args.d_tile,
            merge_dispatch=not args.no_merge,
            row_ladder_max=args.row_ladder_max, donate=args.donate,
            async_pipeline=args.async_pipeline,
            controller=args.controller,
            holdback_lambda=args.holdback_lambda,
            inflight_depth=args.inflight_depth,
            compilation_cache_dir=args.compilation_cache_dir,
            telemetry_out=args.telemetry_out, trace_out=args.trace_out,
            metrics_out=args.metrics_out,
            metrics_period_s=args.metrics_period_ms / 1e3,
            metrics_port=args.metrics_port,
            deterministic_timing=args.deterministic_timing,
            realtime=args.realtime, arrival_batch=args.arrival_batch,
            columnar_admission=not args.scalar_admission,
            device=args.device)
        _print_online(args, load, snap, dt, before)
        return
    results, n_ops, dt = serve_crypto(duration_s=args.duration,
                                      rate_hz=args.rate, n_c=args.n_c,
                                      seed=args.seed, accum=args.accum,
                                      device=args.device)
    print(f"sequencer: {n_ops} tenant ops in {dt:.2f}s "
          f"({n_ops/dt:.0f} ops/s on {args.device}), "
          f"{len(results)} stacked batches dispatched, structurally validated; "
          f"kernel launches {_launched(before)}")


if __name__ == "__main__":
    main()
