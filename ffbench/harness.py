"""One run of one cell: set-up, the measured window, the traced window (with
``--trace 1``), the check, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that the configuration's
entry names; its traffic in ``traffic/<name>.json``; each metric's reader in
``metrics/<name>.py``.

The run, in order:

1. set-up, which ``setup_s`` measures: import, the CUDA context, the
   server built from the configuration's ``serve`` settings
   (``ServeConfig``) on the card, the kernel library (built once into the
   checkout's ``build/``), and a warm-up on the cell's own traffic from a
   stream of its own (``n_c`` requests of every bucket, then rounds of
   WARMUP_ROUND_S of the loop until one captures no new program), ending
   when the device has finished the warm-up's work;
2. the load generator's own preparation, outside every metric: the
   window's requests drawn (a closed loop's POOL_MARGIN times what the
   last warm-up round served) and the heap collected, so that every window
   starts from the same settled heap;
3. the window: ``--seconds`` of the cell's loop, untraced;
4. with ``--trace 1``, a traced window: the loop goes on under
   torch.profiler (CPU and CUDA) for TRACE_SETTLE_S + TRACE_WINDOW_S, and
   the last TRACE_WINDOW_S are read;
5. every outstanding request is answered (pumped, then drained);
6. the peak device memory is read, the server freed, and every answered
   row compared with the plain reference on the card.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ffbench import check, gen, work
from ffbench.loops import Loop, clock

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SETTLE_S = 0.5
TRACE_WINDOW_S = 3.0
SETTLE_CAP_S = 60.0
WARMUP_ROUND_S = 0.5
WARMUP_ROUNDS_MAX = 20
POOL_MARGIN = 2.0


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Cell:
    """One ``workloads`` entry of BENCHMARK.json with what it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.here = here = Path(root) / HERE.name
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "ffbench_metric_" + "".join(c if c.isalnum() else "_"
                                        for c in metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class GcWatch:
    """Garbage-collector passes from construction to ``close``: count,
    seconds and the longest pause of each generation (``gc.callbacks``)."""

    def __init__(self):
        self.passes = [[0, 0.0, 0.0] for _ in range(3)]
        self._t = 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = clock()
        else:
            dt = clock() - self._t
            p = self.passes[info["generation"]]
            p[0] += 1
            p[1] += dt
            p[2] = max(p[2], dt)

    def close(self):
        gc.callbacks.remove(self)


def _window_telemetry():
    from repro_torch.serve.telemetry import Telemetry

    class WindowTelemetry(Telemetry):
        """The server's telemetry, keeping every queue-wait sample in
        order so that the window's own can be sliced out."""

        def __init__(self):
            super().__init__()
            self.queue_waits: list[float] = []

        def observe_latency(self, seconds, *, queue_wait_s=None):
            super().observe_latency(seconds, queue_wait_s=queue_wait_s)
            self.queue_waits.append(queue_wait_s)

    return WindowTelemetry()


def build_server(config: dict, device: str):
    from repro_torch.serve.server import (CryptoServer, ServeConfig,
                                          coscheduler_from_config)
    cfg = ServeConfig(**config["serve"])
    cos = coscheduler_from_config(cfg, device=device)
    return CryptoServer(cfg, coscheduler=cos, telemetry=_window_telemetry())


def _marks(server) -> tuple[int, int, int]:
    t = server.telemetry
    return len(t.dispatches), len(t.batches), len(t.queue_waits)


def _captures(server) -> int:
    return sum(server.cos.trace_counts.values())


def warm_up(server, cfg: dict, traffic: dict, seed: int,
            device: str) -> float:
    """Warm the server on the cell's own traffic; returns the requests a
    second that the last round served."""
    law = cfg["degrees"]
    top = gen.max_degree(law)
    n_c = server.config.n_c
    # n_c requests of each bucket, at the largest degree the law allows in
    # it, so that every class is validated and captured before the loop
    degrees = [min(b, top) for b in gen.buckets(law) for _ in range(n_c)]
    prime = Loop(server, gen.RequestSource(cfg, seed, "prime", device,
                                           degrees=degrees),
                 cfg["workload"])
    for _ in degrees:
        prime.submit()
    prime.settle(SETTLE_CAP_S, drain=False)
    loop = Loop(server, gen.RequestSource(cfg, seed, "warmup", device),
                cfg["workload"])
    rate = 0.0
    for r in range(WARMUP_ROUNDS_MAX):
        before, n0, t0 = _captures(server), len(loop), clock()
        drive(loop, traffic, WARMUP_ROUND_S, seed, f"warmup{r}")
        rate = (len(loop) - n0) / (clock() - t0)
        if _captures(server) == before:
            break
    loop.settle(SETTLE_CAP_S, drain=False)
    return rate


def drive(loop: Loop, traffic: dict, seconds: float, seed: int,
          stream: str):
    """Offer ``seconds`` of the traffic law from now."""
    t0 = clock()
    if traffic["loop"] == "closed":
        loop.closed(int(traffic["concurrency"]), t0 + seconds)
    elif traffic["loop"] == "open":
        if traffic["arrival"] != "poisson":
            raise ValueError(f"unknown arrival law {traffic['arrival']!r}")
        loop.open(t0 + gen.poisson_arrivals(float(traffic["rate_hz"]),
                                            seconds, seed, stream))
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")


def _pool_size(traffic: dict, seconds: float, warm_rate: float) -> int:
    """Requests to draw before the window: an open loop's schedule, or
    POOL_MARGIN times what a closed loop served in its last warm-up round
    (a window that outruns it draws the rest late, and says so)."""
    if traffic["loop"] == "closed":
        return (int(math.ceil(POOL_MARGIN * warm_rate * seconds))
                + int(traffic["concurrency"]))
    return int(round(float(traffic["rate_hz"]) * seconds)) + 1


def _host_counters() -> dict:
    t = os.times()
    return {"user_s": t.user, "sys_s": t.system}


def _per_second(seen, t0: float, seconds: float) -> list[int]:
    """Requests seen in each whole second of the window."""
    out = [0] * max(1, int(seconds))
    for t in seen:
        k = int(t - t0) if t >= t0 else -1
        if 0 <= k < len(out):
            out[k] += 1
    return out


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _traced(loop: Loop, server, traffic: dict, seed: int):
    """The traced window: the loop under torch.profiler; returns the
    device summary and the launches inside the read part."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ffbench import devtrace
    spans: list = []
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        drive(loop, traffic, TRACE_SETTLE_S, seed, "trace_settle")
        with record_function(devtrace.WINDOW):
            t_ns0 = time.perf_counter_ns()
            d0 = len(server.telemetry.dispatches)
            loop.spans = spans
            drive(loop, traffic, TRACE_WINDOW_S, seed, "trace_window")
            loop.spans = None
            d1 = len(server.telemetry.dispatches)
        if on_card:
            torch.cuda.synchronize()
    summary = devtrace.read_events(devtrace.profile_events(prof), spans,
                                   t_ns0)
    return summary, server.telemetry.dispatches[d0:d1]


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        root: Path = ROOT, traffic: dict | None = None) -> tuple[dict, dict]:
    """One run; returns the result line and the record its metrics were
    read from.  ``traffic`` stands in for the cell's traffic file (the knee
    sweep's rates)."""
    t_start = clock() if t_start is None else t_start
    cell = Cell(cell_name, root)
    cfg = cell.config
    traffic = cell.traffic if traffic is None else traffic
    on_card = device != "cpu"
    t_import = clock()
    server = build_server(cfg, device)
    t_server = clock()
    warm_rate = warm_up(server, cfg, traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    # Set-up ends here: what follows is the load generator's, which users
    # of the server never wait for and which grows with the warm-up's rate.
    t_warm = clock()
    source = gen.RequestSource(cfg, seed, "window", device)
    pool = _pool_size(
        traffic, seconds + (TRACE_SETTLE_S + TRACE_WINDOW_S if trace else 0),
        warm_rate)
    source.prefetch(pool)
    t_drawn = clock()
    loop = Loop(server, source, cfg["workload"])
    captures0 = _captures(server)
    # Every run starts its window from a settled heap: the set-up's garbage
    # collected, so no full pass is already due when the window opens.
    gc.collect()

    gcw = GcWatch()
    host0 = _host_counters()
    t0 = clock()
    m0 = _marks(server)
    drive(loop, traffic, seconds, seed, "window")
    t1 = clock()
    m1 = _marks(server)
    host1 = _host_counters()
    gcw.close()
    n_window = len(loop)
    captures_in_window = _captures(server) - captures0

    summary, traced_launches = None, []
    if trace:
        summary, traced_launches = _traced(loop, server, traffic, seed)
    loop.settle(SETTLE_CAP_S, drain=True)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    tel = server.telemetry
    end = t0 + seconds
    seen = loop.seen[:n_window]
    rec = {
        "loop": traffic["loop"],
        "seconds": seconds,
        "setup_s": t_warm - t_start,
        "served_in_window": sum(1 for t in seen if t <= end),
        "latencies_s": [math.inf if math.isnan(t) else t - due
                        for t, due in zip(seen, loop.due)],
        "lags_s": [t - due for t, due in zip(loop.submitted[:n_window],
                                             loop.due)],
        "queue_waits_s": tel.queue_waits[m0[2]:m1[2]],
        "launches": [(r.d_bucket, r.live_rows, r.launched_rows)
                     for r in tel.dispatches[m0[0]:m1[0]]],
        "service_s": sum(b.service_s for b in tel.batches[m0[1]:m1[1]]),
        "window_wall_s": t1 - t0,
        "gc_s": sum(p[1] for p in gcw.passes),
    }
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    if summary is not None:
        shape = work.launch_shape(cfg)
        peak = work.peaks(kind) if on_card else None
        summary["least_s"] = sum(
            work.launch_least_s(r.d_bucket, r.live_rows, peak=peak, **shape)
            for r in traced_launches) if peak else 0.0
        summary["power_limit"] = power_limit() if on_card else None
        rec["trace"] = summary

    rejected = loop.n_rejected
    late_chunks = source.drawn_late
    loop.server = None
    del server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = clock()
    checks = check.judge(loop, cfg, device)
    t_check = clock() - t_check

    kind_of = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind_of):
        value = cell.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        if summary.get("power_limit"):
            dev["power_limit"] = summary["power_limit"]
    result = {
        "correct": check.passed(checks),
        "attempted": len(loop),
        "failed": rejected + checks["wrong_rows"]["value"]
        + checks["missing_rows"]["value"],
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["notes"] = {
        "window_requests": n_window, "rejected": rejected,
        "captures_in_window": captures_in_window,
        "late_payload_chunks": late_chunks,
        "payload_requests_drawn": pool,
        "window_wall_s": rec["window_wall_s"],
        "window_host": {k: host1[k] - host0[k] for k in host0},
        "window_seen_per_s": _per_second(seen, t0, seconds),
        "warm_up_rate": warm_rate,
        "check_s": t_check,
        "window_gc": {f"gen{g}": {"passes": p[0], "s": p[1], "max_s": p[2]}
                      for g, p in enumerate(gcw.passes)},
        "setup_parts_s": {"import": t_import - t_start,
                          "server": t_server - t_import,
                          "warm_up": t_warm - t_server,
                          "payloads": t_drawn - t_warm,
                          "collect": t0 - t_drawn},
    }
    result["checks"] = checks
    return result, rec
