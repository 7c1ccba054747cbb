"""One point of a configuration's knee sweep: a fresh process, set up as a
benchmark run is, serving one open-loop window of Poisson arrivals at a given
rate (``--rate``), or a closed loop of 512 clients (``--rate 0``).

    python3 ffbench/sweep.py --cell <open-loop cell> --rate <hz> --seed <n>
        [--seconds <run_seconds>]

It prints one JSON line: p50/p95/p99 latency from the due time, the
generator's lag (the median over the first and the last tenth of the
arrivals, and p99), rejections, the window's garbage-collector passes, and
whether the rate ``keeps_pace``: the last tenth's median lag under 1 ms
(the queue does not grow) and p95 within LATENCY_LIMIT_MS.

The knee is the highest rate of a sweep that keeps pace, below which every
rate does; an open-loop cell's rate is four fifths of it.  The latency limit
is twice the configuration's 5 ms max-age: what batching alone may add.
A rate at which the window's p95 leaves it is not sustained, even though the
queue drains between stalls.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

LATENCY_LIMIT_MS = 10.0
PACE_LAG_MS = 1.0


def point(cell: str, rate: float, seed: int, seconds: float,
          device: str = "cuda", t_start: float | None = None) -> dict:
    from ffbench import harness
    from ffbench.stats import percentile
    base = harness.Cell(cell).traffic
    if rate > 0:
        traffic = dict(base, loop="open", arrival="poisson", rate_hz=rate)
    else:
        traffic = harness.load_json(harness.HERE / "traffic"
                                    / "closed512.json")
    result, rec = harness.run(cell, seed, seconds, False, device=device,
                              t_start=t_start, traffic=traffic)
    out = {"cell": cell, "rate_hz": rate, "seed": seed, "seconds": seconds,
           "correct": result["correct"],
           "requests": result["notes"]["window_requests"],
           "rejected": result["notes"]["rejected"],
           "gc": result["notes"]["window_gc"]["gen2"]}
    if rate <= 0:
        out["ops_per_s"] = rec["served_in_window"] / seconds
        return out
    lat, lags = rec["latencies_s"], rec["lags_s"]
    tenth = max(1, len(lags) // 10)
    out.update({
        "p50_ms": percentile(lat, 50) * 1e3,
        "p95_ms": percentile(lat, 95) * 1e3,
        "p99_ms": percentile(lat, 99) * 1e3,
        "lag_ms_first_tenth": statistics.median(lags[:tenth]) * 1e3,
        "lag_ms_last_tenth": statistics.median(lags[-tenth:]) * 1e3,
        "lag_ms_p99": percentile(lags, 99) * 1e3,
    })
    out["keeps_pace"] = (out["lag_ms_last_tenth"] < PACE_LAG_MS
                         and out["p95_ms"] <= LATENCY_LIMIT_MS)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    from ffbench import harness
    seconds = args.seconds or harness.Cell(args.cell).bench["run_seconds"]
    res = point(args.cell, args.rate, args.seed, seconds, t_start=T_START)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
