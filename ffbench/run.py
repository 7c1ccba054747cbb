"""Run one cell of the benchmark once and print its result line.

    python3 ffbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and metrics are read from
``BENCHMARK.json`` and the files under ``ffbench/``; the program under test
is the ``repro_torch`` package under ``src/``.  The last line of standard
output is the result (one JSON object); the last lines of standard error
give each number compared with its limit.  Exits non-zero, printing no
result, without enough CUDA devices, or if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ffbench import harness
    chips = int(harness.Cell(args.workload).entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ffbench: the cell needs {chips} CUDA device(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, _ = harness.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"ffbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
