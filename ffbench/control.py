"""The control of the correctness check, at a cell's own size: the plain
reference computed one precision lower (float32 with TF32 off, against the
float64 of the check) stands in the program's place for the requests a run
of the cell offers, and is judged by the same comparison.  It has to come
out wrong; its ``wrong_rows`` is the upper reading that the limit (0) lies
below.  The benchmark's own runs do not run it.

    python3 ffbench/control.py --workload <cell> --seeds <a,b,c> [--rows N]

``--rows`` defaults to the requests of one run of an open-loop cell,
``rate_hz`` x ``run_seconds``; a closed loop's count depends on the program's
speed, so it is given (the most a run of the cell has answered).
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell_name: str, seeds, rows: int | None, device: str,
             root: Path = ROOT) -> list[dict]:
    import torch

    from ffbench import check, gen, harness
    cell = harness.Cell(cell_name, root)
    seconds = cell.bench["run_seconds"]
    if rows is None:
        if cell.traffic["loop"] != "open":
            raise ValueError("a closed-loop cell's control needs its rows")
        rows = int(float(cell.traffic["rate_hz"]) * seconds)
    out = []
    for seed in seeds:
        src = gen.RequestSource(cell.config, seed, "window", device)
        answers = [(src.get(i)[1], None) for i in range(rows)]
        out.append({"seed": seed, "rows": rows, "wrong_rows": check.compare(
            answers, cell.config, device, control=torch.float32)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", type=int)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    res = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   args.rows, "cuda")
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "readings": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
