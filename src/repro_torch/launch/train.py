"""Training launcher of the port — the counterpart of
``repro.launch.train``: the model and its AdamW state on one device, the
synthetic stream and the fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \
        [--smoke] [--steps 100] [--device cpu]

prints the JAX launcher's summary line (``steps=... wall=...s
first_loss=... last_loss=... median_step=...ms stragglers=[...]``).
Without ``--smoke`` it is the arch's full published width: run that on the
card.  Checkpoints go to ``--ckpt-dir``, which must hold none yet; by
default each run makes a new directory under ``build/repro_torch/ckpt`` in
the repository.  (The JAX launcher's fixed ``/tmp/repro_ckpt`` lets a second
run's rotation delete its own checkpoints and a fault restore the first
run's state.)
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.models import steps as ST
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultTolerantLoop

CKPT_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "ckpt"


def build(cfg, *, device=None, seq_len=128, global_batch=8, seed=0,
          lr=3e-4, total_steps=1000):
    """(model, opt_state, train_step, stream) for ``cfg`` on ``device``
    (``cuda`` unless the caller passes ``"cpu"``).

    Everything is placed on that one device: the JAX launcher's mesh and
    logical shardings (``make_local_mesh``, ``ShardingRules``) are not
    ported yet.  The step is eager (no counterpart of ``jax.jit``); it
    updates the model and the state in place."""
    dev = resolve_device(device)
    model, opt_state = ST.init_train_state(cfg, seed=seed, device=dev)
    opt_cfg = AdamWConfig(lr=lr, total_steps=total_steps,
                          warmup_steps=max(10, total_steps // 20))
    step = ST.make_train_step(cfg, opt_cfg)
    data_cfg = DataConfig(seq_len=seq_len, global_batch=global_batch,
                          vocab_size=cfg.vocab_size, seed=seed,
                          frontend_len=cfg.frontend_len if cfg.frontend else 0,
                          d_model=cfg.d_model)
    stream = SyntheticLMStream(data_cfg)
    return model, opt_state, step, stream


def main(argv=None) -> FaultTolerantLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="an empty or new directory (default: a new one "
                         "under build/repro_torch/ckpt)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model, opt_state, step, stream = build(
        cfg, device=args.device, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr, total_steps=args.steps)

    if args.ckpt_dir is None:
        CKPT_ROOT.mkdir(parents=True, exist_ok=True)
        args.ckpt_dir = tempfile.mkdtemp(prefix="run_", dir=CKPT_ROOT)
    loop = FaultTolerantLoop(step, stream, model, opt_state,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    t0 = time.time()
    loop.run(args.steps)
    dt = time.time() - t0
    losses = [m["loss"] for m in loop.metrics_log]
    print(f"steps={args.steps} wall={dt:.1f}s "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"median_step={loop.watchdog.median*1e3:.0f}ms "
          f"stragglers={loop.watchdog.flagged}")
    if args.log:
        with open(args.log, "w") as f:
            json.dump({"metrics": loop.metrics_log, "wall_s": dt}, f)
    return loop


if __name__ == "__main__":
    main()
