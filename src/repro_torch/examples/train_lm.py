"""Train a small LM end-to-end with the port's training stack: the sharded
data pipeline, AdamW, the fault-tolerant loop with rotating checkpoints and
the straggler watchdog — the JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 100] \
        [--inject-fault] [--device cpu]

The default preset is the JAX example's ~5M-parameter OLMo-family model
(4 layers, d 256, vocab 4096, float32); ``--preset 100m`` is its ~100M one.
``--inject-fault`` fails step 37 once, so the loop restores the step-20
checkpoint and resumes.  Checkpoints go to a temporary directory (under
``ckpt_root`` when ``main`` is given one).
"""
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.examples import parser
from repro_torch.launch.train import build
from repro_torch.runtime import FaultTolerantLoop


def main(argv=None, *, ckpt_root=None) -> FaultTolerantLoop:
    """Runs the demo; returns the finished loop (model, optimizer state,
    metrics, watchdog, restarts)."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--preset", choices=["demo", "100m"], default="demo")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--inject-fault", action="store_true",
                    help="kill step 37 once to demonstrate checkpoint/restart")
    args = ap.parse_args(argv)

    base = get_config("olmo_1b")
    if args.preset == "demo":
        cfg = dataclasses.replace(
            base, name="olmo_demo_5m", n_layers=4, d_model=256, n_heads=4,
            n_kv_heads=4, d_head=64, d_ff=1024, vocab_size=4096,
            dtype="float32", blockwise_attn_threshold=4096)
    else:
        cfg = dataclasses.replace(
            base, name="olmo_100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_head=64, d_ff=3072, vocab_size=32768,
            dtype="float32")
    print(f"training {cfg.name}: ~{cfg.params_count()/1e6:.1f}M params, "
          f"seq={args.seq_len}, batch={args.global_batch}, steps={args.steps}")

    model, opt_state, step, stream = build(
        cfg, device=args.device, seq_len=args.seq_len,
        global_batch=args.global_batch, total_steps=args.steps)

    crashed = {"done": False}

    def fault(step_idx):
        if args.inject_fault and step_idx == 37 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure (demo)")

    with tempfile.TemporaryDirectory(dir=ckpt_root) as ckpt:
        loop = FaultTolerantLoop(step, stream, model, opt_state,
                                 ckpt_dir=ckpt, ckpt_every=20,
                                 fault_hook=fault)
        loop.run(args.steps)
    losses = [m["loss"] for m in loop.metrics_log]
    k = max(len(losses) // 10, 1)
    print(f"loss: first10={sum(losses[:k])/k:.4f} "
          f"last10={sum(losses[-k:])/k:.4f} "
          f"(decreased: {sum(losses[-k:]) < sum(losses[:k])})")
    print(f"median step {loop.watchdog.median*1e3:.0f}ms, "
          f"restarts={loop.restarts}, stragglers={loop.watchdog.flagged}")
    return loop


if __name__ == "__main__":
    main()
