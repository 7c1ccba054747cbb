"""Fault-tolerant training loop + straggler watchdog — the counterpart of
``repro.runtime.fault_tolerance``.

* checkpoint/restart: every K steps through CheckpointManager (rotated,
  integrity-hashed); on ANY step failure — a non-finite loss included — the
  loop restores the last checkpoint into the model, the optimizer state and
  the data stream's cursor, and resumes.  Injected faults in tests prove
  identical recovery.  The loop starts at step 0 and refuses a directory
  that already holds checkpoints: rotation by step number would delete the
  new run's and a restore would read the old run's.
* straggler mitigation: per-step wall-clock watchdog flags outlier steps
  (p50 × factor); at scale the flagged host would be cordoned and its data
  shard re-issued — re-issue is free here because the pipeline is
  counter-based (see repro_torch.data.pipeline).
* over a mesh (``launch.train.build(mesh=)``) the loop runs on every rank
  of the process group.  The step's metrics are replicated, so every rank
  reads the same loss, sees the same non-finite value and restores
  together; checkpoints are gathered on every rank and written by rank 0
  (:mod:`repro_torch.checkpoint.manager`).  Only rank 0 checks that the
  directory is empty, and every rank gets its answer.  A fault that one
  rank alone sees is out of scope: that rank would restore while the
  others wait in the step's next collective.  There is no watchdog across
  ranks, as the JAX loop has none.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import batch_to_device
from repro_torch.device import process_group


class StepWatchdog:
    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.durations: list[float] = []
        self.factor = factor
        self.warmup = warmup
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float):
        self.durations.append(seconds)
        if len(self.durations) > self.warmup:
            p50 = float(np.median(self.durations[:-1]))
            if seconds > self.factor * p50:
                self.flagged.append(step)

    @property
    def median(self) -> float:
        return float(np.median(self.durations)) if self.durations else 0.0


class FaultTolerantLoop:
    """Run (train_step, stream) on ``model`` to `total_steps` surviving
    injected faults.  ``train_step(model, opt_state, batch)`` is
    :func:`repro_torch.models.steps.make_train_step`'s (or, over a mesh,
    ``launch.train.build``'s); the stream's numpy batches go to the model's
    device.  A checkpoint holds ``{"params": model.state_dict(), "opt":
    opt_state}`` and the stream's state.  ``ckpt_dir`` must hold no
    checkpoint yet (``FileExistsError``, on every rank)."""

    def __init__(self, train_step, stream, model, opt_state, *,
                 ckpt_dir: str, ckpt_every: int = 10, keep: int = 3,
                 fault_hook=None, max_restarts: int = 10):
        dist = process_group()
        held = [latest_step(ckpt_dir)
                if dist is None or dist.get_rank() == 0 else None]
        if dist is not None:
            # rank 0 reads the directory, every rank gets its answer
            dist.broadcast_object_list(held, src=0)
        if held[0] is not None:
            raise FileExistsError(f"{ckpt_dir} already holds checkpoints "
                                  f"(step {held[0]}): give each run a new "
                                  f"directory")
        self.train_step = train_step
        self.stream = stream
        self.model = model
        self.opt_state = opt_state
        self.manager = CheckpointManager(ckpt_dir, keep=keep, async_save=False)
        self.ckpt_every = ckpt_every
        self.fault_hook = fault_hook
        self.max_restarts = max_restarts
        self.watchdog = StepWatchdog()
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def _save(self, step: int):
        self.manager.save(step, {"params": self.model.state_dict(),
                                 "opt": self.opt_state},
                          extra={"data": self.stream.state(), "step": step})

    def _restore(self):
        like = {"params": self.model.state_dict(), "opt": self.opt_state}
        tree, extra = self.manager.restore_latest(like)
        self.model.load_state_dict(tree["params"])
        self.opt_state = tree["opt"]
        self.stream.restore(extra["data"])
        return int(extra["step"])

    def run(self, total_steps: int):
        """Returns (model, opt_state) after ``total_steps`` steps."""
        self._save(0)
        step = 0
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = batch_to_device(next(self.stream), self.model.device)
                self.model, self.opt_state, metrics = self.train_step(
                    self.model, self.opt_state, batch)
                loss = float(metrics["loss"])     # the step's sync point
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                self.watchdog.record(step, time.monotonic() - t0)
                self.metrics_log.append(
                    {"step": step, "loss": loss,
                     "grad_norm": float(metrics["grad_norm"])})
                step += 1
                if step % self.ckpt_every == 0:
                    self._save(step)
            except Exception:  # noqa: BLE001 — any step failure restores
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step = self._restore()
        self._save(total_steps)
        return self.model, self.opt_state
