"""Deterministic sharded synthetic LM data pipeline — a copy of
``repro.data.pipeline`` (pure numpy, so its batches equal the JAX package's
bit for bit), plus :func:`batch_to_device`.

Counter-based randomness (Philox keyed by (seed, step, host_shard)) makes
every batch a pure function of the step index — so restarts, elastic
re-sharding, and backup-worker re-issue (straggler mitigation) all reproduce
bit-identical data without coordination.  The iterator state is a single
integer; it checkpoints alongside the model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    frontend_len: int = 0      # >0: also emit stub modality embeddings
    d_model: int = 0


class SyntheticLMStream:
    """Per-host shard of the global batch; state = step counter."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._step = 0

    def _rng(self, step: int) -> np.random.Generator:
        mixed = (self.cfg.seed * 0x9E3779B97F4A7C15 + self.host_id) % (1 << 64)
        key = np.array([mixed, step], np.uint64)
        return np.random.Generator(np.random.Philox(key=key))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        # structured synthetic data: Zipf-ish marginals + local repetition so
        # the LM loss actually decreases during the example training run
        z = rng.zipf(1.3, size=(self.local_batch, self.cfg.seq_len + 1))
        tokens = (z % self.cfg.vocab_size).astype(np.int32)
        rep = rng.integers(0, self.cfg.seq_len // 2 + 1)
        tokens[:, rep: 2 * rep] = tokens[:, :rep]  # copy motif
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.cfg.frontend_len:
            out["embeds"] = rng.normal(
                size=(self.local_batch, self.cfg.frontend_len,
                      self.cfg.d_model)).astype(np.float32)
        return out

    def __next__(self) -> dict:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    def __iter__(self):
        return self

    # --- checkpointable state -------------------------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed,
                "host_id": self.host_id, "n_hosts": self.n_hosts}

    def restore(self, state: dict):
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"stream state of seed {state['seed']}, this "
                             f"stream's seed is {self.cfg.seed}")
        self._step = int(state["step"])

    def reshard(self, host_id: int, n_hosts: int) -> "SyntheticLMStream":
        """Elastic re-sharding: same global stream, new host partition."""
        s = SyntheticLMStream(self.cfg, host_id=host_id, n_hosts=n_hosts)
        s._step = self._step
        return s


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: tokens and labels as int64
    (the embedding's and the loss's index type), ``embeds`` as float32."""
    return {k: torch.from_numpy(np.asarray(v)).to(
                device, torch.float32 if k == "embeds" else torch.int64)
            for k, v in batch.items()}
