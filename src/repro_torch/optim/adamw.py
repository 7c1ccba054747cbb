"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule — the counterpart of ``repro.optim.adamw``, in plain
tensor functions (not ``torch.optim.AdamW``, which decays as
``p·(1 − lr·wd)`` before the moment step and has neither the clip nor the
schedule).

The state is JAX's: ``{"m": {name: f32}, "v": {name: f32}, "step": 0-d
int32}``, keyed by the port's parameter names and kept on the parameters'
device.  The update takes JAX's order of operations, so its roundings are
JAX's: the clip scale first, the moments in float32, ``(m/b1c)/(sqrt(v/b2c)
+ eps)``, then ``p - lr·(update + wd·p)`` in float32, cast back to the
parameter's dtype.  ``lr`` and the bias corrections are float32 tensors
computed on the device from the int32 step, as JAX computes them, so a step
never waits on the host.  With bf16 parameters an early-warmup update can be
below half an ulp of a weight, which then does not move — as in JAX.

On DTensor parameters (training over a mesh) the same functions run on
each device's shards: ``m`` and ``v`` keep their parameters' placements
(``ShardingRules.tree_opt_specs``), ``step`` is replicated, and the
gradient norm reduces over every shard and every mesh dimension, so it
arrives replicated, as ``lr`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import dtensor_type


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _named(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a dict of tensors as given."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> dict:
    """Float32 zeros beside every parameter (a module or a dict of tensors),
    and a 0-d int32 step on their device.  Beside DTensor parameters the
    zeros are DTensors at the parameters' placements and the step is
    replicated on their mesh."""
    named = _named(params)
    first = next(iter(named.values()))
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in named.items()}
    dtensor = dtensor_type()
    if dtensor is not None and isinstance(first, dtensor):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor import zeros as dzeros
        mesh = first.device_mesh
        step = dzeros((), dtype=torch.int32, device_mesh=mesh,
                      placements=[Replicate()] * mesh.ndim)
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": step}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor, summed tensor
    by tensor in the order given.  Over DTensors each tensor's sum of
    squares is reduced over its shards and every mesh dimension, and the
    norm is replicated."""
    norm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))
    return _placed_like(norm, None)


def _placed_like(t, ref):
    """A DTensor ``t`` at ``ref``'s placements (replicated when ``ref`` is
    None); anything else as it is."""
    dtensor = dtensor_type()
    if dtensor is None or not isinstance(t, dtensor):
        return t
    from torch.distributed.tensor import Replicate
    placements = (ref.placements if ref is not None
                  else [Replicate()] * t.device_mesh.ndim)
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state: dict):
    """One AdamW step.  ``params`` is a module or a dict of tensors, ``grads``
    a dict of gradients under the same names.  The parameters are written in
    place and ``opt_state``'s moments and step replaced in its dicts (the
    counterpart of donating them to the jitted step).  Returns (params,
    opt_state, stats), stats ``{"grad_norm", "lr"}`` as 0-d float32
    tensors."""
    named = _named(params)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads[n] for n in named)
    # a tensor numerator: ``float / tensor`` is a reciprocal and a product
    # in torch, where JAX divides
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in named.items():
        g = grads[name].float() * scale
        m = _placed_like(cfg.b1 * m_all[name] + (1 - cfg.b1) * g,
                         m_all[name])
        v = _placed_like(cfg.b2 * v_all[name] + (1 - cfg.b2)
                         * torch.square(g), v_all[name])
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (update + cfg.weight_decay * p32))
        m_all[name], v_all[name] = m, v
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
