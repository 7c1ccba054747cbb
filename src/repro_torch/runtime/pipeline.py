"""GPipe-style pipeline parallelism over a mesh axis (PP) — the counterpart
of ``repro.runtime.pipeline``.

The layer stack is split into S contiguous stages; stage i's parameters
live on the device of position i along the mesh axis.  Microbatches stream
through the pipeline with a hop to the next position's device between
stages — the classic (M + S − 1)-tick schedule with bubble fraction
(S−1)/(M+S−1).

Single controller, as JAX's ``shard_map`` is: one process runs every stage
on its own device, tick by tick.  Every stage computes on every tick, the
bubble ticks included (on zeros or a stale carry, never emitted), as JAX's
``fori_loop`` does; a hop is a copy to the next position's device (JAX's
ring ``ppermute``; the wrap to stage 0 is ignored), and the last stage's
outputs are gathered onto the caller's device, where JAX ``psum``s them
with zeros (which gives the same values, except that a −0.0 becomes +0.0).
Forward only (serving / evaluation), as in JAX.
"""
from __future__ import annotations

import torch
from torch import nn


def _to(tree, device):
    """A stage's parameters on ``device``: tensors copied (a no-op where
    they are), modules moved in place, dicts, lists and tuples walked."""
    if isinstance(tree, (torch.Tensor, nn.Module)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _stage(stage_params, i: int):
    """Stage i's parameters: entry i of a list or tuple of S stages, or row
    i of every tensor of a tensor or dict with a leading stage axis (JAX's
    layout)."""
    if isinstance(stage_params, (list, tuple)):
        return stage_params[i]
    if isinstance(stage_params, dict):
        return {k: _stage(v, i) for k, v in stage_params.items()}
    return stage_params[i]


def pipeline_forward(stage_fn, stage_params, x_microbatches, *, mesh,
                     axis: str = "pod"):
    """stage_fn(params_stage, x) -> y; all stages shape-preserving.

    stage_params: S stages (a list, or tensors with a leading axis S ==
    the mesh axis's size); stage i runs on the device of position i along
    ``axis``.  x_microbatches: (M, mb, ...).  Returns the (M, mb, ...)
    outputs after all S stages, on ``x_microbatches``' device."""
    devices = mesh.axis_devices(axis)
    s = mesh.shape[axis]
    m = x_microbatches.shape[0]
    n_ticks = m + s - 1
    params = [_to(_stage(stage_params, i), devices[i]) for i in range(s)]
    xs = x_microbatches.to(devices[0])
    mb_shape = x_microbatches.shape[1:]
    carry = [torch.zeros(mb_shape, dtype=xs.dtype, device=dev)
             for dev in devices]
    outputs = [None] * m
    for t in range(n_ticks):
        ys = []
        for i in range(s):
            # stage 0 ingests microbatch t; the others take the hopped carry
            x_in = xs[min(t, m - 1)] if i == 0 else carry[i]
            ys.append(stage_fn(params[i], x_in))
        # the last stage emits microbatch t - (S-1) when valid
        if 0 <= t - (s - 1) < m:
            outputs[t - (s - 1)] = ys[-1]
        # hop: stage i -> stage i+1 (the ring's wrap to stage 0 is unused)
        carry = [carry[0]] + [ys[i].to(devices[i + 1]) for i in range(s - 1)]
    home = x_microbatches.device
    return torch.stack([y.to(home) for y in outputs])


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
