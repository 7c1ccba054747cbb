"""GPipe-style pipeline parallelism over a mesh axis (PP) — the counterpart
of ``repro.runtime.pipeline``.

The layer stack is split into S contiguous stages; stage i belongs to
position i along the mesh axis.  Microbatches stream through the pipeline
with a hop to the next position between stages — the classic (M + S − 1)-
tick schedule with bubble fraction (S−1)/(M+S−1).  Every stage computes on
every tick, the bubble ticks included (on zeros or a stale carry, never
emitted), as JAX's ``fori_loop`` does; the hop is JAX's ring ``ppermute``,
whose wrap to stage 0 is unused and not sent.  Forward only (serving /
evaluation), as in JAX.

:func:`pipeline_forward` has two forms, chosen by the type of the mesh:

* a :class:`repro_torch.launch.mesh.Mesh` — *single controller*: one
  process runs every stage on its position's device, tick by tick; a hop
  is a copy to the next position's device, and the last stage's outputs
  are gathered onto the caller's device;
* a ``torch.distributed`` ``DeviceMesh`` — *process group*: rank i along
  ``axis`` runs stage i; each tick's hop is a send to the next rank along
  the axis and a receive from the previous one (``batch_isend_irecv``),
  and the last stage broadcasts its outputs to every rank of the axis.

JAX gathers the outputs by ``psum``-ing them with zeros from the other
stages, which gives the same values except that a −0.0 becomes +0.0; both
forms here return the last stage's bits.
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


def _stage(stage_params, i: int, axis: str | None = None):
    """Stage i's parameters: entry i of a list or tuple of S stages, row i
    of every tensor of a tensor or dict with a leading stage axis (JAX's
    layout), or, on a rank of a process group, the one row of its local
    slice of a DTensor sharded ``Shard(0)`` over ``axis``."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(stage_params, (list, tuple)):
        return stage_params[i]
    if isinstance(stage_params, dict):
        return {k: _stage(v, i, axis) for k, v in stage_params.items()}
    if isinstance(stage_params, DTensor):
        dim = stage_params.device_mesh.mesh_dim_names.index(axis)
        if stage_params.placements[dim] != Shard(0):
            raise ValueError(f"stage parameters must be Shard(0) over "
                             f"{axis!r}, got {stage_params.placements}")
        local = stage_params.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a rank holds {local.shape[0]} stages; the "
                             f"stage axis must equal the mesh axis")
        return local[0]
    return stage_params[i]


def _pipeline_group(stage_fn, stage_params, x_microbatches, dmesh,
                    axis: str):
    """This rank's stage of the pipeline over the process group of
    ``dmesh``'s ``axis``; returns the (M, mb, ...) outputs on every rank
    of the axis."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("pipeline_forward over a DeviceMesh needs an "
                           "initialised process group")
    group = dmesh.get_group(axis)
    s = dist.get_world_size(group)
    i = dmesh.get_local_rank(axis)
    m = x_microbatches.shape[0]
    params = _stage(stage_params, i, axis)
    mb_shape = x_microbatches.shape[1:]
    carry = torch.zeros(mb_shape, dtype=x_microbatches.dtype,
                        device=x_microbatches.device)
    outputs = None
    for t in range(m + s - 1):
        # stage 0 ingests microbatch t; the others take the hopped carry
        x_in = x_microbatches[min(t, m - 1)] if i == 0 else carry
        y = stage_fn(params, x_in)
        if outputs is None:
            outputs = y.new_zeros((m,) + tuple(y.shape))
        # the last stage emits microbatch t - (S-1) when valid
        if i == s - 1 and 0 <= t - (s - 1) < m:
            outputs[t - (s - 1)] = y
        # hop: stage i -> stage i+1 (the ring's wrap to stage 0 is unused)
        ops = []
        if i + 1 < s:
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  dist.get_global_rank(group, i + 1), group))
        if i > 0:
            carry = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, carry,
                                  dist.get_global_rank(group, i - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.broadcast(outputs, src=dist.get_global_rank(group, s - 1),
                   group=group)
    return outputs


def pipeline_forward(stage_fn, stage_params, x_microbatches, *, mesh,
                     axis: str = "pod"):
    """stage_fn(params_stage, x) -> y; all stages shape-preserving.

    ``mesh`` a :class:`repro_torch.launch.mesh.Mesh`: stage_params holds S
    stages (a list, or tensors with a leading axis S == the mesh axis's
    size) and stage i runs on the device of position i along ``axis``;
    returns the (M, mb, ...) outputs after all S stages, on
    ``x_microbatches``' device.  ``mesh`` a ``torch.distributed``
    ``DeviceMesh`` (raises without an initialised process group): this
    rank, position i along ``axis``, runs stage i (entry i of a list, or
    its local slice of a DTensor sharded ``Shard(0)`` over ``axis``) on
    its replica of ``x_microbatches``: (M, mb, ...), and returns the
    outputs on every rank of the axis."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return _pipeline_group(stage_fn, stage_params, x_microbatches, mesh,
                               axis)
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
