"""int8 gradient compression with error feedback for the cross-pod reduce —
the counterpart of ``repro.runtime.compression``.

At 1000+ nodes the scarce resource is the inter-pod network: compressing
the cross-pod gradient all-reduce 4× (f32 → int8) with error feedback (the
residual carried to the next step — Seide et al. / EF-SGD) retains
convergence while cutting those bytes 4×.  The quantiser is per-tensor
symmetric.

:func:`compressed_grad_sync` has two forms, chosen by the type of the mesh
it is given, as JAX's ``shard_map`` runs one function on whatever mesh the
program has:

* a :class:`repro_torch.launch.mesh.Mesh` — *single controller*: this one
  process runs every position along ``axis`` (the other axes at index 0),
  each on its own device.  Each position quantises its replica of the
  gradient there; its int8 codes go to the first position's device and are
  widened to int32 only there, summed in position order, and the result is
  copied back to every position.  The returned tensors are the first
  position's;
* a ``torch.distributed`` ``DeviceMesh`` (as ``launch.mesh.device_mesh``
  builds it for ``launch.train.build(mesh=)``) — *process group*: each
  rank runs its own part over the subgroup of ``axis``.  It quantises its
  own replica, the subgroup all-gathers the int8 codes as int8, and every
  rank widens them to int32 and sums them in rank order; ``max(scale)`` is
  an all-reduce MAX.  The new residual stays on its rank.  A DTensor leaf,
  replicated over ``axis`` (any placement on the other axes), syncs its
  local shard and comes back a DTensor of the same placements.

Either way the result is ``sum · max(scale) / n`` in float32 in JAX's order
(n the axis size), the same sum as JAX's int32 ``psum`` at a quarter of its
bytes on the wire (JAX psums ``codes.astype(int32)``, 4 bytes an element,
although its docstring promises an int8 all-reduce).  Inputs and outputs
are replicated over ``axis``, as JAX's ``P()`` specs are.
"""
from __future__ import annotations

import torch


def true_div(x, divisor: float):
    """``x / divisor`` as a quotient.  CUDA divides a tensor by a Python
    number as a product with the number's reciprocal, which can differ from
    the quotient (XLA's, and the CPU's) in the last bit; a divisor tensor
    on the same device is divided."""
    return x / x.new_tensor(divisor)


def quantize_int8(x):
    """f32/bf16 tensor -> (int8 codes, f32 scale)."""
    xf = x.float()
    scale = true_div(torch.clamp(xf.abs().max(), min=1e-12), 127.0)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes, scale):
    return codes.float() * scale


def init_error_state(grads: dict) -> dict:
    """float32 zeros of each gradient's shape on its device (a DTensor's at
    its placements)."""
    return {k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in grads.items()}


def _ef_quantize(g, err):
    target = g.float() + err
    codes, scale = quantize_int8(target)
    recon = dequantize_int8(codes, scale)
    return codes, scale, target - recon   # new residual


def _sync_leaf(g, err, devices: list):
    """One leaf: every position's error-feedback quantisation on its
    device, the int8 codes summed as int32 on the first, averaged with the
    largest scale.  Returns (synced in g's dtype, the new residual), on the
    first position's device."""
    home = devices[0]
    total, scale_max, new_err = None, None, None
    for dev in devices:
        codes, scale, residual = _ef_quantize(g.to(dev), err.to(dev))
        codes, scale = codes.to(home), scale.to(home)
        wide = codes.to(torch.int32)
        total = wide if total is None else total + wide
        scale_max = scale if scale_max is None else torch.maximum(scale_max,
                                                                  scale)
        if new_err is None:
            new_err = residual.to(home)
    # JAX's n is a float32 psum of ones
    synced = true_div(total.float() * scale_max, float(len(devices)))
    return synced.to(g.dtype), new_err


def _sync_leaf_group(g, err, dmesh, axis: str):
    """One leaf on this rank of the process group of ``dmesh``'s ``axis``:
    its error-feedback quantisation, the int8 codes of every rank of the
    axis all-gathered as int8, widened and summed in rank order, the
    largest scale by an all-reduce MAX.  Returns (synced in g's dtype, the
    new residual), both on this rank."""
    import torch.distributed as dist
    group = dmesh.get_group(axis)
    n = dist.get_world_size(group)
    codes, scale, new_err = _ef_quantize(g, err)
    gathered = [torch.empty_like(codes) for _ in range(n)]
    dist.all_gather(gathered, codes, group=group)
    total = gathered[0].to(torch.int32)
    for c in gathered[1:]:
        total = total + c.to(torch.int32)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    synced = true_div(total.float() * scale_max, float(n))
    return synced.to(g.dtype), new_err


def _local(t, axis: str):
    """A leaf's local tensor and, for a DTensor, what rebuilds the DTensor
    of its placements from a local result.  A DTensor leaf must be
    replicated over ``axis``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t, lambda local: local
    dim = t.device_mesh.mesh_dim_names.index(axis)
    if not isinstance(t.placements[dim], Replicate):
        raise ValueError(f"a DTensor leaf must be replicated over {axis!r}, "
                         f"got {t.placements}")
    return t.to_local(), lambda local: DTensor.from_local(
        local, t.device_mesh, t.placements, run_check=False, shape=t.shape,
        stride=t.stride())


def _sync_group(grads: dict, error_state: dict, dmesh, axis: str):
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("compressed_grad_sync over a DeviceMesh needs an "
                           "initialised process group")
    if axis not in (dmesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: "
                         f"{dmesh.mesh_dim_names}")
    synced, new_err = {}, {}
    for name, g in grads.items():
        g_local, g_back = _local(g, axis)
        e_local, e_back = _local(error_state[name], axis)
        s, e = _sync_leaf_group(g_local, e_local, dmesh, axis)
        synced[name], new_err[name] = g_back(s), e_back(e)
    return synced, new_err


def compressed_grad_sync(grads: dict, error_state: dict, *, mesh,
                         axis: str = "pod"):
    """Error-feedback int8 all-reduce of ``grads`` (name → tensor) over
    ``axis`` of ``mesh``: a :class:`repro_torch.launch.mesh.Mesh` (every
    position from this process) or a ``torch.distributed`` ``DeviceMesh``
    (this rank's part, over an initialised process group; raises without
    one).

    The grads are replicated across the axis (the usual post-step state);
    returns (synced grads, new error state), each leaf on its input's
    device (a DTensor leaf at its placements)."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return _sync_group(grads, error_state, mesh, axis)
    devices = mesh.axis_devices(axis)
    synced, new_err = {}, {}
    for name, g in grads.items():
        s, e = _sync_leaf(g, error_state[name], devices)
        synced[name] = s.to(g.device)
        new_err[name] = e.to(error_state[name].device)
    return synced, new_err


def wire_bytes(grads: dict, n_positions: int) -> dict:
    """Bytes one position receives in a sync: int8 codes from each of the
    other positions (the first position, single controller; every rank of
    the process group's all-gather), against the same exchange at an int32
    ``psum``'s 4 bytes an element (JAX's)."""
    elems = sum(g.numel() for g in grads.values())
    return {"int8": (n_positions - 1) * elems,
            "int32_psum": 4 * (n_positions - 1) * elems}
