"""Meshes of the port — the counterpart of ``repro.launch.mesh``.

A :class:`Mesh` is what the JAX package's ``jax.sharding.Mesh`` gives its
readers: axis names, an ordered ``shape`` (axis → size) and an array of
devices of that shape.  Positions map to devices round-robin, as
:func:`repro_torch.device.partition_devices` maps hosts to cards, so a mesh
can hold more positions than the process has devices: the runtime's
single-controller functions (:mod:`repro_torch.runtime.compression`,
:mod:`repro_torch.runtime.pipeline`) then run several positions on one
card, or on the CPU in the tests.

The production meshes are for planning: their entries are
``torch.device("meta")``, and the dry run turns them into a
``torch.distributed`` ``DeviceMesh`` under a ``"fake"`` process group
(:func:`device_mesh`).  Building a mesh touches no device state.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_devices


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and an object array of ``torch.device`` whose shape is
    the mesh's."""
    axis_names: tuple
    devices: np.ndarray

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis → size, in axis order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices of the positions along ``axis``, every other axis at
        index 0."""
        index = [0] * self.devices.ndim
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(shape, axes, devices) -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose position k (row-major) holds
    ``devices[k % len(devices)]``; ``devices`` is a list of
    ``torch.device`` (or anything ``torch.device`` takes)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = int(np.prod(shape))
    flat = np.empty(n, dtype=object)
    for k in range(n):
        flat[k] = devs[k % len(devs)]
    return Mesh(axes, flat.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production meshes, for planning: 16 × 16 (``data``, ``model``)
    or 2 × 16 × 16 (``pod``, ``data``, ``model``), every entry ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")])


def make_local_mesh(device=None) -> Mesh:
    """``(1, n, 1)`` over ``pod``, ``data``, ``model``: every visible CUDA
    device (``device=None``), the devices ``device`` names, or the CPU when
    asked (``device="cpu"``)."""
    devs = resolve_devices(device)
    return make_mesh((1, len(devs), 1), ("pod", "data", "model"), devs)


def make_world_mesh() -> Mesh:
    """``make_local_mesh``'s counterpart over the ranks of the initialised
    process group: ``(1, world, 1)`` over ``pod``, ``data``, ``model``, one
    position a rank, as JAX's ``make_local_mesh`` spans every process's
    devices.  Its entries are ``meta``: a rank addresses only its own
    device (:func:`repro_torch.launch.train.mesh_device`)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_world_mesh needs an initialised process "
                           "group")
    return make_mesh((1, dist.get_world_size(), 1), ("pod", "data", "model"),
                     [torch.device("meta")])


def data_axes(mesh) -> tuple:
    """The batch-sharding axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """A ``torch.distributed`` ``DeviceMesh`` of ``mesh``'s shape and axis
    names, under the process group that is already initialised, whose world
    size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {mesh.size} positions")
    return init_device_mesh(device_type, tuple(mesh.devices.shape),
                            mesh_dim_names=tuple(mesh.axis_names))
