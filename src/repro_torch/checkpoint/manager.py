"""Checkpoint/restart with integrity hashes, rotation and async save — the
counterpart of ``repro.checkpoint.manager``, with its on-disk layout, so
either package reads the other's checkpoints.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json
A tree is nested dicts (and lists) of tensors, numpy arrays and numbers.
Leaves are addressed by their path joined with ``/`` (a module's
``state_dict()`` under ``params`` gives ``params/layers.0.attn.wq``); bf16
leaves are stored as float32 under ``<path>@bf16``.  The manifest records
the step, a SHA-256 of the payload, each leaf's shape and dtype, and
arbitrary JSON extra state (the data stream's cursor).  A checkpoint is
written under ``step_<N>.tmp`` and published with ``os.replace``.

Over a mesh (JAX's elastic restore: a checkpoint reshards onto another
mesh or one device).  A save gathers each DTensor leaf whole on every rank
(``full_tensor()``, a collective every rank enters), and rank 0 alone
writes it, in the layout above and under the leaf names of a one-device
checkpoint, and rotates; a barrier then publishes it to every rank.  So a
checkpoint from a mesh, one from one device and one from the JAX package
each read into the others.  A restore reads the whole arrays on every rank
(each checks the SHA-256), and each DTensor leaf of the ``like`` tree
keeps its own slice at its placements, on whatever mesh it lies (JAX's
``device_put`` under the new mesh's shardings).  A DTensor that reached
the writer un-gathered raises: a shard is never written as the leaf.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.device import dtensor_type, process_group

BF16 = "@bf16"


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process outside any."""
    dist = process_group()
    return dist is None or dist.get_rank() == 0


def _publish():
    """A barrier after rank 0's write, so every rank sees it."""
    dist = process_group()
    if dist is not None:
        dist.barrier()


def _paths(tree, prefix=""):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, value in items:
        yield from _paths(value, f"{prefix}/{key}" if prefix else str(key))


def _host(leaf) -> tuple[np.ndarray, bool]:
    """(a host copy of the leaf as numpy, whether it was bf16): bf16 as
    float32, since numpy has no bf16.  Always a copy, so a tensor updated
    after the save changes nothing written.  A DTensor raises: its local
    tensor is a shard, and :func:`_flatten` gathers it first."""
    dtensor = dtensor_type()
    if dtensor is not None and isinstance(leaf, dtensor):
        raise TypeError("a DTensor leaf reached the checkpoint writer "
                        "un-gathered; its local tensor is one shard")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        return np.array((t.float() if bf16 else t).cpu().numpy()), bf16
    return np.array(leaf), False


def _flatten(tree) -> dict[str, np.ndarray]:
    """Path → host array of every leaf, each DTensor gathered whole first
    (a collective: every rank of its mesh must flatten the same tree)."""
    dtensor = dtensor_type()
    flat = {}
    for key, leaf in _paths(tree):
        if dtensor is not None and isinstance(leaf, dtensor):
            leaf = leaf.full_tensor()
        arr, bf16 = _host(leaf)
        flat[key + BF16 if bf16 else key] = arr
    return flat


def _like_leaf(leaf, arr: np.ndarray):
    """``arr`` in the form of ``leaf``: a DTensor of its dtype whose local
    tensor is this rank's slice at its placements, a tensor of its dtype on
    its device, a numpy array of its dtype, else the array itself."""
    dtensor = dtensor_type()
    if dtensor is not None and isinstance(leaf, dtensor):
        from torch.distributed.tensor import distribute_tensor
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape}, the "
                             f"DTensor it restores is {tuple(leaf.shape)}")
        whole = torch.from_numpy(arr).to(leaf.to_local().device, leaf.dtype)
        return distribute_tensor(whole, leaf.device_mesh, leaf.placements,
                                 src_data_rank=None)
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(leaf.device, leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    return arr


def _unflatten(like, flat: dict[str, np.ndarray]):
    """The tree of ``like`` filled from ``flat``; raises on a missing leaf."""
    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(node))
        if prefix + BF16 in flat:
            return _like_leaf(node, flat[prefix + BF16])
        if prefix not in flat:
            raise KeyError(f"checkpoint has no leaf {prefix!r}")
        return _like_leaf(node, flat[prefix])
    return fill(like, "")


def _write(directory: str, step: int, flat: dict[str, np.ndarray],
           extra: dict | None) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "step": step,
        "sha256": digest,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)   # atomic publish
    return path


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None):
    """Write ``tree`` as ``<directory>/step_<step>``; returns its path.  In
    a process group every rank calls it (DTensors are gathered), rank 0
    writes, and every rank returns after the write."""
    flat = _flatten(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        path = _write(directory, step, flat, extra)
    _publish()
    return path


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, like, step: int | None = None):
    """Returns (tree, extra), the latest step unless ``step`` is given.
    Verifies the payload's SHA-256 before deserialising anything and raises
    ``IOError`` on a mismatch.  The tree has ``like``'s structure, each
    tensor leaf its dtype and device, each numpy leaf its dtype (a JAX
    package checkpoint reads into a like tree of numpy arrays)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    with np.load(npz_path) as npz:
        flat = dict(npz)
    return _unflatten(like, flat), manifest["extra"]


class CheckpointManager:
    """Rotation (the ``keep`` latest) + async save on one writer thread +
    restore-latest.  In a process group every rank calls ``save`` (each
    DTensor is gathered on every rank); rank 0 alone writes and rotates,
    and the save returns on every rank once the write is published, so an
    async save waits for its write there."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra: dict | None = None):
        # copied to host numpy here, before the writer thread sees it
        flat = _flatten(tree)
        if process_group() is not None:
            if _writes():
                self.wait()
                self._save_and_rotate(step, flat, extra)
            _publish()
        elif self._pool is None:
            self._save_and_rotate(step, flat, extra)
        else:
            self.wait()
            self._pending = self._pool.submit(self._save_and_rotate, step,
                                              flat, extra)

    def _save_and_rotate(self, step, flat, extra):
        _write(self.directory, step, flat, extra)
        self._rotate()

    def wait(self):
        """Block until the pending save is written; re-raises its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _rotate(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like):
        self.wait()
        return restore_checkpoint(self.directory, like)

    def latest_step(self):
        self.wait()
        return latest_step(self.directory)

    def close(self):
        """Wait for the pending save and stop the writer thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
