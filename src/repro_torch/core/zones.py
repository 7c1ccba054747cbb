"""Workload / precision zone tagging (paper §4.2) and the kernel launch log.

The JAX package tags its HLO with ``jax.named_scope``: every op's
``op_name`` carries the scope path, and its validator reads the zones off
the compiled module.  PyTorch has no such metadata on a kernel, so the port
keeps the path itself:

* :func:`scope` is the counterpart of ``jax.named_scope``.  It pushes a name
  on a thread-local path (``wzone_bn254/pzone_4limb/channel_3/
  staging_pass_1/vpu_fold``, the role of ``op_name``), opens
  ``torch.profiler.record_function(name)`` and, for a CUDA device, an NVTX
  range, so the zones show in the profiler and in Nsight;
* ``workload_zone(name)``   → scope ``wzone_<name>``;
  ``precision_zone(limbs)`` → scope ``pzone_<limbs>limb``;
  ``tenant_zone(i)``        → scope ``tzone_<i>``;
* :func:`launch_log` opens a log: while it is open, every call of a K1/K2/K3
  wrapper that does work appends one :class:`LaunchRecord` (kernel, scope
  path, the byte ranges it reads and writes, its static arguments), on the
  CPU as on the card, and every scope opened adds its name to the log (a
  fake tensor, as a plan over a mesh runs, has no address: its ranges
  start at None);
* :data:`KERNEL_CALL` marks the body of a K1/K2/K3 wrapper
  (``with KERNEL_CALL:``), so that a walk over the ATen ops a function runs
  (:func:`repro_torch.launch.graph_cost.op_census`) can leave out what a
  wrapper runs: its plain version on the CPU, its output's allocation on
  the card.

The validator (:mod:`repro_torch.core.validator`) matches the log against
the kernel nodes of a captured CUDA graph (or, on the CPU, takes the log as
the program) and checks the zones and the reduction order on it.  A replay
of a captured program runs no Python, so scopes and the log cost something
only while a program is captured or run eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

WZONE_PREFIX = "wzone_"
PZONE_PREFIX = "pzone_"
TZONE_PREFIX = "tzone_"

_local = threading.local()


def current_path() -> str:
    """The calling thread's scope path, names joined by ``/``."""
    return "/".join(getattr(_local, "path", ()))


@contextlib.contextmanager
def scope(name: str, device=None):
    """Push ``name`` on the scope path for the block, under a profiler range
    of the same name (and an NVTX range when ``device`` is a CUDA device)."""
    path = getattr(_local, "path", ())
    for log in getattr(_local, "logs", ()):
        log.scopes.add(name)
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        _local.path = path + (name,)
        try:
            yield
        finally:
            _local.path = path
            if nvtx:
                torch.cuda.nvtx.range_pop()


def workload_zone(name: str, device=None):
    return scope(f"{WZONE_PREFIX}{name}", device)


def precision_zone(limbs: int, device=None):
    return scope(f"{PZONE_PREFIX}{limbs}limb", device)


def tenant_zone(tenant_id: int, device=None):
    return scope(f"{TZONE_PREFIX}{tenant_id}", device)


class _KernelCall:
    """Re-entrant marker of a K1/K2/K3 wrapper's body on this thread."""

    def __enter__(self):
        _local.kernel_depth = getattr(_local, "kernel_depth", 0) + 1

    def __exit__(self, *exc):
        _local.kernel_depth -= 1


KERNEL_CALL = _KernelCall()


def in_kernel_call() -> bool:
    """True inside the body of a K1/K2/K3 wrapper on this thread."""
    return getattr(_local, "kernel_depth", 0) > 0


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One kernel call as the launch log saw it.  ``reads`` and ``writes``
    are ``(address, bytes)`` ranges; ``args`` the static arguments the
    graph reader also sees on the kernel's node."""

    kernel: str        # "limb_matmul", "mont_fold" or "fused_ntt_tile"
    path: str          # scope path at the call
    reads: tuple
    writes: tuple
    args: dict


class LaunchLog:
    """The records of one :func:`launch_log` block, in call order, the name
    of every scope opened in it (``scopes``, the zones a program touches,
    kernels or not) and the type of every device a recorded call wrote on
    (``devices``).  While the block is open it also holds every output it
    recorded, so that no later allocation of the logged run can take a
    recorded output's addresses: an address range then names one
    producer.  A fake tensor has no address and is not held.  ``on_record``,
    if set, is called with each recorded output."""

    def __init__(self):
        self.records: list[LaunchRecord] = []
        self.scopes: set[str] = set()
        self.devices: set[str] = set()
        self.on_record = None
        self._held: list = []


def _extent(t: torch.Tensor) -> tuple:
    """``(address, bytes)`` spanned by ``t``'s elements; the address is
    None for a fake tensor."""
    addr = None if isinstance(t, FakeTensor) else t.data_ptr()
    if t.numel() == 0:
        return (addr, 0)
    span = sum((s - 1) * st for s, st in zip(t.shape, t.stride())) + 1
    return (addr, span * t.element_size())


@contextlib.contextmanager
def launch_log():
    """Log every K1/K2/K3 wrapper call on this thread for the block."""
    logs = getattr(_local, "logs", None)
    if logs is None:
        logs = _local.logs = []
    log = LaunchLog()
    logs.append(log)
    try:
        yield log
    finally:
        logs.remove(log)
        log._held.clear()


def record_launch(kernel: str, inputs, output: torch.Tensor, **args):
    """Append a call to every open log (no-op when none is open).  The
    wrappers call this for each call that does work, whichever device runs
    it; a call with an empty output launches nothing on the card and is not
    recorded."""
    logs = getattr(_local, "logs", None)
    if not logs or output.numel() == 0:
        return
    rec = LaunchRecord(kernel, current_path(),
                       tuple(_extent(t) for t in inputs), (_extent(output),),
                       args)
    for log in logs:
        log.records.append(rec)
        log.devices.add(output.device.type)
        if not isinstance(output, FakeTensor):
            log._held.append(output)
        if log.on_record is not None:
            log.on_record(output)
