"""Device resolution for the port: ``torch.device`` in place of ``jax.Device``.

Every entry point of :mod:`repro_torch` takes a ``device`` argument and runs
on CUDA unless the caller asks for the CPU.  Nothing falls back: without a
CUDA device, a request for the default device raises.
"""
from __future__ import annotations

import sys

import torch


def dtensor_type():
    """DTensor's class, or None while ``torch.distributed.tensor`` is not
    imported (then no tensor is one)."""
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                   None)


def process_group():
    """``torch.distributed`` while a process group is initialised, else
    None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _no_cuda() -> RuntimeError:
    return RuntimeError(
        "repro_torch runs on CUDA by default, but torch sees no CUDA device "
        "here; pass device='cpu' to run the plain PyTorch versions")


def resolve_device(device=None) -> torch.device:
    """One device: ``None``/``"cuda"`` mean the current CUDA device, an int
    means ``cuda:<int>``, ``"cpu"`` means the CPU.  Raises when CUDA is asked
    for (explicitly or by default) and there is none, or the index is out of
    range."""
    if device is None:
        device = "cuda"
    if isinstance(device, int):
        device = torch.device("cuda", device)
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         f"(expected 'cuda' or 'cpu')")
    n = _cuda_count()
    if n == 0:
        raise _no_cuda()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < n:
        raise ValueError(f"cuda:{index} is out of range: this process sees "
                         f"{n} CUDA device(s)")
    return torch.device("cuda", index)


def resolve_devices(devices=None) -> list[torch.device]:
    """A list of distinct devices.  ``None`` means every CUDA device of the
    process; a single spec (str, int, ``torch.device``) means that device; a
    list is resolved entry by entry.  Duplicates and empty lists raise."""
    if devices is None:
        n = _cuda_count()
        if n == 0:
            raise _no_cuda()
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, int, torch.device)):
        devices = [devices]
    resolved, seen = [], set()
    for i, entry in enumerate(devices):
        dev = resolve_device(entry)
        if dev in seen:
            raise ValueError(f"devices[{i}] names {dev} twice: each pin must "
                             f"be distinct")
        seen.add(dev)
        resolved.append(dev)
    if not resolved:
        raise ValueError("devices= must name at least one device "
                         "(use None for every CUDA device)")
    return resolved


def _every_cuda(devices) -> bool:
    """True for the specs that name no particular card: None, ``"cuda"``
    and ``torch.device("cuda")``."""
    if devices is None:
        return True
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        return dev.type == "cuda" and dev.index is None
    return False


def partition_devices(n_parts: int, devices=None) -> list[list[torch.device]]:
    """Split devices into ``n_parts`` slices: contiguous near-even chunks when
    there are at least ``n_parts`` devices (the first ``D mod n_parts`` get
    one extra), else round-robin single devices — the same rule as the JAX
    package's ``partition_devices``, which splits every device.

    A spec that names no card (None, ``"cuda"``, the entry points' default)
    means every CUDA device here, where :func:`resolve_devices` reads a
    bare ``"cuda"`` as the current card; ``"cuda:N"``, a list and
    ``"cpu"`` mean what they say."""
    if n_parts < 1:
        raise ValueError(f"partition_devices needs n_parts >= 1, "
                         f"got {n_parts}")
    devs = resolve_devices(None if _every_cuda(devices) else devices)
    if len(devs) >= n_parts:
        base, extra = divmod(len(devs), n_parts)
        out, lo = [], 0
        for i in range(n_parts):
            hi = lo + base + (1 if i < extra else 0)
            out.append(devs[lo:hi])
            lo = hi
        return out
    return [[devs[i % len(devs)]] for i in range(n_parts)]
