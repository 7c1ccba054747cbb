"""Process-environment bootstrap for the visible CUDA device count — the
counterpart of ``repro.launch.xla_env``.

The JAX package forces N host devices through ``XLA_FLAGS``, which JAX reads
once, when its first backend initialises.  CUDA reads
``CUDA_VISIBLE_DEVICES`` once, when the process's CUDA context starts, and
keeps that device count for the life of the process.  Anything that wants
the first N cards has to edit the environment before that first
initialisation, and has to keep the ids the operator listed rather than
replace them.

This module never starts CUDA itself: :func:`cuda_initialised` asks
``torch.cuda.is_initialized()``, which only reads state, and only when torch
is already imported.  The dry run's LM cells need no such bootstrap: their
world size is a ``"fake"`` process group's, set when the cell starts
(:mod:`repro_torch.launch.dryrun`), and they touch no device.
"""
from __future__ import annotations

import os
import sys

VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"


def with_visible_devices(value: str | None, n: int) -> str:
    """Pure string edit: the first ``n`` ids of ``value`` (the operator's
    ``CUDA_VISIBLE_DEVICES``), or ``0..n-1`` when nothing is set.  Raises on
    ``n < 1`` and when ``value`` lists fewer than ``n`` ids (an empty string
    lists none: it hides every card)."""
    if n < 1:
        raise ValueError(f"visible device count must be >= 1, got {n}")
    if value is None:
        return ",".join(str(i) for i in range(n))
    ids = [tok.strip() for tok in value.split(",") if tok.strip()]
    if len(ids) < n:
        raise ValueError(f"{VISIBLE_DEVICES}={value!r} lists {len(ids)} "
                         f"device(s), fewer than the {n} asked for")
    return ",".join(ids[:n])


def cuda_initialised() -> bool:
    """True iff this process's CUDA context already started (at which point
    ``CUDA_VISIBLE_DEVICES`` edits are inert).  Importing torch alone does
    not start it; the first CUDA tensor or device query does."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def force_visible_device_count(n: int, env=None) -> str:
    """Set ``CUDA_VISIBLE_DEVICES`` to the first ``n`` cards, keeping the
    operator's ids.  Raises ``RuntimeError`` if CUDA already started with
    another device count — the edit would be silently ignored, which is
    worse than failing loudly."""
    if env is None:
        env = os.environ
    if cuda_initialised():
        import torch
        have = torch.cuda.device_count()
        if have != n:
            raise RuntimeError(
                f"cannot make {n} CUDA device(s) visible: CUDA is already "
                f"initialised with {have}; set {VISIBLE_DEVICES} before the "
                f"first CUDA use")
        return env.get(VISIBLE_DEVICES, "")
    value = with_visible_devices(env.get(VISIBLE_DEVICES), n)
    env[VISIBLE_DEVICES] = value
    return value


def maybe_force_visible_device_count(n: int, env=None) -> bool:
    """Best-effort variant: like :func:`force_visible_device_count` but
    returns ``False`` instead of raising when CUDA already started.  Returns
    ``True`` when the environment was (re)written."""
    if cuda_initialised():
        return False
    if env is None:
        env = os.environ
    env[VISIBLE_DEVICES] = with_visible_devices(env.get(VISIBLE_DEVICES), n)
    return True
