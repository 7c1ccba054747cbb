"""Carry the JAX package's LM weights and caches across to the port.

The JAX package keeps parameters as a tree of dicts whose per-layer leaves
are stacked on a leading ``n_layers`` axis (``jax.vmap`` over the layers'
keys); the port keeps one module per layer.  A leaf ``layers/attn/wq`` of
shape (L, d, q) becomes the parameters ``layers.<i>.attn.wq`` of shape
(d, q).  numpy has no bf16, so a bf16 leaf arrives as float32 and is cast
back to the parameter's dtype (bf16 → f32 → bf16 is lossless).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models.model import LMModel

_STACKED = ("layers", "enc_layers")


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def state_from_jax(tree) -> dict[str, np.ndarray]:
    """The port's parameter names → float32 arrays, stacked leaves split."""
    out = {}
    for name, leaf in _flatten(tree):
        arr = np.array(leaf, np.float32)
        top, _, rest = name.partition(".")
        if top in _STACKED:
            for i in range(arr.shape[0]):
                out[f"{top}.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def params_from_jax(cfg, tree, device=None, dtype=None) -> LMModel:
    """An :class:`LMModel` holding the JAX parameter tree's weights.

    ``tree`` is the JAX package's ``init_params`` output as nested dicts of
    numpy (or JAX) arrays.  ``dtype`` ("float32", "bfloat16" or a torch
    dtype) builds the model of ``cfg`` in that dtype instead of the
    config's; float32 leaves (the router, ``a_log``, ``d_skip``) stay
    float32.  Raises on a missing, unexpected or misshapen leaf."""
    if dtype is not None:
        name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(
            dtype, dtype)
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {dtype!r}: expected float32 or bfloat16")
        cfg = dataclasses.replace(cfg, dtype=name)
    model = LMModel(cfg, device=device)
    arrays = state_from_jax(tree)
    state = model.state_dict()
    missing, extra = sorted(set(state) - set(arrays)), sorted(
        set(arrays) - set(state))
    if missing or extra:
        raise ValueError(f"JAX tree does not fit {cfg.name}: missing "
                         f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, param in state.items():
            arr = arrays[name]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape}, port shape "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
    return model


def _cache_dtype(cfg, key: str) -> torch.dtype:
    if key == "pos":
        return torch.int32
    if key == "state":
        return torch.float32
    return torch_dtype(cfg)


def cache_from_jax(cfg, cache, device=None) -> list[dict]:
    """The JAX package's stacked cache dict → the port's per-layer list."""
    dev = resolve_device(device)
    arrays = {k: np.asarray(v) for k, v in cache.items()}
    n = {a.shape[0] for a in arrays.values()}
    if n != {cfg.n_layers}:
        raise ValueError(f"cache layers {sorted(n)}, config {cfg.n_layers}")
    out = []
    for i in range(cfg.n_layers):
        out.append({k: torch.from_numpy(np.array(
            a[i], np.int32 if k == "pos" else np.float32)).to(
                dev, _cache_dtype(cfg, k)) for k, a in arrays.items()})
    return out


def cache_to_numpy(cache) -> dict[str, np.ndarray]:
    """The port's per-layer cache → the JAX layout, stacked on a leading
    layer axis: float leaves as float32, ``pos`` as int32."""
    return {k: np.stack([(cl[k].float() if cl[k].is_floating_point()
                          else cl[k]).cpu().numpy() for cl in cache])
            for k in cache[0]}
