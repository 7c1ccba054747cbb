"""Carry the JAX package's LM weights, optimizer state and caches across to
the port, and the port's parameters and moments back.

The JAX package keeps parameters as a tree of dicts whose per-layer leaves
are stacked on a leading ``n_layers`` axis (``jax.vmap`` over the layers'
keys); the port keeps one module per layer.  A leaf ``layers/attn/wq`` of
shape (L, d, q) becomes the parameters ``layers.<i>.attn.wq`` of shape
(d, q).  numpy has no bf16, so a bf16 leaf arrives as float32 and is cast
back to the parameter's dtype (bf16 → f32 → bf16 is lossless).  The AdamW
moments ``m`` and ``v`` are trees of the parameters' shape and cross the
same way (:func:`opt_state_from_jax`); :func:`state_to_jax` stacks the
port's per-layer tensors back into the JAX tree for a leaf-by-leaf
comparison.
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


def opt_state_from_jax(cfg, opt_state, device=None) -> dict:
    """The JAX package's AdamW state ``{"m": tree, "v": tree, "step"}`` as
    the port's: float32 moments under the port's parameter names and a 0-d
    int32 step, on ``device``.  Raises where a stacked leaf's layer count is
    not the config's."""
    dev = resolve_device(device)
    layers = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers}
    out = {}
    for key in ("m", "v"):
        for name, leaf in _flatten(opt_state[key]):
            top = name.partition(".")[0]
            if top in layers and np.shape(leaf)[0] != layers[top]:
                raise ValueError(f"{key}/{name}: {np.shape(leaf)[0]} layers, "
                                 f"{cfg.name} has {layers[top]}")
        out[key] = {name: torch.from_numpy(arr).to(dev)
                    for name, arr in state_from_jax(opt_state[key]).items()}
    out["step"] = torch.tensor(int(np.asarray(opt_state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def state_to_jax(state) -> dict:
    """The port's parameters (an :class:`LMModel`, or a dict name → tensor
    such as a state dict or AdamW's ``m``) as the JAX package's nested tree
    of float32 numpy arrays, per-layer tensors stacked on a leading layer
    axis in layer order."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    tree: dict = {}
    stacked: dict = {}
    for name, value in state.items():
        arr = (value.detach().float().cpu().numpy()
               if isinstance(value, torch.Tensor)
               else np.asarray(value, np.float32))
        parts = name.split(".")
        if parts[0] in _STACKED:
            stacked.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = arr
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    for path, by_layer in stacked.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.stack([by_layer[i] for i in sorted(by_layer)])
    return tree


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
