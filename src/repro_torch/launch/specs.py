"""Allocation-free input stand-ins for every (arch × shape) dry-run cell —
the counterpart of ``repro.launch.specs``.

JAX describes a cell's inputs with ``ShapeDtypeStruct``s; the port with
tensors on ``torch.device("meta")``, which hold shapes and dtypes and no
data.  The parameters are an :class:`~repro_torch.models.model.LMModel`
built on meta (nothing is drawn), the optimizer state AdamW's zeros on
meta, the decode cache the port's ``init_cache`` layout (a list of
per-layer dicts).  Under the converter's name map
(:func:`repro_torch.launch.shardings.jax_path`) every shape and dtype equals
JAX's ``eval_shape`` leaf, the per-layer leaves a row of JAX's stacked one.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim import init_opt_state

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg, shape_cfg) -> dict:
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    batch = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    if cfg.frontend:
        batch["embeds"] = _meta((b, cfg.frontend_len, cfg.d_model),
                                torch.float32)
    return batch


def decode_inputs_specs(cfg, shape_cfg):
    """(cache, token) stand-ins for a decode cell: one new token against a
    KV/state cache of seq_len."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    enc_len = cfg.frontend_len if cfg.encoder_layers else 0
    cache = M.init_cache(cfg, b, s, enc_len=enc_len, device=META)
    token = _meta((b, 1), torch.int32)
    return cache, token


def abstract_params(cfg) -> M.LMModel:
    return M.LMModel(cfg, device=META)


def abstract_train_state(cfg):
    params = abstract_params(cfg)
    return params, init_opt_state(params)
