"""Config registry of the port: the 10 assigned architectures.

A copy of the JAX package's registry (``repro.configs``), with the same
names and values, so that the port imports nothing of that package.
``get_config(name)`` returns the full published config; ``smoke_config(name)``
returns a reduced same-family config for CPU tests (small layers/width, few
experts, tiny vocab).  ``torch_dtype(cfg)`` is the config's parameter and
activation dtype as a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                     shape_applicable, torch_dtype)

from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b
from repro_torch.configs.starcoder2_7b import CONFIG as starcoder2_7b
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.olmo_1b import CONFIG as olmo_1b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from repro_torch.configs.hymba_1_5b import CONFIG as hymba_1_5b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        internlm2_20b, starcoder2_7b, llama3_405b, olmo_1b,
        granite_moe_3b_a800m, moonshot_v1_16b_a3b, hymba_1_5b,
        whisper_large_v3, mamba2_370m, internvl2_1b,
    ]
}


def get_config(name: str) -> ArchConfig:
    return ARCHS[name.replace("-", "_")]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: 2 layers, narrow width, tiny vocab."""
    cfg = get_config(name)
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = min(cfg.n_kv_heads, n_heads) if n_heads else 0
    if n_heads and n_kv and n_heads % n_kv:
        n_kv = 1
    d_head = 32 if cfg.n_heads else 0
    d_model = max(64, n_heads * d_head) if n_heads else 128
    return dataclasses.replace(
        cfg,
        name=cfg.name + "_smoke",
        n_layers=2,
        encoder_layers=min(cfg.encoder_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_capacity_factor=8.0,   # drop-free in smoke (decode==prefill)
        ssm_state=min(cfg.ssm_state, 16),
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_chunk=16,
        attn_window=min(cfg.attn_window, 64) if cfg.attn_window else 0,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend_len else 0,
        max_position_embeddings=min(cfg.max_position_embeddings, 512)
        if cfg.max_position_embeddings else 0,
        blockwise_attn_threshold=64,
        attn_block_size=32,
        dtype="float32",
    )
