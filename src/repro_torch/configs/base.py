"""Architecture config schema + shape suite for the assigned model pool
(a copy of ``repro.configs.base``, plus :func:`torch_dtype`)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int             # 0 => attention-free
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np (OLMo)
    activation: str = "swiglu"     # swiglu | gelu
    rope: bool = True
    rope_theta: float = 10_000.0
    max_position_embeddings: int = 0   # learned abs-pos (whisper) if > 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # hybrid / local attention
    attn_window: int = 0               # sliding-window size (0 = full)
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = ""                 # "" | audio_stub | vision_stub
    frontend_len: int = 0              # frames / patches in input_specs
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    subquadratic: bool = False         # eligible for long_500k
    # training
    remat: bool = True
    blockwise_attn_threshold: int = 4096
    attn_block_size: int = 1024
    # §Perf ablation switches (defaults = optimized; baseline via overrides)
    gqa_repeat_kv: bool = False     # True: materialise repeated KV (baseline)
    scan_staging: bool = False      # crypto cells: lax.scan over passes
    remat_policy: str = "dots"      # dots | nothing (full recompute)
    grad_accum: int = 1             # microbatched gradient accumulation

    @property
    def qkv_dims(self) -> tuple[int, int]:
        return self.n_heads * self.d_head, self.n_kv_heads * self.d_head

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.n_heads:
            q, kv = self.qkv_dims
            per_layer += d * q + 2 * d * kv + q * d
        if self.n_experts:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * dff
        elif dff:
            n_mats = 3 if self.activation == "swiglu" else 2
            per_layer += n_mats * d * dff
        if self.ssm_state:
            d_in = self.ssm_expand * d
            per_layer += 2 * d * d_in + d_in * d  # in/out projections
            per_layer += d_in * 2 * self.ssm_state  # B,C projections (approx)
        total = emb + self.n_layers * per_layer
        if self.encoder_layers:
            enc_per = 4 * d * d + (3 if self.activation == "swiglu" else 2) * d * dff
            total += self.encoder_layers * enc_per
            total += self.n_layers * 4 * d * d  # cross-attention
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """Assignment skip rules (documented in DESIGN.md §Arch-applicability)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skip: long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention")
    return True, ""


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    """The dtype of the config's parameters, activations and KV caches."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
