"""Granite-3.0 MoE 3B-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_3b_a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab_size=49155,
    norm="rmsnorm", activation="swiglu", rope=True,
    n_experts=40, top_k=8,
)
