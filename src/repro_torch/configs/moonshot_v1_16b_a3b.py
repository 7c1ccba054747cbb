"""Moonlight-16B-A3B (kimi/moonshot) — 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot_v1_16b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=163840,
    norm="rmsnorm", activation="swiglu", rope=True,
    n_experts=64, top_k=6, n_shared_experts=2,
)
