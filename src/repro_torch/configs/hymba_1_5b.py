"""Hymba-1.5B — parallel attention + mamba heads, sliding-window attention
[arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_1_5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    norm="rmsnorm", activation="swiglu", rope=True,
    ssm_state=16, ssm_heads=25, ssm_expand=1,
    attn_window=1024, subquadratic=True,
)
