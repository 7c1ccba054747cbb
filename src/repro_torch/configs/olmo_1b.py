"""OLMo-1B — dense, non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=8192, vocab_size=50304,
    norm="layernorm_np", activation="swiglu", rope=True,
)
