"""InternVL2-1B — InternViT frontend (STUB: precomputed patch embeddings) +
InternLM2-tier LM backbone [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151655,
    norm="rmsnorm", activation="swiglu", rope=True,
    frontend="vision_stub", frontend_len=256,
)
