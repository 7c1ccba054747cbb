"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3_405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab_size=128256,
    norm="rmsnorm", activation="swiglu", rope=True, rope_theta=5e5,
    tie_embeddings=False,
)
