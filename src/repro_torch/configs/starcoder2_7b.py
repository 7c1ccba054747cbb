"""StarCoder2-7B — dense GQA + RoPE code model [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab_size=49152,
    norm="layernorm", activation="gelu", rope=True, rope_theta=1e5,
    tie_embeddings=False,
)
