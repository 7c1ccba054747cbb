"""Mamba2-370m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    norm="rmsnorm", activation="swiglu", rope=False,
    ssm_state=128, ssm_heads=32, ssm_expand=2,
    subquadratic=True,
)
