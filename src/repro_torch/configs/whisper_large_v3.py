"""Whisper large-v3 — encoder-decoder; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_large_v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab_size=51866,
    norm="layernorm", activation="gelu", rope=False,
    max_position_embeddings=448, encoder_layers=32,
    frontend="audio_stub", frontend_len=1500,
    tie_embeddings=False,
)
