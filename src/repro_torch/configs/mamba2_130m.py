"""mamba2-130m — SSD (state-space duality), attn-free [arXiv:2405.21060; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,             # attn-free, no MLP: mamba block only (expand=2)
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
))
