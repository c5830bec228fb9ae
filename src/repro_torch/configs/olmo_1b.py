"""olmo-1b — non-parametric LN (no learnable affine) [arXiv:2402.00838; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,   # MHA
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    parametric_norm=False,
    tie_embeddings=True,
))
