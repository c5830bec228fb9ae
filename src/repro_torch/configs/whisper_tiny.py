"""whisper-tiny — enc-dec; conv frontend is a STUB (input_specs() provides
precomputed frame embeddings at 1500 encoder positions) [arXiv:2212.04356; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,         # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
))
