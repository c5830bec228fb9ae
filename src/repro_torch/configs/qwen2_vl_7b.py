"""qwen2-vl-7b — M-RoPE, dynamic resolution; vision frontend is a STUB
(input_specs() provides precomputed patch embeddings) [arXiv:2409.12191; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    vision_tokens=1024,
    use_mrope=True,
    rope_theta=1_000_000.0,
))
