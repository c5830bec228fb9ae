"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2 every other
layer [arXiv:2403.19887; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,        # 9 periods x (1 attn + 7 mamba)
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    num_experts=16,
    experts_per_tok=2,
    moe_d_ff=24576,
    moe_layer_period=2,   # MoE every other layer
    attn_layer_period=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
))
