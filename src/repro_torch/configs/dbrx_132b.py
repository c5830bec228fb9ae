"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,          # per-expert hidden dim
    vocab_size=100_352,
    num_experts=16,
    experts_per_tok=4,
    moe_d_ff=10752,
    rope_theta=500_000.0,
))
