"""deepseek-v2-236b — MLA (kv_lora=512), 2 shared + 160 routed top-6 [arXiv:2405.04434; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,    # MLA: logical kv heads == q heads; cache is the 512-d latent
    head_dim=128,
    d_ff=1536,           # per routed expert (fine-grained)
    vocab_size=102_400,
    num_experts=160,
    experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
))
