"""Architecture config system: one ModelConfig per architecture — the port's own
copy of ``repro/configs/base.py`` (the port imports nothing of ``repro``).

Shapes: train_4k, prefill_32k, decode_32k, long_500k — see SHAPES below.
``long_500k`` is only valid for sub-quadratic archs (ssm/hybrid).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (fine-grained); 0 → use d_ff
    moe_layer_period: int = 1  # MoE every k-th layer (jamba: 2); dense otherwise
    capacity_factor: float = 1.25
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    mla_absorb: bool = False  # §Perf H3: absorb W_uk into q → attend in latent space
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0  # hybrid: 1 attention layer per this many (jamba: 8)
    # --- frontends (stubs) ---
    encoder_layers: int = 0  # whisper: enc-dec
    encoder_seq: int = 0  # fixed encoder length (whisper: 1500 after conv stub)
    vision_tokens: int = 0  # qwen2-vl: stub patch-embedding positions
    use_mrope: bool = False
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    parametric_norm: bool = True  # olmo: False (non-parametric LN)
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §4 shape policy)."""
        return self.family in ("ssm", "hybrid")

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (CPU-runnable)."""
        small = dict(
            num_layers=min(self.num_layers, 4 if not self.is_hybrid else 8),
            d_model=256,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=512,
            head_dim=64,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_d_ff=256 if self.moe_d_ff else 0,
            kv_lora_rank=64 if self.use_mla else 0,
            qk_rope_dim=32 if self.use_mla else self.qk_rope_dim,
            qk_nope_dim=64 if self.use_mla else self.qk_nope_dim,
            v_head_dim=64 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=64 if self.encoder_seq else 0,
            vision_tokens=16 if self.vision_tokens else 0,
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        from . import all_archs  # noqa: F401  (populates registry)
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        from . import all_archs  # noqa: F401
    return sorted(_REGISTRY)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Shape policy: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; full-attention arch"
    return True, ""
