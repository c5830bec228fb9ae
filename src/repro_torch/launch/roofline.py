"""Roofline model for the NVIDIA H100 target — twin of
``repro/launch/roofline.py``, with the card's constants in place of the
reference's TPU v5e ones (none of which carry over):

    compute term    = op FLOPs         / (cards × 989e12 FLOP/s)
    memory term     = op bytes         / (cards × 3.35e12 B/s)
    collective term = collective bytes / (cards × 450e9 B/s per card)

The op FLOPs, bytes and collective bytes are one rank's, from
``launch/hlo_analysis.analyze_ops`` over the local ops of a DTensor step,
times the cards; MODEL_FLOPS (analytic 6·N·D, or 6·N_active·D for MoE) is
the useful-compute yardstick beside them, and ``mfu`` its share of the
cards' peak over the step time.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, as nvidia-smi names the card these
# numbers are for. Data sheet: NVIDIA H100 Tensor Core GPU Datasheet (2023),
# "H100 SXM" column.
#: bf16 on the tensor cores, dense (the data sheet's 1,979 TFLOPS is with sparsity)
PEAK_FLOPS = 989e12
#: fp32 outside the tensor cores (the data sheet's "FP32" row): the peak that
#: an fp32 step, whose GEMMs run without TF32, is read against
PEAK_FP32_FLOPS = 67e12
#: TF32 on the tensor cores, dense (the data sheet's 989 TFLOPS is with sparsity)
PEAK_TF32_FLOPS = 495e12
#: HBM3 bandwidth
HBM_BW = 3.35e12
#: NVLink 4: 900 GB/s per card in both directions together, so 450e9 one way
LINK_BW = 450e9


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    chips: int
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound assuming perfect overlap of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / op FLOPs — the recompute and redundancy detector."""
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs / (cards × peak × step_time) — the roofline fraction."""
        t = self.step_time_s
        return self.model_flops / (self.chips * self.peak_flops * t) if t > 0 else 0.0


def make_terms(hlo_flops: float, hlo_bytes: float, coll_bytes: float,
               model_flops: float, chips: int, *, peak_flops: float = PEAK_FLOPS,
               hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> RooflineTerms:
    """The three terms on ``chips`` cards; the peaks default to the H100's
    and may be injected (an fp32 step's ``peak_flops=PEAK_FP32_FLOPS``)."""
    return RooflineTerms(
        compute_s=hlo_flops / (chips * peak_flops),
        memory_s=hlo_bytes / (chips * hbm_bw),
        collective_s=coll_bytes / (chips * link_bw),
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=coll_bytes,
        model_flops=model_flops,
        chips=chips,
        peak_flops=peak_flops,
    )


def model_share(model_flops_: float, seconds: float, *, chips: int = 1,
                peak_flops: float = PEAK_FLOPS) -> float:
    """Model FLOPs over the cards' peak times a measured time: the model-FLOPs
    share of a run that took ``seconds``."""
    return model_flops_ / (chips * peak_flops * seconds)


# ------------------------------------------------------- analytic FLOPs -------


def model_flops(cfg: ModelConfig, shape: ShapeConfig, active_params: int) -> float:
    """6·N_active·D for training; 2·N_active per decoded token (+ attention reads).

    Attention FLOPs (the S² term) are added explicitly since 6·N·D ignores them:
      train:  6·b·s²·h·dh·L   (fwd 2 + bwd 4; ×2 for the two matmuls QK^T and PV
              halves folded into the 12·b·s²·d_attn convention)
      decode: 4·b·S·h·dh per attention layer (one query against S cached keys).
    """
    b, s = shape.global_batch, shape.seq_len
    n_attn = _attention_layers(cfg)
    dh = cfg.head_dim
    h = cfg.num_heads
    if shape.mode == "train":
        dense = 6.0 * active_params * b * s
        attn = 12.0 * b * s * s * h * dh * n_attn * 0.5  # causal halves the square
        return dense + attn
    if shape.mode == "prefill":
        dense = 2.0 * active_params * b * s
        attn = 4.0 * b * s * s * h * dh * n_attn * 0.5
        return dense + attn
    # decode: one token, cache length s
    dense = 2.0 * active_params * b
    attn = 4.0 * b * s * h * dh * n_attn
    return dense + attn


def _attention_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_layer_period
    if cfg.is_encdec:
        return cfg.num_layers * 2 + cfg.encoder_layers  # self + cross + encoder
    return cfg.num_layers
