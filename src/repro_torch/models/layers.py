"""Common layers — twin of ``repro/models/layers.py``: RMSNorm (parametric and
OLMo's non-parametric), RoPE and qwen2-vl's M-RoPE, the SwiGLU MLP, embeddings. Plain functions over
dicts of tensors (a ``ParameterDict`` serves), schemas declared with ``P``.

Each keeps the reference's dtypes at every cast point: RMSNorm and RoPE work
in fp32 and return their input's dtype, the logits are fp32, and a product of
a bf16 and an fp32 operand is fp32 (:func:`matmul`, JAX's promotion, where
torch's ``@`` refuses the mix), as a bf16 model's decode meets it against the
fp32 cache. Those fp32 cast points keep a float64 input float64
(:func:`at_least_fp32`): nothing changes for fp32 and bf16 weights, and a
model cast to float64 computes in float64 throughout, the yardstick the
training checks measure fp32 routes against.

The MLP hidden and the logits carry the reference's ``shard`` calls
(``models/sharding_ctx.py``): no-ops outside a mesh context.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .param import P
from .sharding_ctx import current, local_contiguous, shard, weight_for_compute


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 (the reference's ``astype(float32)``), or as it is if float64."""
    return x if x.dtype == torch.float64 else x.float()


def rmsnorm_params(cfg):
    if not cfg.parametric_norm:
        return {}
    return {"scale": P((cfg.d_model,), ("embed",), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / rms(x) (· scale), in fp32 whatever x's dtype; OLMo's empty ``p`` is
    the non-parametric form."""
    x32 = at_least_fp32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if "scale" in p:
        y = y * at_least_fp32(p["scale"])
    return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE -------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d) rotated by the fp32 angles ang (b, s, d/2): split halves
    (x₁, x₂), not interleaved pairs, in fp32, back in x's dtype."""
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]  # (b,s,1,d/2)
    x1, x2 = at_least_fp32(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, h, d); positions: (b, s) ints. The angle is fp32 position ×
    frequency."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (d/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions3 (3, b, s), the (t, h, w) streams; the
    d/2 frequency slots are split into ``sections``, and each slot takes its
    angle from its section's stream. Text tokens carry three identical
    streams, where this is :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)  # (half,): each slot's stream
    pos = positions3[sec_id]  # (half, b, s): each slot's stream
    return _rotate(x, pos.movedim(0, -1).float() * freqs)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with JAX's type promotion, the reference's ``@`` on mixed dtypes:
    both operands in ``torch.promote_types`` of theirs (a bf16 activation
    against an fp32 weight, or the reverse, is an fp32 product). ``b`` is a
    weight: under a mesh context its FSDP shards are gathered first
    (``sharding_ctx.weight_for_compute``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if current() is None:
        return a.to(dt) @ b.to(dt)
    return local_contiguous(a.to(dt)) @ local_contiguous(weight_for_compute(b).to(dt))


# ----------------------------------------------------------------- MLP -------


def mlp_params(cfg, d_ff: Optional[int] = None):
    ff = d_ff or cfg.d_ff
    d = cfg.d_model
    return {
        "gate": P((d, ff), ("embed", "mlp")),
        "up": P((d, ff), ("embed", "mlp")),
        "down": P((ff, d), ("mlp", "embed")),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) ⊙ x W_up) W_down, weights in (in, out) layout."""
    h = shard(F.silu(matmul(x, p["gate"])) * matmul(x, p["up"]), "batch", "seq", "mlp_act")
    return matmul(h, p["down"])


# ----------------------------------------------------------- embeddings ------


def embed_params(cfg):
    out = {"tok": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        out["unembed"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return out


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of ``tok``. Under a mesh context the table keeps its
    vocab rows split as "vocab_act" splits them, its columns gathered, and
    the masked partial rows are summed into batch-split embeddings at once
    (DTensor mis-shapes the mask when that sum is left to a later reshard)."""
    return shard(F.embedding(tokens, shard(p["tok"], "vocab_act", None)), "batch", None, None)


def unembed(p, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits; tied embeddings (no ``unembed``) use ``tok``ᵀ."""
    w = weight_for_compute(p["unembed"] if "unembed" in p else p["tok"].T)
    h = shard(h, "batch", "seq", None)  # the sequence whole: the vocab splits instead
    return shard(at_least_fp32(h) @ at_least_fp32(w), "batch", "seq", "vocab_act")
