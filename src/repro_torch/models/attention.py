"""GQA attention (llama family) — twin of the GQA part of
``repro/models/attention.py``, in modes train (full causal), prefill (causal,
fills the KV cache) and decode (one token against the cache).

Train and prefill attend through ``kernels.ops.flash_attention``: on the card
the hand-written flash kernel (``csrc/flash_attention.cu``), the TPU runtime
path the reference's ``_sdpa`` describes itself as equal to. Decode attends one
query row to a cache masked by ``kv_len``, which the kernel does not compute
(it takes equal query and key lengths), so it stays the plain product
``_sdpa``, as it is in the reference.

The cache is written in place (the reference returns an updated copy): a
serving cache is the largest buffer after the weights, and nothing reads the
old one. It keeps its own dtype (fp32 in ``launch/serve.generate``, as in the
reference), and a bf16 model's decode attends with JAX's promotion: its bf16
query against the fp32 cache is an fp32 product, and so is what follows.
MLA, cross-attention and M-RoPE are not ported: ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from .layers import apply_rope, matmul
from .param import P

#: the reference's mask value; −inf would make a fully masked row's max − max NaN
_NEG = -1e30


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kv_len: int) -> torch.Tensor:
    """The plain attention product of decode, the reference's ``_sdpa`` with
    ``causal=False``: q (b, sq, h, dh) against the cache k, v (b, sk, hkv, dh),
    h % hkv == 0, entries from ``kv_len`` on masked; fp32 softmax. (The
    reference's causal mode and its 512-row query blocks serve train and
    prefill, which the port sends to ``ops.flash_attention``.) A bf16 q
    against an fp32 cache is promoted, as the reference's einsum promotes it.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, sq, hkv, h // hkv, dh).to(dt)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(dt)).float() * (dh ** -0.5)
    logits = torch.where(torch.arange(sk, device=q.device) < kv_len, logits, _NEG)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, dh)


def gqa_params(cfg):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": P((d, h * dh), ("embed", "heads")),
        "wk": P((d, kv * dh), ("embed", "kv")),
        "wv": P((d, kv * dh), ("embed", "kv")),
        "wo": P((h * dh, d), ("heads", "embed")),
    }


def mla_params(cfg):
    """MLA's schema (deepseek-v2), for ``count_params``; MLA itself is not
    ported."""
    d, h = cfg.d_model, cfg.num_heads
    r = cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": P((d, h * (nope + rope_d)), ("embed", "heads")),
        "w_dkv": P((d, r), ("embed", "kv_lora")),
        "w_krope": P((d, rope_d), ("embed", None)),
        "w_uk": P((r, h * nope), ("kv_lora", "heads")),
        "w_uv": P((r, h * vd), ("kv_lora", "heads")),
        "wo": P((h * vd, d), ("heads", "embed")),
    }


def gqa_make_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> dict:
    """A zero (batch, max_len, kv_heads, head_dim) key and value buffer."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_apply(p, cfg, h: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Optional[dict] = None, cache_index: Optional[int] = None, *,
              backend: str = "auto"):
    """One GQA mixer. h: (b, s, d); positions: (b, s). Returns (out, cache):
    prefill writes the prompt's keys and values at 0, decode its one token's
    at ``cache_index`` and attends to the first ``cache_index + 1`` entries.
    ``backend`` picks ``ops.flash_attention``'s route for train and prefill."""
    if cfg.use_mrope:
        raise NotImplementedError(f"M-RoPE ({cfg.name}) is not ported yet: ROADMAP queue 1 "
                                  f"item 14")
    b, s, _ = h.shape
    nh, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope(matmul(h, p["wq"]).reshape(b, s, nh, dh), positions, cfg.rope_theta)
    k = apply_rope(matmul(h, p["wk"]).reshape(b, s, kv, dh), positions, cfg.rope_theta)
    v = matmul(h, p["wv"]).reshape(b, s, kv, dh)
    if mode in ("train", "prefill"):
        out = ops.flash_attention(q, k, v, causal=True, backend=backend)
        if mode == "prefill":
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
    elif mode == "decode":
        cache["k"][:, cache_index:cache_index + s] = k
        cache["v"][:, cache_index:cache_index + s] = v
        out = _sdpa(q, cache["k"], cache["v"], kv_len=cache_index + 1)
    else:
        raise ValueError(mode)
    return matmul(out.reshape(b, s, nh * dh), p["wo"]), cache
