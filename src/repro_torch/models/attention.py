"""Attention mixers — twin of ``repro/models/attention.py``: GQA (llama
family; whisper's encoder, decoder and cross-attention; qwen2-vl with M-RoPE)
and MLA (deepseek-v2), in modes train (full causal, or full for whisper's
encoder), prefill (causal, fills the KV cache) and decode (one token against
the cache).

GQA's train and prefill attend through ``kernels.ops.flash_attention``: on
the card the hand-written flash kernel (``csrc/flash_attention.cu``), the TPU
runtime path the reference's ``_sdpa`` describes itself as equal to. Decode
attends one query row to a cache masked by ``kv_len``, and cross-attention
the decoder's rows to the encoder's memory, of another length: the kernel
computes neither (it takes equal query and key lengths, as the reference's
Pallas kernel does), so both stay the plain product ``_sdpa``, as they are in
the reference. Cross-attention takes no rotary and is never cached or masked:
decode recomputes its keys and values from the memory every step, as the
reference does.

The cache is written in place (the reference returns an updated copy): a
serving cache is the largest buffer after the weights, and nothing reads the
old one. It keeps its own dtype (fp32 in ``launch/serve.generate``, as in the
reference), and a bf16 model's decode attends with JAX's promotion: its bf16
query against the fp32 cache is an fp32 product, and so is what follows.
Under a mesh context (``models/sharding_ctx.py``) the flash kernel runs
through ``local_map`` on each rank's local batch rows and heads
(:func:`_attend`), so it stays the kernel under DTensor; the caches are
written shard by shard (``sharding_ctx.write_seq``).
MLA (deepseek-v2) is the reference's plain product in every mode: its q·k
heads are 192 wide and its v heads 128, and the flash kernel takes one head
width. It caches the 512-d latent c_kv and the shared rope key only; decode
up-projects the cached latents every step (the reference's baseline), or,
with ``cfg.mla_absorb``, attends in latent space.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..kernels import ops
from .layers import apply_mrope, apply_rope, at_least_fp32, matmul
from .param import P
from .sharding_ctx import (
    axis_split, merge_dims, region, shard, split_dim, write_seq,
)

#: the reference's mask value; −inf would make a fully masked row's max − max NaN
_NEG = -1e30
#: the query-block size of MLA's streaming path (the reference's ``_Q_CHUNK``)
_Q_CHUNK = 512


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          kv_len: Optional[int] = None) -> torch.Tensor:
    """The plain attention product of decode and of cross-attention, the
    reference's ``_sdpa`` with ``causal=False``: q (b, sq, h, dh) against k, v
    (b, sk, hkv, dh), h % hkv == 0, keys from ``kv_len`` on masked (none
    without it); fp32 softmax. (The reference's causal mode and its 512-row
    query blocks serve train and prefill, which the port sends to
    ``ops.flash_attention``.) A bf16 q against an fp32 cache is promoted, as
    the reference's einsum promotes it.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = split_dim(q, 2, (hkv, h // hkv)).to(dt)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(dt)).float() * (dh ** -0.5)
    if kv_len is not None:
        logits = torch.where(torch.arange(sk, device=q.device) < kv_len, logits, _NEG)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, dh)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            backend: str) -> torch.Tensor:
    """``ops.flash_attention``; inside a mesh context on each rank's local
    shards (batch over the DP axes, heads over "heads_act"'s). Where the
    heads split m ways and the kv heads do not divide by m, each kv head is
    repeated r = m / gcd(kv, m) times first: r divides the group size, so
    every rank's query heads still find their kv heads among its own."""
    b, s, kv, dh = k.shape
    m = axis_split("heads_act", q.shape[2])
    if m > 1 and kv % m:
        r = m // math.gcd(kv, m)
        k, v = (t.unsqueeze(3).expand(b, s, kv, r, dh).reshape(b, s, kv * r, dh)
                for t in (k, v))
    axes = ("batch", None, "heads_act", None)
    fn = functools.partial(ops.flash_attention, causal=causal, backend=backend)
    return region(fn, (axes, axes, axes), axes, q, k, v)


def gqa_params(cfg):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": P((d, h * dh), ("embed", "heads")),
        "wk": P((d, kv * dh), ("embed", "kv")),
        "wv": P((d, kv * dh), ("embed", "kv")),
        "wo": P((h * dh, d), ("heads", "embed")),
    }


def mla_params(cfg):
    """MLA's schema (deepseek-v2)."""
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


def _mrope_sections(cfg) -> tuple:
    """M-RoPE's (t, h, w) frequency slots: a quarter of head_dim/2 for time,
    the rest split between height and width ((16, 24, 24) at head_dim 128)."""
    half = cfg.head_dim // 2
    t = half // 4
    hw = (half - t) // 2
    return (t, hw, half - t - hw)


def gqa_apply(p, cfg, h: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Optional[dict] = None, cache_index: Optional[int] = None, *,
              cross_kv: Optional[tuple] = None, causal: bool = True,
              backend: str = "auto"):
    """One GQA mixer. h: (b, s, d); positions: (b, s), or (3, b, s) with
    M-RoPE. Returns (out, cache): prefill writes the prompt's keys and values
    at 0, decode its one token's at ``cache_index`` and attends to the first
    ``cache_index + 1`` entries. ``causal=False`` (whisper's encoder) makes
    train mode attend to every key. ``cross_kv=(memory,)`` is
    cross-attention (whisper's decoder): keys and values from ``memory`` (b,
    sk, d), no rotary, no cache and no mask, in every mode. ``backend`` picks
    ``ops.flash_attention``'s route for train and prefill."""
    b, s, _ = h.shape
    nh, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = h if cross_kv is None else cross_kv[0]
    q = split_dim(matmul(h, p["wq"]), 2, (nh, dh))
    k = split_dim(matmul(src, p["wk"]), 2, (kv, dh))
    v = split_dim(matmul(src, p["wv"]), 2, (kv, dh))
    if cross_kv is not None:
        return matmul(merge_dims(_sdpa(q, k, v), 2), p["wo"]), cache
    if cfg.use_mrope:
        sections = _mrope_sections(cfg)
        q = apply_mrope(q, positions, cfg.rope_theta, sections)
        k = apply_mrope(k, positions, cfg.rope_theta, sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if mode in ("train", "prefill"):
        out = _attend(q, k, v, causal=causal if mode == "train" else True, backend=backend)
        if mode == "prefill":
            write_seq(cache["k"], 0, k)
            write_seq(cache["v"], 0, v)
    elif mode == "decode":
        write_seq(cache["k"], cache_index, k)
        write_seq(cache["v"], cache_index, v)
        out = _sdpa(q, cache["k"], cache["v"], kv_len=cache_index + 1)
    else:
        raise ValueError(mode)
    return matmul(merge_dims(out, 2), p["wo"]), cache


# ------------------------------------------------------------------ MLA ------


def mla_make_cache(cfg, batch: int, max_len: int, dtype=torch.float32, device=None) -> dict:
    """A zero latent buffer (batch, max_len, kv_lora_rank) and rope-key
    buffer (batch, max_len, qk_rope_dim)."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                                 device=device)}


def _mla_mask(logits, q_offset: int, kv_len: Optional[int], causal: bool):
    """The reference's −1e30 masks on (b, h, sq, sk) logits: the causal one
    from query row ``q_offset``, and keys from ``kv_len`` on."""
    sq, sk = logits.shape[-2:]
    cols = torch.arange(sk, device=logits.device)
    if causal:
        rows = q_offset + torch.arange(sq, device=logits.device)[:, None]
        logits = torch.where(rows >= cols, logits, _NEG)
    if kv_len is not None:
        logits = torch.where(cols < kv_len, logits, _NEG)
    return logits


def _mla_attend_block(cfg, q, k_nope, v, krope, kv_len, q_offset, causal):
    """One query block. q: (b, sq, h, nope + rope); k_nope, v: (b, sk, h, ·);
    krope: (b, sk, rope). fp32 softmax."""
    b, sq, h, _ = q.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    qn, qr = q[..., :nope], q[..., nope:]
    logits = (torch.einsum("bqhd,bshd->bhqs", qn, k_nope)
              + torch.einsum("bqhd,bsd->bhqs", qr, krope))
    logits = shard(at_least_fp32(logits) * (nope + rope_d) ** -0.5,
                   "batch", "heads_act", None, None)
    pr = torch.softmax(_mla_mask(logits, q_offset, kv_len, causal), dim=-1).to(v.dtype)
    return merge_dims(torch.einsum("bhqs,bshd->bqhd", pr, v), 2)


def _mla_attend_absorbed(cfg, q, ckv, krope, p, kv_len=None, q_offset=0, causal=True):
    """Attention in latent space (``cfg.mla_absorb``): W_uk absorbed into the
    query and W_uv applied to the weighted latents, so the cache is never
    up-projected: logits = (q_nope W_ukᵀ) ckvᵀ + q_rope kropeᵀ, out =
    (P ckv) W_uv."""
    b, sq, h, _ = q.shape
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    qn, qr = q[..., :nope], q[..., nope:]
    q_lat = torch.einsum("bqhd,rhd->bqhr", qn, split_dim(p["w_uk"], 1, (h, nope)))
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhd,bsd->bhqs", qr, krope))
    logits = shard(at_least_fp32(logits) * (nope + rope_d) ** -0.5,
                   "batch", "heads_act", None, None)
    pr = torch.softmax(_mla_mask(logits, q_offset, kv_len, causal), dim=-1).to(ckv.dtype)
    lat = torch.einsum("bhqs,bsr->bqhr", pr, ckv)
    out = torch.einsum("bqhr,rhd->bqhd", lat, split_dim(p["w_uv"], 1, (h, vd)))
    return merge_dims(out, 2)


def _mla_attend(cfg, q, ckv, krope, p, kv_len=None, q_offset=0, causal=True):
    """q: (b, sq, h, nope + rope); ckv: (b, sk, r); krope: (b, sk, rope).

    The baseline up-projects the latents (the whole cache in decode) once a
    call, then attends in query blocks of ``_Q_CHUNK`` rows past that length,
    so the (sq × sk) logits never exist at once; ``cfg.mla_absorb`` switches
    short queries (decode) to :func:`_mla_attend_absorbed`."""
    b, sq, h, _ = q.shape
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    sk = ckv.shape[1]
    if cfg.mla_absorb and sq <= _Q_CHUNK:
        return _mla_attend_absorbed(cfg, q, ckv, krope, p, kv_len, q_offset, causal)
    k_nope = shard(split_dim(matmul(ckv, p["w_uk"]), 2, (h, nope)),
                   "batch", None, "heads_act", None)
    v = shard(split_dim(matmul(ckv, p["w_uv"]), 2, (h, vd)), "batch", None, "heads_act", None)
    if sq <= _Q_CHUNK:
        return _mla_attend_block(cfg, q, k_nope, v, krope, kv_len, q_offset, causal)
    if sq % _Q_CHUNK:
        raise ValueError(f"MLA query length {sq} past {_Q_CHUNK} must be a multiple of it, "
                         f"as in the reference")
    return torch.cat([_mla_attend_block(cfg, q[:, i:i + _Q_CHUNK], k_nope, v, krope, kv_len,
                                        q_offset + i, causal)
                      for i in range(0, sq, _Q_CHUNK)], dim=1)


def mla_apply(p, cfg, h: torch.Tensor, positions: torch.Tensor, mode: str,
              cache: Optional[dict] = None, cache_index: Optional[int] = None, **_):
    """One MLA mixer. h: (b, s, d); positions: (b, s). Returns (out, cache):
    prefill writes the prompt's latents and rope keys at 0, decode its one
    token's at ``cache_index`` and attends to the first ``cache_index + 1``."""
    b, s, _ = h.shape
    nh, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = split_dim(matmul(h, p["wq"]), 2, (nh, nope + rope_d))
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)], dim=-1)
    ckv = matmul(h, p["w_dkv"])  # (b, s, r)
    krope = apply_rope(matmul(h, p["w_krope"])[:, :, None], positions, cfg.rope_theta)[:, :, 0]
    if mode in ("train", "prefill"):
        out = _mla_attend(cfg, q, ckv, krope, p, causal=True)
        if mode == "prefill":
            write_seq(cache["ckv"], 0, ckv)
            write_seq(cache["krope"], 0, krope)
    elif mode == "decode":
        write_seq(cache["ckv"], cache_index, ckv)
        write_seq(cache["krope"], cache_index, krope)
        out = _mla_attend(cfg, q, cache["ckv"], cache["krope"], p, kv_len=cache_index + 1,
                          causal=False)
    else:
        raise ValueError(mode)
    return matmul(out, p["wo"]), cache
