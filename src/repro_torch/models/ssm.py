"""Mamba2 block — twin of ``repro/models/ssm.py``: SSD (state-space duality)
chunked scan [arXiv:2405.21060].

Train and prefill run the chunked SSD algorithm: within a chunk the
recurrence expands into an attention-like masked (q, k) product; across
chunks one (b, h, n, p) state is carried by a Python loop (the reference's
``lax.scan``). Decode is the exact linear recurrence h ← exp(Δa)·h + Δ·x⊗B,
one step of :func:`ssm_scan_ref`.

The casts are the reference's: the intra-chunk weights ``att`` and ``w_k``
in x's dtype, the state and the outputs' sums in fp32 (float64 stays
float64, ``layers.at_least_fp32``). The cache's ``"ssm"`` state is always
fp32, its ``"conv"`` window in the cache dtype; both are written in place.

One departure, in the gradient only: the intra-chunk decay exp(cum_i − cum_j)
is masked before the exponential (−∞ above the diagonal) where the reference
masks after it. The forward values are the same (exp(−∞) = 0), but where a
chunk's decay sums past ~88 the reference's exp overflows above the diagonal
and its gradient there is 0·∞ = NaN, as at mamba2-130m's chunk of 256 on
random weights; the port's stays finite.

Under a mesh context the projections carry the reference's ``shard`` calls,
and the chunk loop, which DTensor has no rule for, runs on each rank's own
batch rows and heads (``sharding_ctx.region``), as does the depthwise
convolution on its rows and channels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import at_least_fp32, matmul, rmsnorm
from .param import P
from .sharding_ctx import assign, merge_dims, region, shard, split_dim


def mamba_params(cfg):
    d, din = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n  # x, B, C are convolved (G=1 groups)
    return {
        "in_proj": P((d, 2 * din + 2 * n + h), ("embed", "d_inner")),
        "conv_w": P((cfg.ssm_conv_width, conv_ch), (None, "d_inner")),
        "conv_b": P((conv_ch,), ("d_inner",), init="zeros"),
        "a_log": P((h,), (None,), init="ones"),
        "d_skip": P((h,), (None,), init="ones"),
        "dt_bias": P((h,), (None,), init="zeros"),
        "norm_scale": P((din,), ("d_inner",), init="ones"),
        "out_proj": P((din, d), ("d_inner", "embed")),
    }


def mamba_make_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    """A zero conv window (batch, width − 1, channels) in ``dtype`` and a zero
    fp32 state (batch, heads, state, head_dim)."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, din + 2 * n), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, n, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (b, s, c); w: (width, c): out[t] =
    Σ_j w[j]·x[t − width + 1 + j] + b, x zero before the start."""
    width, c = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))  # (b, c, s + width − 1)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=c)
    return out.transpose(1, 2) + b


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, d_skip: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (b, s, h, p); dt (b, s, h), already softplus'd; a_log,
    d_skip (h,); bmat, cmat (b, s, n); h0 (b, h, n, p) the initial state.
    Returns (y (b, s, h, p), final state (b, h, n, p)). s must be a multiple
    of the chunk (or below it), as in the reference."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {q}")
    f32 = at_least_fp32(x).dtype
    a = -torch.exp(a_log.to(f32))  # (h,)
    dtf = dt.to(f32)
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(0, s, q):
        xc, dtc = x[:, i:i + q], dtf[:, i:i + q]
        bc, cc = bmat[:, i:i + q], cmat[:, i:i + q]
        cum = torch.cumsum(dtc * a, dim=1)  # (b, q, h), inclusive over the chunk
        cum_last = cum[:, -1:]  # (b, 1, h)
        cb = torch.einsum("bqn,bkn->bqk", cc, bc)
        # masked before the exponential: the reference's exp(cum_i − cum_j) overflows
        # above the diagonal, and its gradient there is NaN (module docstring)
        seg = cum[:, :, None] - cum[:, None]  # (b, q, k, h)
        decay = torch.exp(torch.where(mask[None, ..., None], seg, float("-inf")))
        decay = shard(decay, "batch", None, None, "heads_act")
        att = cb[..., None] * decay * dtc[:, None]  # dt_k broadcast over the q index
        y_intra = torch.einsum("bqkh,bkhp->bqhp", att.to(x.dtype), xc)
        y_inter = torch.einsum("bqn,bhnp,bqh->bqhp", cc.to(f32), state, torch.exp(cum))
        w_k = torch.exp(cum_last - cum) * dtc  # (b, q, h)
        st = torch.einsum("bqn,bqh,bqhp->bhnp", bc, w_k.to(x.dtype), xc)
        state = torch.exp(cum_last[:, 0])[..., None, None] * state + st.to(f32)
        ys.append(y_intra.to(f32) + y_inter)
    y = torch.cat(ys, dim=1) + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), state


def ssm_scan_ref(x, dt, a_log, bmat, cmat, d_skip, h0=None):
    """Sequential oracle for SSD (the reference's; decode's one step)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    f32 = at_least_fp32(x).dtype
    a = -torch.exp(a_log.to(f32))
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device) if h0 is None else h0
    dtf = dt.to(f32)
    ys = []
    for t in range(s):
        upd = torch.einsum("bn,bh,bhp->bhnp", bmat[:, t].to(f32), dtf[:, t], x[:, t].to(f32))
        state = torch.exp(dtf[:, t] * a)[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cmat[:, t].to(f32), state))
    y = torch.stack(ys, dim=1) + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), state


def mamba_apply(p, cfg, hidden: torch.Tensor, mode: str, cache: Optional[dict] = None,
                cache_index: Optional[int] = None):
    """One Mamba2 mixer. hidden: (b, s, d). Returns (out, cache): prefill
    stores the last width − 1 raw (pre-conv) inputs and the final state,
    decode steps both by one token."""
    del cache_index  # the recurrence carries its own position
    b, s, _ = hidden.shape
    din, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    # (b, s, 2·din + 2n + h)
    proj = shard(matmul(hidden, p["in_proj"]), "batch", None, "heads_act")
    z, xbc, dt_raw = torch.split(proj, [din, din + 2 * n, nh], dim=-1)
    f32 = at_least_fp32(dt_raw).dtype
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))

    if mode in ("train", "prefill"):
        chans = ("batch", None, "heads_act")
        conv = region(_causal_conv, (chans, (None, "heads_act"), ("heads_act",)), chans,
                      xbc, p["conv_w"], p["conv_b"])
        x_in, bmat, cmat = torch.split(F.silu(conv), [din, n, n], dim=-1)
        xh = shard(split_dim(x_in, 2, (nh, hd)), "batch", "seq", "heads_act", None)
        heads, rows = ("batch", None, "heads_act", None), ("batch", None, None)
        y, h_final = region(ssd_chunked,
                            (heads, heads[:3], ("heads_act",), rows, rows, ("heads_act",), None),
                            (heads, ("batch", "heads_act", None, None)),
                            xh, dt, p["a_log"], bmat, cmat, p["d_skip"], cfg.ssm_chunk)
        if mode == "prefill" and cache is not None:
            assign(cache["conv"], xbc[:, -(cfg.ssm_conv_width - 1):])
            assign(cache["ssm"], h_final)
    elif mode == "decode":
        window = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (b, width, c)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
        x_in, bmat, cmat = torch.split(F.silu(conv_out)[:, None], [din, n, n], dim=-1)
        y, h_final = ssm_scan_ref(split_dim(x_in, 2, (nh, hd)), dt, p["a_log"], bmat, cmat,
                                  p["d_skip"], h0=cache["ssm"])
        assign(cache["conv"], window[:, 1:])
        assign(cache["ssm"], h_final)
    else:
        raise ValueError(mode)

    gated = shard(merge_dims(y, 2), "batch", None, "heads_act") * F.silu(z)
    gated = rmsnorm({"scale": p["norm_scale"]}, gated, eps=cfg.norm_eps)
    return matmul(gated, p["out_proj"]), cache
