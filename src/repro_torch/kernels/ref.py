"""Plain PyTorch versions of the port's kernels — the same formulas as
``repro/kernels/ref.py``.

They define the semantics. A kernel wrapper takes them for tensors on the CPU,
and ``chip_smoke.py`` and the card tests hold each CUDA kernel against them.
``gram_matvec_ref`` and ``gram_matvec_bwd_ref`` work in row chunks so that they
also run at the sizes the kernels are checked at on the card, where K itself
would not fit.

The matvecs and their backward take the reference kernels' tile
``precision``. With ``"bf16"`` they round to bfloat16 (to nearest even)
exactly where the Pallas kernels cast (``_cast_mxu``,
``repro/kernels/gram_matvec.py:53-82,200-246`` and
``rff_matvec.py:40-47,216-247``): the points before the distance or
projection, whose norms and inner products are then summed from the rounded
values; the covariance tile, the sin/cos tile or the backward's weights
before their contraction, and the contraction's other operand; the
backward's factors before their outer product. Everything else stays in the inputs' dtype, and
every product of rounded operands is taken in that dtype, so a product of two
bfloat16 values is exact and only its sum rounds: the fp32 accumulation of
the tensor cores, with no TF32 and no bfloat16 matmul (which would round its
result, and on the card may reduce in reduced precision).
"""
from __future__ import annotations

import math

import torch

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def stationary_map(d2: torch.Tensor, kind: str) -> torch.Tensor:
    """Elementwise covariance map of squared distances (lengthscale 1)."""
    if kind == "se":
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    if kind == "matern12":
        return torch.exp(-r)
    if kind == "matern32":
        s = _SQRT3 * r
        return (1.0 + s) * torch.exp(-s)
    if kind == "matern52":
        s = _SQRT5 * r
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown stationary kernel {kind!r}")


def dcov_map(d2: torch.Tensor, kind: str) -> torch.Tensor:
    """dκ/d(d²) of :func:`stationary_map`, with the same ε-regularised r."""
    if kind == "se":
        return -0.5 * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    if kind == "matern12":
        return -torch.exp(-r) / (2.0 * r)
    if kind == "matern32":
        return -1.5 * torch.exp(-_SQRT3 * r)
    if kind == "matern52":
        s = _SQRT5 * r
        return -(5.0 / 6.0) * (1.0 + s) * torch.exp(-s)
    raise ValueError(f"unknown stationary kernel {kind!r}")


#: the tile precisions of the reference's kernels (``TILE_PRECISIONS``)
PRECISIONS = ("fp32", "bf16")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


def tile_cast(a: torch.Tensor, precision: str) -> torch.Tensor:
    """A contraction operand as the tile precision casts it, kept in a's dtype:
    rounded to bfloat16 (to nearest even) for ``"bf16"``, as it is for
    ``"fp32"``."""
    return a.to(torch.bfloat16).to(a.dtype) if precision == "bf16" else a


def sqdist(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Squared distances via ‖x‖² + ‖z‖² − 2x·z, clamped at 0."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    zn = torch.sum(z * z, dim=-1)[None, :]
    return torch.clamp(xn + zn - 2.0 * (x @ z.T), min=0.0)


def sqdist_diff(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Squared distances summed from coordinate differences, one coordinate at
    a time: exactly 0 for coincident points on every device and dtype, as the
    kernels' shared FMA order makes theirs (no (rows, m, d) temporary)."""
    out = torch.zeros((x.shape[0], z.shape[0]), dtype=x.dtype, device=x.device)
    for k in range(x.shape[1]):
        out += (x[:, k, None] - z[None, :, k]) ** 2
    return out


def gram_matvec_ref(
    x: torch.Tensor,
    z: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: str = "se",
    row_chunk: int = 4096,
    precision: str = "fp32",
    signal: float = 1.0,
    jitter: float = 0.0,
) -> torch.Tensor:
    """(signal·k(x, z) + jitter·I) @ v — the reference's ``gram_matvec_ref``;
    the kernel's core at the defaults (unit signal, no jitter).
    x:(n,d) z:(m,d) v:(m,s) → (n,s), inputs already lengthscale-scaled (x/ℓ).
    With ``"bf16"``, ``gram_matvec_pallas``'s casts: x, z, the k tile (after
    its signal) and v; jitter·v is added in v's own dtype, as there.
    """
    check_precision(precision)
    if jitter and x.shape[0] != z.shape[0]:
        raise ValueError("jitter·I needs a square operator: z = x (m = n)")
    if not x.shape[0]:
        return v.new_zeros((0, v.shape[1]))
    xc, zc, vc = (tile_cast(a, precision) for a in (x, z, v))

    def k_tile(rows):
        k = stationary_map(sqdist(rows, zc), kind)
        return tile_cast(k if signal == 1.0 else signal * k, precision)

    out = torch.cat([k_tile(xc[i:i + row_chunk]) @ vc
                     for i in range(0, x.shape[0], row_chunk)])
    return out + jitter * v if jitter else out


def gram_matvec_bwd_ref(
    x: torch.Tensor,
    z: torch.Tensor,
    rowv: torch.Tensor,
    colv: torch.Tensor,
    *,
    kind: str = "se",
    row_chunk: int = 1024,
    precision: str = "fp32",
) -> torch.Tensor:
    """dx = 2·(x ⊙ Σⱼ W − W z), W_ij = κ'(d²_ij)·mask_ij·(rowv_i·colv_j): the
    input cotangent of v ↦ k(x, z) @ v at ḡ = rowv (n, s), v = colv (m, s), as
    the reference's ``gram_matvec_bwd_pallas`` computes it. With
    (z, x, colv, rowv) it gives dz.

    The mask is the reference's: Matérn-1/2 drops coincident pairs, where
    κ' ~ 1/r; the other kinds weigh them ½. d² comes from differences, not
    from the matmul identity, so it is exactly 0 for coincident points, as the
    CUDA kernel's is through its shared FMA order (an identity's few ulp on the
    diagonal would become weights of ~1e8 through Matérn-1/2's κ'), and never
    negative, so the reference's clamp and its below-zero mask have nothing to
    do here.

    With ``"bf16"``, ``gram_matvec_bwd_pallas``'s casts: d² from the matmul
    identity on the rounded x and z (``_pair_dists``, as the bf16 forward),
    clamped for κ' and masked from its raw value; rowv·colvᵀ on rounded
    factors; Σⱼ W from the unrounded W; W z on the rounded W and z; the flush
    on the unrounded x.
    """
    check_precision(precision)
    if precision == "bf16":
        return _gram_matvec_bwd_bf16(x, z, rowv, colv, kind, row_chunk)
    out = []
    for i in range(0, x.shape[0], row_chunk):
        xc = x[i:i + row_chunk]
        raw = sqdist_diff(xc, z)
        mask = (raw > 0).to(raw.dtype)
        if kind != "matern12":
            mask = mask + 0.5 * (raw == 0).to(raw.dtype)
        w = dcov_map(raw, kind) * mask * (rowv[i:i + row_chunk] @ colv.T)
        out.append(2.0 * (xc * torch.sum(w, dim=1, keepdim=True) - w @ z))
    return torch.cat(out) if out else x.new_zeros((0, x.shape[1]))


def _gram_matvec_bwd_bf16(x, z, rowv, colv, kind, row_chunk):
    xr, zr, rv, cv = (tile_cast(a, "bf16") for a in (x, z, rowv, colv))
    zn = torch.sum(zr * zr, dim=-1)[None, :]
    out = []
    for i in range(0, x.shape[0], row_chunk):
        xc = xr[i:i + row_chunk]
        raw = torch.sum(xc * xc, dim=-1)[:, None] + zn - 2.0 * (xc @ zr.T)
        mask = (raw > 0).to(raw.dtype)
        if kind != "matern12":
            mask = mask + 0.5 * (raw == 0).to(raw.dtype)
        w = dcov_map(torch.clamp(raw, min=0.0), kind) * mask * (rv[i:i + row_chunk] @ cv.T)
        out.append(2.0 * (x[i:i + row_chunk] * torch.sum(w, dim=1, keepdim=True)
                          - tile_cast(w, "bf16") @ zr))
    return torch.cat(out) if out else x.new_zeros((0, x.shape[1]))


def rff_matvec_ref(x: torch.Tensor, omega: torch.Tensor, w: torch.Tensor, *,
                   precision: str = "fp32") -> torch.Tensor:
    """Φ(x) @ w with paired sin/cos features, unit signal.
    x:(n,d) ω:(m,d) w:(2m,s) → (n,s). With ``"bf16"``, ``rff_matvec_pallas``'s
    casts: x and ω before the projection, the unscaled sin/cos tile and w,
    √(1/m) applied to the contraction's sum."""
    check_precision(precision)
    m = omega.shape[0]
    if precision == "bf16":
        sn, cs = _proj_features(x, omega, precision)
        feats = tile_cast(torch.cat([sn, cs], -1), precision)
        return math.sqrt(1.0 / m) * (feats @ tile_cast(w, precision))
    proj = x @ omega.T
    phi = math.sqrt(1.0 / m) * torch.cat([torch.sin(proj), torch.cos(proj)], -1)
    return phi @ w


def gram_rows_matvec_ref(xi: torch.Tensor, x: torch.Tensor, look: torch.Tensor, *,
                         kind: str = "se", precision: str = "fp32") -> torch.Tensor:
    """K̃(xi, x) @ look: the row panel's matvec with unit signal, inputs
    pre-scaled by 1/ℓ. xi:(p,d) x:(n,d) look:(n,s) → (p,s). With ``"bf16"``
    it is :func:`gram_matvec_ref`'s, the Gram kernel's casts."""
    if precision != "fp32":
        return gram_matvec_ref(xi, x, look, kind=kind, precision=precision)
    return stationary_map(sqdist_diff(xi, x), kind) @ look


def gram_rows_pair_ref(
    xi: torch.Tensor,
    x: torch.Tensor,
    look: torch.Tensor,
    b: torch.Tensor,
    *,
    kind: str = "se",
    p_true=None,
    precision: str = "fp32",
) -> tuple:
    """err = K̃(xi, x) @ look − b with rows ≥ ``p_true`` zeroed, and
    g = K̃(xi, x)ᵀ @ err, from ONE panel — ``gram_rows_pair_pallas``'s
    semantics (unit signal, inputs pre-scaled by 1/ℓ).
    xi:(p,d) x:(n,d) look:(n,s) b:(p,s) → ((p,s), (n,s)). With ``"bf16"``,
    its casts: the points, the panel and look, and err (accumulated, b
    subtracted and masked at full precision) before the second contraction."""
    check_precision(precision)
    p = xi.shape[0]
    p_true = p if p_true is None else p_true
    if precision == "bf16":  # the cast points' distances (_pair_dists)
        panel = stationary_map(sqdist(tile_cast(xi, precision), tile_cast(x, precision)), kind)
    else:
        panel = stationary_map(sqdist_diff(xi, x), kind)  # (p, n), built once
    panel = tile_cast(panel, precision)
    err = panel @ tile_cast(look, precision) - b
    keep = (torch.arange(p, device=xi.device) < p_true)[:, None]
    err = torch.where(keep, err, torch.zeros_like(err))
    return err, panel.T @ tile_cast(err, precision)


def _proj_features(x: torch.Tensor, omega: torch.Tensor, precision: str = "fp32") -> tuple:
    proj = tile_cast(x, precision) @ tile_cast(omega, precision).T
    return torch.sin(proj), torch.cos(proj)


def rff_t_matvec_ref(x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                     m_true=None, precision: str = "fp32") -> torch.Tensor:
    """Φ(x)ᵀ @ u with paired sin/cos features, unit signal, scale √(1/m) of
    the (possibly padded) m, sin rows first, rows of frequencies ≥ ``m_true``
    zeroed in both halves. x:(n,d) ω:(m,d) u:(n,s) → (2m,s). With ``"bf16"``,
    ``rff_t_matvec_pallas``'s casts: x and ω, the sin/cos tiles and u."""
    check_precision(precision)
    m = omega.shape[0]
    m_true = m if m_true is None else m_true
    sn, cs = (tile_cast(f, precision) for f in _proj_features(x, omega, precision))
    u = tile_cast(u, precision)
    scale = math.sqrt(1.0 / m)
    t = scale * torch.cat([sn.T @ u, cs.T @ u], dim=0)
    keep = (torch.arange(2 * m, device=x.device) % m < m_true)[:, None]
    return torch.where(keep, t, torch.zeros_like(t))


def rff_bwd_ref(
    r: torch.Tensor,
    c: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    q1: torch.Tensor,
    q2: torch.Tensor,
    *,
    scale: float,
    row_chunk: int = 256,
    precision: str = "fp32",
) -> torch.Tensor:
    """dR = scale·(cos(RCᵀ) ⊙ P₁Q₁ᵀ − sin(RCᵀ) ⊙ P₂Q₂ᵀ) @ C: the input
    cotangent of the projection RCᵀ, as ``rff_bwd_pallas`` computes it. With
    (x, ω, ḡ, ḡ, w_sin, w_cos) it is ∂x of Φ̃w, with (ω, x, w_sin, w_cos, ḡ, ḡ)
    its ∂ω. r:(rows,d) c:(cols,d) p1,p2:(rows,s) q1,q2:(cols,s) → (rows,d);
    in row chunks, so that the (rows, cols) weights are never whole. With
    ``"bf16"``, its casts: R and C before the projection (and C in W C), the
    four factors before their products, W (computed unrounded) before W C;
    the scale applied to the sum."""
    check_precision(precision)
    r, c, p1, p2, q1, q2 = (tile_cast(a, precision) for a in (r, c, p1, p2, q1, q2))
    out = []
    for i in range(0, r.shape[0], row_chunk):
        proj = r[i:i + row_chunk] @ c.T
        w = (torch.cos(proj) * (p1[i:i + row_chunk] @ q1.T)
             - torch.sin(proj) * (p2[i:i + row_chunk] @ q2.T))
        out.append(scale * (tile_cast(w, precision) @ c))
    return torch.cat(out) if out else r.new_zeros((0, r.shape[1]))


def rff_pair_ref(x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                 m_true=None, precision: str = "fp32") -> torch.Tensor:
    """Φ̃(Φ̃ᵀu) with Φ̃ = √(1/m)·[sin | cos] of the (possibly padded) m, the
    intermediate's rows of frequencies ≥ ``m_true`` zeroed (a zero frequency's
    cos is 1: its row would be Σᵢuᵢ, not 0) — ``rff_pair_pallas``'s semantics.
    x:(n,d) ω:(m,d) u:(n,s) → (n,s). With ``"bf16"`` the second phase casts
    the intermediate as it is kept, scaled by √(1/m) and masked."""
    t = rff_t_matvec_ref(x, omega, u, m_true=m_true, precision=precision)
    return rff_matvec_ref(x, omega, t, precision=precision)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Attention with materialised logits, ``flash_attention_pallas``'s
    semantics: q (b, s, hq, d), k and v (b, s, hkv, d) with hq % hkv == 0,
    query head h reading key/value head h // (hq / hkv) → (b, s, hq, d).

    On bfloat16 inputs, the kernel's casts there: fp32 logits from the bf16 q
    and k, scaled after the product; the max and the normaliser l in fp32, l
    summing the unrounded p; p rounded to bf16 for p·v alone, accumulated in
    fp32; the output rounded to bf16."""
    hq, hkv = q.shape[2], k.shape[2]
    head_map = torch.arange(hq, device=q.device) // (hq // hkv)
    k, v = k[:, :, head_map], v[:, :, head_map]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, float("-inf"))
    if not bf16:
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", tile_cast(p, "bf16"), v.float())
    return (out / p.sum(dim=-1).transpose(1, 2)[..., None]).to(torch.bfloat16)
