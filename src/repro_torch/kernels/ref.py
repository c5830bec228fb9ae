"""Plain PyTorch versions of the port's kernels — the same formulas as
``repro/kernels/ref.py``.

They define the semantics. A kernel wrapper takes them for tensors on the CPU,
and ``chip_smoke.py`` and the card tests hold each CUDA kernel against them.
``gram_matvec_ref`` works in row chunks so that it also runs at the sizes the
kernels are checked at on the card, where K itself would not fit.
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


def sqdist(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Squared distances via ‖x‖² + ‖z‖² − 2x·z, clamped at 0."""
    xn = torch.sum(x * x, dim=-1)[:, None]
    zn = torch.sum(z * z, dim=-1)[None, :]
    return torch.clamp(xn + zn - 2.0 * (x @ z.T), min=0.0)


def gram_matvec_ref(
    x: torch.Tensor,
    z: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: str = "se",
    row_chunk: int = 4096,
) -> torch.Tensor:
    """k(x, z) @ v with unit signal and no jitter — the kernel's core, as
    ``gram_matvec_ref(..., signal=1, jitter=0)`` in the reference.
    x:(n,d) z:(m,d) v:(m,s) → (n,s), inputs already lengthscale-scaled (x/ℓ).
    """
    if not x.shape[0]:
        return v.new_zeros((0, v.shape[1]))
    return torch.cat([
        stationary_map(sqdist(x[i:i + row_chunk], z), kind) @ v
        for i in range(0, x.shape[0], row_chunk)
    ])


def rff_matvec_ref(x: torch.Tensor, omega: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Φ(x) @ w with paired sin/cos features, unit signal.
    x:(n,d) ω:(m,d) w:(2m,s) → (n,s)."""
    m = omega.shape[0]
    proj = x @ omega.T
    phi = math.sqrt(1.0 / m) * torch.cat([torch.sin(proj), torch.cos(proj)], -1)
    return phi @ w
