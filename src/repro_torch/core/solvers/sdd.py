"""Stochastic dual descent (Chapter 4, Algorithm 4.1) — twin of
``repro/core/solvers/sdd.py``.

Minimises the dual objective L*(α) = ½‖α‖²_{K+σ²I} − αᵀb, whose minimiser is
α* = (K+σ²I)⁻¹ b, with random-coordinate gradients (Eq. 4.25): the whole
gradient, σ²α − b included, is subsampled, so its noise vanishes as the
iterate converges. Nesterov momentum and geometric iterate averaging with
r = 100/num_steps (§4.2.3). One row-panel matvec ``rows_mv`` per step, the
row-panel kernel on the card.

On a sharded operator the iterates lie in its layout: under ring each rank
holds its row block, ``look[idx]`` is a masked psum and the velocity's
scatter lands on the rows each rank holds.

The reference's ``lax.scan`` is a Python loop with no host sync inside; a
column whose block residual turns non-finite is flagged and frozen by
``torch.where``. The coordinate blocks come from a ``torch.Generator`` in one
draw up front, or are injected (:class:`~.base.RowDraws`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import (
    LinearOperator, RowDraws, SolveResult, as_matrix_rhs, check_draws, draw_rows,
    finalize, frozen_update, layout_of,
)


def solve_sdd(
    op: LinearOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[RowDraws] = None,
    num_steps: int = 20_000,
    batch_size: int = 512,
    step_size_times_n: float = 50.0,
    momentum: float = 0.9,
    averaging: Optional[float] = None,
    tol: float = 1e-2,
) -> SolveResult:
    """Solve (K+σ²I)V = b by stochastic dual descent. b: (n,) or (n,s)."""
    layout = layout_of(op)
    b2, squeeze = as_matrix_rhs(b)
    n, s = op.shape[0], b2.shape[1]
    sigma2 = op.noise
    beta = step_size_times_n / n
    r = (100.0 / num_steps) if averaging is None else averaging
    if draws is None:
        draws = draw_rows(n, num_steps, batch_size, generator=generator, device=b2.device)
    check_draws(draws.idx, num_steps, batch_size, "sdd")

    alpha = layout.iterate(torch.zeros_like(b2) if x0 is None else (
        x0[:, None] if x0.ndim == 1 else x0))
    vel = torch.zeros_like(alpha)
    avg = alpha
    fl = torch.zeros((s,), dtype=torch.int32, device=b2.device)
    for t in range(num_steps):
        idx = draws.idx[t]
        look = alpha + momentum * vel  # Nesterov lookahead
        # (k_i + σ² e_i)ᵀ look − b_i: the full dual gradient's coordinates
        resid = (op.rows_mv(idx, look) + sigma2 * layout.take(look, idx)
                 - layout.take(b2, idx))  # (p, s)
        fl, apply = frozen_update(fl, torch.all(torch.isfinite(resid), dim=0))
        apply = apply[None, :]
        # duplicate indices add up, as the reference's .at[idx].add does
        g_scaled = (n / batch_size) * resid
        vel_new = layout.index_add_(momentum * vel, idx, -beta * g_scaled)
        vel = torch.where(apply, vel_new, vel)
        alpha = torch.where(apply, alpha + vel, alpha)
        avg = torch.where(apply, r * alpha + (1.0 - r) * avg, avg)
    return finalize(op, avg, layout.iterate(b2), num_steps, squeeze, tol=tol, flags=fl)
