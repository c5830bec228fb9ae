"""Alternating projections / randomised block-coordinate descent (§5.1.1) —
twin of ``repro/core/solvers/ap.py``.

Each step picks a random block I of p coordinates, solves the p×p block system
exactly and updates the maintained residual:

    Δ = (K_II + σ² I_p)⁻¹ r_I ;   α_I += Δ ;   r −= (K_:I + σ² E_I) Δ

One transposed row-panel matvec ``rows_t_mv`` per step (the Gram kernel on
(x, x[I]) on the card) plus the plain p×p ``block_at`` and its solve. The
maintained residual IS b − Aα, so a cold solve spends no full matvec.

The reference's ``lax.scan`` is a Python loop with no host sync inside: the
block solve is ``torch.linalg.solve_ex`` (no error check, which would sync),
and a column whose Δ turns non-finite is flagged and frozen by
``torch.where``. The blocks come from a ``torch.Generator`` in one draw up
front, or are injected (:class:`~.base.RowDraws`).
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import (
    FLAG_NONFINITE, LinearOperator, RowDraws, SolveResult, as_matrix_rhs, check_draws,
    draw_rows, finalize, frozen_update,
)


def solve_ap(
    op: LinearOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[RowDraws] = None,
    num_steps: int = 2000,
    block_size: int = 512,
    tol: float = 1e-2,
) -> SolveResult:
    """Solve (K+σ²I)V = b by alternating projections. b: (n,) or (n,s)."""
    b2, squeeze = as_matrix_rhs(b)
    n, s = b2.shape
    sigma2 = op.noise
    if x0 is None:
        alpha = torch.zeros_like(b2)
        r = b2  # α₀ = 0: the initial residual is free (no A·0 matvec)
        init_mv = 0
    else:
        alpha = x0[:, None] if x0.ndim == 1 else x0
        r = b2 - op.mv(alpha)
        init_mv = 1
    if draws is None:
        draws = draw_rows(n, num_steps, block_size, generator=generator, device=b2.device)
    check_draws(draws.idx, num_steps, block_size, "ap")
    eye = torch.eye(block_size, dtype=b2.dtype, device=b2.device)
    fl = torch.where(torch.all(torch.isfinite(r), dim=0), 0, FLAG_NONFINITE).to(torch.int32)
    for t in range(num_steps):
        idx = draws.idx[t]
        kii = op.block_at(idx) + sigma2 * eye
        # duplicate indices make the block singular in exact arithmetic; the
        # reference's extra 1e-6 jitter keeps the solve defined
        delta = torch.linalg.solve_ex(kii + 1e-6 * eye, r[idx])[0]  # (p, s)
        fl, apply = frozen_update(fl, torch.all(torch.isfinite(delta), dim=0))
        delta = torch.where(apply[None, :], delta, torch.zeros_like(delta))
        alpha = alpha.index_add(0, idx, delta)
        r = (r - op.rows_t_mv(idx, delta)).index_add_(0, idx, -sigma2 * delta)
    # the maintained residual is b − A α: finalize adds no matvec
    return finalize(op, alpha, b2, num_steps, squeeze, tol=tol, residual=r,
                    matvecs=init_mv, flags=fl)
