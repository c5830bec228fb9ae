"""Conjugate gradients with optional preconditioning (§2.2.4, Eq. 2.78) —
twin of ``repro/core/solvers/cg.py``.

Operator-agnostic: consumes any ``LinearOperator`` through ``mv`` alone.
Batched over right-hand sides (each column runs its own CG recursion; they
share one multi-RHS matvec per iteration). Supports warm starts and a fixed
iteration budget.

The reference's ``lax.while_loop`` is a Python loop here. Its condition
``jnp.any(live)`` becomes ONE host sync per iteration (``bool(live.any())``):
the loop must know on the host whether to launch the next matvec.

Matvec economy, kept exactly: a cold start costs no initial matvec (r₀ = b),
and the recursion's residual is handed to ``finalize``, so a solve spends
``iterations`` matvecs, or ``iterations + 1`` on a warm start.

On the card the column dots and norms accumulate in float64
(:func:`_col_dot`, ``base._col_norm``), ‖b‖ and ``finalize``'s residuals
among them, so a column's trajectory, its stop and its reported residual do
not depend on how many columns share the solve.

On a row-sharded operator (a ring ``ShardedGram``) the right-hand side, warm
start and iterates are this rank's row blocks (``layout_of(op).iterate``),
the dots and norms psum-reduce their partials (float64 on the card), and the
preconditioner applies to row blocks; every rank then takes the same branch
at the loop's host sync.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .base import (
    FLAG_BREAKDOWN,
    FLAG_NONFINITE,
    FLAG_STAGNATION,
    FROZEN_FLAGS,
    LinearOperator,
    SolveResult,
    _col_norm,
    as_matrix_rhs,
    finalize,
    layout_of,
)

#: relative improvement of the best-so-far residual that resets the stagnation
#: counter — smaller steady progress than this over ``stall_window`` iterations
#: raises FLAG_STAGNATION (advisory; the column keeps iterating)
_STALL_RTOL = 1e-3


def _flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def _col_dot(a: torch.Tensor, b: torch.Tensor, reduce=None) -> torch.Tensor:
    """Σ_rows a ⊙ b per column (s,). On the card the products' sum runs in
    float64 and is rounded once: the float32 sum over dim 0 of an (n, s)
    tensor splits its work by the width s and rounds each column by it, so a
    column's recursion would move with the columns riding beside it — the
    serving engine's payloads with their batch's bucket. The Gram kernel's
    columns are independent of the width, so with these dots a column's CG
    trajectory on the card is too. On the CPU the float32 sum stays: the
    plain matvecs there round by the width anyway. With ``reduce`` (a
    row-sharded layout's) the partials of this rank's rows are psum-reduced
    in the same precision: on the card in float64, rounded once."""
    dot = torch.sum(a * b, dim=0, dtype=torch.float64 if a.is_cuda else a.dtype)
    return (dot if reduce is None else reduce(dot)).to(a.dtype)


def solve_cg(
    op: LinearOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    max_iters: int = 1000,
    tol: float = 1e-2,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stall_window: int = 100,
) -> SolveResult:
    """Solve (K+σ²I) V = B. b: (n,) or (n,s). ``tol`` is on the *relative*
    residual. ``precond`` is an r ↦ M⁻¹r apply (``WoodburyPrecond``,
    ``JacobiPrecond`` or any callable); without it z = r. Per-column
    freezing: converged and flagged columns take ``alpha = 0`` and stop
    moving, while the others iterate on."""
    layout = layout_of(op)
    red = layout.reduce
    b2, squeeze = as_matrix_rhs(b)
    b2 = layout.iterate(b2)
    if x0 is None:
        v = torch.zeros_like(b2)
        r = b2  # v0 == 0 ⇒ the initial residual is free (no A·0 matvec)
        init_mv = 0
    else:
        v = layout.iterate(x0[:, None] if x0.ndim == 1 else x0)
        r = b2 - op.mv(v)
        init_mv = 1
    z = r if precond is None else precond(r)
    bn = torch.clamp(_col_norm(b2, red), min=1e-30)
    rn = _col_norm(r, red)
    rz = _col_dot(r, z, red)
    # a non-finite initial residual is flagged before the first iteration:
    # NaN > tol is False, so an unflagged NaN column would read as converged
    fl = _flag(~(torch.isfinite(rn) & torch.isfinite(rz)), FLAG_NONFINITE)
    p = z
    best = rn
    since = torch.zeros(rn.shape, dtype=torch.int32, device=rn.device)
    t = 0
    while t < max_iters:
        live = ((fl & FROZEN_FLAGS) == 0) & (rn / bn > tol)
        if not bool(live.any()):  # the one host sync of the iteration
            break
        ap = op.mv(p)
        pap = _col_dot(p, ap, red)
        # in-loop health checks on (s,) reductions: NaN/Inf in ap surfaces in
        # pᵀAp, and pᵀAp ≤ 0 on an active column is breakdown. Flagged columns
        # freeze BEFORE their update is applied.
        bad_now = live & ~torch.isfinite(pap)
        breakdown = live & torch.isfinite(pap) & (pap <= 0)
        fl = fl | _flag(bad_now, FLAG_NONFINITE) | _flag(breakdown, FLAG_BREAKDOWN)
        live = live & ~bad_now & ~breakdown
        alpha = rz / torch.where(pap > 0, pap, torch.ones_like(pap))
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        v = v + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = r if precond is None else precond(r)
        rz_new = _col_dot(r, z, red)
        rn_new = _col_norm(r, red)
        # the update itself can overflow (Inf in ap with a finite pᵀAp)
        post_bad = live & ~(torch.isfinite(rn_new) & torch.isfinite(rz_new))
        fl = fl | _flag(post_bad, FLAG_NONFINITE)
        beta = rz_new / torch.where(rz > 0, rz, torch.ones_like(rz))
        p = z + beta[None, :] * p
        # stagnation watch (advisory): iterations without a relative
        # improvement of the best residual so far; only active columns count
        improved = rn_new < best * (1.0 - _STALL_RTOL)
        since = torch.where(live, torch.where(improved, 0, since + 1), since).to(torch.int32)
        fl = fl | _flag(live & (since >= stall_window), FLAG_STAGNATION)
        best = torch.minimum(best, rn_new)
        rz, rn = rz_new, rn_new
        t += 1
    # one matvec per iteration + the optional warm-start residual; the tracked
    # recursion residual r IS b − A v, so finalize adds no extra matvec
    return finalize(
        op, v, b2, t, squeeze, tol=tol, residual=r, matvecs=init_mv + t, flags=fl,
    )
