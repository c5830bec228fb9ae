"""Shared iterative-solver infrastructure (§2.2.4) — twin of
``repro/core/solvers/base.py``.

Solvers consume the :class:`~repro_torch.core.operators.LinearOperator`
protocol and return a :class:`SolveResult` that reports how many full operator
matvecs they spent and per-column diagnostic flags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..operators import LinearOperator, layout_of

#: non-finite residual/iterate/payload detected (NaN or Inf)
FLAG_NONFINITE = 1
#: CG breakdown: pᵀAp ≤ 0 on an active column (loss of positive-definiteness)
FLAG_BREAKDOWN = 2
#: relative residual stopped improving over the solver's stall window
#: (advisory — the column keeps iterating and may still converge)
FLAG_STAGNATION = 4

#: flags that freeze a column: its updates are zeroed inside the loop so it
#: cannot contaminate the shared multi-RHS matvec (stagnation does not freeze)
FROZEN_FLAGS = FLAG_NONFINITE | FLAG_BREAKDOWN

_FLAG_NAMES = (
    (FLAG_NONFINITE, "nonfinite"),
    (FLAG_BREAKDOWN, "breakdown"),
    (FLAG_STAGNATION, "stagnation"),
)


def flag_names(mask: int) -> tuple:
    """Human-readable names for a single column's flag bitmask."""
    return tuple(name for bit, name in _FLAG_NAMES if int(mask) & bit)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    solution: torch.Tensor  # (n, s)
    residual_norm: torch.Tensor  # (s,) final ||A v − b||₂ per RHS
    rel_residual: torch.Tensor  # (s,) ||A v − b|| / ||b||
    iterations: int  # iterations executed
    converged: bool  # all RHS under tolerance AND flag-free
    matvecs: int = 0  # full operator matvecs spent
    flags: Optional[torch.Tensor] = None  # (s,) int32 per-column FLAG_* bitmask

    @property
    def healthy(self) -> bool:
        """No column carries a freezing flag (nonfinite/breakdown)."""
        return self.flags is None or not bool(torch.any((self.flags & FROZEN_FLAGS) != 0))


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """The random coordinate blocks of an SDD or AP solve, one row per step:
    ``idx`` (num_steps, batch) int64 indices into the n training rows. Drawn
    from a ``torch.Generator`` by :func:`draw_rows`, or injected (the parity
    tests pass the reference's own ``fold_in(key, t)`` draws)."""

    idx: torch.Tensor


def draw_rows(n: int, num_steps: int, batch: int, *, generator: torch.Generator,
              device) -> RowDraws:
    """``num_steps`` blocks of ``batch`` uniform indices in [0, n), in one draw."""
    return RowDraws(idx=torch.randint(0, n, (num_steps, batch), generator=generator,
                                      device=device))


def check_draws(idx: torch.Tensor, num_steps: int, batch: int, solver: str) -> None:
    if tuple(idx.shape) != (num_steps, batch):
        raise ValueError(
            f"{solver}: injected draws hold indices of shape {tuple(idx.shape)}, "
            f"the spec needs (num_steps, batch) = {(num_steps, batch)}"
        )


def frozen_update(fl: torch.Tensor, ok: torch.Tensor) -> tuple:
    """The in-loop NONFINITE bookkeeping of the stochastic solvers: a healthy
    column whose step is not finite gets the flag, and only columns healthy
    and finite apply the step. Tensor ops only, no host sync.
    Returns (flags, apply (s,) bool)."""
    healthy = (fl & FLAG_NONFINITE) == 0
    fl = fl | torch.where(healthy & ~ok, FLAG_NONFINITE, 0).to(torch.int32)
    return fl, healthy & ok


def as_matrix_rhs(b: torch.Tensor) -> tuple:
    if b.ndim == 1:
        return b[:, None], True
    return b, False


def _col_norm(a: torch.Tensor, reduce=None) -> torch.Tensor:
    """‖a‖₂ per column (s,). On the card the sum of squares runs in float64
    and is rounded once, so a column's norm is the same at every width s (the
    float32 ``linalg.norm`` over dim 0 rounds some columns by the width). On
    the CPU the float32 norm stays: the plain matvecs there round by the
    width anyway. With ``reduce`` (a row-sharded layout's) ``a`` is this
    rank's rows: the squares of the ranks' norms, taken as above, are
    psum-reduced in float64 and rounded once, every rank then holding the
    same bits; on one rank the norm is the unsharded one exactly
    (√(x²) = |x| in IEEE arithmetic)."""
    if a.is_cuda:
        norm = torch.linalg.vector_norm(a, dim=0, dtype=torch.float64)
    else:
        norm = torch.linalg.norm(a, dim=0)
    if reduce is not None:
        norm = torch.sqrt(reduce(torch.square(norm.double())))
    return norm.to(a.dtype)


def _col_finite(a: torch.Tensor, reduce=None) -> torch.Tensor:
    """(s,) bool: column all finite — over every rank's rows with ``reduce``."""
    if reduce is None:
        return torch.all(torch.isfinite(a), dim=0)
    bad = torch.sum(~torch.isfinite(a), dim=0, dtype=torch.float64)
    return reduce(bad) == 0


def finalize(
    op: LinearOperator,
    v: torch.Tensor,
    b: torch.Tensor,
    iterations: int,
    squeeze: bool,
    *,
    tol: float,
    residual: Optional[torch.Tensor] = None,
    matvecs: int = 0,
    flags: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Residual bookkeeping shared by all solvers. ``tol`` is the solver's own
    relative-residual tolerance.

    Solvers that track the residual pass it as ``residual`` and skip a full
    matvec; otherwise it is recomputed and ``matvecs`` grows by one. ``v`` and
    ``b`` lie in the operator's layout (row blocks under a ring
    ``ShardedGram``, whose reductions then sum over the ranks). On top of
    the solver's ``flags`` this adds the final payload check — a non-finite
    solution or residual column gets ``FLAG_NONFINITE`` — and clears the
    advisory stagnation flag of columns that reached the tolerance. Any flag
    forces ``converged=False``.
    """
    reduce = layout_of(op).reduce
    if residual is None:
        residual = b - op.mv(v)
        matvecs = matvecs + 1
    rn = _col_norm(residual, reduce)
    bn = torch.clamp(_col_norm(b, reduce), min=1e-30)
    rel = rn / bn
    col_ok = _col_finite(v, reduce) & torch.isfinite(rn)
    f = (
        torch.zeros(rn.shape, dtype=torch.int32, device=rn.device)
        if flags is None
        else flags.to(torch.int32)
    )
    f = f | torch.where(col_ok, 0, FLAG_NONFINITE).to(torch.int32)
    f = torch.where((rel <= tol) & col_ok, f & ~FLAG_STAGNATION, f)
    return SolveResult(
        solution=v[:, 0] if squeeze else v,
        residual_norm=rn,
        rel_residual=rel,
        iterations=int(iterations),
        converged=bool(torch.all((rel <= tol) & (f == 0))),
        matvecs=int(matvecs),
        flags=f,
    )
