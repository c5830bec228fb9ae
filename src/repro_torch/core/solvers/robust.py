"""Escalation ladder on top of ``solve()`` — structured recovery from solver
breakdown; twin of ``repro/core/solvers/robust.py``.

The solver loops detect per-column trouble inside their loops and report it as
``SolveResult.flags`` (non-finite, CG breakdown, stagnation), with flagged
columns frozen. ``solve_robust`` runs the base solve, reads the flags once (the
only happy-path cost: one host readback of an (s,) vector, no extra matvec),
and walks the flagged columns down the rungs:

1. **jitter**: re-solve with a noise bump ε·mean(diag A), judged against the
   rung's *own* regularised system (K + σ²I + εI), as a jittered Cholesky is;
2. **precondition**: CG with a Nyström preconditioner (``Jacobi`` on operators
   without ``precond_factor``);
3. **switch family**: a stochastic spec that diverged re-runs flagged columns
   under preconditioned CG;
4. **dense fallback**: for n ≤ ``dense_fallback_max_n``, materialise and
   Cholesky-solve, escalating jitter until the factorisation succeeds.

Only the flagged columns ride the ladder; healthy columns keep their base
payload untouched, and every rung taken is recorded in the
:class:`SolveReport`. The rungs' random draws (the Nyström subset, a
stochastic spec's steps) come from ``generator``, or from one seeded 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...device import make_generator
from ..operators import LinearOperator, supports
from ..precond import cholesky_or_nan
from .base import FLAG_STAGNATION, FROZEN_FLAGS, SolveResult, as_matrix_rhs, flag_names
from .spec import CG, Jacobi, Nystrom, SpecLike, as_spec, solve


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Configuration of the rung sequence ``solve_robust`` walks; the default
    is the full ladder. An empty ladder (``jitter=()``,
    ``switch_to_cg=False``, ``dense_fallback_max_n=0``) is "base solve +
    structured report"."""

    #: noise bumps, as multiples of mean(diag A); one rung per entry
    jitter: Tuple[float, ...] = (1e-6, 1e-3)
    #: Nyström rank for the precondition rung (needs ``precond_factor``)
    precond_rank: int = 64
    #: re-run flagged columns of a stochastic solve under CG
    switch_to_cg: bool = True
    #: iteration budget for ladder CG rungs
    cg_max_iters: int = 1000
    #: tolerance for ladder CG rungs; None inherits the spec's own ``tol``
    cg_tol: Optional[float] = None
    #: largest n for which the dense Cholesky fallback is permitted (0 = never)
    dense_fallback_max_n: int = 4096
    #: treat FLAG_STAGNATION columns as escalation candidates (advisory flag)
    escalate_on_stagnation: bool = True
    #: also escalate healthy-but-unconverged columns
    escalate_on_unconverged: bool = False


@dataclasses.dataclass(frozen=True)
class RungRecord:
    """One rung taken: which columns it attempted and which it recovered."""

    rung: str  # "jitter:1e-06" | "precond:nystrom" | "switch:cg" | "dense:cholesky(...)"
    columns: Tuple[int, ...]  # column indices this rung attempted
    recovered: Tuple[int, ...]  # subset that came back healthy
    flags_before: Tuple[int, ...]  # per attempted column, pre-rung bitmask
    iterations: int
    matvecs: int

    @property
    def flag_names_before(self) -> Tuple[Tuple[str, ...], ...]:
        return tuple(flag_names(m) for m in self.flags_before)


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """What ``solve_robust`` did: the merged result plus the audit trail."""

    result: SolveResult  # merged payload (healthy base columns + rung rescues)
    rungs: Tuple[RungRecord, ...]  # every rung taken, in order (empty = happy path)
    escalated: bool  # any column left the happy path
    recovered: bool  # True iff no column is still flagged after the ladder
    failed_columns: Tuple[int, ...]  # columns still bad after the final rung

    @property
    def ladder(self) -> Tuple[str, ...]:
        return tuple(r.rung for r in self.rungs)


@dataclasses.dataclass(frozen=True)
class _JitteredOp(LinearOperator):
    """``inner + eps·I``, the operator of the jitter rungs. Only the σ²I split
    changes (``noise``/``mv``/``diag_part``/``dense`` gain ε); the kernel-side
    capabilities forward to the inner operator through ``__getattr__``, so
    ``hasattr`` capability detection sees exactly the inner's set (the
    stochastic solvers add ``op.noise`` themselves)."""

    inner: Any  # the wrapped LinearOperator
    eps: torch.Tensor  # () the absolute ridge added

    @property
    def shape(self) -> tuple:
        return self.inner.shape

    @property
    def noise(self) -> torch.Tensor:
        return self.inner.noise + self.eps

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return self.inner.mv(v) + self.eps * v

    def diag_part(self) -> torch.Tensor:
        return self.inner.diag_part() + self.eps

    def dense(self) -> torch.Tensor:
        a = self.inner.dense()
        return a + self.eps * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)

    def __getattr__(self, name: str):
        if name.startswith("__") or name in ("inner", "eps"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "inner"), name)


def _bad_mask(res: SolveResult, tol: float, policy: EscalationPolicy) -> np.ndarray:
    """Host-side boolean mask of escalation candidates: one device→host copy
    of the (s,) flags (and, if asked, relative residuals)."""
    fl = np.atleast_1d(res.flags.cpu().numpy()).astype(np.int64)
    mask = FROZEN_FLAGS | (FLAG_STAGNATION if policy.escalate_on_stagnation else 0)
    bad = (fl & mask) != 0
    if policy.escalate_on_unconverged:
        rel = np.atleast_1d(res.rel_residual.cpu().numpy())
        bad = bad | ~(rel <= tol)  # NaN-safe: NaN fails the comparison → bad
    return bad


def _pin_backend(op, spec):
    """solve()'s backend pinning, applied to the *inner* operator, so ladder
    rungs can run with ``backend=None`` specs on a forwarding wrapper."""
    backend = getattr(spec, "backend", None)
    if (
        backend is not None
        and dataclasses.is_dataclass(op)
        and getattr(op, "backend", backend) != backend
    ):
        op = dataclasses.replace(op, backend=backend)
    return op


def _ladder(op, spec, policy: EscalationPolicy):
    """Yield (rung_name, rung_op, rung_spec) in escalation order. Every rung
    spec carries ``backend=None``: the base operator arrives pinned."""
    cg_tol = policy.cg_tol if policy.cg_tol is not None else float(getattr(spec, "tol", 1e-2))
    is_cg = isinstance(spec, CG)
    base_spec = (dataclasses.replace(spec, backend=None)
                 if getattr(spec, "backend", None) is not None else spec)

    scale = None
    for j in policy.jitter:
        if scale is None:
            scale = torch.mean(op.diag_part())
        yield f"jitter:{j:g}", _JitteredOp(inner=op, eps=j * scale), base_spec

    pc = Nystrom(rank=policy.precond_rank) if supports(op, "precond_factor") else Jacobi()
    if is_cg and getattr(spec, "precond", None) is None:
        yield "precond:" + pc.name, op, dataclasses.replace(
            base_spec, precond=pc, max_iters=max(policy.cg_max_iters, base_spec.max_iters))
    elif not is_cg and policy.switch_to_cg:
        yield "switch:cg", op, CG(max_iters=policy.cg_max_iters, tol=cg_tol, precond=pc)


def _dense_rescue(op, b_bad: torch.Tensor, tol: float, policy: EscalationPolicy):
    """Final rung: materialise + Cholesky, escalating jitter until the
    factorisation holds. Returns (solution, rel, flags, rung_name) or None."""
    n = op.shape[0]
    if n > policy.dense_fallback_max_n or not supports(op, "dense"):
        return None
    a = op.dense()
    if not bool(torch.isfinite(a).all()):
        return None  # a poisoned operator has no dense escape
    scale = float(torch.mean(torch.diagonal(a)))
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for j in (0.0,) + tuple(policy.jitter) + (1e-2,):
        aj = a + (j * scale) * eye
        l = cholesky_or_nan(aj)
        if not bool(torch.isfinite(l).all()):
            continue
        x = torch.cholesky_solve(b_bad, l)
        # judged against the rung's own (jittered) system, like rung 1
        rn = torch.linalg.norm(aj @ x - b_bad, dim=0)
        bn = torch.clamp(torch.linalg.norm(b_bad, dim=0), min=1e-30)
        rel = rn / bn
        ok = torch.all(torch.isfinite(x), dim=0) & (rel <= max(tol, 1e-4))
        if bool(ok.any()):
            flags = torch.where(ok, 0, FROZEN_FLAGS).to(torch.int32)
            return x, rel, flags, f"dense:cholesky(jitter={j:g})"
    return None


def solve_robust(
    op,
    b: torch.Tensor,
    spec: SpecLike = "cg",
    *,
    generator: Optional[torch.Generator] = None,
    draws: Any = None,
    x0: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
    policy: EscalationPolicy = EscalationPolicy(),
    **overrides: Any,
) -> SolveReport:
    """``solve()`` with breakdown recovery: run the base solve (on
    ``generator`` or ``draws``), then walk any flagged columns down the
    escalation ladder.

    Happy path (no flags): exactly one base ``solve()`` plus one host readback
    of the (s,) flags. On escalation only the flagged columns are re-solved
    (cold, per rung); healthy columns keep their base payload bit for bit.
    The merged result carries the rescued columns' residuals as judged by the
    rescuing rung's system, cleared flags for recovered columns, and the
    summed matvec bill; columns no rung could save stay flagged
    (``report.failed_columns``).
    """
    s = as_spec(spec, **overrides)
    res = solve(op, b, s, generator=generator, draws=draws, x0=x0, delta=delta)
    tol = float(getattr(s, "tol", 1e-2))
    bad = _bad_mask(res, tol, policy)
    if not bad.any():
        return SolveReport(result=res, rungs=(), escalated=False, recovered=True,
                           failed_columns=())

    b2, squeeze = as_matrix_rhs(b)
    d2 = None if delta is None else as_matrix_rhs(delta)[0]
    sol = (res.solution[:, None] if squeeze else res.solution).clone()
    rn = res.residual_norm.clone()
    rel = res.rel_residual.clone()
    fl = res.flags.to(torch.int32).clone()
    total_matvecs = int(res.matvecs)

    pinned = _pin_backend(op, s)
    rungs = []
    rung_gen = generator if generator is not None else make_generator(0, b.device)

    def _attempt(name, rsol, rrel, rflags, riters, rmv):
        """Merge one rung's output for the currently bad columns."""
        nonlocal total_matvecs
        cols = np.nonzero(bad)[0]
        rres = SolveResult(solution=rsol, residual_norm=rrel * 0.0, rel_residual=rrel,
                           iterations=riters, converged=False, matvecs=rmv, flags=rflags)
        ok = ~_bad_mask(rres, tol, policy)
        recovered_cols = tuple(int(c) for c, o in zip(cols, ok) if o)
        rungs.append(RungRecord(
            rung=name, columns=tuple(int(c) for c in cols), recovered=recovered_cols,
            flags_before=tuple(int(v) for v in fl.cpu().numpy()[cols]),
            iterations=int(riters), matvecs=int(rmv),
        ))
        total_matvecs += int(rmv)
        if recovered_cols:
            dev = sol.device
            idx = torch.as_tensor(recovered_cols, device=dev)
            src = torch.as_tensor(
                [int(np.nonzero(cols == c)[0][0]) for c in recovered_cols], device=dev)
            sol[:, idx] = rsol[:, src]
            rel[idx] = rrel[src]
            rn[idx] = rrel[src] * torch.clamp(torch.linalg.norm(b2[:, idx], dim=0), min=1e-30)
            fl[idx] = rflags[src].to(torch.int32)
            bad[np.asarray(recovered_cols)] = False

    for name, rung_op, rung_spec in _ladder(pinned, s, policy):
        if not bad.any():
            break
        cols = torch.as_tensor(np.nonzero(bad)[0], device=b2.device)
        rres = solve(rung_op, b2[:, cols], rung_spec, generator=rung_gen,
                     delta=None if d2 is None else d2[:, cols])
        rsol = rres.solution
        _attempt(name, rsol[:, None] if rsol.ndim == 1 else rsol,
                 torch.atleast_1d(rres.rel_residual),
                 torch.atleast_1d(rres.flags).to(torch.int32),
                 rres.iterations, rres.matvecs)

    if bad.any():
        cols = torch.as_tensor(np.nonzero(bad)[0], device=b2.device)
        rescue = _dense_rescue(pinned, b2[:, cols], tol, policy)
        if rescue is not None:
            x, rrel, rflags, name = rescue
            _attempt(name, x, rrel, rflags, 0, 0)

    failed = tuple(int(c) for c in np.nonzero(bad)[0])
    merged = SolveResult(
        solution=sol[:, 0] if squeeze else sol,
        residual_norm=rn,
        rel_residual=rel,
        iterations=res.iterations,
        converged=bool(torch.all((rel <= tol) & (fl == 0))),
        matvecs=total_matvecs,
        flags=fl,
    )
    return SolveReport(result=merged, rungs=tuple(rungs), escalated=True,
                       recovered=not failed, failed_columns=failed)
