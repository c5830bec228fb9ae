"""Fitted posterior state and the warm-start cache — twin of
``repro/serve/state.py``.

The engine's whole working set is a handful of objects the core library
already produces: representer weights ``v_mean``, per-sample uncertainty
weights ``alpha``, :class:`~repro_torch.core.rff.PriorSamples` pathwise paths,
and a :class:`~repro_torch.core.solvers.spec.SolverSpec`. This module owns

* :class:`PosteriorState` — one fitted posterior, plus the pieces pathwise
  conditioning needs to update it *incrementally*: the prior paths are
  functions evaluable anywhere, so when new observations arrive the RHS of the
  refit solve extends the old one row-wise (old rows keep their stored noise
  draws ``eps`` and cached prior values ``f_x``). Two update paths:
  :func:`extend_state` re-solves the extended system with the old solution,
  zero-padded to the new n, as a strong warm start (Ch. 5 §5.3);
  :func:`update_state_lowrank` skips the (n+k)-re-solve entirely with a
  rank-k bordered-system correction whose iterative cost is k solve columns
  at the OLD n;
* :class:`WarmStartCache` — previous solve solutions keyed by
  ``(hyperparameter fingerprint, request kind)`` and, within that, by the
  request seed; a repeat query reuses its previous representer weights as
  ``x0`` and converges in a handful of iterations.

Random draws (the prior's ω and w, the noise ε, a stochastic solver's steps)
come from an explicit ``torch.Generator`` or are injected (``omega``, ``w``,
``eps``, ``solver_draws``), so the parity tests can hand both packages the
reference's own draws.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.kernels_fn import PARAM_LEAVES, KernelParams, gram
from ..core.operators import Gram
from ..core.pathwise import PosteriorFunctions, pathwise_target_rows
from ..core.rff import PriorSamples, sample_prior
from ..core.solvers.base import (
    FLAG_BREAKDOWN,
    FLAG_NONFINITE,
    FLAG_STAGNATION,
    SolveResult,
)
from ..core.solvers.spec import SolverSpec, as_spec, solve, solve_bordered


def hypers_fingerprint(params: KernelParams, n: int) -> str:
    """A hashable identity for 'the linear system being solved'.

    Covers the kernel hyperparameters (the float32 bytes of the log-hypers,
    and the kind) *and* the training-set size n: after ``add_observations``
    the operator changes shape, so cached solutions keyed under the old
    fingerprint become unreachable instead of surfacing as shape errors
    inside the solver. The same float32 params give the reference's digest.
    """
    h = hashlib.sha256()
    h.update(params.kind.encode())
    h.update(np.int64(n).tobytes())
    for name in PARAM_LEAVES:
        h.update(getattr(params, name).detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _rows(params: KernelParams, a, ndim: int) -> torch.Tensor:
    """``a`` as a float32 tensor on the params' device, at least ``ndim``-D."""
    t = torch.as_tensor(a, dtype=torch.float32, device=params.log_noise.device)
    return torch.atleast_2d(t) if ndim == 2 else torch.atleast_1d(t)


@dataclasses.dataclass
class PosteriorState:
    """One fitted posterior, held long-lived by the engine.

    ``eps`` (the fit solve's noise draws) and ``f_x`` (the prior paths
    evaluated on the training rows) are retained so incremental refits can
    extend the *same* pathwise linear systems row-wise instead of drawing (or
    re-evaluating) anything over the old rows — that is what makes the old
    solution a useful warm start for :func:`extend_state` and an exactly
    correctable one for :func:`update_state_lowrank`.
    """

    params: KernelParams
    x: torch.Tensor  # (n, d)
    y: torch.Tensor  # (n,)
    spec: SolverSpec
    post: PosteriorFunctions  # v_mean, alpha, prior paths
    eps: torch.Tensor  # (n, s) fit-solve noise draws (pathwise targets)
    f_x: torch.Tensor  # (n, s) prior paths at x, cached at fit, extended row-wise
    fit_result: SolveResult
    hypers_key: str

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def prior(self) -> PriorSamples:
        return self.post.prior

    def operator(self) -> Gram:
        """The (K + σ²I) operator every serve-time solve runs against."""
        return Gram(x=self.x, params=self.params)


def _state(params, x, y, spec, prior, sol, eps, f_x, res) -> PosteriorState:
    """A fitted state from a solve's [v_mean | alpha] solution ``sol``."""
    post = PosteriorFunctions(params=params, x=x, prior=prior, v_mean=sol[:, 0],
                              alpha=sol[:, 1:], solve_info=res)
    return PosteriorState(params=params, x=x, y=y, spec=spec, post=post, eps=eps, f_x=f_x,
                          fit_result=res, hypers_key=hypers_fingerprint(params, x.shape[0]))


def fit_state(
    params: KernelParams,
    x,
    y,
    *,
    spec,
    num_samples: int = 16,
    num_features: int = 2048,
    x0: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    solver_draws: Any = None,
) -> PosteriorState:
    """Fit the engine's posterior state: one batched pathwise solve.

    Same math as :func:`~repro_torch.core.pathwise.posterior_functions`, but
    keeps the noise draws ``eps`` so :func:`extend_state` can refit
    incrementally. ``omega`` (num_features/2, d), ``w`` (num_features,
    num_samples), ``eps`` (n, num_samples) and a stochastic solver's
    ``solver_draws`` inject the draws; the rest come from ``generator``, in
    that order.
    """
    s = as_spec(spec)
    x, y = _rows(params, x, 2), _rows(params, y, 1)
    op = Gram(x=x, params=params)
    prior = sample_prior(params, num_samples, num_features, x.shape[1],
                         generator=generator, omega=omega, w=w)
    f_x = prior(x)  # (n, s)
    data, delta, eps = pathwise_target_rows(op.noise, y, f_x, generator=generator, eps=eps)
    res = solve(op, data, s, generator=generator, draws=solver_draws, x0=x0, delta=delta)
    return _state(params, x, y, s, prior, res.solution, eps, f_x, res)


def _new_rows(state: PosteriorState, x_new, y_new, generator, eps):
    """The k new rows: inputs, targets, the prior paths on them alone (old
    rows reuse the cached ``f_x``), their pathwise targets and noise draws."""
    x_new, y_new = _rows(state.params, x_new, 2), _rows(state.params, y_new, 1)
    f_new = state.prior(x_new)
    data_new, delta_new, eps_new = pathwise_target_rows(
        state.params.noise, y_new, f_new, generator=generator, eps=eps)
    return x_new, y_new, f_new, data_new, delta_new, eps_new


def extend_state(
    state: PosteriorState,
    x_new,
    y_new,
    *,
    warm: bool = True,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
    solver_draws: Any = None,
) -> PosteriorState:
    """Incremental posterior update: new observations, warm-started refit.

    Pathwise conditioning makes this cheap: the prior paths are functions, so
    ``f_X`` on the extended inputs is the *same* columns with new rows
    appended, old rows keep their stored noise draws, and only the new rows
    draw fresh ones (``eps`` (k, s) injects them; else ``generator``). The
    refit therefore solves a system whose RHS agrees with the old one on the
    first n rows — the old solution, zero-padded to the new n, is the warm
    start that cuts iterations.
    """
    x_new, y_new, f_new, _, _, eps_new = _new_rows(state, x_new, y_new, generator, eps)
    x2 = torch.cat([state.x, x_new], dim=0)
    y2 = torch.cat([state.y, y_new], dim=0)
    op = Gram(x=x2, params=state.params)
    eps2 = torch.cat([state.eps, eps_new], dim=0)
    f_x2 = torch.cat([state.f_x, f_new], dim=0)
    data = torch.cat([y2[:, None], f_x2], dim=1)
    delta = torch.cat([torch.zeros_like(y2)[:, None], eps2 / op.noise], dim=1)
    x0 = None
    if warm:
        old = torch.cat([state.post.v_mean[:, None], state.post.alpha], dim=1)
        x0 = torch.cat([old, old.new_zeros((x_new.shape[0], old.shape[1]))], dim=0)
    res = solve(op, data, state.spec, generator=generator, draws=solver_draws, x0=x0,
                delta=delta)
    return _state(state.params, x2, y2, state.spec, state.prior, res.solution, eps2, f_x2, res)


def _true_rel_residual(op, sol: torch.Tensor, rhs: torch.Tensor) -> tuple:
    """Certification pass: ``rhs - op.mv(sol)`` norms — one extended-operator
    matvec, the cost of one solver iteration."""
    residual = rhs - op.mv(sol)
    rn = torch.linalg.norm(residual, dim=0)
    bn = torch.clamp(torch.linalg.norm(rhs, dim=0), min=1e-30)
    return rn, rn / bn


def _or_flags(flags) -> torch.Tensor:
    """OR-reduce a per-column flag vector to one combined bitmask (0-d)."""
    f = torch.atleast_1d(torch.as_tensor(flags, dtype=torch.int32))
    return (
        torch.max(f & FLAG_NONFINITE)
        | torch.max(f & FLAG_BREAKDOWN)
        | torch.max(f & FLAG_STAGNATION)
    )


def update_state_lowrank(
    state: PosteriorState,
    x_new,
    y_new,
    *,
    z_tol_factor: float = 1e-1,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
    solver_draws: Any = None,
) -> PosteriorState:
    """Rank-k incremental posterior update via the bordered-system identity.

    Pathwise conditioning makes appending k observations a rank-k correction to
    the representer weights and per-sample uncertainty weights, NOT a fresh
    (n+k)-row solve: all 1+s systems share (K+σ²I), so one k-column solve
    Z = (K_old+σ²I)⁻¹ K(X_old, X_new) against the OLD operator, a dense k×k
    Schur factorization, and closed-form back-substitution extend every column
    of [v_mean | alpha] at once (:func:`~repro_torch.core.solvers.spec.
    solve_bordered` has the algebra). Cost scales with k solve columns at the
    old n — independent of the sample count s — versus :func:`extend_state`'s
    (1+s)-column re-solve at n+k. K(X_old, X_new) is a dense (n, k) block in
    plain torch, as in the reference.

    Draw convention matches :func:`extend_state` (the new rows' noise from
    ``eps`` or ``generator``), so at matching draws both paths extend the
    *same* linear system and agree to solver tolerance.

    The returned ``fit_result`` is certified against the EXTENDED operator:
    one (n+k)-matvec computes the true residual of the corrected solution
    (accounted in ``matvecs`` on top of the Z solve's), so accumulated drift
    across successive low-rank updates is observable — the engine's ``auto``
    policy compacts (falls back to a full warm refit) when it exceeds the spec
    tolerance budget.

    ``z_tol_factor``: the back-substitution amplifies Z-solve error by ‖w‖,
    so the k correction columns are solved ``z_tol_factor`` TIGHTER than the
    state's spec tolerance (``dataclasses.replace(spec, tol=…)``).
    """
    x_new, y_new, f_new, data_new, delta_new, eps_new = _new_rows(
        state, x_new, y_new, generator, eps)
    x2 = torch.cat([state.x, x_new], dim=0)
    y2 = torch.cat([state.y, y_new], dim=0)
    op_old = state.operator()
    rhs_new = data_new + op_old.noise * delta_new  # [y_new | f_new + eps_new]
    sol_old = torch.cat([state.post.v_mean[:, None], state.post.alpha], dim=1)
    b_cols = gram(state.params, state.x, x_new)  # (n, k) cross-covariance
    c_new = gram(state.params, x_new)  # (k, k); solve_bordered adds σ²
    tol = float(getattr(state.spec, "tol", 1e-2))
    z_spec = (
        dataclasses.replace(state.spec, tol=tol * z_tol_factor)
        if dataclasses.is_dataclass(state.spec)
        else state.spec
    )
    sol_ext, z_result = solve_bordered(op_old, b_cols, c_new, rhs_new, sol_old, z_spec,
                                       generator=generator, draws=solver_draws)

    # certify the corrected solution against the EXTENDED operator: one
    # (n+k)-matvec gives the TRUE residual, so drift from the inherited r_old
    # and the inexact Z shows up here instead of silently accumulating
    op2 = Gram(x=x2, params=state.params)
    eps2 = torch.cat([state.eps, eps_new], dim=0)
    f_x2 = torch.cat([state.f_x, f_new], dim=0)
    rhs_ext = torch.cat([y2[:, None], f_x2 + eps2], dim=1)
    rn, rel = _true_rel_residual(op2, sol_ext, rhs_ext)
    # any frozen Z column poisons every output column through Z·w — carry the
    # correction solve's flags onto all of them, plus the final payload check
    carried = _or_flags(z_result.flags)
    col_ok = torch.all(torch.isfinite(sol_ext), dim=0) & torch.isfinite(rn)
    flags = torch.broadcast_to(carried, rel.shape).to(torch.int32)
    flags = flags | torch.where(col_ok, 0, FLAG_NONFINITE).to(torch.int32)
    flags = torch.where((rel <= tol) & col_ok, flags & ~FLAG_STAGNATION, flags)
    res = SolveResult(
        solution=sol_ext,
        residual_norm=rn,
        rel_residual=rel,
        iterations=z_result.iterations,  # k correction columns at the old n
        converged=bool(torch.all((rel <= tol) & (flags == 0))),
        matvecs=int(z_result.matvecs) + 1,  # + the certification matvec
        flags=flags,
    )
    return _state(state.params, x2, y2, state.spec, state.prior, sol_ext, eps2, f_x2, res)


class WarmStartCache:
    """Previous solve solutions, keyed by ``(hypers fingerprint, request kind)``
    and — within a key — by the request seed that generated the RHS columns.

    A repeat query (same seed, same hyperparameters, same kind) regenerates the
    exact same RHS columns, so its cached solution is a near-exact warm start:
    CG re-verifies it in a couple of iterations instead of re-solving (the
    solver, not the cache, certifies the residual).

    Plain LRU over ``(key, seed)`` entries; values are host-side numpy copies
    (one device→host copy a stored request), so cached solutions never pin
    device memory.
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: OrderedDict[Tuple[str, str, int], np.ndarray] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def probe(self, hypers_key: str, kind: str, seed: int) -> bool:
        """Non-mutating hit test (used at submit time to tag requests warm)."""
        return (hypers_key, kind, seed) in self._entries

    def lookup(self, hypers_key: str, kind: str, seed: int) -> Optional[np.ndarray]:
        entry = self._entries.get((hypers_key, kind, seed))
        if entry is not None:
            self._entries.move_to_end((hypers_key, kind, seed))
        return entry

    def store(self, hypers_key: str, kind: str, seed: int, solution: torch.Tensor) -> None:
        self._entries[(hypers_key, kind, seed)] = solution.detach().cpu().numpy()
        self._entries.move_to_end((hypers_key, kind, seed))
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def purge(self, hypers_key: str) -> int:
        """Drop every entry NOT keyed under ``hypers_key``; returns the count.

        After a refit re-keys the engine, entries under a superseded
        fingerprint are permanently unreachable yet still occupy LRU slots
        until natural eviction. The engine calls this on every re-key and
        surfaces the count as ``cache_purged``.
        """
        stale = [k for k in self._entries if k[0] != hypers_key]
        for k in stale:
            del self._entries[k]
        return len(stale)
