"""Sparse variational GP baselines (§2.2.1) — twin of ``repro/core/svgp.py``.

* ``sgpr``: Titsias (2009) collapsed bound with the exact optimal q; predictive
  Eqs. 2.49/2.50, from dense m×m Cholesky factors.
* ``sgpr_iterative``: the same posterior with every application of the Titsias
  matrix B = K_ZZ + σ⁻²K_ZX K_XZ routed through ``solve()`` on the matvec-only
  :class:`~repro_torch.core.operators.NormalEq` operator (σ²·B = K_ZX K_XZ +
  σ²K_ZZ): the n×m cross-covariance and B are never materialised, and on the
  card each of its matvecs is three launches of the Gram kernel on the cross
  shapes n × m, m × n and m × m.
* ``svgp_natgrad_step`` / ``svgp_mean_var``: Hensman et al. (2013) stochastic
  variational inference with explicit natural parameters and natural-gradient
  steps (Eqs. 2.53/2.54) on mini-batches.

The dense pieces (K_ZX K_XZ, the m×m Cholesky factors, the n* × m
cross-covariances at the queries) are plain torch on the inputs' device, as
the reference computes them outside any kernel. Everything runs on the device
of the tensors it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.ops import gram_mv
from .kernels_fn import KernelParams, gram
from .operators import NormalEq
from .solvers.base import SolveResult
from .solvers.spec import CG, SolverSpec, SpecLike, as_spec, solve


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _kzz(params: KernelParams, z: torch.Tensor) -> torch.Tensor:
    """K_ZZ with the reference's 1e-5·σ_f² jitter."""
    return gram(params, z) + 1e-5 * params.signal * _eye(z.shape[0], z)


def _lower_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, b, upper=False)


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b for a vector or a matrix b."""
    if b.ndim == 1:
        return torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.cholesky_solve(b, chol)


@dataclasses.dataclass(frozen=True)
class SGPRPosterior:
    params: KernelParams
    z: torch.Tensor
    chol_b: torch.Tensor  # chol(K_ZZ + σ⁻²K_ZX K_XZ + ridge)
    chol_kzz: torch.Tensor
    proj_y: torch.Tensor  # σ⁻² B⁻¹ K_ZX y

    def mean(self, xs: torch.Tensor) -> torch.Tensor:
        return gram(self.params, xs, self.z) @ self.proj_y

    def var(self, xs: torch.Tensor) -> torch.Tensor:
        kzs = gram(self.params, xs, self.z).T  # (m, n*)
        a = _lower_solve(self.chol_kzz, kzs)
        b = _lower_solve(self.chol_b, kzs)
        kss = self.params.signal * torch.ones(xs.shape[0], dtype=xs.dtype, device=xs.device)
        return kss - torch.sum(a * a, dim=0) + torch.sum(b * b, dim=0)


def sgpr(params: KernelParams, x: torch.Tensor, y: torch.Tensor,
         z: torch.Tensor) -> SGPRPosterior:
    """The dense-Cholesky Titsias posterior with inducing inputs ``z``."""
    m = z.shape[0]
    sigma2 = params.noise
    kzz = _kzz(params, z)
    kzx = gram(params, z, x)
    b = kzz + (kzx @ kzx.T) / sigma2
    # fp32 rounding in K_ZX K_XZ can push the smallest eigenvalue slightly
    # negative (scale ~ n·κ/σ²); a ridge proportional to the matrix scale keeps
    # the Cholesky factor finite
    b = b + (3e-5 * torch.trace(b) / m) * _eye(m, b)
    chol_b = torch.linalg.cholesky(b)
    proj_y = _cho_solve(chol_b, kzx @ y) / sigma2
    return SGPRPosterior(params=params, z=z, chol_b=chol_b,
                         chol_kzz=torch.linalg.cholesky(kzz), proj_y=proj_y)


@dataclasses.dataclass(frozen=True)
class SGPRVariance:
    """:meth:`IterativeSGPRPosterior.var_solve`'s variance (n*,) and its solve."""

    var: torch.Tensor
    solve_info: SolveResult


@dataclasses.dataclass(frozen=True)
class IterativeSGPRPosterior:
    """SGPR posterior whose B⁻¹ applications run through ``solve(NormalEq, …)``.

    The predictive equations need B⁻¹ twice: once for the projected-mean
    weights (at construction, ``solve_info``) and once per prediction batch
    for the variance quadratic k_sZ B⁻¹ k_Zs (:meth:`var_solve`). Only K_ZZ's
    m×m Cholesky factor (for the Q_XX correction) is factorised densely.
    """

    params: KernelParams
    z: torch.Tensor  # (m, d) inducing inputs
    chol_kzz: torch.Tensor  # (m, m) lower Cholesky of K_ZZ (+ stabilising jitter)
    proj_y: torch.Tensor  # (m,) = σ⁻² B⁻¹ K_ZX y, via solve(NormalEq, K_ZX y)
    op: NormalEq  # σ²·B (+ ridge), touched only through matvecs
    spec: SolverSpec  # CG-family spec driving the B⁻¹ applications
    solve_info: Optional[SolveResult] = None  # the projected-mean solve

    def mean(self, xs: torch.Tensor) -> torch.Tensor:
        return gram(self.params, xs, self.z) @ self.proj_y

    def var_solve(self, xs: torch.Tensor) -> SGPRVariance:
        """The variance at ``xs`` with its n*-column ``NormalEq`` solve's
        result as ``solve_info``."""
        kzs = gram(self.params, xs, self.z).T  # (m, n*)
        a = _lower_solve(self.chol_kzz, kzs)
        # k_sZ B⁻¹ k_Zs = σ² · k_sZ (σ²B)⁻¹ k_Zs — one batched NormalEq solve
        res = solve(self.op, kzs, self.spec)
        quad = self.params.noise * torch.sum(kzs * res.solution, dim=0)
        kss = self.params.signal * torch.ones(xs.shape[0], dtype=xs.dtype, device=xs.device)
        return SGPRVariance(var=kss - torch.sum(a * a, dim=0) + quad, solve_info=res)

    def var(self, xs: torch.Tensor) -> torch.Tensor:
        return self.var_solve(xs).var


def sgpr_iterative(
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    *,
    spec: Optional[SpecLike] = None,
    generator: Optional[torch.Generator] = None,
    row_chunk: int = 4096,
) -> IterativeSGPRPosterior:
    """Titsias posterior via iterative solves — the ``solve()``-backed SGPR path.

    ``spec`` must be a matvec-only (CG-family) spec; the default
    ``CG(max_iters=400, tol=1e-6)`` is deliberately tight because the
    normal-equations operator is ill-conditioned (κ(K_XZ)²-ish). The spec's
    ``backend`` pins the operator's Gram matvecs and the right-hand side
    K_ZX y alike.
    """
    s = as_spec(CG(max_iters=400, tol=1e-6) if spec is None else spec)
    backend = getattr(s, "backend", None) or "auto"
    precision = getattr(s, "precision", None) or "fp32"
    m = z.shape[0]
    op = NormalEq(x=x, z=z, params=params, row_chunk=row_chunk, backend=backend,
                  precision=precision)
    # the dense path's fp32-stabilising ridge on B, exactly:
    # B_r = B + 3e-5·tr(B)/m · I  ⇔  σ²B_r = NormalEq + 3e-5·tr(NormalEq)/m · I
    op = dataclasses.replace(op, ridge=3e-5 * torch.sum(op.diag_part()) / m)
    rhs = gram_mv(params, z, y, z=x, backend=backend, row_chunk=row_chunk,
                  precision=precision)  # K_ZX y
    res = solve(op, rhs, s, generator=generator)  # = σ⁻² B⁻¹ K_ZX y
    return IterativeSGPRPosterior(
        params=params, z=z, chol_kzz=torch.linalg.cholesky(_kzz(params, z)),
        proj_y=res.solution, op=op, spec=s, solve_info=res,
    )


def sgpr_elbo(params: KernelParams, x: torch.Tensor, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """Collapsed bound (Eq. 2.47): log N(y|0, Q+σ²I) − tr(K−Q)/(2σ²)."""
    n, m = x.shape[0], z.shape[0]
    sigma2 = params.noise
    lz = torch.linalg.cholesky(_kzz(params, z))
    a = _lower_solve(lz, gram(params, z, x)) / torch.sqrt(sigma2)  # (m, n)
    lb = torch.linalg.cholesky(_eye(m, a) + a @ a.T)
    c = _lower_solve(lb, (a @ y)[:, None])[:, 0] / torch.sqrt(sigma2)
    log_det = torch.sum(torch.log(torch.diagonal(lb))) + 0.5 * n * torch.log(sigma2)
    quad = 0.5 * (torch.dot(y, y) / sigma2 - torch.dot(c, c))
    trace = 0.5 / sigma2 * (params.signal * n - sigma2 * torch.sum(a * a))
    return -log_det - quad - 0.5 * n * math.log(2 * math.pi) - trace


@dataclasses.dataclass
class SVGPState:
    theta1: torch.Tensor  # S⁻¹ m natural parameter (m,)
    theta2: torch.Tensor  # −½ S⁻¹ (m, m)


def svgp_natgrad_step(
    params: KernelParams,
    x_batch: torch.Tensor,
    y_batch: torch.Tensor,
    z: torch.Tensor,
    state: SVGPState,
    n_total: int,
    lr: float = 0.5,
) -> SVGPState:
    """One natural-gradient step (Eqs. 2.53/2.54), mini-batch scaled."""
    m = z.shape[0]
    sigma2 = params.noise
    chol = torch.linalg.cholesky(_kzz(params, z))
    kzb = gram(params, z, x_batch)  # (m, b)
    # K_ZZ⁻¹ applied by Cholesky solves (an fp32 inverse of an ill-conditioned
    # SE Gram corrupts the natural-gradient target)
    a = _cho_solve(chol, kzb)  # K_ZZ⁻¹ K_Zb  (m, b)
    scale = n_total / x_batch.shape[0]
    lam = (a @ a.T) * (scale / sigma2) + _cho_solve(chol, _eye(m, a))
    t1_target = (a @ y_batch) * (scale / sigma2)
    theta1 = state.theta1 + lr * (t1_target - state.theta1)
    theta2 = state.theta2 + lr * (-0.5 * lam - state.theta2)
    return SVGPState(theta1=theta1, theta2=theta2)


def svgp_mean_var(params: KernelParams, z: torch.Tensor, state: SVGPState,
                  xs: torch.Tensor) -> tuple:
    """(mean, variance) of the SVGP predictive at ``xs``."""
    prec = -2.0 * state.theta2
    prec = prec + (1e-6 * torch.trace(prec) / prec.shape[0]) * _eye(prec.shape[0], prec)
    chol_p = torch.linalg.cholesky(prec)
    s_cov = _cho_solve(chol_p, _eye(prec.shape[0], prec))
    mu = _cho_solve(chol_p, state.theta1)
    chol = torch.linalg.cholesky(_kzz(params, z))
    ksz = gram(params, xs, z)
    a = _cho_solve(chol, ksz.T).T  # K_sZ K_ZZ⁻¹
    mean = a @ mu
    var = params.signal - torch.sum(a * ksz, dim=1) + torch.sum((a @ s_cov) * a, dim=1)
    return mean, var
