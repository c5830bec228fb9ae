"""Marginal likelihood optimisation with iterative solvers (Chapter 5) — twin of
``repro/core/mll.py``.

The MLL gradient (Eq. 2.37) needs v_y = A⁻¹y and tr(A⁻¹ ∂A/∂θ), A = K_θ + σ²I.
The trace is estimated from probes: Hutchinson's z ~ N(0, I), giving
mean_j (A⁻¹z_j)ᵀ ∂A z_j, or the pathwise estimator's z = f_X + ε ~ N(0, A)
drawn from the prior, giving mean_j α_jᵀ ∂A α_j with α_j = A⁻¹z_j, the very
weights of pathwise posterior samples (§5.2). Warm starting (§5.3) begins each
outer step's solve at the previous step's solutions, with the probes' random
draws held fixed so that the systems move little.

One batched CG solve of [y | probes] per step, under ``torch.no_grad`` on
detached θ: the reference's ``stop_gradient`` on the solutions. Only the
quadratic forms run with autograd, through the same matvec backend as the
solve; on the card that is the fused Gram kernel, whose backward is the
``gram_matvec_bwd`` kernel. The step is the reference's hand-written Adam,
ascending the MLL.

Random draws come from a ``torch.Generator`` or are injected as
:class:`MLLDraws`: the θ-free base draws, rescaled by the current θ at every
step, so that the parity tests can hand the port the reference's own. A
preconditioned CG spec flows through: its factor is rebuilt at every step's
θ from the step's preconditioner draws (``MLLDraws.precond``; held fixed with
the others under a warm start, as the reference reuses its key).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.ops import gram_mv
from .kernels_fn import KernelParams, map_params, spectral_gammas, spectral_sample
from .operators import Gram
from .precond import PrecondDraws, draw_precond
from .rff import sample_prior
from .solvers.base import SolveResult
from .solvers.spec import SpecLike, as_spec, solve

ESTIMATORS = ("pathwise", "hutchinson")


def _quad(params: KernelParams, x: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
          backend: str = "auto") -> torch.Tensor:
    """uᵀ (K_θ + σ²I) w summed per column, differentiable in θ. u, w: (n, s)."""
    kw = gram_mv(params, x, w, backend=backend)  # (n, s)
    return torch.sum(u * kw, dim=0) + params.noise * torch.sum(u * w, dim=0)


@dataclasses.dataclass(frozen=True)
class MLLDraws:
    """The θ-free random draws of one gradient estimate.

    ``noise`` (n, s) holds standard normals: ε/σ for the pathwise estimator,
    the probes themselves for Hutchinson's. The pathwise estimator's prior
    also needs the spectral base draws ``normals`` (m, d) and, for Matérn,
    ``gammas`` (m, 1), and the prior weights ``w`` (2m, s). ``precond``
    holds a preconditioned CG's draws (the Nyström subset, the RFF
    preconditioner's base frequencies).
    """

    noise: torch.Tensor
    normals: Optional[torch.Tensor] = None
    gammas: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    precond: Optional[PrecondDraws] = None


def _precond_draws(spec, kind: str, n: int, d: int, generator, device):
    pc = getattr(spec, "precond", None)
    method = getattr(pc, "method", None)
    if method is None:  # none, Jacobi, or a prebuilt apply: nothing to draw
        return None
    return draw_precond(method, pc.rank, n, d, kind, generator=generator, device=device)


def draw_mll(kind: str, n: int, d: int, *, num_probes: int = 8,
             num_features: int = 1024, estimator: str = "pathwise",
             generator: Optional[torch.Generator] = None,
             device=None, spec: Optional[SpecLike] = None) -> MLLDraws:
    """Fresh :class:`MLLDraws` for a problem of n points in d dimensions,
    with the draws of ``spec``'s preconditioner if it has one."""
    pdraws = None
    if spec is not None:
        pdraws = _precond_draws(as_spec(spec), kind, n, d, generator, device)
    if estimator == "hutchinson":
        return MLLDraws(noise=torch.randn((n, num_probes), generator=generator,
                                          device=device), precond=pdraws)
    m = num_features // 2
    normals = torch.randn((m, d), generator=generator, device=device)
    gammas = spectral_gammas(kind, m, generator=generator, device=device)
    w = torch.randn((num_features, num_probes), generator=generator, device=device)
    noise = torch.randn((n, num_probes), generator=generator, device=device)
    return MLLDraws(noise=noise, normals=normals, gammas=gammas, w=w, precond=pdraws)


class MLLGradEstimate(NamedTuple):
    grad: KernelParams  # gradient w.r.t. the unconstrained hyperparameters
    v_y: torch.Tensor  # (n,) mean weights — reusable for prediction
    alpha: torch.Tensor  # (n, s) probe/sample weights
    solver_iterations: int
    solve_info: SolveResult  # the step's solve: matvecs and flags too


def mll_grad(
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    num_probes: int = 8,
    num_features: int = 1024,
    estimator: str = "pathwise",
    spec: Optional[SpecLike] = None,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[MLLDraws] = None,
    **spec_overrides,
) -> MLLGradEstimate:
    """Estimated ∇_θ log p(y|θ) (ascent direction), θ in log space.

    ``spec`` defaults to CG; extra keyword arguments are spec-field overrides.
    ``x0`` (n, 1+num_probes) warm-starts the solve. ``draws`` injects the
    random draws; otherwise they come from ``generator``.
    """
    if estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator {estimator!r}; expected one of {ESTIMATORS}")
    s = as_spec("cg" if spec is None else spec, **spec_overrides)
    backend = getattr(s, "backend", None) or "auto"
    n, d = x.shape
    if draws is None:
        draws = draw_mll(params.kind, n, d, num_probes=num_probes,
                         num_features=num_features, estimator=estimator,
                         generator=generator, device=x.device, spec=s)
    theta = map_params(torch.Tensor.detach, params)
    with torch.no_grad():  # the solutions carry no gradient (stop_gradient)
        if estimator == "pathwise":
            omega = spectral_sample(theta, num_features // 2, d, generator=generator,
                                    normals=draws.normals, gammas=draws.gammas)
            prior = sample_prior(theta, num_probes, num_features, d, omega=omega, w=draws.w)
            probes = prior(x) + torch.sqrt(theta.noise) * draws.noise  # ~ N(0, A)
        else:
            probes = draws.noise
        rhs = torch.cat([y[:, None], probes], dim=1)
        res = solve(Gram(x=x, params=theta, backend=backend), rhs, s, x0=x0,
                    generator=generator, draws=draws.precond)
    v_y, alpha = res.solution[:, 0], res.solution[:, 1:]

    p = map_params(lambda t: t.detach().requires_grad_(), params)
    # data fit: +½ v_yᵀ ∂A v_y ⇒ differentiate ½ v_yᵀ A(θ) v_y
    fit = 0.5 * _quad(p, x, v_y[:, None], v_y[:, None], backend)[0]
    if estimator == "pathwise":
        # tr(A⁻¹∂A) ≈ mean_j α_jᵀ ∂A α_j ⇒ differentiate ½ mean α A α
        tr = 0.5 * torch.mean(_quad(p, x, alpha, alpha, backend))
    else:
        # tr(A⁻¹∂A) ≈ mean_j (A⁻¹z_j)ᵀ ∂A z_j ⇒ differentiate ½ mean α A z
        tr = 0.5 * torch.mean(_quad(p, x, alpha, probes, backend))
    leaves = [p.log_lengthscale, p.log_signal, p.log_noise]
    g = torch.autograd.grad(fit - tr, leaves)
    grad = dataclasses.replace(params, log_lengthscale=g[0], log_signal=g[1],
                               log_noise=g[2])
    return MLLGradEstimate(grad=grad, v_y=v_y, alpha=alpha,
                           solver_iterations=res.iterations, solve_info=res)


@dataclasses.dataclass
class MLLOptimState:
    params: KernelParams
    adam_m: KernelParams
    adam_v: KernelParams
    warm: Optional[torch.Tensor]  # previous solutions (n, 1+s) for warm starting
    step: int
    total_solver_iters: int
    last_solve: Optional[SolveResult] = None  # the latest step's solve


def _adam(params, g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The reference's ``_tree_adam``, leaf by leaf: ASCENT on the MLL."""
    m = map_params(lambda m_, g_: b1 * m_ + (1 - b1) * g_, m, g)
    v = map_params(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_, v, g)
    t = step + 1
    mhat = map_params(lambda m_: m_ / (1 - b1**t), m)
    vhat = map_params(lambda v_: v_ / (1 - b2**t), v)
    params = map_params(lambda p, m_, v_: p + lr * m_ / (torch.sqrt(v_) + eps),
                        params, mhat, vhat)
    return params, m, v


def optimize_mll(
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    lr: float = 0.05,
    warm_start: bool = True,
    estimator: str = "pathwise",
    num_probes: int = 8,
    spec: Optional[SpecLike] = None,
    callback: Optional[Callable[[int, MLLOptimState], None]] = None,
    draws: Optional[MLLDraws] = None,
    **spec_overrides,
) -> MLLOptimState:
    """Outer loop: Adam ascent on θ with warm-started inner solves (Ch. 5).

    With ``warm_start`` one set of draws (``draws``, or drawn once from
    ``generator``) serves every step, as the reference reuses one key: fresh
    probes would re-randomise the right-hand side and void the warm start
    (§5.3.3). Without it every step draws afresh.
    """
    if draws is not None and not warm_start:
        raise ValueError(
            "injected draws are held fixed across steps, which only a warm start "
            "does; without warm_start every step draws afresh from the generator"
        )
    s = as_spec("cg" if spec is None else spec, **spec_overrides)
    if warm_start and draws is None:
        draws = draw_mll(params.kind, *x.shape, num_probes=num_probes,
                         estimator=estimator, generator=generator, device=x.device,
                         spec=s)
    zeros = map_params(torch.zeros_like, params)
    st = MLLOptimState(params, zeros, zeros, None, 0, 0)
    for t in range(num_steps):
        est = mll_grad(st.params, x, y, generator=generator, num_probes=num_probes,
                       estimator=estimator, spec=s, x0=st.warm if warm_start else None,
                       draws=draws)
        p, m, v = _adam(st.params, est.grad, st.adam_m, st.adam_v, t, lr)
        st = MLLOptimState(p, m, v, est.solve_info.solution, t + 1,
                           st.total_solver_iters + est.solver_iterations,
                           est.solve_info)
        if callback is not None:
            callback(t, st)
    return st
