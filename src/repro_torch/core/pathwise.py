"""Pathwise conditioning (§2.1.2, Eq. 2.12) driven by any solver — twin of
``repro/core/pathwise.py``.

A posterior function sample is a *function*

    f_|y(·) = f(·) + K_(·)X (v* − α*_i),
        v*   = (K+σ²I)⁻¹ y                  (posterior-mean representer weights)
        α*_i = (K+σ²I)⁻¹ (f_X^i + ε_i)      (per-sample uncertainty-reduction weights)

with f a prior sample approximated by random Fourier features. All s+1 systems
share the coefficient matrix and are solved as ONE batched multi-RHS solve.
Evaluating the result at new X* costs one cross-covariance matvec plus one
feature matvec, both through the fused CUDA kernels on the card.

Random draws come from an explicit ``torch.Generator`` or are injected
(``omega``, ``w``, ``eps``), so the parity tests can hand both packages the
reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import gram_mv
from .kernels_fn import KernelParams
from .operators import Gram
from .rff import PriorSamples, sample_prior
from .solvers.base import SolveResult
from .solvers.spec import SpecLike, as_spec, solve


@dataclasses.dataclass(frozen=True)
class PosteriorFunctions:
    """s posterior function samples + the posterior mean, evaluable anywhere.

    Evaluation is one prior-feature matvec Φ(·) @ W plus one cross-covariance
    matvec K(·, X) @ [weights], both through the backend that drove the solve;
    neither the (n*, 2m) feature matrix nor the (n*, n) cross-Gram block is
    materialised on the card.
    """

    params: KernelParams
    x: torch.Tensor  # (n, d) training inputs
    prior: PriorSamples  # s prior functions
    v_mean: torch.Tensor  # (n,) representer weights of the mean
    alpha: torch.Tensor  # (n, s) per-sample uncertainty-reduction weights
    solve_info: Optional[SolveResult] = None
    backend: str = "auto"

    @property
    def num_samples(self) -> int:
        return self.alpha.shape[1]

    def mean(self, xs: torch.Tensor) -> torch.Tensor:
        return gram_mv(self.params, xs, self.v_mean, z=self.x, backend=self.backend)

    def __call__(self, xs: torch.Tensor) -> torch.Tensor:
        """Evaluate all samples at xs → (n*, s)."""
        w = self.v_mean[:, None] - self.alpha  # (n, s)
        return self.prior(xs) + gram_mv(self.params, xs, w, z=self.x, backend=self.backend)

    def sample_mean_and_var(self, xs: torch.Tensor) -> tuple:
        f = self(xs)
        return self.mean(xs), torch.var(f, dim=1, correction=0)

    def blocked_mean_and_var(self, xs_blocks: torch.Tensor) -> tuple:
        """Many query blocks ``(B, L, d)`` through ONE evaluation of the
        flattened ``(B·L, d)`` points, reshaped back to ``(B, L)`` mean and
        variance. Padding rows cost flops, not correctness."""
        b, l, d = xs_blocks.shape
        mean, var = self.sample_mean_and_var(xs_blocks.reshape(b * l, d))
        return mean.reshape(b, l), var.reshape(b, l)

    def sample_paths(self, xs: torch.Tensor, w_prior: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
        """Evaluate *fresh* posterior sample paths at ``xs`` → (n*, s), from new
        prior weight columns ``w_prior`` (num_features, s) on this posterior's
        feature map and their solved weights ``alpha`` (n, s):

            f_|y(·) = Φ(·) w_prior + K(·, X) (v_mean − alpha)
        """
        w = self.v_mean[:, None] - alpha  # (n, s)
        return self.prior.phi_mv(xs, w_prior) + gram_mv(
            self.params, xs, w, z=self.x, backend=self.backend
        )


def pathwise_target_rows(
    noise: torch.Tensor,
    y_rows: torch.Tensor,
    f_rows: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> tuple:
    """Pathwise target rows in ``solve()``'s (b, δ) convention.

    Returns (data (m, 1+s), delta (m, 1+s), eps (m, s)) with data =
    [y | f_X^1 .. f_X^s] and δ = [0 | ε_1/σ² .. ε_s/σ²]. ε = √σ²·N(0, 1) is
    drawn from ``generator`` unless injected.
    """
    if eps is None:
        eps = torch.sqrt(noise) * torch.randn(
            f_rows.shape, generator=generator, dtype=f_rows.dtype, device=f_rows.device
        )
    data = torch.cat([y_rows[:, None], f_rows], dim=1)
    delta = torch.cat([torch.zeros_like(y_rows)[:, None], eps / noise], dim=1)
    return data, delta, eps


def pathwise_targets(
    op: Gram,
    y: torch.Tensor,
    prior: PriorSamples,
    *,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> tuple:
    """Batched targets (data (n, 1+s), delta (n, 1+s)) of the pathwise solve:
    the system solved is (K+σ²I)V = data + σ²δ = [y | f_X + ε]."""
    f_x = prior(op.x)  # (n, s)
    data, delta, _ = pathwise_target_rows(op.noise, y, f_x, generator=generator, eps=eps)
    return data, delta


def posterior_functions(
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 16,
    num_features: int = 2048,
    spec: Optional[SpecLike] = None,
    x0: Optional[torch.Tensor] = None,
    omega: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    solver_draws=None,
    **spec_overrides,
) -> PosteriorFunctions:
    """End-to-end pathwise posterior: RFF prior + one batched iterative solve.

    ``spec`` (any registered solver: CG, SGD, SDD, AP) defaults to CG; extra
    keyword arguments are spec-field overrides. ``omega`` (num_features/2, d),
    ``w`` (num_features, num_samples), ``eps`` (n, num_samples) and a
    stochastic solver's ``solver_draws`` (``SGDDraws``/``RowDraws``) inject
    the random draws; the rest come from ``generator``.
    """
    s = as_spec("cg" if spec is None else spec, **spec_overrides)
    backend = getattr(s, "backend", None) or "auto"
    op = Gram(x=x, params=params, backend=backend)
    prior = sample_prior(params, num_samples, num_features, x.shape[1],
                         generator=generator, omega=omega, w=w)
    data, delta = pathwise_targets(op, y, prior, generator=generator, eps=eps)
    res = solve(op, data, s, generator=generator, draws=solver_draws, x0=x0,
                delta=delta)
    sol = res.solution
    return PosteriorFunctions(
        params=params,
        x=x,
        prior=prior,
        v_mean=sol[:, 0],
        alpha=sol[:, 1:],
        solve_info=res,
        backend=backend,
    )
