"""Inducing-point pathwise sampling via iterative solves (§3.2.3) — twin of
``repro/core/inducing.py``.

For m ≪ n inducing points Z, the optimal inducing posterior mean and
per-sample uncertainty-reduction weights solve the m×m normal equations
(Eqs. 3.23/3.24)

    (K_ZX K_XZ + σ² K_ZZ) u = K_ZX b,    b = y  or  f_X + ε,

touched only through K_XZ matvecs (:class:`~repro_torch.core.operators.NormalEq`).
Posterior samples: f(·) + K_(·)Z (v* − α*) (Eq. 3.36), with f an RFF prior.

On the card the right-hand side K_ZX [y | f_X + ε] and each ``NormalEq``
matvec go through the Gram kernel on the cross shapes, and the prior f_X and
every evaluation of the sample paths through the RFF kernel. Random draws
come from an explicit ``torch.Generator``, or are injected (``omega``, ``w``,
``eps``; ``idx`` for the inducing subset).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import gram_mv
from .kernels_fn import KernelParams, gram
from .operators import NormalEq  # noqa: F401 (re-export: NormalEq lives in operators)
from .rff import PriorSamples, sample_prior
from .solvers.base import SolveResult
from .solvers.spec import CG, SpecLike, as_spec, solve


@dataclasses.dataclass(frozen=True)
class InducingPosterior:
    params: KernelParams
    z: torch.Tensor  # (m, d) inducing inputs
    prior: PriorSamples
    v_mean: torch.Tensor  # (m,)
    alpha: torch.Tensor  # (m, s)
    solve_info: Optional[SolveResult] = None

    def mean(self, xs: torch.Tensor) -> torch.Tensor:
        return gram(self.params, xs, self.z) @ self.v_mean

    def __call__(self, xs: torch.Tensor) -> torch.Tensor:
        """The s sample paths at xs → (n*, s): one prior feature matvec plus
        the dense n* × m cross-covariance."""
        kxz = gram(self.params, xs, self.z)
        return self.prior(xs) + kxz @ (self.v_mean[:, None] - self.alpha)


def inducing_posterior(
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 16,
    num_features: int = 2048,
    spec: Optional[SpecLike] = None,
    max_iters: int = 200,
    tol: float = 1e-5,
    row_chunk: int = 4096,
    omega: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> InducingPosterior:
    """Optimal inducing posterior via ``solve()`` on the normal-equations operator.

    ``spec`` must be a matvec-only (CG-family) spec; when omitted it is
    ``CG(max_iters=max_iters, tol=tol)``. The tight default ``tol`` matters:
    the operator is ill-conditioned (κ(K_XZ)²-ish). The spec's ``backend``
    pins the Gram side (right-hand side and operator) and the prior's feature
    matvecs alike. ``omega`` ((num_features/2, d)), ``w`` ((num_features,
    num_samples)) and ``eps`` ((n, num_samples)) inject the prior's draws and
    the noise; otherwise they come from ``generator``, in that order.
    """
    s = as_spec(CG(max_iters=max_iters, tol=tol) if spec is None else spec)
    backend = getattr(s, "backend", None) or "auto"
    precision = getattr(s, "precision", None) or "fp32"
    prior = sample_prior(params, num_samples, num_features, x.shape[1],
                         generator=generator, omega=omega, w=w).with_backend(backend)
    f_x = prior(x)
    if eps is None:
        eps = torch.sqrt(params.noise) * torch.randn(f_x.shape, generator=generator,
                                                     dtype=f_x.dtype, device=f_x.device)
    targets = torch.cat([y[:, None], f_x + eps], dim=1)  # (n, 1+s)
    rhs = gram_mv(params, z, targets, z=x, backend=backend, row_chunk=row_chunk,
                  precision=precision)  # K_ZX b: (m, 1+s)
    op = NormalEq(x=x, z=z, params=params, row_chunk=row_chunk, backend=backend,
                  precision=precision)
    res = solve(op, rhs, s, generator=generator)
    sol = res.solution
    return InducingPosterior(params=params, z=z, prior=prior, v_mean=sol[:, 0],
                             alpha=sol[:, 1:], solve_info=res)


def select_inducing_greedy(x: torch.Tensor, m: int, *,
                           generator: Optional[torch.Generator] = None,
                           idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cheap inducing-point selection: a uniform subset of m distinct rows
    (§3.3.1's stated-adequate fallback for large m). ``idx`` (m,) injects the
    subset; otherwise it is a prefix of a permutation from ``generator``."""
    if idx is None:
        idx = torch.randperm(x.shape[0], generator=generator, device=x.device)[:m]
    return x[idx]
