"""Latent Kronecker structure (Chapter 6, LKGP) — twin of
``repro/core/kronecker.py``.

Product-kernel GPs on a Cartesian grid X = X₁ × X₂ give K = K₁ ⊗ K₂ (Eq. 2.68).
With observations on a subset (mask M) of the grid, the observed covariance is
the projection of a latent Kronecker product,

    K_obs = P_M (K₁ ⊗ K₂) P_Mᵀ            (§6.2.2)

which keeps fast matvecs:

    (K_obs + σ²I) v = P_M vec(K₁ V K₂ᵀ) + σ² v,   V = unvec(P_Mᵀ v)

at O(n₁n₂(n₁+n₂)) instead of O(n_obs²): two dense products over the factors,
plain torch on the card as in the reference. The operator enters the solver
layer as :class:`~repro_torch.core.operators.LatentKroneckerOp`, so
``lkgp_posterior`` runs its batched system through ``solve()``. Prior samples
on the full grid come from the Kronecker Cholesky (L₁ ⊗ L₂) w (Eq. 2.73).

Break-even (§6.2.6): the latent Kronecker matvec beats the direct one when the
observed density ρ = n_obs/(n₁n₂) exceeds ρ* = sqrt((n₁+n₂)/(n₁n₂)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .kernels_fn import KernelParams, gram
from .operators import LatentKroneckerOp
from .solvers.base import SolveResult
from .solvers.spec import CG, SpecLike, as_spec, solve


def _kron_mv(k1: torch.Tensor, k2: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """(K₁ ⊗ K₂) applied to each (n1, n2) slice of ``full`` (n1, n2, s)."""
    return torch.einsum("ab,bcs->acs", k1, torch.einsum("cd,bds->bcs", k2, full))


@dataclasses.dataclass(frozen=True)
class LatentKroneckerGP:
    """Two-factor LKGP over grid (g1 × g2) with an observation mask."""

    params1: KernelParams
    params2: KernelParams
    grid1: torch.Tensor  # (n1, d1)
    grid2: torch.Tensor  # (n2, d2)
    obs_idx: torch.Tensor  # (n_obs,) int64 flat indices into the n1*n2 grid — the mask M
    noise: torch.Tensor  # σ²

    @property
    def shape(self) -> tuple:
        return self.grid1.shape[0], self.grid2.shape[0]

    def k1(self) -> torch.Tensor:
        return gram(self.params1, self.grid1)

    def k2(self) -> torch.Tensor:
        return gram(self.params2, self.grid2)

    def project_up(self, v_obs: torch.Tensor) -> torch.Tensor:
        """P_Mᵀ v: scatter observed vector(s) into the full grid.
        (n_obs, s) → (n1, n2, s)."""
        n1, n2 = self.shape
        full = v_obs.new_zeros((n1 * n2, v_obs.shape[1]))
        return full.index_copy(0, self.obs_idx, v_obs).reshape(n1, n2, -1)

    def project_down(self, v_full: torch.Tensor) -> torch.Tensor:
        """P_M v: gather observed entries. (n1, n2, s) → (n_obs, s)."""
        return v_full.reshape(-1, v_full.shape[-1])[self.obs_idx]

    def mv(self, v_obs: torch.Tensor) -> torch.Tensor:
        """(K_obs + σ²I) @ v via the latent Kronecker matvec (§6.2.3)."""
        squeeze = v_obs.ndim == 1
        v2 = v_obs[:, None] if squeeze else v_obs
        out = _kron_mv(self.k1(), self.k2(), self.project_up(v2))
        out = self.project_down(out) + self.noise * v2
        return out[:, 0] if squeeze else out

    def prior_sample_grid(self, num_samples: int, *,
                          generator: Optional[torch.Generator] = None,
                          w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prior samples on the full grid (Eq. 2.73) → (n1, n2, s), from the
        standard normals ``w`` (n1, n2, s), injected or drawn from
        ``generator``."""
        n1, n2 = self.shape
        # jitter ∝ signal: fp32 Grams of close points round slightly indefinite
        g1, g2 = self.grid1, self.grid2
        l1 = torch.linalg.cholesky(self.k1() + 1e-5 * self.params1.signal * torch.eye(
            n1, dtype=g1.dtype, device=g1.device))
        l2 = torch.linalg.cholesky(self.k2() + 1e-5 * self.params2.signal * torch.eye(
            n2, dtype=g2.dtype, device=g2.device))
        if w is None:
            w = torch.randn((n1, n2, num_samples), generator=generator, dtype=g1.dtype,
                            device=g1.device)
        return _kron_mv(l1, l2, w)

    def cross_mv(self, weights_obs: torch.Tensor) -> torch.Tensor:
        """K_{grid,obs} @ w → full-grid predictions. (n_obs, s) → (n1, n2, s)."""
        squeeze = weights_obs.ndim == 1
        w2 = weights_obs[:, None] if squeeze else weights_obs
        out = _kron_mv(self.k1(), self.k2(), self.project_up(w2))
        return out[..., 0] if squeeze else out


class LKGPSamples(tuple):
    """``(mean (n1, n2), samples (n1, n2, s))``, unpacked as the reference
    returns them, with the batched solve's ``SolveResult`` as ``solve_info``
    (the field the other posteriors carry)."""

    solve_info: SolveResult

    def __new__(cls, mean: torch.Tensor, samples: torch.Tensor, solve_info: SolveResult):
        out = super().__new__(cls, (mean, samples))
        out.solve_info = solve_info
        return out


def lkgp_posterior(
    gp: LatentKroneckerGP,
    y_obs: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 8,
    max_iters: Optional[int] = None,
    spec: Optional[SpecLike] = None,
    w: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> LKGPSamples:
    """Pathwise posterior on the FULL grid (§6.2.4), solver-spec driven.

    Returns (mean (n1, n2), samples (n1, n2, s)) as :class:`LKGPSamples`,
    whose ``solve_info`` is the solve's ``SolveResult``. One batched ``solve()`` on the
    :class:`~repro_torch.core.operators.LatentKroneckerOp` for
    [y | f_obs + ε], then f_full + K_{grid,obs}(v − α). ``spec`` must be a
    matvec-only (CG-family) spec and defaults to ``CG(max_iters=500,
    tol=1e-4)``; an explicit ``max_iters`` overrides the spec's budget. The
    grid normals ``w`` (n1, n2, s) and the noise ``eps`` (n_obs, s) are
    injected or drawn from ``generator``, in that order.
    """
    if spec is None:
        s = CG(max_iters=500 if max_iters is None else max_iters, tol=1e-4)
    else:
        s = as_spec(spec) if max_iters is None else as_spec(spec, max_iters=max_iters)
    f_grid = gp.prior_sample_grid(num_samples, generator=generator, w=w)
    f_obs = gp.project_down(f_grid)
    if eps is None:
        eps = torch.sqrt(gp.noise) * torch.randn(f_obs.shape, generator=generator,
                                                 dtype=f_obs.dtype, device=f_obs.device)
    rhs = torch.cat([y_obs[:, None], f_obs + eps], dim=1)
    res: SolveResult = solve(LatentKroneckerOp(gp=gp), rhs, s, generator=generator)
    v_mean, alpha = res.solution[:, :1], res.solution[:, 1:]
    mean = gp.cross_mv(v_mean)[..., 0]
    samples = f_grid + gp.cross_mv(v_mean - alpha)
    return LKGPSamples(mean, samples, res)


def make_lkgp(
    params1: KernelParams,
    params2: KernelParams,
    grid1,
    grid2,
    mask,
    noise,
    *,
    device: DeviceLike = None,
) -> LatentKroneckerGP:
    """Build an LKGP from a boolean (n1, n2) observation mask. The grids and
    noise go to ``grid1``'s device when it is a tensor and no ``device`` is
    named, else to ``device`` (the card unless ``"cpu"``)."""
    if isinstance(grid1, torch.Tensor) and device is None:
        dev = grid1.device
    else:
        dev = resolve_device(device)
    mask = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    idx = torch.as_tensor(np.nonzero(mask.reshape(-1))[0], dtype=torch.int64, device=dev)
    g1 = torch.as_tensor(grid1, device=dev)
    return LatentKroneckerGP(
        params1=params1,
        params2=params2,
        grid1=g1,
        grid2=torch.as_tensor(grid2, dtype=g1.dtype, device=dev),
        obs_idx=idx,
        noise=torch.as_tensor(noise, dtype=g1.dtype, device=dev),
    )


def break_even_density(n1: int, n2: int) -> float:
    """ρ* above which the latent Kronecker matvec is cheaper than the direct
    O(n_obs²) matvec (§6.2.6): (ρ n₁n₂)² = n₁n₂(n₁+n₂) ⇒ ρ* = sqrt((n₁+n₂)/(n₁n₂))."""
    return math.sqrt((n1 + n2) / (n1 * n2))


def lkgp_matvec_flops(n1: int, n2: int, density: float) -> tuple:
    """(latent-Kronecker flops, direct flops) per matvec."""
    lk = 2.0 * n1 * n2 * (n1 + n2)
    n_obs = density * n1 * n2
    direct = 2.0 * n_obs * n_obs
    return lk, direct
