"""Exact GP regression (§2.1.1–2.1.2) — the O(n³) oracle, twin of
``repro/core/gp.py``.

Ground truth for the iterative path in tests and in ``chip_smoke.py``; never
used at scale. K + σ²I is assembled in row chunks so that the oracle fits on
the card at the sizes the smoke checks (its temporaries stay one chunk wide).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .kernels_fn import KernelParams, gram


@dataclasses.dataclass(frozen=True)
class ExactPosterior:
    params: KernelParams
    x: torch.Tensor
    y: torch.Tensor
    chol: torch.Tensor  # cholesky(K + σ²I), lower
    weights: torch.Tensor  # (K+σ²I)⁻¹ y

    def mean(self, xs: torch.Tensor) -> torch.Tensor:
        return gram(self.params, xs, self.x) @ self.weights

    def cov(self, xs: torch.Tensor) -> torch.Tensor:
        kxs = gram(self.params, self.x, xs)
        sol = torch.cholesky_solve(kxs, self.chol)
        return gram(self.params, xs) - kxs.T @ sol

    def var(self, xs: torch.Tensor) -> torch.Tensor:
        return torch.diagonal(self.cov(xs))

    def sample(self, xs: torch.Tensor, num_samples: int, *,
               generator: Optional[torch.Generator] = None,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conventional sampling via Cholesky of the posterior covariance
        (Eq. 2.9) → (n*, num_samples). The standard normals ``w`` (n*,
        num_samples) are injected or drawn from ``generator``."""
        eye = torch.eye(xs.shape[0], dtype=xs.dtype, device=xs.device)
        chol = torch.linalg.cholesky(self.cov(xs) + 1e-6 * eye)
        if w is None:
            w = torch.randn((xs.shape[0], num_samples), generator=generator,
                            dtype=xs.dtype, device=xs.device)
        return self.mean(xs)[:, None] + chol @ w


def _cholesky(params: KernelParams, x: torch.Tensor, row_chunk: int) -> torch.Tensor:
    """cholesky(K + σ²I), lower, with K + σ²I assembled in row chunks and freed
    once factored."""
    n = x.shape[0]
    a = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for i in range(0, n, row_chunk):
        a[i:i + row_chunk] = gram(params, x[i:i + row_chunk], x)
    a.diagonal().add_(params.noise)
    return torch.linalg.cholesky(a)


def exact_posterior(params: KernelParams, x: torch.Tensor, y: torch.Tensor,
                    row_chunk: int = 4096) -> ExactPosterior:
    chol = _cholesky(params, x, row_chunk)
    w = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return ExactPosterior(params=params, x=x, y=y, chol=chol, weights=w)


def exact_mll(params: KernelParams, x: torch.Tensor, y: torch.Tensor,
              row_chunk: int = 4096) -> torch.Tensor:
    """Log marginal likelihood (Eq. 2.36), zero prior mean, in the inputs'
    dtype — the Cholesky oracle of the MLL optimisation."""
    chol = _cholesky(params, x, row_chunk)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    data_fit = -0.5 * torch.dot(y, alpha)
    complexity = -torch.sum(torch.log(torch.diagonal(chol)))
    return data_fit + complexity - 0.5 * x.shape[0] * math.log(2.0 * math.pi)
