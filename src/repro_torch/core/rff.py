"""Random Fourier features (§2.2.2): approximate prior function samples — the
single-device part of ``repro/core/rff.py``.

A prior sample is f(x) ≈ Φ(x) w with w ~ N(0, I) and the paired sin/cos map
Φ(x) = √(σ_f²/m)·[sin(xΩᵀ) | cos(xΩᵀ)] (Sutherland & Schneider, 2015).
Pathwise conditioning (core/pathwise.py) evaluates f_X (train) and f_X* (test)
jointly through ``phi_mv``, which goes to the fused CUDA kernel on the card;
SGD's regulariser runs ``phi_pair_mv`` = Φ(Φᵀu) on fresh features every step
through the fused pair kernel, and ``phi_t_mv`` = Φᵀu through the transposed
kernel.

Random draws come from an explicit ``torch.Generator``, or are injected
(``omega``, ``w``): the parity tests hand both packages the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import materialised_features, rff_mv, rff_pair_mv, rff_t_mv
from .kernels_fn import KernelParams, spectral_sample
from .operators import FeatureOperator


@dataclasses.dataclass(frozen=True)
class FourierFeatures(FeatureOperator):
    """The paired sin/cos feature map Φ — a :class:`FeatureOperator`.

    ``backend`` selects the feature-matvec path (kernels/ops.py): ``"auto"``
    (the CUDA kernel on the card, materialised features on the CPU),
    ``"cuda"`` or ``"features"``; ``precision`` the tile precision (only
    ``"fp32"`` is ported). Each matvec may override both per call. The
    reference's cos-only variant is not ported.
    """

    omega: torch.Tensor  # (m, d) frequencies
    phase: torch.Tensor  # (m,) phases of the reference's cos-only variant; unused here
    signal: torch.Tensor  # σ_f² signal variance
    backend: str = "auto"
    precision: str = "fp32"

    @property
    def num_features(self) -> int:
        return 2 * self.omega.shape[0]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Φ(x) materialised: (n, 2m) — the optional ``features`` capability."""
        return materialised_features(x, self.omega, self.signal)

    def _kw(self, backend: Optional[str], precision: Optional[str]) -> dict:
        return dict(signal=self.signal,
                    backend=self.backend if backend is None else backend,
                    precision=precision or self.precision)

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor, *, backend: Optional[str] = None,
               precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x) @ w: (n, s-like)."""
        return rff_mv(x, self.omega, w, **self._kw(backend, precision))

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor, *, backend: Optional[str] = None,
                 precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x)ᵀ @ u: (num_features, s-like), sin rows first."""
        return rff_t_mv(x, self.omega, u, **self._kw(backend, precision))

    def phi_pair_mv(self, x: torch.Tensor, u: torch.Tensor, *,
                    backend: Optional[str] = None,
                    precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x) (Φ(x)ᵀ u): (n, s-like) — SGD's regulariser in one dispatch."""
        return rff_pair_mv(x, self.omega, u, **self._kw(backend, precision))


def make_fourier_features(
    params: KernelParams,
    num_features: int,
    d: int,
    *,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
) -> FourierFeatures:
    """A paired feature map with ``num_features`` columns (m = num_features/2
    frequencies from the kernel's spectral density, or the injected ``omega``)."""
    if num_features % 2:
        raise ValueError(f"paired features need an even num_features, got {num_features}")
    m = num_features // 2
    if omega is None:
        omega = spectral_sample(params, m, d, generator=generator)
    # the paired map has no phases; the field keeps the reference's layout
    phase = torch.zeros((m,), dtype=omega.dtype, device=omega.device)
    return FourierFeatures(omega=omega, phase=phase, signal=params.signal)


@dataclasses.dataclass(frozen=True)
class PriorSamples(FeatureOperator):
    """s prior function samples f⁽ⁱ⁾(·) = Φ(·) w_i, evaluable anywhere.
    ``__call__(x)`` is ``phi_mv(x, w)`` through the map's backend dispatch."""

    ff: FourierFeatures
    w: torch.Tensor  # (num_features, s)

    @property
    def num_features(self) -> int:
        return self.ff.num_features

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff.features(x)

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_mv(x, w, **kw)

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_t_mv(x, u, **kw)

    def phi_pair_mv(self, x: torch.Tensor, u: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_pair_mv(x, u, **kw)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.phi_mv(x, self.w)  # (n, s)


def sample_prior(
    params: KernelParams,
    num_samples: int,
    num_features: int,
    d: int,
    *,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
) -> PriorSamples:
    """``num_samples`` prior functions on a fresh feature map. ``omega``
    ((num_features/2, d)) and ``w`` ((num_features, num_samples)) inject the
    draws; otherwise they come from ``generator``."""
    ff = make_fourier_features(params, num_features, d, generator=generator, omega=omega)
    if w is None:
        w = torch.randn((ff.num_features, num_samples), generator=generator,
                        device=ff.omega.device)
    return PriorSamples(ff=ff, w=w)
