"""Random Fourier features (§2.2.2): approximate prior function samples — the
single-device part of ``repro/core/rff.py``.

A prior sample is f(x) ≈ Φ(x) w with w ~ N(0, I) and the paired sin/cos map
Φ(x) = √(σ_f²/m)·[sin(xΩᵀ) | cos(xΩᵀ)] (Sutherland & Schneider, 2015), or
the cos-only map Φ(x) = √(2σ_f²/m)·cos(xΩᵀ + b) with uniform phases b.
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
import math
from typing import Optional

import torch

from ..kernels.ops import (
    FEATURE_TRACE_COUNTS, materialised_features, resolve_feature_backend, rff_mv,
    rff_pair_mv, rff_t_mv,
)
from .kernels_fn import KernelParams, spectral_sample
from .operators import FeatureOperator


@dataclasses.dataclass(frozen=True)
class FourierFeatures(FeatureOperator):
    """The feature map Φ — a :class:`FeatureOperator`: paired sin/cos
    (``paired=True``, 2m features) or cos-only with phases (m features).

    ``backend`` selects the feature-matvec path (kernels/ops.py): ``"auto"``
    (the CUDA kernel on the card, materialised features on the CPU),
    ``"cuda"`` or ``"features"``; ``precision`` the tile precision (only
    ``"fp32"`` is ported). Each matvec may override both per call. The fused
    kernel implements the paired map only: for the cos-only map ``"auto"``
    materialises the features and ``"cuda"`` raises, as the reference does
    with ``"pallas"``.
    """

    omega: torch.Tensor  # (m, d) frequencies
    phase: torch.Tensor  # (m,) phases of the cos-only map; unused by the paired one
    signal: torch.Tensor  # σ_f² signal variance
    paired: bool = True
    backend: str = "auto"
    precision: str = "fp32"

    @property
    def num_features(self) -> int:
        m = self.omega.shape[0]
        return 2 * m if self.paired else m

    def with_backend(self, backend: str) -> "FourierFeatures":
        return dataclasses.replace(self, backend=backend)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Φ(x) materialised: (n, num_features) — the optional ``features``
        capability."""
        if self.paired:
            return materialised_features(x, self.omega, self.signal)
        m = self.omega.shape[0]
        proj = x @ self.omega.T + self.phase[None, :]
        return torch.sqrt(2.0 * self.signal / m) * torch.cos(proj)

    def _kw(self, backend: Optional[str], precision: Optional[str]) -> dict:
        return dict(signal=self.signal,
                    backend=self.backend if backend is None else backend,
                    precision=precision or self.precision)

    def _cos_only(self, x: torch.Tensor, backend: Optional[str], uses: int) -> torch.Tensor:
        """The cos-only map's materialised features, after refusing a
        ``"cuda"`` request; counted as ``uses`` feature dispatches."""
        resolve_feature_backend(self.backend if backend is None else backend, x.device,
                                paired=False)
        FEATURE_TRACE_COUNTS["features"] += uses
        return self.features(x)

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor, *, backend: Optional[str] = None,
               precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x) @ w: (n, s-like)."""
        if not self.paired:
            return self._cos_only(x, backend, 1) @ w
        return rff_mv(x, self.omega, w, **self._kw(backend, precision))

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor, *, backend: Optional[str] = None,
                 precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x)ᵀ @ u: (num_features, s-like), sin rows first."""
        if not self.paired:
            return self._cos_only(x, backend, 1).T @ u
        return rff_t_mv(x, self.omega, u, **self._kw(backend, precision))

    def phi_pair_mv(self, x: torch.Tensor, u: torch.Tensor, *,
                    backend: Optional[str] = None,
                    precision: Optional[str] = None) -> torch.Tensor:
        """Φ(x) (Φ(x)ᵀ u): (n, s-like) — SGD's regulariser in one dispatch."""
        if not self.paired:
            feats = self._cos_only(x, backend, 2)  # built once, used twice
            return feats @ (feats.T @ u)
        return rff_pair_mv(x, self.omega, u, **self._kw(backend, precision))


def make_fourier_features(
    params: KernelParams,
    num_features: int,
    d: int,
    *,
    paired: bool = True,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
    phase: Optional[torch.Tensor] = None,
) -> FourierFeatures:
    """A feature map with ``num_features`` columns: paired (m = num_features/2
    frequencies) or cos-only (m = num_features frequencies, phases uniform on
    [0, 2π)). Frequencies come from the kernel's spectral density, phases
    after them from ``generator``, unless ``omega`` or ``phase`` inject them."""
    if paired and num_features % 2:
        raise ValueError(f"paired features need an even num_features, got {num_features}")
    m = num_features // 2 if paired else num_features
    if omega is None:
        omega = spectral_sample(params, m, d, generator=generator)
    if paired:  # the paired map has no phases; the field keeps the layout
        phase = torch.zeros((m,), dtype=omega.dtype, device=omega.device)
    elif phase is None:
        phase = 2.0 * math.pi * torch.rand((m,), generator=generator, dtype=omega.dtype,
                                           device=omega.device)
    return FourierFeatures(omega=omega, phase=phase, signal=params.signal, paired=paired)


@dataclasses.dataclass(frozen=True)
class PriorSamples(FeatureOperator):
    """s prior function samples f⁽ⁱ⁾(·) = Φ(·) w_i, evaluable anywhere.
    ``__call__(x)`` is ``phi_mv(x, w)``. ``backend`` (the reference's field;
    None: the feature map's own) is every matvec's backend unless the call
    names one."""

    ff: FourierFeatures
    w: torch.Tensor  # (num_features, s)
    backend: Optional[str] = None

    @property
    def num_features(self) -> int:
        return self.ff.num_features

    @property
    def num_samples(self) -> int:
        return self.w.shape[1]

    def with_backend(self, backend: str) -> "PriorSamples":
        return dataclasses.replace(self, backend=backend)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff.features(x)

    def _kw(self, kw: dict) -> dict:
        return kw if self.backend is None or "backend" in kw else {"backend": self.backend, **kw}

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_mv(x, w, **self._kw(kw))

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_t_mv(x, u, **self._kw(kw))

    def phi_pair_mv(self, x: torch.Tensor, u: torch.Tensor, **kw) -> torch.Tensor:
        return self.ff.phi_pair_mv(x, u, **self._kw(kw))

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
