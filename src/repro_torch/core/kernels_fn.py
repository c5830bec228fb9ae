"""Covariance functions (dissertation §2.1.3) — twin of ``repro/core/kernels_fn.py``.

Hyperparameters live in *unconstrained* (log) space in a frozen dataclass of
tensors. Pairwise Gram blocks use the distance-as-matmul identity
‖x − x'‖² = ‖x‖² + ‖x'‖² − 2x·x', so the dominant cost is a matmul; the CUDA
kernel in ``kernels/gram_matvec.py`` fuses it with the covariance map and the
matvec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..kernels.ref import sqdist, stationary_map

SE = "se"
MATERN12 = "matern12"
MATERN32 = "matern32"
MATERN52 = "matern52"
TANIMOTO = "tanimoto"

KINDS = (SE, MATERN12, MATERN32, MATERN52, TANIMOTO)

#: ν of each Matérn kind — its spectral density is a Student-t with 2ν dof
_MATERN_NU = {MATERN12: 0.5, MATERN32: 1.5, MATERN52: 2.5}


#: the tensor fields of :class:`KernelParams` — the leaves of the reference's pytree
PARAM_LEAVES = ("log_lengthscale", "log_signal", "log_noise")


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Unconstrained GP hyperparameters θ = {log lengthscales, log signal, log noise}.

    Frozen: an update is a new instance (:func:`map_params`,
    ``dataclasses.replace``), and leaves may carry ``requires_grad``.
    """

    log_lengthscale: torch.Tensor  # (d,) ARD or scalar ()
    log_signal: torch.Tensor  # ()
    log_noise: torch.Tensor  # ()
    kind: str = SE

    @property
    def lengthscale(self) -> torch.Tensor:
        return torch.exp(self.log_lengthscale)

    @property
    def signal(self) -> torch.Tensor:  # signal *variance*
        return torch.exp(2.0 * self.log_signal)

    @property
    def noise(self) -> torch.Tensor:  # noise variance σ²
        return torch.exp(2.0 * self.log_noise)


def map_params(fn, params: KernelParams, *rest: KernelParams) -> KernelParams:
    """``fn`` leaf by leaf over ``params`` and ``rest`` — the reference's
    ``jax.tree.map`` over KernelParams; ``kind`` is kept."""
    return dataclasses.replace(params, **{
        name: fn(getattr(params, name), *(getattr(p, name) for p in rest))
        for name in PARAM_LEAVES
    })


def make_params(
    kind: str = SE,
    lengthscale=1.0,
    signal: float = 1.0,
    noise: float = 0.1,
    d: Optional[int] = None,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> KernelParams:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KINDS}")
    dev = resolve_device(device)
    ls = torch.as_tensor(lengthscale, dtype=dtype, device=dev)
    if d is not None and ls.ndim == 0:
        ls = torch.full((d,), float(ls), dtype=dtype, device=dev)
    return KernelParams(
        log_lengthscale=torch.log(ls),
        log_signal=torch.log(torch.as_tensor(signal, dtype=dtype, device=dev)),
        log_noise=torch.log(torch.as_tensor(noise, dtype=dtype, device=dev)),
        kind=kind,
    )


def gram(params: KernelParams, x: torch.Tensor,
         z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense Gram matrix K(x, z) — the reference path (O(n m) memory)."""
    z = x if z is None else z
    if params.kind == TANIMOTO:
        # inner-product form of Σmin/Σmax, valid for binary fingerprints
        inner = x @ z.T
        xn = torch.sum(x * x, dim=-1)[:, None]
        zn = torch.sum(z * z, dim=-1)[None, :]
        denom = xn + zn - inner
        return params.signal * inner / torch.clamp(denom, min=1e-12)
    ls = params.lengthscale
    return params.signal * stationary_map(sqdist(x / ls, z / ls), params.kind)


def gram_diag(params: KernelParams, x: torch.Tensor) -> torch.Tensor:
    return params.signal * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


def matvec(
    params: KernelParams,
    x: torch.Tensor,
    v: torch.Tensor,
    z: Optional[torch.Tensor] = None,
    row_chunk: int = 4096,
    jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(K(x,z) + jitter·I) @ v in row chunks — O(chunk·m) memory, never
    materialising K. v may be (m,) or (m, s)."""
    z_ = x if z is None else z
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    out = torch.cat([
        gram(params, x[i:i + row_chunk], z_) @ v2
        for i in range(0, x.shape[0], row_chunk)
    ]) if x.shape[0] else v2.new_zeros((0, v2.shape[1]))
    if jitter is not None and z is None:
        out = out + jitter * v2
    return out[:, 0] if squeeze else out


def _gamma_half_integer(nu: float, m: int, generator: Optional[torch.Generator],
                        device: torch.device) -> torch.Tensor:
    """(m, 1) draws of Gamma(ν, 1) for half-integer ν, exactly: χ²₂ν / 2 is the
    sum of 2ν squared standard normals, halved."""
    k = int(round(2 * nu))
    z = torch.randn((m, k), generator=generator, device=device)
    return 0.5 * torch.sum(z * z, dim=1, keepdim=True)


def spectral_gammas(kind: str, m: int, *, generator: Optional[torch.Generator] = None,
                    device=None) -> Optional[torch.Tensor]:
    """The (m, 1) Gamma(ν, 1) draws behind a Matérn-ν spectral sample, None for
    SE. Like the normals, they do not depend on θ."""
    if kind not in _MATERN_NU:
        return None
    return _gamma_half_integer(_MATERN_NU[kind], m, generator, device)


def spectral_sample(
    params: KernelParams,
    m: int,
    d: int,
    *,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    gammas: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample m frequencies ω from the kernel's spectral density (§2.2.2).

    SE ↔ N(0, I/ℓ²); Matérn-ν ↔ multivariate Student-t with 2ν dof, scaled by
    1/ℓ: ω = n / √(g/ν)/ℓ with n ~ N(0, I) (m, d) and g ~ Gamma(ν, 1) (m, 1).
    ``normals`` and ``gammas`` inject those draws (the reference's own, in the
    parity tests, or draws held fixed while θ moves) and override ``generator``;
    the result is rescaled by the current θ either way.
    """
    kind = params.kind
    dev = params.log_lengthscale.device
    if kind not in (SE, *_MATERN_NU):
        raise ValueError(f"no spectral density for kernel {kind!r}")
    if normals is None:
        normals = torch.randn((m, d), generator=generator, device=dev)
    w = normals
    if kind in _MATERN_NU:
        nu = _MATERN_NU[kind]
        if gammas is None:
            gammas = _gamma_half_integer(nu, m, generator, dev)
        w = normals / torch.sqrt(gammas.reshape(m, 1) / nu)
    return w / params.lengthscale


# ---------------------------------------------------------------------------
# Product kernels over Cartesian grids (Ch. 6 latent Kronecker structure).


def kronecker_grams(params_list: list, grids: list) -> list:
    """Per-factor Gram matrices K_j = k_j(X_j, X_j) of a product kernel (Eq. 2.68)."""
    return [gram(p, g) for p, g in zip(params_list, grids)]
