"""Preconditioners for CG (§2.2.4; Gardner et al. 2018, Wang et al. 2019) —
twin of ``repro/core/precond.py``.

The low-rank family builds a rank-m surrogate K ≈ L Lᵀ and applies
(L Lᵀ + σ²I)⁻¹ via Woodbury in O(n·m) per application:

  * ``nystrom``: uniform-subset Nyström (one m×m inverse + matmuls);
  * ``pivoted_cholesky``: greedy diagonal pivoting, ``rank`` sequential steps;
  * ``rff``: the materialised random-feature matrix Φ as the factor (ΦΦᵀ is an
    unbiased K estimate, §2.2.2); on ``RFFGram`` it is the operator's own Φ.

Factor construction is an *operator capability*: preconditioner specs call
``op.precond_factor(rank, generator=, draws=, method=)``, which routes here
via :func:`low_rank_factor`. :class:`JacobiPrecond` is the zero-setup
fallback built from the protocol's required ``diag_part()``.

The factor builds and the Woodbury apply are plain torch, as in the
reference: on the card a preconditioned CG iteration is one Gram kernel
launch plus this apply (two skinny matmuls and an m×m triangular solve).

``jnp.linalg.cholesky`` returns NaNs where a matrix is not positive
definite; ``torch.linalg.cholesky`` raises, and syncs with the host to do so.
The builds here use ``cholesky_ex``/``inv_ex`` and write NaN where the
reference would, with no host sync. Random draws (the Nyström subset, the
RFF frequencies) come from a ``torch.Generator`` or are injected as
:class:`PrecondDraws`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..device import make_generator
from .kernels_fn import KernelParams, gram, gram_diag, spectral_gammas, spectral_sample
from .operators import LinearOperator


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a``, all NaN where the factorisation fails
    (``jnp.linalg.cholesky``'s convention), without a host sync."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def _inv_or_nan(a: torch.Tensor) -> torch.Tensor:
    inv, info = torch.linalg.inv_ex(a)
    return torch.where(info == 0, inv, torch.full_like(inv, float("nan")))


@dataclasses.dataclass(frozen=True)
class PrecondDraws:
    """The random draws of a preconditioner build: ``idx`` (rank,) int64, the
    Nyström subset; ``normals`` (rank/2, d) and, for Matérn, ``gammas``
    (rank/2, 1), the θ-free spectral draws of the RFF preconditioner's
    frequencies (rescaled by the current θ at every build). Each build uses
    the fields its method needs."""

    idx: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None
    gammas: Optional[torch.Tensor] = None


def draw_precond(method: str, rank: int, n: int, d: int, kind: str, *,
                 generator: torch.Generator, device) -> Optional[PrecondDraws]:
    """Fresh :class:`PrecondDraws` for a factor ``method`` (None for the
    deterministic pivoted Cholesky)."""
    if method == "nystrom":
        return PrecondDraws(idx=_subset(n, rank, generator, device))
    if method == "rff":
        m = rank // 2
        return PrecondDraws(
            normals=torch.randn((m, d), generator=generator, device=device),
            gammas=spectral_gammas(kind, m, generator=generator, device=device))
    return None


def _subset(n: int, rank: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=device)[:min(rank, n)]


@dataclasses.dataclass(frozen=True)
class WoodburyPrecond(LinearOperator):
    """The surrogate M = L Lᵀ + σ²I. Protocol convention: ``mv`` is the
    FORWARD apply M @ v, while ``__call__`` is the preconditioner apply
    r ↦ M⁻¹r (the Woodbury solve) that CG consumes."""

    l: torch.Tensor  # (n, m) low-rank factor, K ≈ L Lᵀ (this rank's rows when row-sharded)
    chol: torch.Tensor  # (m, m) lower Cholesky of LᵀL + σ²I
    sigma2: torch.Tensor  # () noise variance
    # a row-sharded layout's psum: Lᵀr sums over the ranks' rows
    reduce: Optional[Callable] = None

    @property
    def rank(self) -> int:
        return self.l.shape[1]

    @property
    def shape(self) -> tuple:
        return (self.l.shape[0], self.l.shape[0])

    @property
    def noise(self) -> torch.Tensor:
        return self.sigma2

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """M @ v = L(Lᵀv) + σ²v — the protocol's forward apply."""
        return self.l @ (self.l.T @ v) + self.sigma2 * v

    def diag_part(self) -> torch.Tensor:
        """diag(M) = Σ_j L² + σ²."""
        return torch.sum(self.l * self.l, dim=1) + self.sigma2

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ @ r via Woodbury: (r − L (LᵀL + σ²I)⁻¹ Lᵀ r) / σ². On row
        blocks the (m, s) product Lᵀr is psum-reduced: the apply's only
        collective."""
        if r.ndim == 1:
            return self(r[:, None])[:, 0]
        lt_r = self.l.T @ r
        if self.reduce is not None:
            lt_r = self.reduce(lt_r)
        sol = torch.cholesky_solve(lt_r, self.chol)
        return (r - self.l @ sol) / self.sigma2


@dataclasses.dataclass(frozen=True)
class JacobiPrecond(LinearOperator):
    """Diagonal (Jacobi) preconditioner M = diag(A), from the protocol's
    required ``diag_part()``; same conventions as :class:`WoodburyPrecond`."""

    d: torch.Tensor  # (n,) diag(A) — includes the σ² shift (diag_part convention)

    @property
    def shape(self) -> tuple:
        return (self.d.shape[0], self.d.shape[0])

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """M @ v = diag(A) ⊙ v."""
        return self.d[:, None] * v if v.ndim == 2 else self.d * v

    def diag_part(self) -> torch.Tensor:
        return self.d

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ @ r = r / diag(A)."""
        return r / self.d[:, None] if r.ndim == 2 else r / self.d


def jacobi_preconditioner(op) -> JacobiPrecond:
    """The Jacobi apply for any protocol operator (``diag_part`` is required,
    so this never raises a capability error)."""
    return JacobiPrecond(d=op.diag_part())


def woodbury_from_factor(l: torch.Tensor, sigma2, layout=None) -> WoodburyPrecond:
    """(n, m) factor L with K ≈ LLᵀ → the (LLᵀ + σ²I)⁻¹ apply. The inner
    m × m factor is built from the whole L; with a row-sharded ``layout``
    (a ring ``ShardedGram``'s) the apply keeps this rank's rows of L and
    takes row blocks."""
    m = l.shape[1]
    inner = l.T @ l + sigma2 * torch.eye(m, dtype=l.dtype, device=l.device)
    reduce = None if layout is None else layout.reduce
    return WoodburyPrecond(l=l if reduce is None else layout.iterate(l),
                           chol=cholesky_or_nan(inner),
                           sigma2=torch.as_tensor(sigma2, dtype=l.dtype, device=l.device),
                           reduce=reduce)


def _default_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    # the reference falls back to PRNGKey(0) when no key is given
    return make_generator(0, device) if generator is None else generator


def nystrom_factor(params: KernelParams, x: torch.Tensor, rank: int = 100, *,
                   generator: Optional[torch.Generator] = None,
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, rank) Nyström factor L = K_xz K_zz^{-1/2} from a uniform subset:
    ``idx``, or ``rank`` distinct rows drawn from ``generator``."""
    n = x.shape[0]
    if idx is None:
        idx = _subset(n, rank, _default_generator(generator, x.device), x.device)
    elif tuple(idx.shape) != (min(rank, n),):
        raise ValueError(
            f"injected Nyström subset has shape {tuple(idx.shape)}, rank {rank} of "
            f"n = {n} needs ({min(rank, n)},)")
    z = x.index_select(0, idx)
    kzz = gram(params, z) + 1e-6 * torch.eye(z.shape[0], dtype=x.dtype, device=x.device)
    kxz = gram(params, x, z)
    return kxz @ cholesky_or_nan(_inv_or_nan(kzz))


def nystrom_preconditioner(params: KernelParams, x: torch.Tensor, rank: int = 100, *,
                           generator: Optional[torch.Generator] = None,
                           idx: Optional[torch.Tensor] = None) -> WoodburyPrecond:
    return woodbury_from_factor(
        nystrom_factor(params, x, rank, generator=generator, idx=idx), params.noise)


def _pivoted_cholesky_factor(params: KernelParams, x: torch.Tensor, rank: int) -> torch.Tensor:
    """Greedy pivoted Cholesky, ``rank`` steps. The pivot stays a 0-d device
    tensor (``index_select``, ``index_fill``): no host sync in the loop.
    ``argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    n = x.shape[0]
    diag = gram_diag(params, x)
    l = x.new_zeros((n, rank))
    for i in range(rank):
        p = torch.argmax(diag).view(1)
        kp = gram(params, x.index_select(0, p), x)[0]  # row p of K
        row = kp - l @ l.index_select(0, p)[0]
        piv = torch.sqrt(torch.clamp(diag.index_select(0, p), min=1e-12))
        col = (row / piv).index_copy(0, p, piv)
        l[:, i] = col
        diag = torch.clamp(diag - col * col, min=0.0).index_fill(0, p, 0.0)
    return l


def pivoted_cholesky_preconditioner(params: KernelParams, x: torch.Tensor,
                                    rank: int = 100) -> WoodburyPrecond:
    return woodbury_from_factor(_pivoted_cholesky_factor(params, x, rank), params.noise)


def rff_factor(params: KernelParams, x: torch.Tensor, rank: int = 256, *,
               generator: Optional[torch.Generator] = None,
               normals: Optional[torch.Tensor] = None,
               gammas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, rank) random-feature factor L = Φ(x) with E[LLᵀ] = K (§2.2.2): a
    fresh paired sin/cos draw from the kernel's spectral density (or the
    injected base draws), materialised once. ``rank`` must be even."""
    from .rff import make_fourier_features  # deferred: rff imports operators

    if rank % 2:
        raise ValueError(
            f"rff precond rank must be even (paired sin/cos columns); got {rank}"
        )
    d = x.shape[1]
    omega = spectral_sample(params, rank // 2, d,
                            generator=_default_generator(generator, x.device),
                            normals=normals, gammas=gammas)
    return make_fourier_features(params, rank, d, omega=omega).features(x)


PRECOND_FACTOR_METHODS = ("nystrom", "pivoted_cholesky", "rff")


def low_rank_factor(
    params: KernelParams,
    x: torch.Tensor,
    rank: int,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[PrecondDraws] = None,
    method: str = "nystrom",
) -> torch.Tensor:
    """(n, rank) factor L with K(x, x) ≈ L Lᵀ — the ``precond_factor``
    backend of ``Gram``."""
    dr = PrecondDraws() if draws is None else draws
    if method == "nystrom":
        return nystrom_factor(params, x, rank, generator=generator, idx=dr.idx)
    if method == "pivoted_cholesky":
        return _pivoted_cholesky_factor(params, x, rank)
    if method == "rff":
        return rff_factor(params, x, rank, generator=generator, normals=dr.normals,
                          gammas=dr.gammas)
    raise ValueError(
        f"unknown precond factor method {method!r}; expected one of "
        f"{PRECOND_FACTOR_METHODS}"
    )
