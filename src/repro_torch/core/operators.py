"""The ``LinearOperator`` protocol and its feature-side twin ``FeatureOperator``
— the single-device part of ``repro/core/operators.py``.

Every expensive GP computation reduces to solving (K + σ²I) V = B against a
positive-definite matrix touched only through matvecs. The protocol (see
:class:`LinearOperator`) requires ``shape``, ``mv(v)``, ``diag_part()`` and
``noise``; optional capabilities (row blocks, preconditioner factors) are
declared by defining the method, and ``require_capabilities`` refuses a
consumer that needs one the operator lacks. :class:`Gram` offers the row-block
capabilities the stochastic solvers consume (``rows_mv``, ``rows_t_mv``,
``rows_pair_mv``, ``block_at``) and the ``precond_factor`` that the
preconditioner specs build from (core/precond.py). :class:`RFFGram` is the
random-feature surrogate ΦΦᵀ + σ²I, touched through two feature matvecs.
:class:`NormalEq` is the m×m inducing-point normal-equations operator
K_ZX K_XZ + σ²K_ZZ (three cross Gram matvecs), and :class:`LatentKroneckerOp`
the latent Kronecker operator P(K₁ ⊗ K₂)Pᵀ + σ²I of Ch. 6; both are
matvec-only. The sharded operators are not ported yet (ROADMAP queue 1 item
13).

Pathwise conditioning writes every posterior sample as f(·) + K(·, X) w with the
prior f a feature expansion Φ(·) w; :class:`FeatureOperator` is its protocol,
implemented by ``FourierFeatures`` / ``PriorSamples`` (core/rff.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.ops import gram_mv, gram_rows_matvec, gram_rows_pair
from .kernels_fn import KernelParams, gram, gram_diag

#: Capabilities beyond the required ``mv``/``shape``/``diag_part``/``noise``.
OPTIONAL_CAPABILITIES = (
    "rows_mv", "rows_t_mv", "rows_pair_mv", "block_at", "precond_factor"
)

#: FeatureOperator capabilities beyond ``phi_mv``/``num_features``/``shape``.
OPTIONAL_FEATURE_CAPABILITIES = ("features",)


def supports(op, *caps: str) -> bool:
    """True iff ``op`` provides every named capability (method or attribute)."""
    return all(hasattr(op, c) for c in caps)


def capabilities(op, optional: tuple = OPTIONAL_CAPABILITIES) -> tuple:
    """The optional capabilities ``op`` provides (for error messages)."""
    return tuple(c for c in optional if supports(op, c))


def require_capabilities(op, caps, *, consumer: str) -> None:
    """Raise a clear ``TypeError`` if ``op`` lacks any of ``caps``."""
    missing = tuple(c for c in caps if not supports(op, c))
    if missing:
        feature_side = all(c in OPTIONAL_FEATURE_CAPABILITIES for c in missing)
        have = capabilities(
            op, OPTIONAL_FEATURE_CAPABILITIES if feature_side else OPTIONAL_CAPABILITIES
        )
        raise TypeError(
            f"{consumer} needs operator capabilities {missing} that "
            f"{type(op).__name__} does not provide (optional capabilities it "
            f"has: {have or '()'})."
        )


class LinearOperator:
    """Protocol base for the square operators ``solve()`` accepts: ``shape``,
    ``mv``, ``diag_part`` and ``noise`` are required; optional capabilities
    are declared by defining the method."""

    @property
    def shape(self) -> tuple:
        raise NotImplementedError(f"{type(self).__name__} must define shape")

    @property
    def noise(self) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} must define noise")

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} must define mv")

    def diag_part(self) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} must define diag_part")


class FeatureOperator:
    """Protocol base for feature maps Φ into ``num_features`` dimensions,
    touched only through ``phi_mv(x, w)`` = Φ(x) @ w and its transpose
    ``phi_t_mv(x, u)`` = Φ(x)ᵀ @ u."""

    @property
    def num_features(self) -> int:
        raise NotImplementedError(f"{type(self).__name__} must define num_features")

    @property
    def shape(self) -> tuple:
        return (None, self.num_features)

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} must define phi_mv")

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} must define phi_t_mv")


# ---------------------------------------------------------------------------
# Matvec counters of instrumented operators (``instrument=True``): one per
# executed matvec. The loops run on the host, so no callback is needed.
# ---------------------------------------------------------------------------

_RUNTIME_COUNTS = {"mv": 0, "rows": 0}


def reset_matvec_counts() -> None:
    for k in _RUNTIME_COUNTS:
        _RUNTIME_COUNTS[k] = 0


def matvec_counts() -> dict:
    """{"mv": full operator matvecs, "rows": row-block matvecs} executed by
    instrumented operators since the last reset."""
    return dict(_RUNTIME_COUNTS)


@dataclasses.dataclass(frozen=True)
class Gram(LinearOperator):
    """The linear operator A = K(X,X) + σ² I, touched only through matvecs.

    ``backend`` selects the matvec implementation (see kernels/ops.py):
    ``"auto"`` (the CUDA kernel on the card, chunked on the CPU), ``"cuda"``,
    ``"chunked"`` or ``"dense"``; a solver spec can pin it per solve.
    ``instrument=True`` counts executed matvecs in ``matvec_counts()``.
    """

    x: torch.Tensor  # (n, d) training inputs
    params: KernelParams
    row_chunk: int = 2048
    backend: str = "auto"
    precision: str = "fp32"
    instrument: bool = False

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def shape(self) -> tuple:
        return (self.n, self.n)

    @property
    def noise(self) -> torch.Tensor:
        return self.params.noise

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """(K + σ²I) @ v without materialising K. v: (n,) or (n, s)."""
        out = gram_mv(
            self.params, self.x, v, jitter=self.noise, backend=self.backend,
            row_chunk=self.row_chunk, precision=self.precision,
        )
        if self.instrument:
            _RUNTIME_COUNTS["mv"] += 1
        return out

    def mv_k(self, v: torch.Tensor) -> torch.Tensor:
        """K @ v (no jitter)."""
        out = gram_mv(self.params, self.x, v, backend=self.backend,
                      row_chunk=self.row_chunk, precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["mv"] += 1
        return out

    def diag_part(self) -> torch.Tensor:
        """diag(K + σ²I) — (n,)."""
        return gram_diag(self.params, self.x) + self.noise

    def rows_mv(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K[idx, :] @ u, the panel never materialised on ``cuda``.
        u: (n,) or (n, s) → (|idx|, s-like)."""
        out = gram_rows_matvec(self.params, self.x, idx, u, backend=self.backend,
                               precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out

    def rows_t_mv(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K[idx, :]ᵀ @ u = K[:, idx] @ u. u: (|idx|,) or (|idx|, s) → (n, s-like)."""
        out = gram_rows_matvec(self.params, self.x, idx, u, transpose=True,
                               backend=self.backend, precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out

    def rows_pair_mv(self, idx: torch.Tensor, look: torch.Tensor,
                     b: torch.Tensor) -> tuple:
        """SGD's pair step: ``err = K[idx,:] @ look − b`` and
        ``g = K[idx,:]ᵀ @ err`` in one dispatch, counted as two row-block
        matvecs (the work it replaces). look: (n, s); b: (|idx|, s)."""
        err, g = gram_rows_pair(self.params, self.x, idx, look, b,
                                backend=self.backend, precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 2
        return err, g

    def block_at(self, idx: torch.Tensor) -> torch.Tensor:
        """K[idx, idx], the |idx|×|idx| principal block (AP's exact sub-solve),
        plain ``gram`` on the gathered points as in the reference."""
        xi = self.x[idx]
        return gram(self.params, xi, xi)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """K[idx, :] materialised — O(|idx|·n) memory; the solvers use the
        fused ``rows_mv``/``rows_t_mv``/``block_at`` instead."""
        return gram(self.params, self.x[idx], self.x)

    def precond_factor(self, rank: int, *, generator: Optional[torch.Generator] = None,
                       draws=None, method: str = "nystrom") -> torch.Tensor:
        """(n, rank) factor L with K ≈ L Lᵀ for Woodbury preconditioning; the
        random draws from ``generator`` or injected ``draws``
        (``PrecondDraws``)."""
        from .precond import low_rank_factor  # deferred: precond imports operators

        return low_rank_factor(self.params, self.x, rank, generator=generator, draws=draws,
                               method=method)

    def dense(self) -> torch.Tensor:
        """Materialised K + σ²I (tests / small-n reference only)."""
        eye = torch.eye(self.n, dtype=self.x.dtype, device=self.x.device)
        return gram(self.params, self.x) + self.noise * eye


@dataclasses.dataclass(frozen=True)
class RFFGram(LinearOperator):
    """The operator A = Φ(X) Φ(X)ᵀ + σ² I — the random-feature surrogate of
    the Gram operator, touched only through two feature matvecs per ``mv``
    (on the card, the RFF kernel in its Φ̃ᵀu and Φ̃W orientations). Its
    ``precond_factor`` is the materialised Φ, an exact factor, so the ``RFF``
    preconditioner inverts it exactly.
    """

    x: torch.Tensor  # (n, d) training inputs
    ff: "FeatureOperator"  # the feature map (a FourierFeatures)
    sigma2: torch.Tensor  # () noise variance σ²
    # feature-matvec backend/precision overrides; None inherits the ff's own.
    # A spec's ``backend``/``precision`` fields pin them through solve().
    backend: Optional[str] = None
    precision: Optional[str] = None

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def shape(self) -> tuple:
        return (self.n, self.n)

    @property
    def noise(self) -> torch.Tensor:
        return self.sigma2

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """(ΦΦᵀ + σ²I) @ v = Φ(Φᵀv) + σ²v — two feature matvecs."""
        bk, pr = self.backend, self.precision
        t = self.ff.phi_t_mv(self.x, v, backend=bk, precision=pr)
        return self.ff.phi_mv(self.x, t, backend=bk, precision=pr) + self.sigma2 * v

    def diag_part(self) -> torch.Tensor:
        """diag(ΦΦᵀ) + σ². Paired sin/cos features satisfy Σ_j Φ_ij² = σ_f²
        exactly (sin² + cos² = 1 per frequency); the cos-only map needs the
        materialised rows."""
        if getattr(self.ff, "paired", True):
            return torch.broadcast_to(self.ff.signal, (self.n,)) + self.sigma2
        return torch.sum(self.ff.features(self.x) ** 2, dim=1) + self.sigma2

    def precond_factor(self, rank: int, *, generator: Optional[torch.Generator] = None,
                       draws=None, method: str = "rff") -> torch.Tensor:
        """The materialised feature matrix Φ — an *exact* factor. Only
        ``method="rff"`` is meaningful: a Nyström or pivoted-Cholesky request
        would silently get a factor of the operator's full feature count, so
        it raises. ``rank``, ``generator`` and ``draws`` are accepted for
        interface parity and ignored."""
        if method != "rff":
            raise ValueError(
                f"RFFGram's only factor is its own feature matrix (method "
                f"'rff', {self.ff.num_features} columns); a {method!r} factor "
                f"of rank {rank} is not available — use CG(precond=RFF()) or "
                f"Jacobi() on this operator"
            )
        require_capabilities(self.ff, ("features",), consumer="RFFGram.precond_factor")
        return self.ff.features(self.x)

    def dense(self) -> torch.Tensor:
        """Materialised ΦΦᵀ + σ²I (tests / small-n reference only)."""
        phi = self.ff.features(self.x)
        eye = torch.eye(self.n, dtype=self.x.dtype, device=self.x.device)
        return phi @ phi.T + self.sigma2 * eye


# ---------------------------------------------------------------------------
# NormalEq — inducing-point normal equations (§3.2.3), matvec-only
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NormalEq(LinearOperator):
    """The m×m operator K_ZX K_XZ + σ² K_ZZ (+ ridge·I), touched only through
    matvecs.

    Matvec-only (no kernel-row capabilities, no ``precond_factor``), so only
    CG-family specs without a factor preconditioner drive it through
    ``solve()``: SGD, SDD, AP and ``Nystrom`` are refused with a capability
    error. Used by ``inducing_posterior`` (Eqs. 3.23/3.24) and the iterative
    SGPR path (``svgp.sgpr_iterative``): K_ZX K_XZ + σ²K_ZZ = σ²·B with B the
    Titsias matrix K_ZZ + σ⁻²K_ZX K_XZ.

    ``backend`` selects the Gram matvec path of its three products (K_XZ·u,
    K_ZX·(K_XZ·u), K_ZZ·u) as :class:`Gram`'s does: ``"auto"`` is the CUDA
    kernel on the cross shapes n × m and m × n on the card and the chunked
    matvec on the CPU. A spec's ``backend`` pins it per solve, as it pins
    ``Gram``'s. ``ridge`` adds ridge·I — the iterative SGPR path's copy of the
    dense path's fp32-stabilising ridge.
    """

    x: torch.Tensor  # (n, d) training inputs
    z: torch.Tensor  # (m, d) inducing inputs
    params: KernelParams
    ridge: object = 0.0  # additive ridge·I: a float or a 0-d tensor (0 = the pure operator)
    row_chunk: int = 4096
    backend: str = "auto"
    precision: str = "fp32"

    @property
    def shape(self) -> tuple:
        return (self.z.shape[0], self.z.shape[0])

    @property
    def noise(self) -> torch.Tensor:
        return self.params.noise

    def _mv(self, rows: torch.Tensor, v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        return gram_mv(self.params, rows, v, z=cols, backend=self.backend,
                       row_chunk=self.row_chunk, precision=self.precision)

    def mv(self, u: torch.Tensor) -> torch.Tensor:
        """(K_ZX K_XZ + σ² K_ZZ + ridge·I) @ u without materialising K_XZ (n×m):
        three Gram matvecs."""
        kxz_u = self._mv(self.x, u, self.z)
        kzx_kxz_u = self._mv(self.z, kxz_u, self.x)
        kzz_u = self._mv(self.z, u, self.z)
        return kzx_kxz_u + self.params.noise * kzz_u + self.ridge * u

    def diag_part(self) -> torch.Tensor:
        """diag(K_ZX K_XZ) + σ²·diag(K_ZZ) + ridge: Σᵢ k(xᵢ, z_j)² in row
        chunks of X, never the whole n×m block."""
        sq = sum(torch.sum(gram(self.params, self.x[i:i + self.row_chunk], self.z) ** 2, dim=0)
                 for i in range(0, self.x.shape[0], self.row_chunk))
        return sq + self.params.noise * gram_diag(self.params, self.z) + self.ridge


# ---------------------------------------------------------------------------
# LatentKroneckerOp — Ch. 6 structured operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatentKroneckerOp(LinearOperator):
    """(P_M (K₁ ⊗ K₂) P_Mᵀ + σ²I) as a LinearOperator (§6.2.2–6.2.3).

    Wraps a :class:`~repro_torch.core.kronecker.LatentKroneckerGP`: the matvec
    costs O(n₁n₂(n₁+n₂)) through the latent Kronecker identity (two dense
    products over the factors) instead of O(n_obs²). Matvec-only: SGD, SDD,
    AP and factor preconditioners are refused with a capability error;
    ``Jacobi`` builds from ``diag_part``. ``instrument=True`` counts executed
    matvecs in ``matvec_counts()``.
    """

    gp: "LatentKroneckerGP"  # noqa: F821 (core/kronecker.py)
    instrument: bool = False

    @property
    def shape(self) -> tuple:
        n_obs = self.gp.obs_idx.shape[0]
        return (n_obs, n_obs)

    @property
    def noise(self) -> torch.Tensor:
        return self.gp.noise

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """(K_obs + σ²I) @ v via the latent Kronecker matvec (§6.2.3)."""
        out = self.gp.mv(v)
        if self.instrument:
            _RUNTIME_COUNTS["mv"] += 1
        return out

    def diag_part(self) -> torch.Tensor:
        """diag(K_obs) + σ² = d₁[i₁]·d₂[i₂] at each observed grid index + σ²."""
        n2 = self.gp.shape[1]
        d1 = gram_diag(self.gp.params1, self.gp.grid1)
        d2 = gram_diag(self.gp.params2, self.gp.grid2)
        return d1[self.gp.obs_idx // n2] * d2[self.gp.obs_idx % n2] + self.gp.noise
