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
matvec-only. :class:`ShardedGram` is the Gram operator with its training rows
split over the ranks of a ``torch.distributed`` mesh (one process a shard),
combined by the collectives of core/collectives.py; it tells the solvers how
their vectors lie through its ``layout`` (:class:`Replicated` for every other
operator).

Pathwise conditioning writes every posterior sample as f(·) + K(·, X) w with the
prior f a feature expansion Φ(·) w; :class:`FeatureOperator` is its protocol,
implemented by ``FourierFeatures`` / ``PriorSamples`` (core/rff.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..kernels.ops import gram_mv, gram_rows_matvec, gram_rows_pair
from . import collectives as coll
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
    ``block`` sets the CUDA launches' chunks (the fewest K-loop columns a
    chunk holds, a multiple of 64); the ``"auto"`` default resolves per call
    from its shapes (``kernels/autotune.py``).
    ``instrument=True`` counts executed matvecs in ``matvec_counts()``.
    """

    x: torch.Tensor  # (n, d) training inputs
    params: KernelParams
    row_chunk: int = 2048
    backend: str = "auto"
    block: "int | str" = "auto"
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
            block=self.block, row_chunk=self.row_chunk, precision=self.precision,
        )
        if self.instrument:
            _RUNTIME_COUNTS["mv"] += 1
        return out

    def mv_k(self, v: torch.Tensor) -> torch.Tensor:
        """K @ v (no jitter)."""
        out = gram_mv(self.params, self.x, v, backend=self.backend, block=self.block,
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
                               block=self.block, precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out

    def rows_t_mv(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K[idx, :]ᵀ @ u = K[:, idx] @ u. u: (|idx|,) or (|idx|, s) → (n, s-like)."""
        out = gram_rows_matvec(self.params, self.x, idx, u, transpose=True,
                               backend=self.backend, block=self.block,
                               precision=self.precision)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out

    def rows_pair_mv(self, idx: torch.Tensor, look: torch.Tensor,
                     b: torch.Tensor) -> tuple:
        """SGD's pair step: ``err = K[idx,:] @ look − b`` and
        ``g = K[idx,:]ᵀ @ err`` in one dispatch, counted as two row-block
        matvecs (the work it replaces). look: (n, s); b: (|idx|, s)."""
        err, g = gram_rows_pair(self.params, self.x, idx, look, b, backend=self.backend,
                                block=self.block, precision=self.precision)
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


# ---------------------------------------------------------------------------
# Vector layouts: how a solver's vectors lie across the ranks
# ---------------------------------------------------------------------------


class Replicated:
    """A solver's vectors whole on every rank: one device, or a
    :class:`ShardedGram` under gather. The solvers reach every step that
    crosses rows through their operator's layout (:func:`layout_of`), so a
    row-sharded operator can make each one explicit (JAX's sharding
    propagation does them unasked in the reference):

    * ``iterate(v)`` — a right-hand side, warm start or δ in the iterate's
      layout;
    * ``local(v)`` / ``from_local(v)`` — an iterate to this rank's rows and
      back (SGD's regulariser runs on row blocks);
    * ``take(v, idx)`` — ``v[idx]``, whole on every rank;
    * ``index_add_(v, idx, vals)`` — ``v.index_add_(0, idx, vals)``, in place
      on ``v`` (the solvers pass a tensor of their own);
    * ``reduce`` — None here; where the rows are split, a callable that sums
      the ranks' partial column reductions (the same bits on every rank).
    """

    reduce: Optional[Callable] = None

    def iterate(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def local(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def from_local(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def take(self, v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return v[idx]

    def index_add_(self, v: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return v.index_add_(0, idx, vals)


REPLICATED = Replicated()


def layout_of(op) -> Replicated:
    """The layout of ``op``'s vectors: its own ``layout``, else replicated."""
    return getattr(op, "layout", REPLICATED)


def _rows_of(v: torch.Tensor, lo: int, n_local: int, n: int) -> torch.Tensor:
    """This rank's rows [lo, lo + n_local) of a whole (n, ...) tensor; a row
    block (n_local, ...) passes as it is."""
    if v.shape[0] == n_local:
        return v
    if v.shape[0] == n:
        return v[lo:lo + n_local]
    raise ValueError(
        f"a vector of {v.shape[0]} rows is neither whole ({n}) nor this rank's "
        f"block ({n_local})"
    )


@dataclasses.dataclass(frozen=True)
class _GatherLayout(Replicated):
    """Vectors whole on every rank of ``group``; this rank's rows are
    [lo, lo + n_local)."""

    group: object
    lo: int
    n_local: int

    def local(self, v: torch.Tensor) -> torch.Tensor:
        return v[self.lo:self.lo + self.n_local]

    def from_local(self, v: torch.Tensor) -> torch.Tensor:
        return coll.all_gather_rows(v, self.group)


@dataclasses.dataclass(frozen=True)
class _RingLayout(Replicated):
    """Iterates as row blocks, rank i's rows [i·n_local, (i+1)·n_local) of n.
    A whole vector (a replicated right-hand side) is read where it lies; a
    row block is gathered by a masked psum and scattered into locally."""

    group: object
    lo: int
    n_local: int
    n: int

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        return coll.psum(partial, self.group)

    def iterate(self, v: torch.Tensor) -> torch.Tensor:
        return _rows_of(v, self.lo, self.n_local, self.n)

    def take(self, v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if v.shape[0] == self.n:
            return v[idx]
        return _psum_row_gather(v, idx, self.group)

    def index_add_(self, v: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        rel = idx - self.lo
        mask = ((rel >= 0) & (rel < self.n_local))[:, None]
        return v.index_add_(0, rel.clamp(0, self.n_local - 1),
                           torch.where(mask, vals, torch.zeros_like(vals)))


# ---------------------------------------------------------------------------
# ShardedGram — the Gram operator with its rows split over ranks
# ---------------------------------------------------------------------------

#: Communication strategies for :class:`ShardedGram` (docs/distributed.md):
#: ``gather`` all-gathers the inputs (and results) around each matvec;
#: ``ring`` rotates the shard pairs around the ranks against the per-shard
#: contraction, so the (n, d) panel is never replicated and no matvec
#: all-gathers; ``auto`` picks ring once the replicated panel would exceed the
#: operator's byte budget.
COMM_STRATEGIES = ("gather", "ring", "auto")


def _psum_row_gather(x_local: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """``x_full[idx]`` without replicating x: every rank contributes the
    ``idx`` rows that live in its block (others zeroed) and a psum adds them.
    Moves O(|idx|·d) bytes, not the O(n·d) of an all-gather. Assumes the
    canonical block-row layout (rank i holds rows [i·n_local, (i+1)·n_local)),
    which :meth:`ShardedGram.check_layout` verifies."""
    n_local = x_local.shape[0]
    rel = idx - coll.axis_index(group) * n_local
    mask = ((rel >= 0) & (rel < n_local)).reshape(-1, *([1] * (x_local.ndim - 1)))
    rows = x_local[rel.clamp(0, n_local - 1)]
    return coll.psum(torch.where(mask, rows, torch.zeros_like(rows)), group)


@dataclasses.dataclass(frozen=True)
class ShardedGram(LinearOperator):
    """(K(X,X) + σ²I) with the training rows split over the ranks of
    ``mesh``'s ``data_axes``: SPMD, one process a shard, each holding ``x``,
    its block of the canonical block-row layout (rank i the rows
    [i·n/P, (i+1)·n/P); :func:`~repro_torch.core.distributed.shard_training_rows`).

    Each rank contracts its block row without materialising it: the
    per-shard products go through ``gram_mv``, so on the card every shard
    pair is a launch of the Gram kernel. ``comm`` picks the schedule
    (:data:`COMM_STRATEGIES`):

    * ``"gather"`` — ``mv`` all-gathers x, contracts K(x_local, X) @ v in one
      launch and all-gathers the result: vectors whole on every rank, in and
      out (two all-gathers a matvec; one with ``gather_once``).
    * ``"ring"`` — P stages: stage t contracts K(x_local, x_peer) @ v_peer
      while the shift of the next (x_peer, v_peer) is in flight (issued
      before the launch, waited on after it). ``mv`` maps row blocks to row
      blocks; no all-gather, 2(P − 1) shifts a matvec. Row gathers go
      through a masked psum of |idx| rows.
    * ``"auto"`` — ring once the replicated (n, d) panel exceeds
      ``comm_budget_bytes``, gather otherwise (and at P = 1 or with
      ``gather_once``).

    The row primitives: ``rows_mv`` psum-reduces the ranks' column blocks
    K(x[idx], x_local) @ u_local (whole result); ``rows_t_mv`` computes row
    blocks K(x_local, x[idx]) @ u, all-gathered under gather and left as row
    blocks under ring; ``block_at`` is the plain |idx|² block on the gathered
    rows. ``layout`` tells the solvers how their vectors lie (row blocks
    under ring, with psum-reduced column sums). ``wrap_features`` wraps SGD's
    fresh feature map so its pair step runs per shard
    (:class:`~repro_torch.core.rff.ShardedFourierFeatures`).

    ``gather_once=True`` replicates x once a solve (``prepare_for_solve``,
    called by ``solve()`` outside the loop) into ``x_full``; it is the
    opposite trade to ring, so the two together raise ``ValueError``.
    """

    x: torch.Tensor  # (n/P, d) this rank's block of the training inputs
    params: KernelParams
    mesh: object  # a torch.distributed DeviceMesh
    data_axes: tuple = ("data",)
    row_chunk: int = 2048
    backend: str = "auto"
    block: "int | str" = "auto"  # every shard's launches (see ``Gram.block``)
    precision: str = "fp32"
    instrument: bool = False
    # the replicated input panel, set by prepare_for_solve() under gather_once
    x_full: Optional[torch.Tensor] = None
    gather_once: bool = False
    comm: str = "gather"
    # "auto" switches to ring when the replicated (n, d) panel exceeds this
    comm_budget_bytes: int = 128 * 2**20

    def __post_init__(self):
        if self.comm not in COMM_STRATEGIES:
            raise ValueError(
                f"unknown comm strategy {self.comm!r}; expected one of "
                f"{COMM_STRATEGIES}"
            )
        if self.comm == "ring" and self.gather_once:
            raise ValueError(
                "gather_once=True replicates the O(n·d) input panel that "
                "comm='ring' exists to avoid — pick one: gather_once with "
                "comm='gather', or comm='ring' alone (comm='auto' resolves "
                "to gather when gather_once is set)"
            )

    @property
    def _group(self):
        return coll.axis_group(self.mesh, self.data_axes)

    def _mesh_size(self) -> int:
        """Ranks along ``data_axes``: the ring's pipeline depth P."""
        return coll.axis_size(self._group)

    @property
    def n(self) -> int:
        return self.x.shape[0] * self._mesh_size()

    @property
    def shape(self) -> tuple:
        return (self.n, self.n)

    @property
    def noise(self) -> torch.Tensor:
        return self.params.noise

    def _local_mv(self, x_local: torch.Tensor, x_other: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        """K(x_local, x_other) @ v through ``gram_mv`` (no jitter)."""
        return gram_mv(self.params, x_local, v, z=x_other, backend=self.backend,
                       block=self.block, row_chunk=self.row_chunk, precision=self.precision)

    def _resolve_comm(self) -> str:
        """The effective strategy: ``auto`` → ring once the replicated (n, d)
        panel would exceed ``comm_budget_bytes`` (gather under
        ``gather_once``, which asked for the panel, and at P = 1)."""
        if self.comm != "auto":
            return self.comm
        if self.gather_once or self._mesh_size() == 1:
            return "gather"
        panel_bytes = self.n * self.x.shape[1] * self.x.element_size()
        return "ring" if panel_bytes > self.comm_budget_bytes else "gather"

    @property
    def layout(self) -> Replicated:
        g, n_local = self._group, self.x.shape[0]
        lo = coll.axis_index(g) * n_local
        if self._resolve_comm() == "ring":
            return _RingLayout(group=g, lo=lo, n_local=n_local, n=self.n)
        return _GatherLayout(group=g, lo=lo, n_local=n_local)

    def _local(self, v: torch.Tensor) -> torch.Tensor:
        n_local = self.x.shape[0]
        return _rows_of(v, coll.axis_index(self._group) * n_local, n_local, self.n)

    def _x_all(self) -> torch.Tensor:
        """The whole (n, d) panel: the cached ``x_full``, else an all-gather."""
        if self.x_full is not None:
            return self.x_full
        return coll.all_gather_rows(self.x, self._group)

    def _gather_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """x[idx] whole on every rank: from ``x_full`` (gather_once), a masked
        psum of |idx| rows (ring), or the all-gathered panel (gather, which
        pays the O(n·d) all-gather to index it)."""
        if self.x_full is None and self._resolve_comm() == "ring":
            return _psum_row_gather(self.x, idx, self._group)
        return self._x_all()[idx]

    def check_layout(self) -> None:
        """Raise ``ValueError`` unless every rank holds the same number of
        rows — the canonical block-row layout that the masked row gathers and
        the ring assume (n % P == 0). One all-gather of the row counts."""
        g = self._group
        counts = coll.all_gather_rows(
            torch.tensor([self.x.shape[0]], device=self.x.device), g).tolist()
        if len(set(counts)) != 1:
            raise ValueError(
                f"ShardedGram needs the canonical block-row layout, n/P rows on "
                f"every rank (n % P == 0); the {len(counts)} ranks hold {counts} rows"
            )

    def prepare_for_solve(self) -> "ShardedGram":
        """Per-solve setup (``solve()`` calls it once, outside the loop):
        :meth:`check_layout`, so that uneven blocks raise before any
        collective of the loop, then with ``gather_once`` replicate x into
        ``x_full`` so that no matvec of the loop all-gathers it."""
        self.check_layout()
        if not self.gather_once or self.x_full is not None:
            return self
        return dataclasses.replace(self, x_full=coll.all_gather_rows(self.x, self._group))

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        """(K + σ²I) @ v under the resolved strategy. gather: v whole (n, s),
        result whole; ring: v this rank's (n/P, s) block, result its block."""
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        g = self._group
        if self._resolve_comm() == "ring":
            p_size = coll.axis_size(g)
            out = self.noise * v2
            x_peer, v_peer = self.x, v2
            for t in range(p_size):
                # stage t+1's shift is issued before stage t's launch and
                # waited on after it, so the move overlaps the contraction
                nxt = coll.ring_shift((x_peer, v_peer), g) if t + 1 < p_size else None
                out = out + self._local_mv(self.x, x_peer, v_peer)
                if nxt is not None:
                    x_peer, v_peer = nxt.wait()
        else:
            out = self._local_mv(self.x, self._x_all(), v2) + self.noise * self._local(v2)
            out = coll.all_gather_rows(out, g)
        if self.instrument:
            _RUNTIME_COUNTS["mv"] += 1
        return out[:, 0] if squeeze else out

    def _rows_mv_at(self, xi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K(xi, X) @ u for gathered rows xi: each rank's column block
        K(xi, x_local) @ u_local, psum-reduced."""
        return coll.psum(self._local_mv(xi, self.x, self._local(u)), self._group)

    def _rows_t_mv_at(self, xi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K(X, xi) @ u: this rank's row block, all-gathered unless ring."""
        out = self._local_mv(self.x, xi, u)
        return out if self._resolve_comm() == "ring" else coll.all_gather_rows(out, self._group)

    def rows_mv(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K[idx, :] @ u: each rank contracts its column block
        K(x[idx], x_local) @ u_local and a psum adds them. u: whole or this
        rank's rows; the (|idx|, s-like) result is whole on every rank."""
        squeeze = u.ndim == 1
        out = self._rows_mv_at(self._gather_rows(idx), u[:, None] if squeeze else u)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out[:, 0] if squeeze else out

    def rows_t_mv(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """K[idx, :]ᵀ @ u = K[:, idx] @ u: each rank computes its row block
        K(x_local, x[idx]) @ u (u: (|idx|, s-like), whole). Under gather the
        blocks are all-gathered into a whole (n, s-like); under ring the
        result stays this rank's block."""
        squeeze = u.ndim == 1
        out = self._rows_t_mv_at(self._gather_rows(idx), u[:, None] if squeeze else u)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 1
        return out[:, 0] if squeeze else out

    def rows_pair_mv(self, idx: torch.Tensor, look: torch.Tensor, b: torch.Tensor) -> tuple:
        """err = K[idx,:] @ look − b, then g = K[idx,:]ᵀ @ err: the two row
        primitives on x[idx] gathered once (no single launch spans the
        collectives); counted as two row-block matvecs."""
        xi = self._gather_rows(idx)
        err = self._rows_mv_at(xi, look) - b
        g = self._rows_t_mv_at(xi, err)
        if self.instrument:
            _RUNTIME_COUNTS["rows"] += 2
        return err, g

    def block_at(self, idx: torch.Tensor) -> torch.Tensor:
        """K[idx, idx], plain ``gram`` on the gathered rows, whole on every
        rank."""
        xi = self._gather_rows(idx)
        return gram(self.params, xi, xi)

    def wrap_features(self, ff: "FeatureOperator") -> "FeatureOperator":
        """SGD's mesh capability: ``ff`` with its matvecs run per shard over
        this operator's mesh (row blocks in and out, the transposes
        psum-reduced, the (n, 2m) feature matrix never built)."""
        from .rff import ShardedFourierFeatures  # deferred: rff imports this module

        return ShardedFourierFeatures(inner=ff, mesh=self.mesh, data_axes=self.data_axes)

    def diag_part(self) -> torch.Tensor:
        """diag(K + σ²I) in the vectors' layout: this rank's rows under ring,
        whole otherwise."""
        if self.x_full is not None:
            return gram_diag(self.params, self.x_full) + self.noise
        local = gram_diag(self.params, self.x) + self.noise
        return self.layout.from_local(local)

    def precond_factor(self, rank: int, *, generator: Optional[torch.Generator] = None,
                       draws=None, method: str = "nystrom") -> torch.Tensor:
        """The (n, rank) factor with global semantics, as the reference builds
        it: on the whole panel, the same on every rank (draws from generators
        seeded alike, or injected)."""
        from .precond import low_rank_factor  # deferred: precond imports operators

        return low_rank_factor(self.params, self._x_all(), rank, generator=generator,
                               draws=draws, method=method)

    def dense(self) -> torch.Tensor:
        """Materialised K + σ²I, whole (tests / small-n reference only)."""
        x_all = self._x_all()
        eye = torch.eye(x_all.shape[0], dtype=x_all.dtype, device=x_all.device)
        return gram(self.params, x_all) + self.noise * eye
