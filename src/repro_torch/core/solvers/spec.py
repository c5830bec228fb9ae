"""Declarative solver configuration and the single ``solve()`` entry point —
twin of ``repro/core/solvers/spec.py``.

Frozen spec dataclasses describe *how* to solve (``CG``, ``SGD``, ``SDD``,
``AP``) and how to precondition (``Nystrom``, ``PivotedCholesky``, ``RFF``,
``Jacobi``); registries map names to spec classes, and every spec
round-trips through JSON as a tagged dict of its fields, with the
reference's tags and field names. ``solve(op, b, spec, generator=...,
draws=..., x0=..., delta=...)`` handles random draws, warm starts, backend
pinning, preconditioner builds and capability checks for any
:class:`~repro_torch.core.operators.LinearOperator`; ``solve_batched`` and
``solve_bordered`` build on it.

The system solved is always

    (K + σ²I) V = b + σ² δ

where ``delta`` is an optional extra channel: pathwise sampling passes δ = ε/σ².
SGD keeps δ in its regulariser (Eq. 3.6); CG, SDD and AP fold σ²δ into the
right-hand side, which is algebraically identical.

The stochastic solvers draw from a ``torch.Generator`` (the twin of the
reference's PRNG key) or take injected draws (``SGDDraws``, ``RowDraws``);
``solve()`` refuses a stochastic spec that has neither. A preconditioned CG
takes ``PrecondDraws`` (the Nyström subset, the RFF frequencies) the same
way, and without either draws from a generator seeded 0, as the reference
falls back to ``PRNGKey(0)``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple, Type, Union

import torch

from ...kernels.ops import BACKENDS, FEATURE_BACKENDS, PRECISIONS
from ..operators import layout_of, require_capabilities
from ..precond import cholesky_or_nan, jacobi_preconditioner, woodbury_from_factor
from .ap import solve_ap
from .base import SolveResult, as_matrix_rhs
from .cg import solve_cg
from .sdd import solve_sdd
from .sgd import solve_sgd

# ---------------------------------------------------------------------------
# Preconditioner specs (§2.2.4; built on core/precond.py)
# ---------------------------------------------------------------------------

_PRECOND_REGISTRY: Dict[str, type] = {}


def register_precond(name: str, cls: Optional[type] = None):
    """Register a preconditioner spec class under a string name (decorator)."""

    def deco(c: type) -> type:
        c.name = name
        _PRECOND_REGISTRY[name] = c
        return c

    return deco(cls) if cls is not None else deco


def get_precond(name: str) -> type:
    try:
        return _PRECOND_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown preconditioner {name!r}; registered: {sorted(_PRECOND_REGISTRY)}"
        ) from None


def registered_preconds() -> tuple:
    return tuple(sorted(_PRECOND_REGISTRY))


class _JsonSpecMixin:
    """``to_json``/``from_json`` shared by solver and preconditioner specs:
    a spec is a tagged dict of its fields; a nested preconditioner spec is a
    tagged dict too, and a prebuilt apply refuses to serialize."""

    def to_json(self, **dumps_kwargs: Any) -> str:
        return spec_to_json(self, **dumps_kwargs)

    @staticmethod
    def from_json(s: str) -> Any:
        return spec_from_json(s)


class _FactorPrecondSpec(_JsonSpecMixin):
    """Preconditioner specs built from an operator's ``precond_factor``
    capability: L = op.precond_factor(rank, method=...) with K ≈ LLᵀ, wrapped
    in the Woodbury apply (LLᵀ + σ²I)⁻¹."""

    method: ClassVar[str] = "?"

    def build(self, op, *, generator: Optional[torch.Generator] = None,
              draws: Any = None) -> Callable:
        require_capabilities(
            op, ("precond_factor",), consumer=f"the {self.name!r} preconditioner"
        )
        l = op.precond_factor(self.rank, generator=generator, draws=draws,
                              method=self.method)
        return woodbury_from_factor(l, op.noise, layout=layout_of(op))


@register_precond("nystrom")
@dataclasses.dataclass(frozen=True)
class Nystrom(_FactorPrecondSpec):
    """Uniform-subset Nyström preconditioner: rank-m surrogate + Woodbury
    apply. Draws: ``PrecondDraws(idx=...)``."""

    method: ClassVar[str] = "nystrom"
    rank: int = 100


@register_precond("pivoted_cholesky")
@dataclasses.dataclass(frozen=True)
class PivotedCholesky(_FactorPrecondSpec):
    """Greedy pivoted-Cholesky preconditioner (sequential build, no draws)."""

    method: ClassVar[str] = "pivoted_cholesky"
    rank: int = 100


@register_precond("rff")
@dataclasses.dataclass(frozen=True)
class RFF(_FactorPrecondSpec):
    """Random-feature preconditioner: L = Φ(x), E[LLᵀ] = K. ``rank`` counts
    feature *columns* (even: paired sin/cos). On ``RFFGram`` the factor is
    the operator's own Φ and Woodbury is the exact inverse. Draws:
    ``PrecondDraws(normals=..., gammas=...)``."""

    method: ClassVar[str] = "rff"
    rank: int = 256


@register_precond("jacobi")
@dataclasses.dataclass(frozen=True)
class Jacobi(_JsonSpecMixin):
    """Diagonal (Jacobi) preconditioner from the protocol's *required*
    ``diag_part()``: works on every operator ``solve()`` accepts."""

    def build(self, op, *, generator: Optional[torch.Generator] = None,
              draws: Any = None) -> Callable:
        return jacobi_preconditioner(op)


PrecondSpec = Union[Nystrom, PivotedCholesky, RFF, Jacobi]
# a raw ``r -> M⁻¹r`` callable is also accepted wherever a PrecondSpec fits
PrecondLike = Union[Nystrom, PivotedCholesky, RFF, Jacobi, Callable]


# ---------------------------------------------------------------------------
# Solver specs + registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type["SolverSpec"]] = {}


def register_solver(name: str, cls: Optional[type] = None):
    """Register a spec class under a string name (usable as a decorator)."""

    def deco(c: type) -> type:
        c.name = name
        _REGISTRY[name] = c
        return c

    return deco(cls) if cls is not None else deco


def get_solver(name: str) -> Type["SolverSpec"]:
    """String → spec class lookup; raises on unknown names."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered solvers: {sorted(_REGISTRY)}"
        ) from None


def registered_solvers() -> tuple:
    return tuple(sorted(_REGISTRY))


class SolverSpec(_JsonSpecMixin):
    """Base class for declarative solver configs. ``run`` maps the spec onto
    the solver function; consumers go through ``solve()``. ``needs`` declares
    the operator capabilities the solver consumes beyond the required ones.
    ``backend`` / ``precision`` fields, where not None, pin the operator's
    matvec backend and tile precision for the solve."""

    name: ClassVar[str] = "?"
    #: stochastic solvers need a generator or injected draws
    requires_generator: ClassVar[bool] = False
    needs: ClassVar[Tuple[str, ...]] = ()

    def run(self, op, b: torch.Tensor, *, generator: Optional[torch.Generator] = None,
            draws: Any = None, x0: Optional[torch.Tensor] = None,
            delta: Optional[torch.Tensor] = None) -> SolveResult:
        raise NotImplementedError


def _fold_delta(op, b: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold the δ channel into the RHS: (K+σ²I)V = b + σ²δ."""
    return b if delta is None else b + op.noise * delta


@register_solver("cg")
@dataclasses.dataclass(frozen=True)
class CG(SolverSpec):
    """Conjugate gradients (§2.2.4), optionally preconditioned. ``precond``
    is a preconditioner spec, built once per solve (it depends on the
    hyperparameters), or a prebuilt ``r -> M⁻¹r`` apply. Draws: the
    preconditioner's ``PrecondDraws``."""

    max_iters: int = 1000
    tol: float = 1e-2
    precond: Optional[PrecondLike] = None
    backend: Optional[str] = None
    precision: Optional[str] = None
    # iterations without relative residual improvement before FLAG_STAGNATION
    # is raised on a column (advisory)
    stall_window: int = 100

    def run(self, op, b, *, generator=None, draws=None, x0=None,
            delta=None) -> SolveResult:
        pc = self.precond
        if pc is not None and not callable(pc):
            if not hasattr(pc, "build"):
                raise TypeError(
                    f"CG's precond must be a preconditioner spec ({registered_preconds()}) "
                    f"or an r -> M⁻¹r callable; got {pc!r}"
                )
            pc = pc.build(op, generator=generator, draws=draws)
        return solve_cg(
            op, _fold_delta(op, b, delta), x0,
            max_iters=self.max_iters, tol=self.tol, precond=pc,
            stall_window=self.stall_window,
        )


@register_solver("sgd")
@dataclasses.dataclass(frozen=True)
class SGD(SolverSpec):
    """Primal stochastic gradient descent (Ch. 3), the only solver with a
    native δ channel (Eq. 3.6). Its fresh-feature regulariser samples
    frequencies from the operator's kernel and evaluates them on its inputs,
    so the operator must expose ``x`` and ``params``. Draws: ``SGDDraws``."""

    requires_generator: ClassVar[bool] = True
    needs: ClassVar[Tuple[str, ...]] = ("rows_mv", "rows_t_mv", "x", "params")

    num_steps: int = 20_000
    batch_size: int = 512
    num_features: int = 100
    step_size_times_n: float = 0.5
    momentum: float = 0.9
    average_tail: float = 0.5
    grad_clip: float = 0.1
    tol: float = 1e-2
    backend: Optional[str] = None
    precision: Optional[str] = None

    def run(self, op, b, *, generator=None, draws=None, x0=None,
            delta=None) -> SolveResult:
        return solve_sgd(
            op, b, x0, generator=generator, draws=draws,
            num_steps=self.num_steps, batch_size=self.batch_size,
            num_features=self.num_features,
            step_size_times_n=self.step_size_times_n, momentum=self.momentum,
            average_tail=self.average_tail, grad_clip=self.grad_clip,
            delta=delta, tol=self.tol,
        )


@register_solver("sdd")
@dataclasses.dataclass(frozen=True)
class SDD(SolverSpec):
    """Stochastic dual descent (Ch. 4, Algorithm 4.1). Draws: ``RowDraws``."""

    requires_generator: ClassVar[bool] = True
    needs: ClassVar[Tuple[str, ...]] = ("rows_mv",)

    num_steps: int = 20_000
    batch_size: int = 512
    step_size_times_n: float = 50.0
    momentum: float = 0.9
    averaging: Optional[float] = None
    tol: float = 1e-2
    backend: Optional[str] = None
    precision: Optional[str] = None

    def run(self, op, b, *, generator=None, draws=None, x0=None,
            delta=None) -> SolveResult:
        return solve_sdd(
            op, _fold_delta(op, b, delta), x0, generator=generator, draws=draws,
            num_steps=self.num_steps, batch_size=self.batch_size,
            step_size_times_n=self.step_size_times_n, momentum=self.momentum,
            averaging=self.averaging, tol=self.tol,
        )


@register_solver("ap")
@dataclasses.dataclass(frozen=True)
class AP(SolverSpec):
    """Alternating projections / randomised block-coordinate descent
    (§5.1.1). Draws: ``RowDraws``."""

    requires_generator: ClassVar[bool] = True
    needs: ClassVar[Tuple[str, ...]] = ("rows_t_mv", "block_at")

    num_steps: int = 2000
    block_size: int = 512
    tol: float = 1e-2
    backend: Optional[str] = None
    precision: Optional[str] = None

    def run(self, op, b, *, generator=None, draws=None, x0=None,
            delta=None) -> SolveResult:
        return solve_ap(
            op, _fold_delta(op, b, delta), x0, generator=generator, draws=draws,
            num_steps=self.num_steps, block_size=self.block_size, tol=self.tol,
        )


# ---------------------------------------------------------------------------
# JSON serialization: every spec is a tagged dict of its fields
# ---------------------------------------------------------------------------


def spec_to_dict(spec) -> Dict[str, Any]:
    """Spec (solver or preconditioner) → plain JSON-compatible dict."""
    if not dataclasses.is_dataclass(spec):
        raise TypeError(f"expected a spec dataclass, got {spec!r}")
    tag = "precond" if type(spec) in _PRECOND_REGISTRY.values() else "solver"
    if spec.name not in (_PRECOND_REGISTRY if tag == "precond" else _REGISTRY):
        raise TypeError(
            f"{type(spec).__name__} is not a registered spec; register it with "
            f"register_{tag}(name) before serializing"
        )
    d: Dict[str, Any] = {tag: spec.name}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "precond" and v is not None:
            if callable(v) and not dataclasses.is_dataclass(v):
                raise TypeError(
                    "a prebuilt preconditioner apply is a runtime object and "
                    "cannot be serialized; use a Nystrom/PivotedCholesky spec"
                )
            v = spec_to_dict(v)
        d[f.name] = v
    return d


def spec_from_dict(d: Dict[str, Any]):
    """Tagged dict → spec instance (inverse of :func:`spec_to_dict`)."""
    d = dict(d)
    if "solver" in d:
        cls: type = get_solver(d.pop("solver"))
    elif "precond" in d:
        cls = get_precond(d.pop("precond"))
    else:
        raise ValueError(
            "spec dict must be tagged with a 'solver' or 'precond' name; "
            f"got keys {sorted(d)}"
        )
    if isinstance(d.get("precond"), dict):
        d["precond"] = spec_from_dict(d["precond"])
    return cls(**d)


def spec_to_json(spec, **dumps_kwargs: Any) -> str:
    return json.dumps(spec_to_dict(spec), **dumps_kwargs)


def spec_from_json(s: str):
    return spec_from_dict(json.loads(s))


SpecLike = Union[str, SolverSpec, Type[SolverSpec]]


def as_spec(spec: SpecLike, **overrides: Any) -> SolverSpec:
    """Normalise a spec instance, spec class, or registered name to an
    instance, with ``overrides`` applied on top."""
    if isinstance(spec, str):
        spec = get_solver(spec)
    if isinstance(spec, type) and issubclass(spec, SolverSpec):
        return spec(**overrides)
    if isinstance(spec, SolverSpec):
        return dataclasses.replace(spec, **overrides) if overrides else spec
    raise TypeError(
        f"expected a SolverSpec, spec class, or registered solver name; got {spec!r}"
    )


def _validate_x0(op, b: torch.Tensor, x0: torch.Tensor) -> None:
    """Warm-start sanity checks at the ``solve()`` boundary: ``x0`` must match
    ``b``'s shape and dtype exactly (a stale warm-start cache is the usual
    cause of a mismatch)."""
    if tuple(x0.shape) != tuple(b.shape):
        n = op.shape[0]
        raise ValueError(
            f"warm start x0 has shape {tuple(x0.shape)} but the right-hand side "
            f"has shape {tuple(b.shape)} (operator is {n}×{n}); x0 must match b "
            f"exactly. Drop x0 for a cold solve."
        )
    if x0.dtype != b.dtype:
        raise TypeError(
            f"warm start x0 has dtype {x0.dtype} but the right-hand side has "
            f"dtype {b.dtype}; pass x0 in the RHS dtype"
        )


def solve(
    op,
    b: torch.Tensor,
    spec: SpecLike = "cg",
    *,
    generator: Optional[torch.Generator] = None,
    draws: Any = None,
    x0: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
    **overrides: Any,
) -> SolveResult:
    """Solve (K+σ²I)V = b + σ²δ with a registered solver on any operator.

    Args:
        op: a :class:`~repro_torch.core.operators.LinearOperator`.
        b: right-hand side(s), ``(n,)`` or ``(n, s)``.
        spec: a ``SolverSpec`` instance, spec class, or registered name.
        generator: a ``torch.Generator`` on the operator's device; a
            stochastic solver draws from it unless ``draws`` are given.
        draws: injected draws of a stochastic solver (``SGDDraws`` for SGD,
            ``RowDraws`` for SDD and AP) or of a preconditioned CG's
            preconditioner (``PrecondDraws``).
        x0: optional warm start, same shape as ``b``.
        delta: optional δ channel, same shape as ``b``.
        **overrides: spec-field overrides, e.g. ``solve(op, b, "cg", max_iters=50)``.
    """
    s = as_spec(spec, **overrides)
    backend = getattr(s, "backend", None)
    if backend is not None:
        known = BACKENDS + tuple(f for f in FEATURE_BACKENDS if f not in BACKENDS)
        if backend not in known:
            raise ValueError(f"unknown backend {backend!r}; expected one of {known}")
        if dataclasses.is_dataclass(op) and getattr(op, "backend", backend) != backend:
            op = dataclasses.replace(op, backend=backend)
    precision = getattr(s, "precision", None)
    if precision is not None:
        if precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {precision!r}; expected one of {PRECISIONS}"
            )
        if (
            dataclasses.is_dataclass(op)
            and getattr(op, "precision", precision) != precision
        ):
            op = dataclasses.replace(op, precision=precision)
    if s.requires_generator and generator is None and draws is None:
        raise ValueError(
            f"solver {s.name!r} is stochastic: solve(..., generator=torch.Generator"
            f"(device=...).manual_seed(...)) or injected draws= are required"
        )
    if x0 is not None:
        _validate_x0(op, b, x0)
    require_capabilities(op, s.needs, consumer=f"solver {s.name!r}")
    prep = getattr(op, "prepare_for_solve", None)
    if callable(prep):
        # per-solve setup, once, outside the solver's loop — e.g.
        # ShardedGram(gather_once=True) gathers its rows here instead of on
        # every matvec
        op = prep()
    return s.run(op, b, generator=generator, draws=draws, x0=x0, delta=delta)


# ---------------------------------------------------------------------------
# Multi-RHS coalescing on top of solve() — the serving engine's primitive
# ---------------------------------------------------------------------------


def solve_batched(
    op,
    blocks,
    spec: SpecLike = "cg",
    *,
    generator: Optional[torch.Generator] = None,
    draws: Any = None,
    x0_blocks=None,
    delta_blocks=None,
    pad_columns_to: Optional[int] = None,
    **overrides: Any,
) -> list:
    """Coalesce per-consumer RHS column blocks into ONE multi-RHS solve.

    k callers each bring a small RHS block against the same operator; the
    blocks are stacked column-wise, solved in one :func:`solve`, and
    scattered back as one ``SolveResult`` per block. ``iterations`` and
    ``matvecs`` on each result are the *shared* batch totals, while
    ``residual_norm``/``rel_residual``/``converged``/``flags`` are per block.

    Args:
        blocks: RHS blocks, each ``(n,)`` or ``(n, s_i)``.
        x0_blocks: optional warm starts, one per block (``None`` entries are
            cold); if every entry is ``None`` the batch is a cold solve.
        delta_blocks: optional δ channels, one per block (``None`` → δ = 0).
        pad_columns_to: pad the stacked RHS with zero columns up to this
            count (the serving engine's fixed bucket widths); zero columns
            converge at once and are sliced off.

    Returns one ``SolveResult`` per block, in order; solutions of 1-D blocks
    are squeezed back to 1-D.
    """
    s = as_spec(spec, **overrides)
    blocks = list(blocks)
    if not blocks:
        return []
    mats, squeezes = [], []
    for blk in blocks:
        m, sq = as_matrix_rhs(torch.as_tensor(blk))
        mats.append(m)
        squeezes.append(sq)
    widths = [m.shape[1] for m in mats]
    offsets = [0]
    for w in widths:
        offsets.append(offsets[-1] + w)
    total = offsets[-1]
    n = mats[0].shape[0]

    def _stack(maybe_blocks, what):
        if maybe_blocks is None:
            return None
        maybe_blocks = list(maybe_blocks)
        if len(maybe_blocks) != len(blocks):
            raise ValueError(
                f"{what} has {len(maybe_blocks)} blocks for {len(blocks)} RHS "
                f"blocks; pass one entry per block (None for missing)"
            )
        if all(e is None for e in maybe_blocks):
            return None
        cols = []
        for e, w in zip(maybe_blocks, widths):
            if e is None:
                cols.append(mats[0].new_zeros((n, w)))
            else:
                cols.append(as_matrix_rhs(torch.as_tensor(e))[0])
        return torch.cat(cols, dim=1)

    b = torch.cat(mats, dim=1)
    x0 = _stack(x0_blocks, "x0_blocks")
    delta = _stack(delta_blocks, "delta_blocks")
    if pad_columns_to is not None and pad_columns_to > total:
        zeros = b.new_zeros((n, pad_columns_to - total))
        b = torch.cat([b, zeros], dim=1)
        if x0 is not None:
            x0 = torch.cat([x0, zeros], dim=1)
        if delta is not None:
            delta = torch.cat([delta, zeros], dim=1)

    res = solve(op, b, s, generator=generator, draws=draws, x0=x0, delta=delta)
    tol = float(getattr(s, "tol", 1e-2))
    out = []
    for (lo, hi), sq in zip(zip(offsets[:-1], offsets[1:]), squeezes):
        sol = res.solution[:, lo:hi]
        rel = res.rel_residual[lo:hi]
        fl = res.flags[lo:hi]
        out.append(
            SolveResult(
                solution=sol[:, 0] if sq else sol,
                residual_norm=res.residual_norm[lo:hi],
                rel_residual=rel,
                iterations=res.iterations,
                # per-block convergence is flag-aware, like finalize(): a
                # flagged column in THIS block fails this block only
                converged=bool(torch.all((rel <= tol) & (fl == 0))),
                matvecs=res.matvecs,
                flags=fl,
            )
        )
    return out


# ---------------------------------------------------------------------------
# Bordered-system (rank-k) extension on top of solve_batched — the serving
# engine's incremental-update primitive
# ---------------------------------------------------------------------------


def solve_bordered(
    op,
    b_cols: torch.Tensor,
    c_new: torch.Tensor,
    rhs_new: torch.Tensor,
    sol_old: torch.Tensor,
    spec: SpecLike = "cg",
    *,
    generator: Optional[torch.Generator] = None,
    draws: Any = None,
    x0: Optional[torch.Tensor] = None,
    **overrides: Any,
) -> Tuple[torch.Tensor, SolveResult]:
    """Extend a solved system by k rows via the bordered-system identity.

    Given ``sol_old`` with (A = K_old + σ²I)·sol_old ≈ rhs_old, the
    cross-covariance B = K(X_old, X_new) (``b_cols``, (n, k)), the new block
    C = K(X_new, X_new) (``c_new``, (k, k), WITHOUT noise: σ²I is added here
    from ``op.noise``) and the bottom RHS rows ``rhs_new`` ((k, m)), the
    extended system [[A, B], [Bᵀ, C+σ²I]] [u; w] = [rhs_old; rhs_new] is

        Z = A⁻¹ B                       (ONE k-column solve at the old n)
        S = (C + σ²I) − Bᵀ Z            (k×k Schur complement, Cholesky)
        w = S⁻¹ (rhs_new − Bᵀ sol_old)
        u = sol_old − Z w

    The Z solve goes through :func:`solve_batched` (warm-startable by
    ``x0``). A Schur complement that is not positive definite gives NaN, as
    the reference's Cholesky does.

    Returns ``(solution (n+k, m), z_result)``.
    """
    s = as_spec(spec, **overrides)
    b_cols = torch.as_tensor(b_cols)
    if b_cols.ndim != 2:
        raise ValueError(f"b_cols must be (n, k); got shape {tuple(b_cols.shape)}")
    n, k = b_cols.shape
    c_new = torch.as_tensor(c_new)
    if tuple(c_new.shape) != (k, k):
        raise ValueError(
            f"c_new must be ({k}, {k}) to match b_cols' {k} columns; got "
            f"{tuple(c_new.shape)}"
        )
    sol_old, _ = as_matrix_rhs(torch.as_tensor(sol_old))
    rhs_new, _ = as_matrix_rhs(torch.as_tensor(rhs_new))
    if sol_old.shape[0] != n or rhs_new.shape[0] != k:
        raise ValueError(
            f"sol_old rows ({sol_old.shape[0]}) must match the old n ({n}) and "
            f"rhs_new rows ({rhs_new.shape[0]}) the k new rows ({k})"
        )
    (z_result,) = solve_batched(
        op, [b_cols], s, generator=generator, draws=draws,
        x0_blocks=None if x0 is None else [x0],
    )
    z = z_result.solution  # (n, k) = A⁻¹ B
    eye = torch.eye(k, dtype=b_cols.dtype, device=b_cols.device)
    schur = c_new + op.noise * eye - b_cols.T @ z
    # symmetrise the fp drift from the iterative Z before factorizing — S is
    # S.P.D. by the Schur-complement theorem whenever the extended Gram is
    schur = 0.5 * (schur + schur.T)
    w = torch.cholesky_solve(rhs_new - b_cols.T @ sol_old, cholesky_or_nan(schur))
    u = sol_old - z @ w  # (n, m)
    return torch.cat([u, w], dim=0), z_result
