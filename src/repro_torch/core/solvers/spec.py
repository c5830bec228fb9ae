"""Declarative solver configuration and the single ``solve()`` entry point —
twin of ``repro/core/solvers/spec.py`` without its preconditioner specs and
JSON round trip.

Frozen spec dataclasses describe *how* to solve; a registry maps names
(``"cg"``, ``"sgd"``, ``"sdd"``, ``"ap"``) to spec classes;
``solve(op, b, spec, generator=..., draws=..., x0=..., delta=...)`` handles
random draws, warm starts, backend pinning and capability checks for any
:class:`~repro_torch.core.operators.LinearOperator`.

The system solved is always

    (K + σ²I) V = b + σ² δ

where ``delta`` is an optional extra channel: pathwise sampling passes δ = ε/σ².
SGD keeps δ in its regulariser (Eq. 3.6); CG, SDD and AP fold σ²δ into the
right-hand side, which is algebraically identical.

The stochastic solvers draw from a ``torch.Generator`` (the twin of the
reference's PRNG key) or take injected draws (``SGDDraws``, ``RowDraws``);
``solve()`` refuses a stochastic spec that has neither. Preconditioner specs
are not ported yet and raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type, Union

import torch

from ...kernels.ops import BACKENDS, FEATURE_BACKENDS, PRECISIONS
from ..operators import require_capabilities
from .ap import solve_ap
from .base import SolveResult
from .cg import solve_cg
from .sdd import solve_sdd
from .sgd import solve_sgd

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


class SolverSpec:
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
    """Conjugate gradients (§2.2.4). ``precond`` is kept for the reference's
    field layout; preconditioner specs are not ported yet."""

    max_iters: int = 1000
    tol: float = 1e-2
    precond: Optional[Any] = None
    backend: Optional[str] = None
    precision: Optional[str] = None
    # iterations without relative residual improvement before FLAG_STAGNATION
    # is raised on a column (advisory)
    stall_window: int = 100

    def run(self, op, b, *, generator=None, draws=None, x0=None,
            delta=None) -> SolveResult:
        if self.precond is not None:
            raise NotImplementedError(
                "preconditioned CG is not ported yet: ROADMAP queue 1 item 5"
            )
        return solve_cg(
            op, _fold_delta(op, b, delta), x0,
            max_iters=self.max_iters, tol=self.tol, stall_window=self.stall_window,
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
            ``RowDraws`` for SDD and AP).
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
    return s.run(op, b, generator=generator, draws=draws, x0=x0, delta=delta)
