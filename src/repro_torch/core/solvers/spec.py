"""Declarative solver configuration and the single ``solve()`` entry point —
the CG part of ``repro/core/solvers/spec.py``.

Frozen spec dataclasses describe *how* to solve; a registry maps names
(``"cg"``) to spec classes; ``solve(op, b, spec, x0=..., delta=...)`` handles
warm starts, backend pinning and capability checks for any
:class:`~repro_torch.core.operators.LinearOperator`.

The system solved is always

    (K + σ²I) V = b + σ² δ

where ``delta`` is an optional extra channel: pathwise sampling passes δ = ε/σ².
CG has no native δ channel and folds σ²δ into the right-hand side, which is
algebraically identical.

The reference's stochastic solvers (``"sgd"``, ``"sdd"``, ``"ap"``) and its
preconditioner specs are not ported yet; asking for them raises
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional, Tuple, Type, Union

import torch

from ...kernels.ops import BACKENDS, FEATURE_BACKENDS, PRECISIONS
from ..operators import require_capabilities
from .base import SolveResult
from .cg import solve_cg

_REGISTRY: Dict[str, Type["SolverSpec"]] = {}

#: reference solver names the port does not have yet → where they come from
_NOT_PORTED = {
    "sgd": "ROADMAP queue 1 item 8",
    "sdd": "ROADMAP queue 1 item 8",
    "ap": "ROADMAP queue 1 item 8",
}


def register_solver(name: str, cls: Optional[type] = None):
    """Register a spec class under a string name (usable as a decorator)."""

    def deco(c: type) -> type:
        c.name = name
        _REGISTRY[name] = c
        return c

    return deco(cls) if cls is not None else deco


def get_solver(name: str) -> Type["SolverSpec"]:
    """String → spec class lookup; raises on unknown or unported names."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet: {_NOT_PORTED[name]}"
        )
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
    needs: ClassVar[Tuple[str, ...]] = ()

    def run(self, op, b: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
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

    def run(self, op, b, *, x0=None, delta=None) -> SolveResult:
        if self.precond is not None:
            raise NotImplementedError(
                "preconditioned CG is not ported yet: ROADMAP queue 1 item 5"
            )
        return solve_cg(
            op, _fold_delta(op, b, delta), x0,
            max_iters=self.max_iters, tol=self.tol, stall_window=self.stall_window,
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
    x0: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
    **overrides: Any,
) -> SolveResult:
    """Solve (K+σ²I)V = b + σ²δ with a registered solver on any operator.

    Args:
        op: a :class:`~repro_torch.core.operators.LinearOperator`.
        b: right-hand side(s), ``(n,)`` or ``(n, s)``.
        spec: a ``SolverSpec`` instance, spec class, or registered name.
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
    if x0 is not None:
        _validate_x0(op, b, x0)
    require_capabilities(op, s.needs, consumer=f"solver {s.name!r}")
    return s.run(op, b, x0=x0, delta=delta)
