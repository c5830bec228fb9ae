"""Deterministic fault injection for the robustness checks — twin of
``repro/testing/faults.py``.

* :class:`FaultyOperator` wraps any operator and corrupts chosen *columns* of
  every ``mv`` output, so it poisons exactly the chosen RHS lanes of a shared
  multi-RHS solve. Columns beyond the operand's width never fire, so a fault
  at batch position c ≥ a request's solo width vanishes when it is re-run
  alone; ``min_width`` makes that threshold explicit.
* :class:`FaultyFeatureOperator` corrupts chosen columns of ``phi_mv`` output:
  the right-hand sides built from prior draws, a fault that follows a request
  into its solo re-run.
* :class:`DenseOperator` is A + σ²I for an explicit A: indefinite matrices
  (CG breakdown), singular systems, any conditioning.
  :func:`near_singular_problem` builds the duplicated-rows Gram that makes
  fp32 CG stagnate.

A fault fires or not by the operand's shape alone (no call counters), so a
test is reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.kernels_fn import make_params
from ..core.operators import Gram, LinearOperator
from ..device import DeviceLike, make_generator, resolve_device


def _corrupt_columns(out: torch.Tensor, columns, value: float, min_width: int) -> torch.Tensor:
    """The chosen columns of a matvec/feature-map output set to ``value``."""
    if out.ndim == 1:
        if 0 in columns and min_width <= 1:
            return torch.full_like(out, value)
        return out
    if out.shape[1] < max(min_width, 1):
        return out
    out = out.clone()
    for c in columns:
        if c < out.shape[1]:
            out[:, c] = value
    return out


@dataclasses.dataclass(frozen=True)
class FaultyOperator(LinearOperator):
    """``inner`` with chosen ``mv``-output columns forced to ``value``.

    Everything but ``mv`` forwards to the wrapped operator (capabilities
    included, via ``__getattr__``: row-block solvers see the *clean*
    operator; this models a fault in the multi-RHS matvec every CG iteration
    runs). ``dense()`` forwards clean: a dense fallback is another code path.
    """

    inner: Any  # the wrapped LinearOperator
    columns: Tuple[int, ...] = (0,)
    value: float = float("nan")
    #: the fault fires only when the operand has at least this many columns
    min_width: int = 0

    @property
    def shape(self) -> tuple:
        return self.inner.shape

    @property
    def noise(self) -> torch.Tensor:
        return self.inner.noise

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return _corrupt_columns(self.inner.mv(v), self.columns, self.value, self.min_width)

    def diag_part(self) -> torch.Tensor:
        return self.inner.diag_part()

    def dense(self) -> torch.Tensor:
        return self.inner.dense()

    def prepare_for_solve(self) -> "FaultyOperator":
        prep = getattr(self.inner, "prepare_for_solve", None)
        if callable(prep):
            return dataclasses.replace(self, inner=prep())
        return self

    def __getattr__(self, name: str):
        if name.startswith("__") or name in ("inner", "columns", "value", "min_width"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "inner"), name)


@dataclasses.dataclass(frozen=True)
class FaultyFeatureOperator:
    """A feature operator whose ``phi_mv`` output columns are forced to
    ``value``: it poisons the RHS built from those prior weight columns on
    every rebuild (the persistent-fault model)."""

    inner: Any  # the wrapped FeatureOperator
    columns: Tuple[int, ...] = (0,)
    value: float = float("nan")
    min_width: int = 0

    @property
    def num_features(self) -> int:
        return self.inner.num_features

    @property
    def shape(self) -> tuple:
        return self.inner.shape

    def phi_mv(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        return _corrupt_columns(self.inner.phi_mv(x, w, **kw), self.columns, self.value,
                                self.min_width)

    def phi_t_mv(self, x: torch.Tensor, u: torch.Tensor, **kw) -> torch.Tensor:
        return self.inner.phi_t_mv(x, u, **kw)

    def __getattr__(self, name: str):
        if name.startswith("__") or name in ("inner", "columns", "value", "min_width"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "inner"), name)


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """A + σ²I for an explicit dense A — exact pathologies on demand.

    CG breakdown: ``DenseOperator(a=torch.diag(torch.tensor([1., -1.])))``
    with b = [1, 1] hits pᵀAp = 0 on the very first iteration."""

    a: torch.Tensor  # (n, n) the raw matrix (need not be PSD — that's the point)
    sigma2: torch.Tensor = dataclasses.field(default_factory=lambda: torch.tensor(0.0))

    @property
    def shape(self) -> tuple:
        return tuple(self.a.shape)

    @property
    def noise(self) -> torch.Tensor:
        return self.sigma2

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return self.a @ v + self.sigma2 * v

    def diag_part(self) -> torch.Tensor:
        return torch.diagonal(self.a) + self.sigma2

    def dense(self) -> torch.Tensor:
        eye = torch.eye(self.a.shape[0], dtype=self.a.dtype, device=self.a.device)
        return self.a + self.sigma2 * eye


def near_singular_problem(
    n: int = 96,
    s: int = 3,
    *,
    noise: float = 1e-8,
    seed: int = 0,
    d: int = 2,
    generator: Optional[torch.Generator] = None,
    x: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
):
    """The standard ill-conditioned setup: a squared-exponential Gram over
    inputs with duplicated rows and vanishing noise, on which fp32 CG
    stagnates well above any honest tolerance. The inputs (n//2 uniform rows,
    repeated) and the (n, s) normal right-hand side come from ``generator``
    (or one seeded ``seed``), unless ``x`` (n, d) and ``b`` (n, s) are
    injected.

    Returns ``(op, b, params, x)``."""
    dev = resolve_device(device)
    if x is None or b is None:
        gen = make_generator(seed, dev) if generator is None else generator
        if x is None:
            half = torch.rand((n // 2, d), generator=gen, device=dev)
            x = torch.cat([half, half], dim=0)[:n]  # duplicated rows
        if b is None:
            b = torch.randn((n, s), generator=gen, device=dev)
    params = make_params("se", lengthscale=0.5, signal=1.0, noise=noise, device=dev)
    return Gram(x=x, params=params), b, params, x


def nan_columns(b: torch.Tensor, columns: Tuple[int, ...]) -> torch.Tensor:
    """``b`` with the chosen columns replaced by NaN."""
    b = b.clone()
    for c in columns:
        b[:, c] = float("nan")
    return b
