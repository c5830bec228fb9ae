"""Stochastic gradient descent (Chapter 3) — twin of ``repro/core/solvers/sgd.py``.

Minimises the primal kernel-ridge objective (Eq. 3.2/3.3)

    L(v) = ½‖b_data − K v‖² + σ²/2 ‖v − δ‖²_K

whose minimiser is v* = (K+σ²I)⁻¹(b_data + σ²δ). δ is SGD's native channel
(Eq. 3.6): pathwise sampling keeps the noise draw in the regulariser, out of
the mini-batch data-fit term. The gradient estimate of a step is

    ĝ(v) = (n/p) K[I,:]ᵀ(K[I,:] v − b_I)  +  σ² Φ (Φᵀ (v − δ))

with a mini-batch I of p rows and fresh random Fourier features Φ each step.
Both terms are pair primitives, one dispatch each: the data-fit term
``rows_pair_mv`` (the row-panel pair kernel on the card), the regulariser
``phi_pair_mv`` (the feature pair kernel), on the operator's backend.
Nesterov momentum, gradient clipping at ``grad_clip·n``, and arithmetic
(Polyak) averaging over the last ``average_tail`` of the steps (§3.3).

On a sharded operator the regulariser's fresh map is wrapped by the
operator's ``wrap_features`` (reference ``sgd.py:90-97``) and runs per shard
on this rank's rows; the iterate lies in the operator's layout (row blocks
under ring, whole under gather, where the regulariser's rows are
all-gathered back), ``b[idx]`` is read through the layout, and the gradient
norms psum-reduce over the ranks.

The reference's ``lax.scan`` is a Python loop here with no host sync inside:
a column whose gradient turns non-finite is flagged and frozen by
``torch.where``. Random draws, the minibatch indices and each step's
frequencies, come from a ``torch.Generator`` in one draw up front, or are
injected (:class:`SGDDraws`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels_fn import spectral_sample
from ..operators import supports
from ..rff import FourierFeatures
from .base import (
    LinearOperator, SolveResult, _col_norm, as_matrix_rhs, check_draws, finalize,
    frozen_update, layout_of,
)


@dataclasses.dataclass(frozen=True)
class SGDDraws:
    """The random draws of an SGD solve: ``idx`` (num_steps, batch) int64
    minibatch indices and ``omega`` (num_steps, num_features, d), each step's
    fresh frequencies (already over the lengthscale)."""

    idx: torch.Tensor
    omega: torch.Tensor


def draw_sgd(op, num_steps: int, batch_size: int, num_features: int, *,
             generator: torch.Generator) -> SGDDraws:
    """All of an SGD solve's draws at once, on the operator's device."""
    n, d = op.shape[0], op.x.shape[1]
    idx = torch.randint(0, n, (num_steps, batch_size), generator=generator,
                        device=op.x.device)
    omega = spectral_sample(op.params, num_steps * num_features, d, generator=generator)
    return SGDDraws(idx=idx, omega=omega.reshape(num_steps, num_features, d))


def solve_sgd(
    op: LinearOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SGDDraws] = None,
    num_steps: int = 20_000,
    batch_size: int = 512,
    num_features: int = 100,
    step_size_times_n: float = 0.5,
    momentum: float = 0.9,
    average_tail: float = 0.5,
    delta: Optional[torch.Tensor] = None,
    grad_clip: float = 0.1,
    tol: float = 1e-2,
) -> SolveResult:
    """Solve (K+σ²I)V = b_data + σ²δ by primal SGD. b/delta: (n,) or (n,s).
    The draws come from ``draws`` if given, else from ``generator``."""
    layout = layout_of(op)
    b2, squeeze = as_matrix_rhs(b)
    n, s = op.shape[0], b2.shape[1]
    sigma2 = op.noise
    delta2 = layout.iterate(torch.zeros_like(b2) if delta is None else (
        delta[:, None] if delta.ndim == 1 else delta
    ))
    v = layout.iterate(torch.zeros_like(b2) if x0 is None else (
        x0[:, None] if x0.ndim == 1 else x0))
    if draws is None:
        draws = draw_sgd(op, num_steps, batch_size, num_features, generator=generator)
    check_draws(draws.idx, num_steps, batch_size, "sgd")
    lr = step_size_times_n / n
    tail_start = int(num_steps * (1.0 - average_tail))
    # the regulariser's feature matvecs follow the operator's backend and
    # precision, pinned by the spec through solve() like the Gram matvecs
    feat_backend = getattr(op, "backend", "auto") or "auto"
    feat_precision = getattr(op, "precision", "fp32") or "fp32"
    fused_pair = supports(op, "rows_pair_mv")
    wrap = op.wrap_features if supports(op, "wrap_features") else (lambda ff: ff)
    phase = torch.zeros((num_features,), dtype=b2.dtype, device=b2.device)

    mom = torch.zeros_like(v)
    avg = torch.zeros_like(v)
    cnt = 0.0
    fl = torch.zeros((s,), dtype=torch.int32, device=b2.device)
    for t in range(num_steps):
        idx = draws.idx[t]
        look = v + momentum * mom  # Nesterov lookahead
        b_idx = layout.take(b2, idx)
        if fused_pair:
            _, g_raw = op.rows_pair_mv(idx, look, b_idx)
        else:
            g_raw = op.rows_t_mv(idx, op.rows_mv(idx, look) - b_idx)
        g_fit = (n / batch_size) * g_raw
        ff = wrap(FourierFeatures(omega=draws.omega[t], phase=phase, signal=op.params.signal,
                                  backend=feat_backend, precision=feat_precision))
        g_reg = layout.from_local(ff.phi_pair_mv(op.x, layout.local(look - delta2)))
        g = g_fit + sigma2 * g_reg
        gn = _col_norm(g, layout.reduce)[None, :]
        # a NaN/Inf anywhere in a column's gradient surfaces in its norm;
        # flagged columns freeze so one poisoned RHS cannot spoil the batch
        fl, apply = frozen_update(fl, torch.isfinite(gn[0]))
        apply = apply[None, :]
        g = g * torch.clamp(grad_clip * n / torch.clamp(gn, min=1e-30), max=1.0)
        mom = torch.where(apply, momentum * mom - lr * g, mom)
        v = torch.where(apply, v + mom, v)
        if t >= tail_start:
            cnt += 1.0
            avg = torch.where(apply, avg + (v - avg) / cnt, avg)
    v_out = avg if cnt > 0 else v
    return finalize(op, v_out, layout.iterate(b2) + sigma2 * delta2, num_steps, squeeze,
                    tol=tol, flags=fl)
