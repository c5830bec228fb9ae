"""Distributed GP inference over ``torch.distributed`` — twin of
``repro/core/distributed.py``: :class:`~repro_torch.core.operators.ShardedGram`
through the unified ``solve()``.

SPMD: one process a shard. Every rank runs the same program on its own block
of the training rows (a block-row distribution of K, the canonical layout
:func:`shard_training_rows` cuts), contracts its blocks through the same
kernels as the single-device path (on the card, one Gram kernel launch a shard
pair), and the solvers' cross-row steps become the collectives of
core/collectives.py over the mesh's ``data`` group.

``comm`` picks the schedule (docs/distributed.md): ``"gather"`` all-gathers
the inputs and results around each matvec (vectors whole on every rank);
``"ring"`` rotates the shard pairs around the ranks against the per-shard
contraction, so the (n, d) panel is never replicated, no matvec all-gathers,
and CG's iterates stay row blocks (psum-reduced dots, shard-local axpys:
O(n·s/P) vector memory a rank); ``"auto"`` picks ring once the replicated
panel exceeds a byte budget. Any registered spec runs: CG (with Nyström,
pivoted-Cholesky or RFF preconditioning through ``precond_factor``), SGD, SDD
and AP, with warm starts, the δ channel and matvec accounting. Stochastic
draws must be the same on every rank: inject them (``SGDDraws``,
``RowDraws``) or seed every rank's generator alike.

Run it under ``torchrun`` (one process a card) or from spawned ranks; ranks
that share a card form a gloo group, whose collectives stage CUDA tensors
through host memory (NCCL refuses two ranks on one card).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from . import collectives as coll
from .kernels_fn import KernelParams
from .operators import COMM_STRATEGIES, ShardedGram
from .solvers.base import SolveResult
from .solvers.spec import SpecLike, as_spec, solve


def shard_training_rows(mesh, x: torch.Tensor, data_axes=("data",)) -> torch.Tensor:
    """This rank's block of the canonical block-row layout of ``x`` (n, d),
    given whole on every rank: rows [i·n/P, (i+1)·n/P) on rank i. Raises
    ``ValueError`` when n % P != 0 (the masked row gathers and the ring
    assume equal blocks)."""
    group = coll.axis_group(mesh, data_axes)
    p_size, i = coll.axis_size(group), coll.axis_index(group)
    n = x.shape[0]
    if n % p_size:
        raise ValueError(
            f"n = {n} training rows do not split into {p_size} equal blocks "
            f"(n % P != 0); the canonical block-row layout needs n divisible by P"
        )
    n_local = n // p_size
    return x[i * n_local:(i + 1) * n_local].contiguous()


def distributed_solve(
    params: KernelParams,
    x: torch.Tensor,
    b: torch.Tensor,
    mesh,
    spec: SpecLike = "cg",
    data_axes=("data",),
    *,
    generator: Optional[torch.Generator] = None,
    draws: Any = None,
    x0: Optional[torch.Tensor] = None,
    delta: Optional[torch.Tensor] = None,
    backend: str = "auto",
    row_chunk: int = 2048,
    gather_once: bool = False,
    comm: str = "gather",
    comm_budget_bytes: Optional[int] = None,
) -> SolveResult:
    """Spec-driven front door for sharded solves — ``solve(ShardedGram, …)``.

    ``x`` is this rank's row block (:func:`shard_training_rows`); ``b`` (and
    ``x0``/``delta``) whole or this rank's rows. Stochastic specs need
    ``generator=`` or injected ``draws=`` as in the single-device ``solve()``,
    the same on every rank; the spec's ``backend`` pins the per-shard backend.

    Under ``ring`` a matvec-only spec (the CG family) gets its right-hand
    side, warm start and δ as row blocks, so every iterate stays a row block
    through the loop and so does the solution. ``gather_once=True``
    replicates x once a solve instead of all-gathering it every matvec; it
    is the opposite trade to ``ring``, so the two together raise
    ``ValueError``. Returns the full :class:`SolveResult`.
    """
    if comm not in COMM_STRATEGIES:
        raise ValueError(
            f"unknown comm strategy {comm!r}; expected one of {COMM_STRATEGIES}"
        )
    if comm == "ring" and gather_once:
        raise ValueError(
            "gather_once=True pre-replicates the O(n·d) input panel that "
            "comm='ring' exists to avoid — drop one of them (comm='auto' "
            "resolves to gather when gather_once is set)"
        )
    axes = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    kwargs = {} if comm_budget_bytes is None else dict(comm_budget_bytes=comm_budget_bytes)
    op = ShardedGram(x=x, params=params, mesh=mesh, data_axes=axes, backend=backend,
                     row_chunk=row_chunk, gather_once=gather_once, comm=comm, **kwargs)
    if op._resolve_comm() == "ring" and not as_spec(spec).needs:
        # matvec-only spec: the RHS, warm start and δ as row blocks, so the
        # ring mv's row blocks and the iterates agree from the first step
        rows = op.layout.iterate
        b, x0, delta = (None if v is None else rows(v) for v in (b, x0, delta))
    return solve(op, b, spec, generator=generator, draws=draws, x0=x0, delta=delta)
