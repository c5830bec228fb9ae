"""Request lifecycle dataclasses for the GP posterior serving engine — twin of
``repro/serve/request.py``.

A request is born in ``GPEngine.submit`` (queued), picked up by the scheduler
into a batch plan (scheduled), executed as part of one shared multi-RHS solve
or one fused batched query pass (executing), and finished as a
:class:`Completion` carrying the payload plus per-request accounting
(completed). The caller holds a :class:`RequestHandle` across that whole
lifecycle — ``submit`` never blocks, ``engine.step()`` drives completions.

Request kinds (``docs/serving.md``):

* ``predict``        — posterior mean + MC variance at a query block; served
                       from the engine's cached posterior state (no solve),
                       row-batched with other predicts into one fused pass;
* ``sample``         — fresh pathwise posterior function samples at a query
                       block; contributes ``num_samples`` RHS columns to the
                       step's shared solve;
* ``thompson_step``  — a parallel Thompson acquisition (§3.3.2): fresh sample
                       columns ride the same shared solve, then each sample is
                       maximised by multi-start Adam ascent; returns the
                       acquisition points.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

PREDICT = "predict"
SAMPLE = "sample"
THOMPSON = "thompson_step"

#: every request kind the engine accepts
KINDS = (PREDICT, SAMPLE, THOMPSON)
#: kinds that contribute RHS columns to the step's shared multi-RHS solve
SOLVE_KINDS = (SAMPLE, THOMPSON)


@dataclasses.dataclass
class Request:
    """One queued posterior query.

    ``seed`` fully determines the request's randomness (prior weight draw,
    noise draw, ascent starts), so results are reproducible and — for
    deterministic solvers like CG — independent of which batch the request
    lands in (tested: interleaved arrival orders give identical payloads).
    ``warm`` is stamped at submit time from a warm-start cache probe and is
    part of the scheduler's grouping key, so warm repeats never share an
    iteration budget with cold solves.
    """

    id: int
    kind: str
    xs: Optional[torch.Tensor]  # (m, d) query block on the engine's device;
    # None for thompson_step
    num_samples: int  # RHS columns this request contributes (solve kinds)
    seed: int
    arrival: float  # engine clock() at submit
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    warm: bool = False  # warm-start cache probe hit (solve kinds only)
    # absolute engine-clock deadline; requests past it complete with a
    # structured deadline_exceeded error instead of queueing forever
    deadline: Optional[float] = None
    # times this request was skipped by batch formation while queued; the
    # scheduler's starvation guard forces it to head a batch past max_skips
    skips: int = 0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def num_rows(self) -> int:
        return 0 if self.xs is None else int(self.xs.shape[0])


@dataclasses.dataclass
class Completion:
    """A finished request: payload + per-request accounting.

    ``value`` is kind-specific:

    * predict       — ``{"mean": (m,), "var": (m,)}``
    * sample        — ``{"samples": (m, num_samples)}``
    * thompson_step — ``{"points": (num_samples, d), "values": (num_samples,)}``

    ``metrics`` is uniform: ``queue_s`` (arrival → batch start), ``exec_s``
    (the batch's compute wall, shared by everything in the batch), ``total_s``,
    ``batch_requests``/``batch_columns``/``bucket_columns``/``bucket_rows``
    (what the request rode with), and for solve kinds ``iterations``,
    ``matvecs`` (shared batch totals) and ``warm``.

    ``error`` is ``None`` on success; a failed request carries a structured
    dict instead of a payload — ``{"code": ..., "message": ...}`` plus
    code-specific detail (``flags``/``rungs`` for ``solver_failure``,
    ``deadline``/``now`` for ``deadline_exceeded``). Codes:
    ``deadline_exceeded`` | ``solver_failure`` | ``exec_error`` |
    ``quarantined``. Never an exception: fault isolation means the caller of a
    *different* request in the same batch sees nothing at all.
    """

    request_id: int
    kind: str
    value: Dict[str, Any]
    metrics: Dict[str, Any]
    error: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class RequestHandle:
    """The caller's non-blocking view of a submitted request."""

    def __init__(self, request: Request):
        self.request = request
        self._completion: Optional[Completion] = None

    @property
    def done(self) -> bool:
        return self._completion is not None

    def result(self) -> Completion:
        if self._completion is None:
            raise RuntimeError(
                f"request {self.request.id} ({self.request.kind}) is still "
                f"queued — drive the engine with step()/run_until_idle() first"
            )
        return self._completion

    def _complete(self, completion: Completion) -> None:
        self._completion = completion


@dataclasses.dataclass(frozen=True)
class RequestDraws:
    """One request's random draws: fresh prior weights ``w``
    (num_features, num_samples) and noise ``eps`` (n, num_samples), and for
    ``thompson_step`` the ascent's multi-start candidates, either injected
    (``uniform`` (num_candidates − n_exploit, d), the incumbents ``pick``
    (n_exploit,) and their ``perturb`` normals (n_exploit, d)) or drawn from
    ``generator``, the request's own generator after w and ε.

    ``GPEngine`` draws them from ``torch.Generator(device).manual_seed(seed)``
    in a fixed order (w, ε, then the candidates), unless its ``draws_fn``
    injects them: the parity tests hand the engine the reference's own."""

    w: torch.Tensor
    eps: torch.Tensor
    generator: Optional[torch.Generator] = None
    uniform: Optional[torch.Tensor] = None
    pick: Optional[torch.Tensor] = None
    perturb: Optional[torch.Tensor] = None
