"""Continuous-batching scheduler: FIFO with compatible-group coalescing — twin
of ``repro/serve/scheduler.py``.

Policy (see ``docs/serving.md``):

* Strict head-of-line FIFO: the oldest queued request fixes the batch's group;
  younger requests join *in arrival order* iff they belong to the same group
  and the caps allow. Incompatible requests are skipped without losing their
  queue position, so no group can starve another — the skipped head is served
  on the next step.
* Groups: ``predict`` requests batch with each other (they share one fused
  row-batched query pass over cached state — no solve); ``sample`` and
  ``thompson_step`` batch together (both contribute RHS columns to ONE shared
  multi-RHS solve), but *warm* (cache-hit) and *cold* requests never mix —
  a batch's iteration count is its slowest column's, so one cold column would
  erase every warm column's latency win.
* Caps: ``max_batch_requests`` bounds any batch; ``max_rhs_columns`` bounds the
  solve batch's total RHS width (the solver's memory per iteration is
  O(n · columns)).
* Starvation guard: every skip increments ``Request.skips``; once a request
  has been passed over ``max_skips`` times, it is promoted to head the next
  batch regardless of the true head's group. Under pure FIFO evolution the
  head is always consumed, so skips stay monotone along the queue and wait
  is already bounded by queue position — the guard is the *invariant* that
  keeps it bounded under any richer policy (priorities, re-queues, external
  mutation of the queue) without auditing each one.
* Deadlines: ``expire(now)`` removes requests whose ``deadline`` has passed —
  the engine completes them with a structured ``deadline_exceeded`` error, so
  nothing silently queues forever.

Bucketing is the engine's job (the scheduler deals in requests, not shapes) —
:func:`bucket` is the shared shape-quantisation helper: padding rows/columns up
to the next power of two keeps the set of solve/query shapes small and fixed:
on the card each width picks one of the Gram kernel's compiled tile widths
(``kernels/gram_matvec.py``'s ``gram_plan``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from .request import PREDICT, Request, SOLVE_KINDS

#: batch group tags
GROUP_PREDICT = "predict"
GROUP_SOLVE_COLD = "solve_cold"
GROUP_SOLVE_WARM = "solve_warm"


def bucket(n: int, minimum: int) -> int:
    """Smallest power-of-two ≥ max(n, minimum) — the fixed shape ladder."""
    size = max(int(n), int(minimum), 1)
    return 1 << (size - 1).bit_length()


def group_of(req: Request) -> str:
    if req.kind == PREDICT:
        return GROUP_PREDICT
    if req.kind in SOLVE_KINDS:
        return GROUP_SOLVE_WARM if req.warm else GROUP_SOLVE_COLD
    raise ValueError(f"unknown request kind {req.kind!r}")


@dataclasses.dataclass
class BatchPlan:
    """One step's worth of coalesced work, in arrival order."""

    group: str
    requests: List[Request]

    @property
    def total_columns(self) -> int:
        return sum(r.num_samples for r in self.requests)

    @property
    def max_rows(self) -> int:
        return max((r.num_rows for r in self.requests), default=0)


class FIFOScheduler:
    """The engine's queue + batch former. Host-side and O(queue) per step."""

    def __init__(
        self,
        max_batch_requests: int = 16,
        max_rhs_columns: int = 64,
        max_skips: int = 16,
    ):
        if max_batch_requests < 1 or max_rhs_columns < 1:
            raise ValueError("batch caps must be >= 1")
        if max_skips < 1:
            raise ValueError("max_skips must be >= 1")
        self.max_batch_requests = max_batch_requests
        self.max_rhs_columns = max_rhs_columns
        self.max_skips = max_skips
        self._queue: Deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def add(self, req: Request) -> None:
        if req.kind in SOLVE_KINDS and req.num_samples > self.max_rhs_columns:
            raise ValueError(
                f"request wants {req.num_samples} RHS columns but the "
                f"scheduler caps a whole batch at {self.max_rhs_columns}; "
                f"raise max_rhs_columns or split the request"
            )
        self._queue.append(req)

    def pending(self) -> Tuple[Request, ...]:
        return tuple(self._queue)

    def expire(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline has passed.

        The engine calls this at the top of each step and completes the
        returned requests with a structured ``deadline_exceeded`` error —
        an expired request never executes and never blocks the queue."""
        expired = [r for r in self._queue if r.expired(now)]
        if expired:
            self._queue = deque(r for r in self._queue if not r.expired(now))
        return expired

    def next_batch(self) -> Optional[BatchPlan]:
        """Form the next batch: head request + every compatible follower the
        caps admit, preserving arrival order; the rest keep their positions.

        Starvation guard: a request skipped ``max_skips`` times is promoted to
        *be* the head — its group fixes this batch — so position-preserving
        skips can never defer any single request indefinitely."""
        if not self._queue:
            return None
        head = self._queue[0]
        for req in self._queue:
            if req.skips >= self.max_skips:
                head = req  # oldest over-skipped request wins
                break
        grp = group_of(head)
        picked: List[Request] = []
        kept: List[Request] = []
        columns = 0
        for req in self._queue:
            want_cols = req.num_samples if req.kind in SOLVE_KINDS else 0
            if (
                group_of(req) == grp
                and len(picked) < self.max_batch_requests
                and (grp == GROUP_PREDICT or columns + want_cols <= self.max_rhs_columns)
            ):
                picked.append(req)
                columns += want_cols
            else:
                req.skips += 1
                kept.append(req)
        self._queue = deque(kept)
        return BatchPlan(group=grp, requests=picked)
