"""`GPEngine` — the long-lived GP posterior serving loop, twin of
``repro/serve/engine.py``.

Clients ``submit`` posterior queries (``predict`` / ``sample`` /
``thompson_step``) and a driver calls ``step()`` in a loop; each step the
scheduler coalesces compatible queued requests into one batch, the batch
executes as ONE shared computation, and completions are scattered back to the
callers' handles:

    submit → schedule → batch → execute → complete        (engine.step())

Every expensive posterior computation is a multi-RHS solve against the *same*
(K + σ²I) operator, so queued ``sample``/``thompson_step`` requests stack
their RHS columns into one ``solve(op, B, spec)`` (one fused Gram kernel
launch an iteration, however many requests ride it), and queued ``predict``
requests stack their query blocks into one cross-covariance pass over cached
representer weights. Batch shapes are bucketed to powers of two, so serving
runs a small fixed set of kernel widths.

Warm starts (Ch. 5 §5.3): solutions are cached keyed by (hyperparameter
fingerprint, request kind, request seed); repeat queries re-enter the solver
with their previous solution as ``x0`` and converge in a couple of iterations.
New observations go through ``add_observations``: by default a rank-k
bordered-system correction of the existing solution, certified against the
extended operator and compacted to a full warm row-extension refit when
accumulated drift exceeds the tolerance budget (serve/state.py).

Synchronous and host-driven (``step()`` is the vLLM idiom; ``submit`` never
blocks). The engine lives on one device: the card unless ``device="cpu"``.
All device work stays inside the core library's ``solve()`` and fused-matvec
entry points; the host reads one flag vector a solve batch.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.kernels_fn import KernelParams, map_params
from ..core.pathwise import PosteriorFunctions
from ..core.rff import PriorSamples
from ..core.solvers.base import FROZEN_FLAGS, flag_names
from ..core.solvers.robust import EscalationPolicy, _pin_backend, solve_robust
from ..core.solvers.spec import SpecLike, as_spec, solve
from ..core.thompson import _maximise_samples
from ..device import DeviceLike, make_generator, resolve_device
from .metrics import EngineStats
from .request import (
    Completion,
    KINDS,
    PREDICT,
    Request,
    RequestDraws,
    RequestHandle,
    SAMPLE,
    SOLVE_KINDS,
    THOMPSON,
)
from .scheduler import (
    BatchPlan,
    FIFOScheduler,
    GROUP_PREDICT,
    GROUP_SOLVE_WARM,
    bucket,
)
from .state import (
    PosteriorState,
    WarmStartCache,
    extend_state,
    fit_state,
    update_state_lowrank,
)

#: a solve batch's right-hand sides are built in feature launches of this
#: many columns: the RFF kernel's plan (its frequency chunks) depends on the
#: operand's width, and a request's columns must round alike in any batch
RHS_SLICE = 8
#: offsets of the solver generators' seeds, as the reference folds its key:
#: solve batch t takes t, a rescue of request r 20,000,000 + r, refit t
#: 10,000,000 + t
_RESCUE_SEEDS, _REFIT_SEEDS = 20_000_000, 10_000_000


class EngineOverloaded(RuntimeError):
    """Backpressure signal: the queue is past ``max_queue_depth`` and the
    overload policy rejected this submit. Callers back off and retry."""


class GPEngine:
    """Continuous-batching server over one fitted GP posterior.

    Args:
        params, x, y: the fitted hyperparameters and training data (usually via
            ``IterativeGP.engine()``); moved to ``device``.
        spec: the SolverSpec every serve-time solve runs with. The per-request
            determinism guarantee (same seed ⇒ same payload, regardless of
            batch composition) holds for deterministic solvers (CG, the
            default); stochastic specs draw their steps from a per-solve
            generator, so results then depend on batching.
        num_samples / num_features: the cached posterior's pathwise sample
            count and prior feature count (predict variance quality).
        seed / generator: the fit's draws and the solver generators' seeds
            come from ``generator``, or from one on ``device`` seeded ``seed``.
        device: where the engine runs; the card unless ``"cpu"``.
        max_batch_requests / max_rhs_columns: scheduler caps.
        row_bucket_min / col_bucket_min: smallest padded block shapes.
        clock: timeline source for arrival/latency stamps; compute durations
            are measured with ``time.perf_counter`` after a device sync.
        state: an already fitted :class:`PosteriorState` to serve in place of
            fitting one (the parity tests carry the reference's across).
        draws_fn: ``draws_fn(request) -> RequestDraws`` injects a request's
            draws in place of its seeded generator's.

    A request's draws come from ``torch.Generator(device).manual_seed(seed)``
    (w, then ε, then a Thompson request's candidates): the same seed gives
    the same payload on one device, but CPU and CUDA generators give
    different streams, so not across devices.

    Fault tolerance:
        max_skips: scheduler starvation guard — a request skipped this many
            times is promoted to head the next batch.
        default_deadline_s: relative deadline stamped on every submit that
            does not pass its own ``deadline_s``; ``None`` = no deadline.
        max_queue_depth / overload_policy: overload shedding — past the depth
            threshold, ``"degrade"`` serves ``sample`` requests as mean-only
            ``predict`` (and rejects the rest), ``"reject"`` refuses
            everything with :class:`EngineOverloaded` backpressure.
        max_exec_retries / retry_backoff_s: host-level retry of a batch whose
            execution *raised*; past the budget the batch's requests complete
            with ``exec_error``.
        quarantine_after: a (kind, seed) identity whose solo rescue fails this
            many times is quarantined — later submits complete immediately
            with a ``quarantined`` error instead of poisoning more batches.
        escalation: the :class:`EscalationPolicy` for solo rescues of flagged
            columns (``None`` disables rescue — flagged requests fail fast).
        operator_transform: optional hook wrapping the solve operator each
            batch (fault injection; must keep the LinearOperator protocol).

    Incremental updates:
        update_policy: the default ``add_observations`` path — ``"lowrank"``,
            ``"full"``, or ``"auto"`` (lowrank with residual-drift
            compaction; the default).
        compaction_tol_factor: the auto policy's drift budget — fall back to a
            full warm refit when a low-rank update's certified residual against
            the extended operator exceeds this factor × the spec tolerance.
    """

    def __init__(
        self,
        params: KernelParams,
        x,
        y,
        *,
        spec: SpecLike = "cg",
        num_samples: int = 16,
        num_features: int = 1024,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        max_batch_requests: int = 16,
        max_rhs_columns: int = 64,
        row_bucket_min: int = 16,
        col_bucket_min: int = 8,
        warm_cache_entries: int = 256,
        default_sample_count: int = 8,
        clock: Callable[[], float] = time.monotonic,
        max_skips: int = 16,
        default_deadline_s: Optional[float] = None,
        max_queue_depth: Optional[int] = None,
        overload_policy: str = "degrade",
        max_exec_retries: int = 1,
        retry_backoff_s: float = 0.02,
        quarantine_after: int = 2,
        escalation: Optional[EscalationPolicy] = EscalationPolicy(),
        operator_transform: Optional[Callable] = None,
        update_policy: str = "auto",
        compaction_tol_factor: float = 4.0,
        state: Optional[PosteriorState] = None,
        draws_fn: Optional[Callable[[Request], RequestDraws]] = None,
    ):
        if overload_policy not in ("degrade", "reject"):
            raise ValueError(
                f"overload_policy must be 'degrade' or 'reject', got "
                f"{overload_policy!r}"
            )
        if update_policy not in ("lowrank", "full", "auto"):
            raise ValueError(
                f"update_policy must be 'lowrank', 'full' or 'auto', got "
                f"{update_policy!r}"
            )
        self.device = resolve_device(device)
        self.update_policy = update_policy
        self.compaction_tol_factor = float(compaction_tol_factor)
        self.spec = as_spec(spec)
        self._clock = clock
        self.row_bucket_min = int(row_bucket_min)
        self.col_bucket_min = int(col_bucket_min)
        self.default_sample_count = int(default_sample_count)
        self.default_deadline_s = default_deadline_s
        self.max_queue_depth = max_queue_depth
        self.overload_policy = overload_policy
        self.max_exec_retries = int(max_exec_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.quarantine_after = int(quarantine_after)
        self.escalation = escalation
        self._op_transform = operator_transform
        self._draws_fn = draws_fn
        gen = make_generator(seed, self.device) if generator is None else generator
        self._solver_seed = int(torch.randint(0, 1 << 40, (1,), generator=gen,
                                              device=gen.device))
        if state is None:
            params = map_params(lambda t: t.to(self.device), params)
            state = fit_state(params, x, y, spec=self.spec, num_samples=num_samples,
                              num_features=num_features, generator=gen)
        self.state: PosteriorState = state
        self.scheduler = FIFOScheduler(
            max_batch_requests=max_batch_requests,
            max_rhs_columns=max_rhs_columns,
            max_skips=max_skips,
        )
        self.cache = WarmStartCache(max_entries=warm_cache_entries)
        self._stats = EngineStats()
        self._ids = itertools.count()
        self._auto_seeds = itertools.count()
        self._handles: dict = {}
        # poison-request bookkeeping: strike counts and the quarantine set,
        # keyed by the (kind, seed) identity that regenerates the RHS columns
        self._strikes: dict = {}
        self._quarantine: set = set()
        # warm-start savings are reported against the most recent cold solve
        self._last_cold_iters: Optional[int] = None
        # refit-savings baseline: the most recent COLD solve of the fit system
        # (EngineStats docstring has the exact semantics)
        self._stats.refit_baseline_n = self.state.n
        self._stats.refit_baseline_iters = int(self.state.fit_result.iterations)

    def _solver_generator(self, offset: int) -> torch.Generator:
        """The generator of one solve's own draws (a stochastic spec's steps,
        a preconditioner's subset), seeded apart by ``offset``."""
        return make_generator(self._solver_seed + offset, self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ submit

    def submit(
        self,
        kind: str,
        xs=None,
        *,
        num_samples: Optional[int] = None,
        seed: Optional[int] = None,
        deadline_s: Optional[float] = None,
        **options,
    ) -> RequestHandle:
        """Queue a request; never blocks on execution. Returns a handle
        completed by step().

        ``seed`` pins the request's randomness (repeat seeds are what the
        warm-start cache keys on); omitted, a fresh engine-unique seed is
        assigned. ``deadline_s`` is relative to now (falls back to the
        engine's ``default_deadline_s``); a request still queued past its
        deadline completes with a structured ``deadline_exceeded`` error.
        ``options`` are kind-specific (thompson_step: ascent parameters
        ``num_candidates``/``num_top``/``ascent_steps``/``lr``).

        Overload shedding: past ``max_queue_depth``, policy ``"degrade"``
        downgrades ``sample`` to mean-only ``predict`` (same query block) and
        rejects everything else; policy ``"reject"`` refuses all submits —
        rejection raises :class:`EngineOverloaded` as backpressure. A
        quarantined (kind, seed) identity completes immediately with a
        ``quarantined`` error.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; expected one of {KINDS}")
        if (
            self.max_queue_depth is not None
            and len(self.scheduler) >= self.max_queue_depth
        ):
            if (
                self.overload_policy == "degrade"
                and kind == SAMPLE
                and xs is not None
            ):
                kind = PREDICT
                options["degraded"] = True
                self._stats.degraded += 1
            else:
                self._stats.shed += 1
                raise EngineOverloaded(
                    f"queue depth {len(self.scheduler)} >= max_queue_depth "
                    f"{self.max_queue_depth}; request shed "
                    f"(policy={self.overload_policy!r}) — back off and retry"
                )
        if kind in (PREDICT, SAMPLE):
            if xs is None:
                raise ValueError(f"{kind!r} requests need a query block xs of shape (m, d)")
            xs = torch.atleast_2d(torch.as_tensor(xs, dtype=torch.float32, device=self.device))
            if xs.shape[1] != self.state.x.shape[1]:
                raise ValueError(
                    f"query block has feature dimension {xs.shape[1]}, "
                    f"engine state has d={self.state.x.shape[1]}"
                )
        elif xs is not None:
            raise ValueError(
                "thompson_step requests draw their own candidates — xs must be None"
            )
        if num_samples is None:
            num_samples = (
                self.state.post.num_samples if kind == PREDICT
                else self.default_sample_count
            )
        if seed is None:
            seed = (1 << 20) + next(self._auto_seeds)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(
            id=next(self._ids),
            kind=kind,
            xs=xs,
            num_samples=int(num_samples),
            seed=int(seed),
            arrival=self._clock(),
            options=dict(options),
            warm=(
                kind in SOLVE_KINDS
                and self.cache.probe(self.state.hypers_key, kind, int(seed))
            ),
            deadline=None if deadline_s is None else self._clock() + deadline_s,
        )
        handle = RequestHandle(req)
        self._handles[req.id] = handle
        self._stats.requests_submitted += 1
        if kind in SOLVE_KINDS and (kind, int(seed)) in self._quarantine:
            # repeat offender: fail fast instead of poisoning another batch
            self._stats.quarantined += 1
            self._fail(
                req,
                code="quarantined",
                message=(
                    f"(kind={kind!r}, seed={seed}) exceeded "
                    f"{self.quarantine_after} failed rescue attempts and is "
                    f"quarantined; resubmit with a fresh seed"
                ),
            )
            return handle
        self.scheduler.add(req)
        return handle

    # convenience wrappers
    def predict(self, xs, **kw) -> RequestHandle:
        return self.submit(PREDICT, xs, **kw)

    def sample(self, xs, **kw) -> RequestHandle:
        return self.submit(SAMPLE, xs, **kw)

    def thompson_step(self, **kw) -> RequestHandle:
        return self.submit(THOMPSON, None, **kw)

    # -------------------------------------------------------------------- step

    def _fail(self, req, *, code: str, message: str, **detail) -> Completion:
        """Complete ``req`` with a structured error (never an exception)."""
        comp = Completion(
            request_id=req.id,
            kind=req.kind,
            value={},
            metrics=dict(queue_s=self._clock() - req.arrival),
            error=dict(code=code, message=message, **detail),
        )
        self._handles.pop(req.id)._complete(comp)
        self._stats.failed += 1
        return comp

    def step(self) -> List[Completion]:
        """Run one engine iteration: expire → schedule → batch → execute →
        complete.

        Returns the completions produced this step (possibly empty), both
        successes and structured failures (``Completion.ok``). Latency
        accounting: ``queue_s`` is arrival → batch start on the engine clock;
        ``exec_s`` is the batch's measured compute wall, up to a device sync
        (shared by every request in the batch, as is the solve's
        iteration/matvec spend).
        """
        now = self._clock()
        completions: List[Completion] = []
        for req in self.scheduler.expire(now):
            self._stats.deadline_misses += 1
            completions.append(
                self._fail(
                    req,
                    code="deadline_exceeded",
                    message=(
                        f"request {req.id} ({req.kind}) expired in queue: "
                        f"deadline {req.deadline:.3f} < now {now:.3f}"
                    ),
                    deadline=req.deadline,
                    now=now,
                )
            )
        plan = self.scheduler.next_batch()
        if plan is None:
            return completions
        t_start = self._clock()
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                if plan.group == GROUP_PREDICT:
                    values, extra = self._execute_predict(plan)
                    errors: dict = {}
                else:
                    values, extra, errors = self._execute_solve(plan)
                self._sync()
                break
            except Exception as exc:  # noqa: BLE001 — isolation boundary:
                # a raising batch must fail structurally, not kill the loop
                attempt += 1
                if attempt > self.max_exec_retries:
                    for req in plan.requests:
                        completions.append(
                            self._fail(
                                req,
                                code="exec_error",
                                message=f"batch execution failed after "
                                f"{attempt} attempts: {exc!r}",
                            )
                        )
                    return completions
                self._stats.retries += 1
                time.sleep(self.retry_backoff_s * attempt)
        exec_s = time.perf_counter() - t0

        self._stats.steps += 1
        self._stats.bump_batch(plan.group)
        for req, value in zip(plan.requests, values):
            queue_s = t_start - req.arrival
            error = errors.get(req.id)
            if error is not None:
                comp = self._fail(req, **error)
                if error.get("code") == "solver_failure":
                    self._strike(req)
                completions.append(comp)
                continue
            metrics = dict(
                queue_s=queue_s,
                exec_s=exec_s,
                total_s=queue_s + exec_s,
                batch_requests=len(plan.requests),
                group=plan.group,
                **extra,
            )
            if req.kind in SOLVE_KINDS:
                metrics["warm"] = req.warm
            if req.options.get("degraded"):
                metrics["degraded"] = True
            comp = Completion(
                request_id=req.id, kind=req.kind, value=value, metrics=metrics
            )
            self._handles.pop(req.id)._complete(comp)
            self._stats.bump_kind(req.kind)
            self._stats.queue_latencies.append(queue_s)
            self._stats.total_latencies.append(queue_s + exec_s)
            completions.append(comp)
        return completions

    def _strike(self, req) -> None:
        """Record a failed rescue; quarantine the (kind, seed) identity past
        the strike budget."""
        ident = (req.kind, req.seed)
        self._strikes[ident] = self._strikes.get(ident, 0) + 1
        if self._strikes[ident] >= self.quarantine_after:
            self._quarantine.add(ident)

    def run_until_idle(self, max_steps: int = 100_000) -> List[Completion]:
        """Drive step() until the queue drains; returns all completions."""
        out: List[Completion] = []
        for _ in range(max_steps):
            if len(self.scheduler) == 0:
                break
            out.extend(self.step())
        return out

    # --------------------------------------------------------------- execution

    def _execute_predict(self, plan: BatchPlan):
        """One fused row-batched mean/variance pass over cached state: the
        blocks padded to the bucketed shape on the device, two Gram launches
        and one feature launch for the whole batch."""
        rows = bucket(plan.max_rows, self.row_bucket_min)
        nblk = bucket(len(plan.requests), 1)
        blocks = torch.stack([F.pad(req.xs, (0, 0, 0, rows - req.num_rows))
                              for req in plan.requests])
        blocks = F.pad(blocks, (0, 0, 0, 0, 0, nblk - len(plan.requests)))
        mean, var = self.state.post.blocked_mean_and_var(blocks)
        values = [
            {"mean": mean[i, : r.num_rows], "var": var[i, : r.num_rows]}
            for i, r in enumerate(plan.requests)
        ]
        real_rows = sum(r.num_rows for r in plan.requests)
        self._stats.predict_rows += real_rows
        self._stats.predict_padded_rows += nblk * rows - real_rows
        return values, dict(bucket_rows=rows, bucket_blocks=nblk)

    def _request_draws(self, req: Request) -> RequestDraws:
        """Deterministic per-request randomness: fresh prior weight draws and
        noise draws from the request seed alone, so the payload is independent
        of batch composition (CG) and repeat seeds regenerate identical
        columns — the warm-start cache's correctness condition. The request's
        generator goes on to draw a Thompson request's candidates."""
        if self._draws_fn is not None:
            return self._draws_fn(req)
        state = self.state
        gen = make_generator(req.seed, self.device)
        w_new = torch.randn((state.prior.num_features, req.num_samples), generator=gen,
                            device=self.device)
        eps = torch.sqrt(state.params.noise) * torch.randn(
            (state.n, req.num_samples), generator=gen, device=self.device, dtype=w_new.dtype)
        return RequestDraws(w=w_new, eps=eps, generator=gen)

    def _execute_solve(self, plan: BatchPlan):
        """ONE shared multi-RHS solve for every sample/thompson request in the
        batch, then per-request scatter + evaluation.

        Every device pass in this path is batch-level, never per-request: the
        requests' prior weight columns are stacked so feature launches of
        RHS_SLICE columns each produce every RHS, one ``solve`` produces every
        representer block (one Gram launch an iteration), and one pathwise
        evaluation produces every sample request's payload — per-request work
        is slicing, and a Thompson request's own ascent. On the card a
        request's solved columns are the same bits in any batch: the
        slices, the Gram kernel's independent columns and CG's float64 dots
        make its trajectory independent of the batch's width.

        Fault isolation: after the shared solve, columns whose flags carry
        ``FROZEN_FLAGS`` (one host read of the flag vector) identify the
        requests that poisoned them; each such request is re-run *solo*
        through :func:`solve_robust`'s escalation ladder against the same
        operator. Rescued requests complete normally; unrescuable ones get a
        structured ``solver_failure`` error. Requests whose columns stayed
        clean are untouched — their payloads are bit-identical to a
        fault-free batch.
        """
        state = self.state
        noise = state.params.noise
        op = state.operator()
        if self._op_transform is not None:
            # a wrapper cannot survive solve()'s dataclasses.replace backend
            # pinning, so pin the inner operator first, then wrap
            op = self._op_transform(_pin_backend(op, self.spec))
        n = state.n
        per_req = [self._request_draws(r) for r in plan.requests]
        widths = [r.num_samples for r in plan.requests]
        offsets = [0, *itertools.accumulate(widths)]
        total = offsets[-1]
        cbucket = bucket(total, self.col_bucket_min)

        w_cat = torch.cat([dr.w for dr in per_req], dim=1)
        delta = torch.cat([dr.eps / noise for dr in per_req], dim=1)
        pad = cbucket - total
        if pad:
            w_cat = F.pad(w_cat, (0, pad))
            delta = F.pad(delta, (0, pad))
        # feature launches of RHS_SLICE columns build every request's RHS
        # columns (padded zero-weight columns give zero columns, which
        # converge at once)
        data = torch.cat([state.prior.phi_mv(state.x, w_cat[:, i:i + RHS_SLICE])
                          for i in range(0, cbucket, RHS_SLICE)], dim=1)

        x0 = None
        if plan.group == GROUP_SOLVE_WARM:
            cols = np.zeros((n, cbucket), dtype=np.float32)
            for req, lo, hi in zip(plan.requests, offsets[:-1], offsets[1:]):
                hit = self.cache.lookup(state.hypers_key, req.kind, req.seed)
                if hit is not None and hit.shape == (n, req.num_samples):
                    cols[:, lo:hi] = hit
                    self._stats.warm_hits += 1
                else:  # probe said warm but the entry aged out — cold column
                    self._stats.warm_misses += 1
            x0 = torch.as_tensor(cols, dtype=data.dtype, device=data.device)
        res = solve(op, data, self.spec, generator=self._solver_generator(self._stats.solves),
                    x0=x0, delta=delta)
        iters = int(res.iterations)
        matvecs = int(res.matvecs)
        self._stats.solves += 1
        self._stats.rhs_columns += total
        self._stats.padded_columns += pad
        self._stats.solver_iterations += iters
        self._stats.solver_matvecs += matvecs
        if plan.group == GROUP_SOLVE_WARM:
            if self._last_cold_iters is not None:
                self._stats.iterations_saved_warm += max(
                    0, self._last_cold_iters - iters
                )
        else:
            self._last_cold_iters = iters

        # ---- fault isolation: map flagged columns back to their requests,
        # rescue each affected request solo, fail the unrescuable ones
        flags = np.atleast_1d(res.flags.cpu().numpy()).astype(np.int64)
        if flags.size == 1 and cbucket > 1:
            flags = np.full((cbucket,), int(flags[0]))
        bad = (flags[:total] & FROZEN_FLAGS) != 0
        errors: dict = {}
        rescued: dict = {}
        if bad.any():
            for req, dr, lo, hi in zip(plan.requests, per_req, offsets[:-1], offsets[1:]):
                if not bad[lo:hi].any():
                    continue
                req_flags = [int(f) for f in flags[lo:hi]]
                names = flag_names(int(np.bitwise_or.reduce(flags[lo:hi])))
                if self.escalation is None:
                    errors[req.id] = dict(
                        code="solver_failure",
                        message=(
                            f"request {req.id} ({req.kind}) columns flagged "
                            f"({', '.join(names)}) and rescue is disabled"
                        ),
                        flags=req_flags,
                    )
                    continue
                self._stats.escalations += 1
                data_req = state.prior.phi_mv(state.x, dr.w)
                report = solve_robust(
                    op,
                    data_req,
                    self.spec,
                    generator=self._solver_generator(_RESCUE_SEEDS + req.id),
                    delta=dr.eps / noise,
                    policy=self.escalation,
                )
                if report.failed_columns:
                    errors[req.id] = dict(
                        code="solver_failure",
                        message=(
                            f"request {req.id} ({req.kind}) columns flagged "
                            f"({', '.join(names)}); escalation ladder "
                            f"{report.ladder or ['(empty)']} could not recover "
                            f"columns {report.failed_columns}"
                        ),
                        flags=req_flags,
                        rungs=list(report.ladder),
                    )
                else:
                    rescued[req.id] = report.result.solution

        for req, lo, hi in zip(plan.requests, offsets[:-1], offsets[1:]):
            if req.id in errors:
                continue  # never cache a poisoned solution
            sol = rescued.get(req.id)
            if sol is None:
                sol = res.solution[:, lo:hi]
            self.cache.store(state.hypers_key, req.kind, req.seed, sol)

        values_by_id = {}
        # one batched pathwise evaluation serves every sample request: their
        # query blocks stack row-wise, the batch's weight/representer columns
        # ride whole (padded zero columns are exact mean paths), and each
        # request's payload is the (rows, columns) sub-block at its offsets
        sample_at = [
            (req, lo) for req, lo in zip(plan.requests, offsets[:-1])
            if req.kind == SAMPLE
            and req.id not in errors and req.id not in rescued
        ]
        if sample_at:
            row_offsets, r_total = [], 0
            for req, _ in sample_at:
                row_offsets.append(r_total)
                r_total += req.num_rows
            rbucket = bucket(r_total, self.row_bucket_min)
            xs_all = torch.cat([req.xs for req, _ in sample_at], dim=0)
            xs_pad = F.pad(xs_all, (0, 0, 0, rbucket - r_total))
            vals = state.post.sample_paths(xs_pad, w_cat, res.solution)
            for (req, lo), ro in zip(sample_at, row_offsets):
                values_by_id[req.id] = {
                    "samples": vals[ro : ro + req.num_rows, lo : lo + req.num_samples]
                }

        # rescued sample requests get a solo pathwise pass over the rescued
        # representer block (cheap: the solve already happened in the ladder)
        for req, dr in zip(plan.requests, per_req):
            if req.kind == SAMPLE and req.id in rescued:
                values_by_id[req.id] = {
                    "samples": state.post.sample_paths(req.xs, dr.w, rescued[req.id])
                }

        for req, dr, lo, hi in zip(plan.requests, per_req, offsets[:-1], offsets[1:]):
            if req.kind != THOMPSON or req.id in errors:
                continue
            # THOMPSON: ascend each fresh sample path (§3.3.2); the ascent runs
            # per request, at a bucketed column count
            sbucket = bucket(req.num_samples, self.col_bucket_min)
            spad = sbucket - req.num_samples
            alpha_req = rescued.get(req.id, res.solution[:, lo:hi])
            post_r = PosteriorFunctions(
                params=state.params,
                x=state.x,
                prior=PriorSamples(ff=state.prior.ff, w=F.pad(w_cat[:, lo:hi], (0, spad))),
                v_mean=state.post.v_mean,
                alpha=F.pad(alpha_req, (0, spad)),
                backend=state.post.backend,
            )
            opts = req.options
            pts = _maximise_samples(
                post_r,
                state.y,
                num_candidates=int(opts.get("num_candidates", 256)),
                num_top=int(opts.get("num_top", 2)),
                ascent_steps=int(opts.get("ascent_steps", 10)),
                lr=float(opts.get("lr", 1e-2)),
                lengthscale=float(torch.mean(state.params.lengthscale)),
                generator=dr.generator,
                uniform=dr.uniform,
                pick=dr.pick,
                perturb=dr.perturb,
            )
            with torch.no_grad():
                per_sample = torch.diagonal(post_r(pts))
            values_by_id[req.id] = {
                "points": pts[: req.num_samples],
                "values": per_sample[: req.num_samples],
            }
        values = [values_by_id.get(req.id, {}) for req in plan.requests]
        extra = dict(
            batch_columns=total,
            bucket_columns=cbucket,
            iterations=iters,
            matvecs=matvecs,
        )
        return values, extra, errors

    # ------------------------------------------------------------------- state

    def add_observations(
        self, x_new, y_new, *, warm: bool = True, update: Optional[str] = None
    ) -> None:
        """Append observations and update the posterior state incrementally.

        Drains the queue first so every pending request is served against the
        state it was submitted under. ``update`` picks the path (defaults to
        the engine's ``update_policy``):

        * ``"lowrank"`` — rank-k bordered correction
          (:func:`~repro_torch.serve.state.update_state_lowrank`): k
          correction columns solved against the OLD n-operator plus a k×k
          Schur factorization. Applied unconditionally (the certified residual
          is still recorded — check ``last_refit_rel_residual``).
        * ``"full"`` — row-extension refit
          (:func:`~repro_torch.serve.state.extend_state`), warm-started when
          ``warm`` (the pre-update solution zero-padded to the new n).
        * ``"auto"`` — lowrank first, compacted to a full warm refit when the
          corrected solution's TRUE residual against the extended operator
          exceeds ``compaction_tol_factor × spec.tol`` (or the correction
          solve raised a freezing flag).

        The new rows' noise draws come from a generator seeded by the refit's
        index, the same for the lowrank candidate and a compaction. Every
        path re-keys ``hypers_key`` (it covers n), purges the now unreachable
        warm-cache entries (counted in ``cache_purged``) and resets the
        warm-batch cold-iteration reference.
        """
        update = self.update_policy if update is None else update
        if update not in ("lowrank", "full", "auto"):
            raise ValueError(
                f"update must be 'lowrank', 'full' or 'auto', got {update!r}"
            )
        self.run_until_idle()
        offset = _REFIT_SEEDS + self._stats.refits
        if update == "full":
            self._refit_full(x_new, y_new, offset, warm=warm)
        else:
            cand = update_state_lowrank(self.state, x_new, y_new,
                                        generator=self._solver_generator(offset))
            drift = float(torch.max(cand.fit_result.rel_residual))
            tol = float(getattr(self.spec, "tol", 1e-2))
            accept = update == "lowrank" or (
                cand.fit_result.healthy and drift <= self.compaction_tol_factor * tol
            )
            if accept:
                k = int(cand.n) - int(self.state.n)
                self.state = cand
                self._stats.lowrank_updates += 1
                self._stats.lowrank_rows += k
                self._stats.lowrank_iterations += int(cand.fit_result.iterations)
                self._stats.lowrank_matvecs += int(cand.fit_result.matvecs)
                self._stats.last_refit_rel_residual = drift
            else:
                # compaction: the correction drifted past the certifiable
                # budget (or its solve flagged) — re-solve the extended system
                # in full, warm-started from the PRE-update state
                self._stats.compactions += 1
                self._refit_full(x_new, y_new, offset, warm=True)
        self._stats.refits += 1
        # a new operator shape: cold-iteration reference resets with it, and
        # warm-cache entries under the superseded hypers_key are unreachable
        self._last_cold_iters = None
        self._stats.cache_purged += self.cache.purge(self.state.hypers_key)

    def _refit_full(self, x_new, y_new, offset: int, *, warm: bool) -> None:
        """Full row-extension refit + its iteration/savings accounting."""
        self.state = extend_state(self.state, x_new, y_new, warm=warm,
                                  generator=self._solver_generator(offset))
        iters = int(self.state.fit_result.iterations)
        self._stats.refit_iterations += iters
        self._stats.last_refit_rel_residual = float(
            torch.max(self.state.fit_result.rel_residual)
        )
        if warm:
            self._stats.refit_iterations_saved += max(
                0, self._stats.refit_baseline_iters - iters
            )
        else:
            # a cold solve of the fit system at the CURRENT n: re-baseline,
            # so later warm refits are credited against a fresh reference
            self._stats.refit_baseline_n = self.state.n
            self._stats.refit_baseline_iters = iters

    # ------------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Cumulative counter snapshot + live queue/state info (one dict, used
        by the launcher, the chip check and the tests alike)."""
        snap = self._stats.snapshot()
        snap.update(
            queue_depth=len(self.scheduler),
            n=self.state.n,
            posterior_samples=self.state.post.num_samples,
            hypers_key=self.state.hypers_key,
            solver=self.spec.name,
            warm_cache_entries=len(self.cache),
        )
        return snap
