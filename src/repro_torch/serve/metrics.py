"""Cumulative engine counters and latency summaries — twin of
``repro/serve/metrics.py``.

Plain host-side Python counters — the engine loop is host code (like any
continuous-batching server); everything device-side stays in the solver's own
``SolveResult``/runtime-matvec accounting. ``EngineStats.snapshot()`` is the
one read path, used by ``GPEngine.stats()``, the serving benchmark, and the
engine tests, so the three can never disagree about what a counter means.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input.

    Textbook nearest-rank: the ``max(⌈q/100 · N⌉, 1)``-th smallest value
    (clamped to N, so q=0 → the minimum and q=100 → the maximum). The previous
    implementation rounded an interpolation index with ``int(round(...))``,
    which goes through Python's round-half-even — biasing small-sample
    quantiles (e.g. p50 of N=4 picked the 3rd element, p50 of N=100 the 51st
    instead of the 50th), exactly where serving latency windows are small.
    """
    if not values:
        return 0.0
    xs = sorted(values)
    rank = min(len(xs), max(1, math.ceil(q / 100.0 * len(xs))))
    return float(xs[rank - 1])


@dataclasses.dataclass
class EngineStats:
    """Monotone counters for one engine's lifetime.

    ``iterations_saved_warm`` is the headline warm-start number: for every
    warm-batch solve, the iteration gap to the most recent *cold* solve of the
    same request kind (clamped at zero).

    Refit accounting (``add_observations``): ``refits`` counts posterior
    updates applied by ANY path; the full-refit path adds its solve iterations
    to ``refit_iterations``, the rank-k path adds its correction-solve
    iterations/matvecs to ``lowrank_iterations``/``lowrank_matvecs`` (k solve
    columns at the OLD n, + one certification matvec). ``compactions`` counts
    ``auto``-policy fallbacks to a full warm refit after the certified drift
    exceeded its budget; ``last_refit_rel_residual`` is the most recent
    update's max true relative residual against the extended operator.

    ``refit_iterations_saved`` credits each WARM full refit against
    ``refit_baseline_iters`` — the most recent COLD solve of the fit system
    (the engine's initial fit, or any ``warm=False`` refit), re-baselined
    whenever one occurs; ``refit_baseline_n`` records the n it was measured
    at. Cold iteration counts are non-decreasing in n at a fixed spec, so a
    baseline measured at a smaller n can only UNDERSTATE savings — the counter
    is a clamped lower bound, never an overstatement (exact lowrank-vs-full
    economics are measured in ``bench_serve``'s write-heavy section instead).

    ``cache_purged`` counts warm-start cache entries dropped because their
    ``hypers_key`` was superseded by a refit re-key (they were unreachable but
    still held LRU slots).
    """

    requests_submitted: int = 0
    requests_served: Dict[str, int] = dataclasses.field(default_factory=dict)
    steps: int = 0
    batches: Dict[str, int] = dataclasses.field(default_factory=dict)
    solves: int = 0
    rhs_columns: int = 0  # real RHS columns batched through shared solves
    padded_columns: int = 0  # bucket padding columns on top of them
    solver_iterations: int = 0
    solver_matvecs: int = 0
    warm_hits: int = 0
    warm_misses: int = 0
    iterations_saved_warm: int = 0
    refits: int = 0  # posterior updates applied, any path
    refit_iterations: int = 0  # full-refit solve iterations
    refit_iterations_saved: int = 0  # vs refit_baseline_iters (see docstring)
    refit_baseline_n: int = 0  # n at which the cold baseline was measured
    refit_baseline_iters: int = 0  # iterations of that cold fit-system solve
    lowrank_updates: int = 0  # rank-k bordered updates accepted
    lowrank_rows: int = 0  # observation rows appended via the rank-k path
    lowrank_iterations: int = 0  # correction-solve iterations (k cols, old n)
    lowrank_matvecs: int = 0  # correction-solve matvecs + certification matvecs
    compactions: int = 0  # auto-policy fallbacks to a full warm refit
    cache_purged: int = 0  # stale-key warm-cache entries dropped on re-key
    last_refit_rel_residual: float = 0.0  # latest update's certified drift
    predict_rows: int = 0
    predict_padded_rows: int = 0
    # fault-tolerance counters (docs/robustness.md): every failure-handling
    # decision the engine takes is visible here, so chaos tests and the
    # serve_gp --json driver can assert on exactly what happened
    deadline_misses: int = 0  # requests expired before execution
    shed: int = 0  # requests rejected at submit (queue over threshold)
    degraded: int = 0  # sample requests downgraded to predict under overload
    retries: int = 0  # batch execution retries (exec-level exceptions)
    escalations: int = 0  # flagged requests re-run solo via solve_robust
    quarantined: int = 0  # submits refused: (kind, seed) exceeded its strikes
    failed: int = 0  # completions delivered with a structured error
    queue_latencies: List[float] = dataclasses.field(default_factory=list)
    total_latencies: List[float] = dataclasses.field(default_factory=list)

    def bump_kind(self, kind: str, n: int = 1) -> None:
        self.requests_served[kind] = self.requests_served.get(kind, 0) + n

    def bump_batch(self, group: str) -> None:
        self.batches[group] = self.batches.get(group, 0) + 1

    def snapshot(self) -> dict:
        """A JSON-ready view — the contract shared by ``GPEngine.stats()``,
        ``benchmarks/bench_serve.py`` and the engine tests."""
        return {
            "requests_submitted": self.requests_submitted,
            "requests_served": dict(self.requests_served),
            "steps": self.steps,
            "batches": dict(self.batches),
            "solves": self.solves,
            "rhs_columns": self.rhs_columns,
            "padded_columns": self.padded_columns,
            "solver_iterations": self.solver_iterations,
            "solver_matvecs": self.solver_matvecs,
            "warm_hits": self.warm_hits,
            "warm_misses": self.warm_misses,
            "iterations_saved_warm": self.iterations_saved_warm,
            "refits": self.refits,
            "refit_iterations": self.refit_iterations,
            "refit_iterations_saved": self.refit_iterations_saved,
            "refit_baseline_n": self.refit_baseline_n,
            "refit_baseline_iters": self.refit_baseline_iters,
            "lowrank_updates": self.lowrank_updates,
            "lowrank_rows": self.lowrank_rows,
            "lowrank_iterations": self.lowrank_iterations,
            "lowrank_matvecs": self.lowrank_matvecs,
            "compactions": self.compactions,
            "cache_purged": self.cache_purged,
            "last_refit_rel_residual": self.last_refit_rel_residual,
            "predict_rows": self.predict_rows,
            "predict_padded_rows": self.predict_padded_rows,
            "deadline_misses": self.deadline_misses,
            "shed": self.shed,
            "degraded": self.degraded,
            "retries": self.retries,
            "escalations": self.escalations,
            "quarantined": self.quarantined,
            "failed": self.failed,
            "queue_latency_p50_s": percentile(self.queue_latencies, 50),
            "queue_latency_p99_s": percentile(self.queue_latencies, 99),
            "total_latency_p50_s": percentile(self.total_latencies, 50),
            "total_latency_p99_s": percentile(self.total_latencies, 99),
        }
