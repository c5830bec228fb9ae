"""Iterative solvers: CG (optionally preconditioned), SGD, SDD and AP through
the single ``solve()`` entry point, its multi-RHS forms ``solve_batched`` and
``solve_bordered``, and the escalation ladder ``solve_robust``."""
from .ap import solve_ap
from .base import (
    FLAG_BREAKDOWN,
    FLAG_NONFINITE,
    FLAG_STAGNATION,
    FROZEN_FLAGS,
    RowDraws,
    SolveResult,
    draw_rows,
    flag_names,
)
from .cg import solve_cg
from .robust import EscalationPolicy, RungRecord, SolveReport, solve_robust
from .sdd import solve_sdd
from .sgd import SGDDraws, draw_sgd, solve_sgd
from .spec import (
    AP, CG, RFF, SDD, SGD, Jacobi, Nystrom, PivotedCholesky, SolverSpec, as_spec,
    get_precond, get_solver, register_precond, register_solver, registered_preconds,
    registered_solvers, solve, solve_batched, solve_bordered, spec_from_dict,
    spec_from_json, spec_to_dict, spec_to_json,
)

__all__ = [
    "AP", "CG", "EscalationPolicy", "FLAG_BREAKDOWN", "FLAG_NONFINITE", "FLAG_STAGNATION",
    "FROZEN_FLAGS", "Jacobi", "Nystrom", "PivotedCholesky", "RFF", "RowDraws",
    "RungRecord", "SDD", "SGD", "SGDDraws", "SolveReport", "SolveResult", "SolverSpec",
    "as_spec", "draw_rows", "draw_sgd", "flag_names", "get_precond", "get_solver",
    "register_precond", "register_solver", "registered_preconds", "registered_solvers",
    "solve", "solve_ap", "solve_batched", "solve_bordered", "solve_cg", "solve_robust",
    "solve_sdd", "solve_sgd", "spec_from_dict", "spec_from_json", "spec_to_dict",
    "spec_to_json",
]
