"""Iterative solvers: CG, SGD, SDD and AP through the single ``solve()``
entry point."""
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
from .sdd import solve_sdd
from .sgd import SGDDraws, draw_sgd, solve_sgd
from .spec import AP, CG, SDD, SGD, SolverSpec, as_spec, get_solver, register_solver, solve

__all__ = [
    "AP", "CG", "FLAG_BREAKDOWN", "FLAG_NONFINITE", "FLAG_STAGNATION", "FROZEN_FLAGS",
    "RowDraws", "SDD", "SGD", "SGDDraws", "SolveResult", "SolverSpec", "as_spec",
    "draw_rows", "draw_sgd", "flag_names", "get_solver", "register_solver", "solve",
    "solve_ap", "solve_cg", "solve_sdd", "solve_sgd",
]
