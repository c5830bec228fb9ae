"""Iterative solvers: CG through the single ``solve()`` entry point."""
from .base import (
    FLAG_BREAKDOWN,
    FLAG_NONFINITE,
    FLAG_STAGNATION,
    FROZEN_FLAGS,
    SolveResult,
    flag_names,
)
from .cg import solve_cg
from .spec import CG, SolverSpec, as_spec, get_solver, register_solver, solve

__all__ = [
    "CG", "FLAG_BREAKDOWN", "FLAG_NONFINITE", "FLAG_STAGNATION", "FROZEN_FLAGS",
    "SolveResult", "SolverSpec", "as_spec", "flag_names", "get_solver",
    "register_solver", "solve", "solve_cg",
]
