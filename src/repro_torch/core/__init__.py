"""The GP core of the port: covariance functions, operators, CG (optionally
preconditioned) and the stochastic solvers (SGD, SDD, AP), the escalation
ladder, random features, pathwise conditioning, MLL optimisation, parallel
Thompson sampling and the ``IterativeGP`` façade."""
from .api import IterativeGP
from .gp import exact_mll, exact_posterior
from .kernels_fn import (
    KernelParams, gram, gram_diag, make_params, map_params, matvec, spectral_sample,
)
from .mll import MLLDraws, MLLGradEstimate, MLLOptimState, mll_grad, optimize_mll
from .operators import Gram, RFFGram
from .pathwise import PosteriorFunctions, posterior_functions
from .precond import (
    JacobiPrecond, PrecondDraws, WoodburyPrecond, jacobi_preconditioner,
    nystrom_preconditioner, pivoted_cholesky_preconditioner, woodbury_from_factor,
)
from .rff import FourierFeatures, PriorSamples, make_fourier_features, sample_prior
from .solvers import (
    AP, CG, RFF, SDD, SGD, EscalationPolicy, Jacobi, Nystrom, PivotedCholesky, RowDraws,
    SGDDraws, SolveReport, SolveResult, solve, solve_ap, solve_batched, solve_bordered,
    solve_cg, solve_robust, solve_sdd, solve_sgd,
)
from .thompson import ThompsonDraws, ThompsonState, ascend_samples, thompson_step

__all__ = [
    "AP", "CG", "EscalationPolicy", "FourierFeatures", "Gram", "IterativeGP", "Jacobi",
    "JacobiPrecond", "KernelParams", "MLLDraws", "MLLGradEstimate", "MLLOptimState",
    "Nystrom", "PivotedCholesky", "PosteriorFunctions", "PrecondDraws", "PriorSamples",
    "RFF", "RFFGram", "RowDraws", "SDD", "SGD", "SGDDraws", "SolveReport", "SolveResult",
    "ThompsonDraws", "ThompsonState", "WoodburyPrecond", "ascend_samples", "exact_mll",
    "exact_posterior", "gram", "gram_diag", "jacobi_preconditioner",
    "make_fourier_features", "make_params", "map_params", "matvec", "mll_grad",
    "nystrom_preconditioner", "optimize_mll", "pivoted_cholesky_preconditioner",
    "posterior_functions", "sample_prior", "solve", "solve_ap", "solve_batched",
    "solve_bordered", "solve_cg", "solve_robust", "solve_sdd", "solve_sgd",
    "spectral_sample", "thompson_step", "woodbury_from_factor",
]
