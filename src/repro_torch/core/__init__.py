"""The GP core of the port: covariance functions, operators, CG and the
stochastic solvers (SGD, SDD, AP), random features, pathwise conditioning, MLL optimisation, parallel Thompson sampling and
the ``IterativeGP`` façade."""
from .api import IterativeGP
from .gp import exact_mll, exact_posterior
from .kernels_fn import (
    KernelParams, gram, gram_diag, make_params, map_params, matvec, spectral_sample,
)
from .mll import MLLDraws, MLLGradEstimate, MLLOptimState, mll_grad, optimize_mll
from .operators import Gram
from .pathwise import PosteriorFunctions, posterior_functions
from .rff import FourierFeatures, PriorSamples, make_fourier_features, sample_prior
from .solvers import (
    AP, CG, SDD, SGD, RowDraws, SGDDraws, SolveResult, solve, solve_ap, solve_cg,
    solve_sdd, solve_sgd,
)
from .thompson import ThompsonDraws, ThompsonState, ascend_samples, thompson_step

__all__ = [
    "AP", "CG", "FourierFeatures", "Gram", "IterativeGP", "KernelParams", "MLLDraws",
    "MLLGradEstimate", "MLLOptimState", "PosteriorFunctions", "PriorSamples",
    "RowDraws", "SDD", "SGD", "SGDDraws", "SolveResult", "ThompsonDraws",
    "ThompsonState", "ascend_samples", "exact_mll",
    "exact_posterior", "gram", "gram_diag", "make_fourier_features", "make_params",
    "map_params", "matvec", "mll_grad", "optimize_mll", "posterior_functions",
    "sample_prior", "solve", "solve_ap", "solve_cg", "solve_sdd", "solve_sgd",
    "spectral_sample", "thompson_step",
]
