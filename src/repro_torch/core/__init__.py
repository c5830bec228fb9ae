"""The GP core of the port: covariance functions, operators, CG (optionally
preconditioned) and the stochastic solvers (SGD, SDD, AP), the escalation
ladder, random features, pathwise conditioning, MLL optimisation, parallel
Thompson sampling, the ``IterativeGP`` façade, and the sparse and structured
paths (SGPR, SVGP, inducing-point pathwise posteriors, the latent Kronecker
GP), and the distributed solve over ``torch.distributed`` (``ShardedGram``,
``distributed_solve``)."""
from .api import IterativeGP
from .gp import exact_mll, exact_posterior
from .inducing import inducing_posterior
from .kernels_fn import (
    KernelParams, gram, gram_diag, kronecker_grams, make_params, map_params, matvec,
    spectral_sample,
)
from .kronecker import break_even_density, lkgp_posterior, make_lkgp
from .mll import MLLDraws, MLLGradEstimate, MLLOptimState, mll_grad, optimize_mll
from .distributed import distributed_solve, shard_training_rows
from .operators import Gram, LatentKroneckerOp, NormalEq, RFFGram, ShardedGram
from .pathwise import PosteriorFunctions, posterior_functions
from .precond import (
    JacobiPrecond, PrecondDraws, WoodburyPrecond, jacobi_preconditioner,
    nystrom_preconditioner, pivoted_cholesky_preconditioner, woodbury_from_factor,
)
from .rff import (
    FourierFeatures, PriorSamples, ShardedFourierFeatures, make_fourier_features, sample_prior,
)
from .solvers import (
    AP, CG, RFF, SDD, SGD, EscalationPolicy, Jacobi, Nystrom, PivotedCholesky, RowDraws,
    SGDDraws, SolveReport, SolveResult, solve, solve_ap, solve_batched, solve_bordered,
    solve_cg, solve_robust, solve_sdd, solve_sgd,
)
from .svgp import sgpr, sgpr_elbo, sgpr_iterative
from .thompson import ThompsonDraws, ThompsonState, ascend_samples, thompson_step

__all__ = [
    "AP", "CG", "EscalationPolicy", "FourierFeatures", "Gram", "IterativeGP", "Jacobi",
    "JacobiPrecond", "KernelParams", "LatentKroneckerOp", "MLLDraws", "MLLGradEstimate",
    "MLLOptimState", "NormalEq", "Nystrom", "PivotedCholesky", "PosteriorFunctions",
    "PrecondDraws", "PriorSamples", "RFF", "RFFGram", "RowDraws", "SDD", "SGD",
    "SGDDraws", "ShardedFourierFeatures", "ShardedGram", "SolveReport", "SolveResult",
    "ThompsonDraws", "ThompsonState", "WoodburyPrecond", "ascend_samples",
    "break_even_density", "distributed_solve", "exact_mll", "exact_posterior", "gram",
    "gram_diag", "inducing_posterior", "jacobi_preconditioner", "kronecker_grams",
    "lkgp_posterior", "make_fourier_features", "make_lkgp", "make_params", "map_params",
    "matvec", "mll_grad", "nystrom_preconditioner", "optimize_mll",
    "pivoted_cholesky_preconditioner", "posterior_functions", "sample_prior", "sgpr",
    "sgpr_elbo", "sgpr_iterative", "shard_training_rows", "solve", "solve_ap",
    "solve_batched", "solve_bordered", "solve_cg", "solve_robust", "solve_sdd",
    "solve_sgd", "spectral_sample", "thompson_step", "woodbury_from_factor",
]
