"""`IterativeGP` — the paper's pipeline in three lines, twin of
``repro/core/api.py``.

    gp = IterativeGP("matern32", lengthscale=0.5, noise=0.1, spec=CG(tol=1e-3))
    mean, var = gp.fit(x, y).optimize(num_steps=20).predict(x_new)

``fit`` stores the data; ``optimize`` runs Adam ascent on the marginal
likelihood with warm-started solves (core/mll.py); ``predict`` runs ONE
batched solve of (K+σ²I)V = [y | f_X + ε] with the model's spec (CG, SGD, SDD
or AP) and evaluates the pathwise-conditioned posterior at the new points;
``engine`` hands the fitted GP to the serving engine (``repro_torch.serve``).
The model lives on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Callable, Optional

import torch

from ..device import DeviceLike, make_generator, resolve_device
from .kernels_fn import KernelParams, make_params
from .mll import MLLOptimState, optimize_mll
from .pathwise import PosteriorFunctions, posterior_functions
from .solvers.base import flag_names
from .solvers.spec import SolverSpec, SpecLike, as_spec

if TYPE_CHECKING:
    from ..serve import GPEngine


class IterativeGP:
    """Scalable GP regression façade over the iterative-solver stack.

    Stateful and deliberately small: ``fit`` stores the data, and
    ``posterior``/``sample``/``predict`` expose pathwise-conditioned function
    samples. Random draws come from a ``torch.Generator`` on the model's device
    seeded with ``seed``, unless an explicit ``generator`` is passed.
    """

    def __init__(
        self,
        kernel: str = "matern32",
        *,
        lengthscale: float = 1.0,
        signal: float = 1.0,
        noise: float = 0.1,
        spec: SpecLike = "cg",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.kernel = kernel
        self._init_hypers = dict(lengthscale=lengthscale, signal=signal, noise=noise)
        self.spec: SolverSpec = as_spec(spec)
        self.params: Optional[KernelParams] = None
        self.x: Optional[torch.Tensor] = None
        self.y: Optional[torch.Tensor] = None
        self._gen = make_generator(seed, self.device)
        self._post: Optional[PosteriorFunctions] = None
        self._post_cache_key: Optional[tuple] = None
        self.last_optim: Optional[MLLOptimState] = None

    def _require_fitted(self):
        if self.x is None:
            raise RuntimeError("call fit(x, y) before optimizing or predicting")

    def _as_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def fit(self, x, y) -> "IterativeGP":
        """Store training data; hyperparameters are created on first fit (and
        re-initialised if the feature dimension changes)."""
        x, y = self._as_tensor(x), self._as_tensor(y)
        if self.params is not None and tuple(self.params.log_lengthscale.shape) != (
            x.shape[1],
        ):
            self.params = None
        if self.params is None:
            self.params = make_params(
                self.kernel, d=x.shape[1], device=self.device, **self._init_hypers
            )
        self.x, self.y = x, y
        self._post = None
        return self

    def optimize(
        self,
        num_steps: int = 20,
        lr: float = 0.05,
        *,
        num_probes: int = 8,
        warm_start: bool = True,
        estimator: str = "pathwise",
        generator: Optional[torch.Generator] = None,
        callback: Optional[Callable[[int, MLLOptimState], None]] = None,
    ) -> "IterativeGP":
        """Adam ascent on the MLL with warm-started inner solves (Ch. 5).
        ``callback(t, state)`` sees each step's state, its solve among it."""
        self._require_fitted()
        st = optimize_mll(
            self.params,
            self.x,
            self.y,
            generator=self._gen if generator is None else generator,
            num_steps=num_steps,
            lr=lr,
            num_probes=num_probes,
            warm_start=warm_start,
            estimator=estimator,
            spec=self.spec,
            callback=callback,
        )
        self.params = st.params
        self.last_optim = st
        self._post = None
        return self

    def engine(
        self,
        *,
        num_samples: int = 16,
        num_features: int = 2048,
        generator: Optional[torch.Generator] = None,
        **engine_kwargs,
    ) -> "GPEngine":
        """Hand the fitted GP off to a long-lived serving engine.

        Returns a :class:`repro_torch.serve.GPEngine` on this GP's device,
        holding its fitted posterior state (representer weights, pathwise prior
        paths, solver spec) and serving streams of ``predict`` / ``sample`` /
        ``thompson_step`` requests with continuous batching over shared
        multi-RHS solves. The engine snapshots the current hyperparameters and
        data; further ``optimize``/``fit`` calls on this façade do not affect
        it (push new observations with ``engine.add_observations``). Its fit
        draws from this GP's generator unless ``generator`` is given.
        """
        self._require_fitted()
        from ..serve import GPEngine  # deferred: serve imports core

        return GPEngine(
            self.params,
            self.x,
            self.y,
            spec=self.spec,
            num_samples=num_samples,
            num_features=num_features,
            generator=self._gen if generator is None else generator,
            device=self.device,
            **engine_kwargs,
        )

    def posterior(
        self,
        num_samples: int = 16,
        num_features: int = 2048,
        generator: Optional[torch.Generator] = None,
    ) -> PosteriorFunctions:
        """Pathwise-conditioned posterior function samples. Cached until the
        data or sampling arguments change; passing an explicit ``generator``
        always draws fresh samples."""
        self._require_fitted()
        cache_key = (num_samples, num_features)
        if (self._post is None or generator is not None
                or self._post_cache_key != cache_key):
            self._post = posterior_functions(
                self.params,
                self.x,
                self.y,
                generator=self._gen if generator is None else generator,
                num_samples=num_samples,
                num_features=num_features,
                spec=self.spec,
            )
            self._post_cache_key = cache_key
            info = self._post.solve_info
            if info is not None and not info.healthy:
                mask = 0
                for f in info.flags.tolist():
                    mask |= int(f)
                warnings.warn(
                    f"solver {self.spec.name!r} diverged "
                    f"(flags: {', '.join(flag_names(mask))})",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return self._post

    def sample(self, xs, num_samples: int = 16,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Evaluate posterior function samples at ``xs`` → (n*, num_samples)."""
        return self.posterior(num_samples, generator=generator)(self._as_tensor(xs))

    def predict(self, xs, num_samples: int = 64,
                generator: Optional[torch.Generator] = None) -> tuple:
        """Posterior mean (representer weights, no MC error) and MC variance."""
        post = self.posterior(num_samples, generator=generator)
        return post.sample_mean_and_var(self._as_tensor(xs))
