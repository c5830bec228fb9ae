"""Large-scale parallel Thompson sampling (§3.3.2, Fig. 3.6/3.7; §4.3.2 Fig. 4.4)
— twin of ``repro/core/thompson.py``.

Each acquisition step draws ``acq_batch`` posterior *function* samples by
pathwise conditioning (one batched solve), then maximises every sample with
the paper's multi-start strategy: explore (uniform) + exploit (perturbed
incumbents) candidates → top-k by sample value → Adam ascent on the sample
function → acquire the argmaxes.

The ascent differentiates the posterior samples with respect to the query
points: ∂x* of the prior Φ(x*)W through the RFF backward kernel and ∂x* of the
cross-covariance K(x*, X)V through the Gram backward kernel, each behind its
autograd Function (``kernels/rff_matvec.py``, ``kernels/gram_matvec.py``), so
on the card no gradient materialises features or cross-Gram panels.

Every random draw comes from an explicit ``torch.Generator`` or is injected
(:class:`ThompsonDraws`): the parity tests hand the port the reference's own
draws. :func:`ascend_samples` runs the ascent alone from given starts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .kernels_fn import KernelParams
from .pathwise import PosteriorFunctions, posterior_functions
from .solvers.spec import SpecLike, as_spec


@dataclasses.dataclass
class ThompsonState:
    x: torch.Tensor  # (n, d) observed inputs
    y: torch.Tensor  # (n,)
    best: float


@dataclasses.dataclass(frozen=True)
class ThompsonDraws:
    """Every random draw of one :func:`thompson_step`, injected in place of
    the generator's: the posterior's frequencies ``omega`` (num_features/2, d),
    prior weights ``w`` (num_features, acq_batch) and target noise ``eps``
    (n, acq_batch); a stochastic solver's ``solver_draws`` (``RowDraws`` or
    ``SGDDraws``; None for CG); the ``uniform`` explore candidates
    (num_candidates − n_exploit, d); the incumbents ``pick`` (n_exploit,) and
    their ``perturb`` normals (n_exploit, d); and the observation normals
    ``obs`` (acq_batch,). A field left None is drawn from the generator."""

    omega: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    pick: Optional[torch.Tensor] = None
    perturb: Optional[torch.Tensor] = None
    obs: Optional[torch.Tensor] = None
    solver_draws: Any = None


def thompson_candidates(
    x: torch.Tensor,
    y: torch.Tensor,
    num_candidates: int,
    *,
    lengthscale: float,
    exploit_frac: float = 0.9,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
    pick: Optional[torch.Tensor] = None,
    perturb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The multi-start candidates on [0,1]^d → (num_candidates, d): uniform
    explore points, then incumbents drawn ∝ softmax(y) with replacement and
    perturbed by ℓ/2·N(0, 1), all clipped to [0, 1]. ``uniform``, ``pick`` and
    ``perturb`` inject the draws; the rest come from ``generator``."""
    n, d = x.shape
    n_exploit = int(num_candidates * exploit_frac)
    if uniform is None:
        uniform = torch.rand((num_candidates - n_exploit, d), generator=generator,
                             device=x.device)
    if pick is None:
        pick = torch.multinomial(torch.softmax(y, dim=0), n_exploit, replacement=True,
                                 generator=generator)
    if perturb is None:
        perturb = torch.randn((n_exploit, d), generator=generator, device=x.device)
    near = x[pick] + (lengthscale / 2.0) * perturb
    return torch.clamp(torch.cat([uniform, near], dim=0), 0.0, 1.0)


def ascent_value(post: PosteriorFunctions, xs: torch.Tensor) -> torch.Tensor:
    """Σ over starts t and samples j of sample j at its own start, xs[t, j]:
    the scalar whose gradient moves every start on its own sample.
    xs: (num_top, s, d)."""
    top, s, d = xs.shape
    v = post(xs.reshape(top * s, d)).reshape(top, s, s)
    return torch.diagonal(v, dim1=1, dim2=2).sum()


def ascend_samples(post: PosteriorFunctions, x0: torch.Tensor, *, ascent_steps: int,
                   lr: float) -> torch.Tensor:
    """The reference's hand-written Adam ascent (β = 0.9/0.999, bias
    correction, ε = 1e-8, clipped to [0,1] after each step) of every start
    on its own sample, from x0 (num_top, s, d) → the iterates after
    ``ascent_steps`` steps, same shape. One forward and one backward
    evaluation of the posterior per step."""
    xs = x0.detach()
    m = torch.zeros_like(xs)
    vv = torch.zeros_like(xs)
    for t in range(ascent_steps):
        xg = xs.requires_grad_()
        (g,) = torch.autograd.grad(ascent_value(post, xg), [xg])
        with torch.no_grad():
            m = 0.9 * m + 0.1 * g
            vv = 0.999 * vv + 0.001 * g * g
            mh = m / (1 - 0.9 ** (t + 1.0))
            vh = vv / (1 - 0.999 ** (t + 1.0))
            xs = torch.clamp(xs + lr * mh / (torch.sqrt(vh) + 1e-8), 0.0, 1.0)
    return xs.detach()


def _maximise_samples(
    post: PosteriorFunctions,
    y: torch.Tensor,
    *,
    num_candidates: int,
    num_top: int,
    ascent_steps: int,
    lr: float,
    exploit_frac: float = 0.9,
    lengthscale: float = 0.2,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
    pick: Optional[torch.Tensor] = None,
    perturb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Maximise each posterior sample on [0,1]^d → (s, d) acquisition points:
    the candidates, the top ``num_top`` of each sample (a stable descending
    sort), the ascent, then each sample's best final iterate."""
    s = post.num_samples
    cands = thompson_candidates(post.x, y, num_candidates, lengthscale=lengthscale,
                                exploit_frac=exploit_frac, generator=generator,
                                uniform=uniform, pick=pick, perturb=perturb)
    with torch.no_grad():
        vals = post(cands)  # (n_cand, s)
    top = torch.argsort(-vals, dim=0, stable=True)[:num_top]  # (top, s)
    xs = ascend_samples(post, cands[top], ascent_steps=ascent_steps, lr=lr)
    with torch.no_grad():
        final = post(xs.reshape(num_top * s, -1)).reshape(num_top, s, s)
    per = torch.diagonal(final, dim1=1, dim2=2)  # value of start t on sample j
    best_t = torch.argmax(per, dim=0)  # (s,)
    return xs[best_t, torch.arange(s, device=xs.device)]


def thompson_step(
    params: KernelParams,
    state: ThompsonState,
    objective: Callable[[torch.Tensor], torch.Tensor],
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[ThompsonDraws] = None,
    acq_batch: int = 50,
    num_features: int = 1024,
    spec: Optional[SpecLike] = None,
    num_candidates: int = 2000,
    num_top: int = 5,
    ascent_steps: int = 30,
    lr: float = 1e-3,
    **spec_overrides,
) -> ThompsonState:
    """One acquisition round on the state's device. ``spec`` is any registered
    SolverSpec (defaults to SDD, the paper's Thompson workhorse); extra keyword
    arguments are spec-field overrides. The draws come from ``generator``, a
    generator on the state's device, unless ``draws`` injects them."""
    dr = draws if draws is not None else ThompsonDraws()
    missing = [f.name for f in dataclasses.fields(dr)
               if f.name != "solver_draws" and getattr(dr, f.name) is None]
    if generator is None and missing:
        raise ValueError(f"thompson_step needs a torch.Generator to draw {missing}")
    s = as_spec("sdd" if spec is None else spec, **spec_overrides)
    with torch.no_grad():
        post = posterior_functions(
            params, state.x, state.y, generator=generator, num_samples=acq_batch,
            num_features=num_features, spec=s, omega=dr.omega, w=dr.w, eps=dr.eps,
            solver_draws=dr.solver_draws,
        )
    x_new = _maximise_samples(
        post, state.y, num_candidates=num_candidates, num_top=num_top,
        ascent_steps=ascent_steps, lr=lr,
        lengthscale=float(torch.mean(params.lengthscale)), generator=generator,
        uniform=dr.uniform, pick=dr.pick, perturb=dr.perturb,
    )
    obs = dr.obs
    if obs is None:
        obs = torch.randn((x_new.shape[0],), generator=generator, device=x_new.device)
    with torch.no_grad():
        y_new = objective(x_new) + torch.sqrt(params.noise) * obs
    x = torch.cat([state.x, x_new], dim=0)
    y = torch.cat([state.y, y_new], dim=0)
    return ThompsonState(x=x, y=y, best=float(torch.max(y)))
