"""Carry the JAX package's state across, as numpy arrays, into the port's objects
(GP hyperparameters, features, posteriors, serving states, SVGP and LKGP
states and draws; LM params and optimiser states).

The parity tests pull these arrays out of ``repro`` objects; the port itself
never sees JAX. Every function takes the target ``device`` (the card unless
``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.kernels_fn import KernelParams
from .core.kronecker import LatentKroneckerGP
from .core.pathwise import PosteriorFunctions
from .core.precond import PrecondDraws
from .core.rff import FourierFeatures, PriorSamples
from .core.solvers import RowDraws, SGDDraws, SolveResult
from .core.solvers.spec import as_spec, spec_from_dict
from .core.svgp import SVGPState
from .core.thompson import ThompsonDraws, ThompsonState
from .device import DeviceLike, resolve_device
from .models.model import Transformer, leaf_tree, lm_leaves
from .models.param import tree_map
from .serve.request import RequestDraws
from .serve.state import PosteriorState, hypers_fingerprint


def _t(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def params_from_numpy(log_lengthscale, log_signal, log_noise, kind: str, *,
                      device: DeviceLike = None) -> KernelParams:
    dev = resolve_device(device)
    return KernelParams(
        log_lengthscale=_t(log_lengthscale, dev), log_signal=_t(log_signal, dev),
        log_noise=_t(log_noise, dev), kind=kind,
    )


def params_to_numpy(params: KernelParams) -> tuple:
    """(log_lengthscale, log_signal, log_noise, kind) as numpy arrays and the
    kind — what :func:`params_from_numpy` takes back."""
    return (*(t.detach().cpu().numpy() for t in
              (params.log_lengthscale, params.log_signal, params.log_noise)),
            params.kind)


def features_from_numpy(omega, phase, signal, *, paired: bool = True,
                        device: DeviceLike = None) -> FourierFeatures:
    dev = resolve_device(device)
    return FourierFeatures(omega=_t(omega, dev), phase=_t(phase, dev),
                           signal=_t(signal, dev), paired=paired)


def prior_from_numpy(omega, w, signal, *, device: DeviceLike = None) -> PriorSamples:
    dev = resolve_device(device)
    omega = _t(omega, dev)
    ff = FourierFeatures(omega=omega, phase=torch.zeros_like(omega[:, 0]),
                         signal=_t(signal, dev))
    return PriorSamples(ff=ff, w=_t(w, dev))


def posterior_from_numpy(params: KernelParams, x, v_mean, alpha,
                         prior: PriorSamples, *,
                         device: DeviceLike = None) -> PosteriorFunctions:
    """A posterior from its representer weights ``v_mean`` (n,), ``alpha``
    (n, s), training inputs ``x`` (n, d) and the prior it was conditioned on."""
    dev = resolve_device(device)
    return PosteriorFunctions(params=params, x=_t(x, dev), prior=prior,
                              v_mean=_t(v_mean, dev), alpha=_t(alpha, dev))


def posterior_state_from_numpy(params: KernelParams, x, y, omega, w, v_mean, alpha, eps,
                               f_x, spec, *, iterations: int, matvecs: int,
                               rel_residual=None, flags=None,
                               device: DeviceLike = None) -> PosteriorState:
    """A serving engine's fitted state: the training data ``x`` (n, d) and
    ``y`` (n,), the prior's ``omega`` (num_features/2, d) and ``w``
    (num_features, s), the representer weights ``v_mean`` (n,) and ``alpha``
    (n, s), the fit's noise draws ``eps`` and prior values ``f_x`` (n, s),
    the ``spec`` (a port spec, or the reference's ``spec_to_dict``), and the
    fit result's ``iterations``, ``matvecs`` and, if given, per-column
    ``rel_residual`` and ``flags`` (1 + s,). ``params`` come from
    :func:`params_from_numpy` on the same device."""
    dev = resolve_device(device)
    spec = spec_from_dict(spec) if isinstance(spec, dict) else as_spec(spec)
    prior = prior_from_numpy(omega, w, params.signal.detach().cpu().numpy(), device=dev)
    x, y = _t(x, dev), _t(y, dev)
    v_mean, alpha = _t(v_mean, dev), _t(alpha, dev)
    sol = torch.cat([v_mean[:, None], alpha], dim=1)
    cols = sol.shape[1]
    rel = torch.zeros(cols, device=dev) if rel_residual is None else _t(rel_residual, dev)
    fl = (torch.zeros(cols, dtype=torch.int32, device=dev) if flags is None else
          torch.as_tensor(np.array(flags, dtype=np.int32), device=dev))
    res = SolveResult(solution=sol, residual_norm=rel * 0.0, rel_residual=rel,
                      iterations=int(iterations), converged=bool((fl == 0).all()),
                      matvecs=int(matvecs), flags=fl)
    post = PosteriorFunctions(params=params, x=x, prior=prior, v_mean=v_mean, alpha=alpha,
                              solve_info=res)
    return PosteriorState(params=params, x=x, y=y, spec=spec, post=post, eps=_t(eps, dev),
                          f_x=_t(f_x, dev), fit_result=res,
                          hypers_key=hypers_fingerprint(params, x.shape[0]))


def request_draws_from_numpy(w, eps, uniform=None, pick=None, perturb=None, *,
                             device: DeviceLike = None) -> RequestDraws:
    """One serving request's draws: prior weights ``w`` (num_features,
    num_samples), noise ``eps`` (n, num_samples) and, for ``thompson_step``,
    the ``uniform`` explore candidates, the incumbents ``pick`` and their
    ``perturb`` normals — e.g. the reference engine's ``_request_draws`` and
    its ascent key's splits."""
    dev = resolve_device(device)
    return RequestDraws(
        w=_t(w, dev), eps=_t(eps, dev),
        uniform=None if uniform is None else _t(uniform, dev),
        pick=None if pick is None else torch.as_tensor(np.asarray(pick, dtype=np.int64),
                                                       device=dev),
        perturb=None if perturb is None else _t(perturb, dev))


def sgd_draws_from_numpy(idx, omega, *, device: DeviceLike = None) -> SGDDraws:
    """An SGD solve's per-step draws: ``idx`` (num_steps, batch) minibatch
    indices and ``omega`` (num_steps, num_features, d) frequencies, e.g. the
    reference's own ``fold_in(key, t)`` draws."""
    dev = resolve_device(device)
    return SGDDraws(idx=torch.as_tensor(np.asarray(idx, dtype=np.int64), device=dev),
                    omega=_t(omega, dev))


def row_draws_from_numpy(idx, *, device: DeviceLike = None) -> RowDraws:
    """An SDD or AP solve's per-step coordinate blocks ``idx`` (num_steps, batch)."""
    dev = resolve_device(device)
    return RowDraws(idx=torch.as_tensor(np.asarray(idx, dtype=np.int64), device=dev))


def precond_draws_from_numpy(idx=None, normals=None, gammas=None, *,
                             device: DeviceLike = None) -> PrecondDraws:
    """A preconditioner build's draws: the Nyström subset ``idx`` (rank,),
    or the RFF preconditioner's spectral base draws ``normals``
    (rank/2, d) and, for Matérn, ``gammas`` (rank/2, 1) — e.g. the
    reference's ``jax.random.choice`` subset and ``spectral_sample`` draws."""
    dev = resolve_device(device)
    return PrecondDraws(
        idx=None if idx is None else torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                                     device=dev),
        normals=None if normals is None else _t(normals, dev),
        gammas=None if gammas is None else _t(gammas, dev))


def svgp_state_from_numpy(theta1, theta2, *, device: DeviceLike = None) -> SVGPState:
    """An SVGP state from its natural parameters ``theta1`` (m,) and
    ``theta2`` (m, m)."""
    dev = resolve_device(device)
    return SVGPState(theta1=_t(theta1, dev), theta2=_t(theta2, dev))


def lkgp_from_numpy(params1: KernelParams, params2: KernelParams, grid1, grid2, obs_idx,
                    noise, *, device: DeviceLike = None) -> LatentKroneckerGP:
    """A latent Kronecker GP from its factor hyperparameters, grids ``grid1``
    (n1, d1) and ``grid2`` (n2, d2), flat observed indices ``obs_idx``
    (n_obs,) and noise variance ``noise``."""
    dev = resolve_device(device)
    return LatentKroneckerGP(
        params1=params1, params2=params2, grid1=_t(grid1, dev), grid2=_t(grid2, dev),
        obs_idx=torch.as_tensor(np.asarray(obs_idx, dtype=np.int64), device=dev),
        noise=_t(noise, dev))


def inducing_draws_from_numpy(omega, w, eps, *, device: DeviceLike = None) -> dict:
    """``inducing_posterior``'s draws as its keyword arguments: the prior's
    ``omega`` (num_features/2, d) and ``w`` (num_features, num_samples), and
    the noise ``eps`` (n, num_samples)."""
    dev = resolve_device(device)
    return dict(omega=_t(omega, dev), w=_t(w, dev), eps=_t(eps, dev))


def lkgp_draws_from_numpy(w, eps, *, device: DeviceLike = None) -> dict:
    """``lkgp_posterior``'s (and ``fit_curve_gp``'s) draws as keyword
    arguments: the grid normals ``w`` (n1, n2, s) and the noise ``eps``
    (n_obs, s)."""
    dev = resolve_device(device)
    return dict(w=_t(w, dev), eps=_t(eps, dev))


def thompson_draws_from_numpy(omega, w, eps, uniform, pick, perturb, obs, *,
                              solver_draws=None, device: DeviceLike = None) -> ThompsonDraws:
    """One ``thompson_step``'s draws: the posterior's ``omega``
    (num_features/2, d), ``w`` (num_features, acq_batch), ``eps``
    (n, acq_batch), the ``uniform`` explore candidates, the incumbents
    ``pick`` and their ``perturb`` normals, and the observation normals
    ``obs`` (acq_batch,); ``solver_draws`` from :func:`row_draws_from_numpy`
    or :func:`sgd_draws_from_numpy` (None for CG)."""
    dev = resolve_device(device)
    return ThompsonDraws(
        omega=_t(omega, dev), w=_t(w, dev), eps=_t(eps, dev), uniform=_t(uniform, dev),
        pick=torch.as_tensor(np.asarray(pick, dtype=np.int64), device=dev),
        perturb=_t(perturb, dev), obs=_t(obs, dev), solver_draws=solver_draws,
    )


def thompson_state_from_numpy(x, y, *, device: DeviceLike = None) -> ThompsonState:
    """A Thompson state from observed inputs ``x`` (n, d) and values ``y``
    (n,)."""
    dev = resolve_device(device)
    x, y = _t(x, dev), _t(y, dev)
    return ThompsonState(x=x, y=y, best=float(torch.max(y)))


def is_bf16_words(a) -> bool:
    """Whether numpy array ``a`` holds bf16 values as raw 2-byte words: a
    ``|V2`` array, what ``np.load`` gives back for the reference's bfloat16
    arrays."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def bf16_to_words(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's raw 2-byte words as a ``|V2`` array, the form in which
    ``np.savez`` stores the reference's bfloat16 leaves (numpy has no bf16,
    and the port does not import ``ml_dtypes``)."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.dtype("V2"))


def _lm_t(a, device: torch.device) -> torch.Tensor:
    """A weight in its own dtype: bfloat16 arrays (``ml_dtypes``' type, which
    JAX gives, or raw 2-byte words, :func:`is_bf16_words`) carried across bit
    for bit, everything else as float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or is_bf16_words(a):
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return _t(a, device)


def lm_params_from_numpy(cfg, tree, *, device: DeviceLike = None) -> Transformer:
    """The reference's LM params pytree as numpy arrays (``embed.tok`` and
    ``embed.unembed``, ``final_norm``, and ``layers.*`` stacked with a leading
    layer axis; jamba's period leaves with a sub-block axis after it;
    whisper's ``enc_layers.*``, ``enc_norm`` and ``dec_layers.*``) → the
    port's :class:`Transformer`, its layers unstacked. The weights keep their
    (in, out) orientation: both packages compute h @ W, and no weight goes
    into an ``nn.Linear`` (which would want Wᵀ). bf16 weights stay bf16, bit
    for bit; all others become float32."""
    dev = resolve_device(device)
    return Transformer(cfg, tree_map(lambda a: _lm_t(a, dev), tree))


def lm_params_to_numpy(model: Transformer, *, bf16: str = "float32") -> dict:
    """:func:`lm_params_from_numpy`'s inverse: the reference's params pytree,
    layers stacked again. bf16 weights become float32 arrays (exactly) or,
    with ``bf16="words"``, their raw words (:func:`bf16_to_words`)."""
    if bf16 not in ("float32", "words"):
        raise ValueError(f"bf16={bf16!r}: 'float32' or 'words'")

    def array(p):
        if p.dtype != torch.bfloat16:
            return p.detach().cpu().numpy()
        return bf16_to_words(p) if bf16 == "words" else p.detach().cpu().float().numpy()

    flat = [t.detach().cpu() for _, ts in lm_leaves(model) for t in ts]
    return tree_map(array, leaf_tree(model, flat))


def opt_state_from_numpy(cfg, mu, nu, step, *, device: DeviceLike = None):
    """The reference's ``OptState(mu, nu, step)`` of an LM as numpy arrays →
    the port's, its moments :class:`Transformer`s (bf16 ``mu`` carried bit for
    bit, as ``ml_dtypes`` arrays or raw words)."""
    from .train.optim import OptState  # the train package imports this module

    dev = resolve_device(device)
    return OptState(mu=lm_params_from_numpy(cfg, mu, device=dev),
                    nu=lm_params_from_numpy(cfg, nu, device=dev),
                    step=torch.as_tensor(np.array(step, dtype=np.int32), device=dev))


def opt_state_to_numpy(opt) -> dict:
    """:func:`opt_state_from_numpy`'s inverse: ``{"mu", "nu", "step"}``, the
    moments stacked as the reference stores them, a bf16 moment as its raw
    words, the step an int32 scalar."""
    return {"mu": lm_params_to_numpy(opt.mu, bf16="words"),
            "nu": lm_params_to_numpy(opt.nu, bf16="words"),
            "step": np.asarray(opt.step.detach().cpu().numpy(), dtype=np.int32)}
