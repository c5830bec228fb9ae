"""Learning-curve prediction with the latent Kronecker GP (Ch. 6 §6.3.2) —
twin of ``repro/train/curve_gp.py``.

A sweep logs (config, step) → loss into a partially observed grid: configs ×
steps is a product space, and runs observed only as prefixes give the
projection mask. The fitted GP predicts each curve's continuation, which
serves to

  * early-stop runs whose predicted final loss is dominated (sweep pruning),
  * flag divergence (observed loss outside the posterior's 3σ band).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.kernels_fn import make_params
from ..core.kronecker import lkgp_posterior, make_lkgp
from ..device import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass
class CurvePrediction:
    mean: torch.Tensor  # (configs, steps) posterior mean over the full grid
    std: torch.Tensor  # (configs, steps)
    final_mean: torch.Tensor  # (configs,) predicted final-step loss
    final_std: torch.Tensor


def fit_curve_gp(
    curves,  # (n_configs, n_steps) observed losses (junk where masked)
    mask,  # (n_configs, n_steps) bool — True = observed
    config_features,  # (n_configs, d1)
    step_features=None,  # (n_steps, 1); default log-steps
    *,
    noise: float = 1e-2,
    num_samples: int = 16,
    max_iters: int = 300,
    generator: Optional[torch.Generator] = None,
    w: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> CurvePrediction:
    """The LKGP posterior over the whole grid, from the observed cells.

    Arrays or tensors; they run on ``curves``' device when it is a tensor and
    no ``device`` is named, else on ``device`` (the card unless ``"cpu"``).
    ``w`` and ``eps`` inject ``lkgp_posterior``'s draws; otherwise they come
    from ``generator`` (seed 0 on the device when none is given).
    """
    if isinstance(curves, torch.Tensor) and device is None:
        dev = curves.device
    else:
        dev = resolve_device(device)
    curves = torch.as_tensor(curves, dtype=torch.float32, device=dev)
    config_features = torch.as_tensor(config_features, dtype=torch.float32, device=dev)
    n_steps = curves.shape[1]
    if step_features is None:
        step_features = torch.log(torch.arange(1, n_steps + 1, dtype=torch.float32,
                                               device=dev))[:, None]
    if generator is None and (w is None or eps is None):
        generator = make_generator(0, dev)
    gp = make_lkgp(
        make_params("matern52", lengthscale=1.0, signal=1.0, d=config_features.shape[1],
                    device=dev),
        make_params("matern52", lengthscale=1.0, signal=1.0, d=1, device=dev),
        config_features, step_features, mask, noise, device=dev,
    )
    y_obs = curves.reshape(-1)[gp.obs_idx]
    mu = y_obs.mean()
    mean, samples = lkgp_posterior(gp, y_obs - mu, generator=generator,
                                   num_samples=num_samples, max_iters=max_iters, w=w, eps=eps)
    mean = mean + mu
    std = torch.std(samples, dim=-1, correction=0)
    return CurvePrediction(mean=mean, std=std, final_mean=mean[:, -1], final_std=std[:, -1])


def should_stop_early(pred: CurvePrediction, config_idx: int, margin: float = 1.0) -> bool:
    """Prune run i if its predicted final loss is at least ``margin``·σ worse
    than the best predicted final loss across the sweep."""
    best = torch.min(pred.final_mean)
    i = config_idx
    return bool(pred.final_mean[i] - margin * pred.final_std[i] > best)


def divergence_score(pred: CurvePrediction, config_idx: int, step: int,
                     observed_loss: float) -> float:
    """|z|-score of an observed loss under the GP posterior — >3 flags divergence."""
    m = pred.mean[config_idx, step]
    s = torch.clamp(pred.std[config_idx, step], min=1e-6)
    return float(torch.abs(observed_loss - m) / s)
