"""Deterministic synthetic data — twin of ``repro/data/pipeline.py``'s LM token
batches, regression datasets, learning-curve grids and molecule fingerprints.

``regression_dataset``, ``grid_curves`` and ``molecule_fingerprints``: the
reference is pure numpy up to its final ``jnp.asarray``, so these compute the
bit-identical arrays, the first two as numpy arrays (callers move them to a
device), the fingerprints as tensors on the requested device. ``token_batch``: the same planted bigram
chain, drawn from a ``torch.Generator`` (so not the reference's tokens: the
parity tests hand both packages the same tokens instead); ``lm_batch`` adds
the stub frontends' inputs (``stub_inputs``), which the reference's launchers
do not give.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def token_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int, *,
                device: DeviceLike = None) -> dict:
    """Stateless LM batch, a pure function of (seed, step): each row starts
    uniform, then next = (31·cur + 17) mod vocab with probability 0.8 and
    uniform otherwise. Returns int64 ``tokens`` (batch, seq_len) and their
    next tokens ``labels``. Drawn on the CPU, so the tokens are the same on
    every device."""
    gen = torch.Generator().manual_seed((int(seed) << 32) + int(step))
    a, c = 31, 17
    cur = torch.randint(0, vocab, (batch,), generator=gen)
    rnd = torch.randint(0, vocab, (seq_len, batch), generator=gen)
    coin = torch.rand((seq_len, batch), generator=gen) < 0.8
    chain = [cur]
    for t in range(seq_len):
        cur = torch.where(coin[t], (a * cur + c) % vocab, rnd[t])
        chain.append(cur)
    tokens = torch.stack(chain, dim=1).to(resolve_device(device))  # (batch, seq_len + 1)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def stub_inputs(cfg, seed: int, step: int, batch: int, *, device: DeviceLike = None) -> dict:
    """The stub frontends' inputs of batch ``step``, a pure function of (seed,
    step) drawn with numpy: whisper's frame embeddings "frames" (batch,
    encoder_seq, d_model), unit normal; qwen2-vl's patch embeddings
    "vision_embeds" (batch, vision_tokens, d_model) at the token embeddings'
    scale, 0.02. Empty for the other families."""
    rng = np.random.default_rng([seed, step])
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = 0.02 * rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model), np.float32)
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def lm_batch(cfg, seed: int, step: int, batch: int, seq_len: int, *,
             device: DeviceLike = None) -> dict:
    """Train batch ``step`` of ``cfg``: ``token_batch``'s tokens and labels and
    the family's ``stub_inputs``, all a pure function of (seed, step)."""
    return dict(token_batch(seed, step, batch, seq_len, cfg.vocab_size, device=device),
                **stub_inputs(cfg, seed, step, batch, device=device))

# name → (n, d) matching the paper's Table 3.1/4.1 datasets (synthetic stand-ins)
UCI_SHAPES = {
    "pol": (15_000, 26),
    "elevators": (16_599, 18),
    "bike": (17_379, 17),
    "protein": (45_730, 9),
    "keggdirected": (48_827, 20),
    "3droad": (434_874, 3),
    "song": (515_345, 90),
    "buzz": (583_250, 77),
    "houseelectric": (2_049_280, 11),
}


def regression_dataset(name_or_n, d: Optional[int] = None, seed: int = 0,
                       noise: float = 0.1, n_test: int = 1024) -> dict:
    """Synthetic regression with UCI-matched shapes: y = sum of random sinusoids
    (stationary, medium lengthscale) + Gaussian noise. Returns a dict of numpy
    arrays ("x", "y", "x_test", "y_test") and the ints "n", "d"."""
    if isinstance(name_or_n, str):
        n, d = UCI_SHAPES[name_or_n]
    else:
        n = int(name_or_n)
        if d is None:
            raise ValueError("regression_dataset(n) needs d")
    rng = np.random.default_rng(seed)
    # frequency scale ∝ 1/√d keeps the function's total variation moderate in
    # any dimension
    w = rng.normal(size=(d, 16)) * (1.5 / np.sqrt(d))
    b = rng.uniform(0, 2 * np.pi, size=16)
    amp = rng.normal(size=16) / np.sqrt(16)

    def f(x):
        return np.cos(x @ w + b) @ amp

    x = rng.normal(size=(n, d)).astype(np.float32)
    xt = rng.normal(size=(n_test, d)).astype(np.float32)
    y = (f(x) + noise * rng.normal(size=n)).astype(np.float32)
    yt = f(xt).astype(np.float32)
    mu, sd = y.mean(), y.std() + 1e-12
    return {
        "x": x, "y": (y - mu) / sd,
        "x_test": xt, "y_test": (yt - mu) / sd,
        "n": n, "d": d,
    }


def grid_curves(n_configs: int = 64, n_steps: int = 50, density: float = 0.7,
                seed: int = 0) -> dict:
    """Learning-curve grid (configs × steps) with missing values (Ch. 6 §6.3.2):
    loss_ij = a_i · (t_j+1)^(−b_i) + c_i + noise; curves observed as prefixes
    of random length. Returns numpy arrays: "curves" (n_configs, n_steps)
    float32, "mask" bool (True = observed), "grid1" (n_configs, 4) config
    features and "grid2" (n_steps, 1) log-steps."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, n_configs)
    bexp = rng.uniform(0.3, 0.8, n_configs)
    c = rng.uniform(0.1, 0.5, n_configs)
    t = np.arange(1, n_steps + 1, dtype=np.float32)
    curves = a[:, None] * t[None, :] ** (-bexp[:, None]) + c[:, None]
    curves += 0.01 * rng.normal(size=curves.shape)
    # prefix observation mask: config i observed up to a random cut
    cuts = rng.integers(int(density * n_steps * 0.5), n_steps + 1, n_configs)
    mask = t[None, :] <= cuts[:, None]
    x1 = rng.normal(size=(n_configs, 4)).astype(np.float32)  # config features
    x2 = np.log(t)[:, None].astype(np.float32)  # step feature
    return {"curves": curves.astype(np.float32), "mask": mask, "grid1": x1, "grid2": x2}


def molecule_fingerprints(n: int = 4096, dim: int = 1024, seed: int = 0, n_test: int = 512,
                          *, device: DeviceLike = None) -> dict:
    """Sparse count fingerprints (counts in {0, 1, 2}) and synthetic binding
    scores that depend on the presence of 8 random bit motifs, so that
    Tanimoto similarity is the right inductive bias (Ch. 4 §4.3.3); scores
    clipped at their 95% quantile and standardised on the training rows.
    Returns float32 tensors on ``device``: "x" (n, dim), "y" (n,), "x_test"
    (n_test, dim), "y_test" (n_test,)."""
    rng = np.random.default_rng(seed)
    ntot = n + n_test
    x = (rng.random((ntot, dim)) < 0.05).astype(np.float32)
    x += (rng.random((ntot, dim)) < 0.01).astype(np.float32)
    motifs = (rng.random((8, dim)) < 0.08).astype(np.float32)
    wm = rng.normal(size=8)
    overlap = (x @ motifs.T) / (motifs.sum(1, keepdims=True).T + 1e-9)
    y = overlap @ wm + 0.05 * rng.normal(size=ntot)
    y = np.minimum(y, np.quantile(y, 0.95))
    mu, sd = y[:n].mean(), y[:n].std() + 1e-12
    y = ((y - mu) / sd).astype(np.float32)
    dev = resolve_device(device)
    return {"x": torch.from_numpy(x[:n]).to(dev), "y": torch.from_numpy(y[:n]).to(dev),
            "x_test": torch.from_numpy(x[n:]).to(dev), "y_test": torch.from_numpy(y[n:]).to(dev)}
