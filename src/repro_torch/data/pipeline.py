"""Deterministic synthetic regression data — numpy copy of the regression part
of ``repro/data/pipeline.py``.

The reference is pure numpy up to its final ``jnp.asarray``, so these return the
bit-identical float32 arrays, as numpy arrays; callers move them to a device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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
