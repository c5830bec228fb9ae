"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(only launch/dryrun.py installs the 512-device placeholder platform)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.kernels_fn import gram, make_params


@pytest.fixture(scope="session")
def toy_regression():
    """Small GP regression problem with a dense ground-truth solve."""
    key = jax.random.PRNGKey(0)
    n, d = 400, 3
    x = jax.random.normal(key, (n, d))
    y = jnp.sin(2.0 * x[:, 0]) + jnp.cos(x[:, 1] + x[:, 2])
    y = y + 0.05 * jax.random.normal(jax.random.fold_in(key, 1), (n,))
    params = make_params("matern32", lengthscale=0.8, signal=1.0, noise=0.3, d=d)
    kmat = gram(params, x) + params.noise * jnp.eye(n)
    v_star = jnp.linalg.solve(kmat, y)
    xt = jax.random.normal(jax.random.fold_in(key, 2), (64, d))
    return dict(x=x, y=y, params=params, kmat=kmat, v_star=v_star, x_test=xt, n=n, d=d)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (the port's CUDA kernels); skips without one"
    )
