"""Pathwise conditioning in the port (repro_torch.core.pathwise, core.rff)
against the JAX reference, with the reference's own random draws injected."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import make_params as jmake_params
from repro.core.pathwise import posterior_functions as jposterior_functions
from repro.core.rff import sample_prior as jsample_prior
from repro.core.solvers.spec import CG as JCG
from repro_torch.convert import (
    features_from_numpy, params_from_numpy, posterior_from_numpy, prior_from_numpy,
)
from repro_torch.core.pathwise import pathwise_target_rows, posterior_functions
from repro_torch.core.rff import sample_prior
from repro_torch.core.solvers import CG

N, D, S, F = 240, 3, 8, 256


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=N)).astype(np.float32)
    xt = rng.normal(size=(50, D)).astype(np.float32)
    jp = jmake_params("matern32", lengthscale=0.9, signal=1.2, noise=0.15, d=D)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "matern32", device="cpu")
    key = jax.random.PRNGKey(3)
    spec = dict(max_iters=400, tol=1e-5)
    ref = jposterior_functions(jp, jnp.asarray(x), jnp.asarray(y), key, num_samples=S,
                               num_features=F, spec=JCG(**spec))
    # the reference's draws, as posterior_functions makes them (pathwise.py:172)
    kp, ke, _ = jax.random.split(key, 3)
    jprior = jsample_prior(jp, kp, S, F, D)
    eps = np.array(jnp.sqrt(jp.noise) * jax.random.normal(ke, (N, S)))
    out = posterior_functions(
        tp, torch.from_numpy(x), torch.from_numpy(y), num_samples=S, num_features=F,
        spec=CG(**spec), omega=torch.from_numpy(np.array(jprior.ff.omega)),
        w=torch.from_numpy(np.array(jprior.w)), eps=torch.from_numpy(eps),
    )
    return dict(x=x, y=y, xt=xt, jp=jp, tp=tp, ref=ref, out=out, eps=eps)


def test_solve_weights_match_jax(problem):
    # Both solve the same (1+s)-column system to relative residual 1e-5 in
    # fp32; their weights agree to 1e-3 relative.
    ref, out = problem["ref"], problem["out"]
    np.testing.assert_array_equal(np.array(ref.prior.ff.omega), out.prior.ff.omega.numpy())
    assert _rel(out.v_mean.numpy(), ref.v_mean) <= 1e-3
    assert _rel(out.alpha.numpy(), ref.alpha) <= 1e-3
    assert out.solve_info.converged and out.solve_info.matvecs == out.solve_info.iterations


def test_mean_and_variance_at_test_points_match_jax(problem):
    ref, out, xt = problem["ref"], problem["out"], problem["xt"]
    jm, jv = ref.sample_mean_and_var(jnp.asarray(xt))
    tm, tv = out.sample_mean_and_var(torch.from_numpy(xt))
    assert _rel(tm.numpy(), jm) <= 1e-3
    assert _rel(tv.numpy(), jv) <= 1e-3
    assert _rel(out(torch.from_numpy(xt)).numpy(), ref(jnp.asarray(xt))) <= 1e-3


def test_converted_posterior_evaluates_like_jax(problem):
    # No solve: the same weights and draws evaluated by both packages, which
    # differ only by fp32 summation order over n = 240 terms (≤ 1e-5).
    ref, tp, xt = problem["ref"], problem["tp"], problem["xt"]
    prior = prior_from_numpy(np.array(ref.prior.ff.omega), np.array(ref.prior.w),
                             np.array(ref.prior.ff.signal), device="cpu")
    post = posterior_from_numpy(tp, problem["x"], np.array(ref.v_mean),
                                np.array(ref.alpha), prior, device="cpu")
    txt, jxt = torch.from_numpy(xt), jnp.asarray(xt)
    assert _rel(post.mean(txt).numpy(), ref.mean(jxt)) <= 1e-5
    assert _rel(post(txt).numpy(), ref(jxt)) <= 1e-5
    blocks = xt[:48].reshape(4, 12, D)
    bm, bv = post.blocked_mean_and_var(torch.from_numpy(blocks))
    jbm, jbv = ref.blocked_mean_and_var(jnp.asarray(blocks))
    assert bm.shape == (4, 12) and _rel(bm.numpy(), jbm) <= 1e-5
    assert _rel(bv.numpy(), jbv) <= 1e-5
    w_new = np.random.default_rng(1).normal(size=(F, 3)).astype(np.float32)
    a_new = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    paths = post.sample_paths(txt, torch.from_numpy(w_new), torch.from_numpy(a_new))
    jpaths = ref.sample_paths(jxt, jnp.asarray(w_new), jnp.asarray(a_new))
    assert _rel(paths.numpy(), jpaths) <= 1e-5


def test_feature_map_and_target_rows_match_jax(problem):
    ref, xt = problem["ref"], problem["xt"]
    ff = features_from_numpy(np.array(ref.prior.ff.omega), np.array(ref.prior.ff.phase),
                             np.array(ref.prior.ff.signal), device="cpu")
    assert ff.num_features == F
    np.testing.assert_allclose(ff.features(torch.from_numpy(xt)).numpy(),
                               np.asarray(ref.prior.ff.features(jnp.asarray(xt))),
                               rtol=1e-5, atol=1e-6)
    y, f = torch.zeros(5), torch.ones(5, 2)
    eps = torch.full((5, 2), 0.3)
    data, delta, e = pathwise_target_rows(torch.tensor(0.09), y, f, eps=eps)
    assert data.shape == delta.shape == (5, 3) and e is eps
    np.testing.assert_allclose(delta[:, 1:].numpy(), 0.3 / 0.09, rtol=1e-6)
    assert (delta[:, 0] == 0).all() and (data[:, 1:] == 1).all()


def test_generator_draws_are_reproducible(problem):
    tp = problem["tp"]
    a = sample_prior(tp, 4, 64, D, generator=torch.Generator().manual_seed(5))
    b = sample_prior(tp, 4, 64, D, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.ff.omega, b.ff.omega) and torch.equal(a.w, b.w)
    assert a.w.shape == (64, 4) and a(torch.zeros(3, D)).shape == (3, 4)
    # the transpose is ported: Φᵀu against the materialised features
    xq, uq = torch.randn(3, D), torch.randn(3, 2)
    torch.testing.assert_close(a.phi_t_mv(xq, uq), a.features(xq).T @ uq,
                               rtol=1e-5, atol=1e-6)
