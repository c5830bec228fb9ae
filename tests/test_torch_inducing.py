"""Inducing-point pathwise posteriors in the port (repro_torch.core.inducing)
against the JAX reference (repro.core.inducing), on the reference test's
problem (tests/test_svgp_inducing.py: n = 600, d = 2, SE, Z = X[::4]) with the
reference's own prior draws ω, w and noise ε injected.

Without a ridge the normal-equations operator is numerically singular here:
CG's iterates on the same inputs part between the packages after ~5
iterations even in float64 (4e-15 of scale at 5, 1e-5 at 10, ~3% at 30), as
the residual's norm grows before it falls. So the solve's outputs are held to
the reference at a 5-iteration budget in float64 and a 3-iteration one in
fp32, and the reference's default budget
(CG(200, 1e-5)) is held where the reference holds itself: in prediction
space, against the dense SGPR posterior."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.inducing import inducing_posterior as jinducing_posterior
from repro.core.inducing import select_inducing_greedy as jselect
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.rff import sample_prior as jsample_prior
from repro.core.solvers.spec import CG as JCG
from repro_torch.convert import inducing_draws_from_numpy, params_from_numpy
from repro_torch.core import CG
from repro_torch.core.inducing import inducing_posterior, select_inducing_greedy
from repro_torch.core.svgp import sgpr

KEY = jax.random.PRNGKey(0)
N, D, S, F = 600, 2, 256, 4096


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    """Largest entry error relative to the reference's largest entry."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _problem(dtype):
    """The reference test's data, hyperparameters and posterior key, and the
    reference's own draws (inducing.py:72-75: split the key into the prior's
    and ε's), as numpy arrays of ``dtype`` for both packages."""
    x = jax.random.normal(KEY, (N, D))
    y = jnp.sin(2 * x[:, 0]) + 0.1 * jax.random.normal(jax.random.fold_in(KEY, 1), (N,))
    xt = jax.random.normal(jax.random.fold_in(KEY, 2), (40, D))
    jp = jmake_params("se", lengthscale=0.8, signal=1.0, noise=0.3, d=D)
    arrays = {k: np.asarray(v, dtype) for k, v in dict(x=x, y=y, xt=xt).items()}
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), jp)
    key = jax.random.PRNGKey(1)
    kp, ke = jax.random.split(key)
    prior = jsample_prior(jp, kp, S, F, D)
    eps = jnp.sqrt(jp.noise) * jax.random.normal(ke, (N, S), dtype)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "se", device="cpu")
    if dtype == np.float32:
        draws = inducing_draws_from_numpy(np.asarray(prior.ff.omega), np.asarray(prior.w),
                                          np.asarray(eps), device="cpu")
    else:  # the converters carry float32; the float64 draws go across as they are
        tp = dataclasses.replace(tp, **{k: getattr(tp, k).double() for k in
                                        ("log_lengthscale", "log_signal", "log_noise")})
        draws = dict(omega=prior.ff.omega, w=prior.w, eps=eps)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    return dict(jp=jp, key=key, j={k: jnp.asarray(v) for k, v in arrays.items()},
                tp=tp, t=t, draws=draws)


def _both(pb, spec_kw):
    j, t = pb["j"], pb["t"]
    ref = jinducing_posterior(pb["jp"], j["x"], j["y"], j["x"][::4], pb["key"],
                              num_samples=S, num_features=F, spec=JCG(**spec_kw))
    out = inducing_posterior(pb["tp"], t["x"], t["y"], t["x"][::4], num_samples=S,
                             num_features=F, spec=CG(**spec_kw), **pb["draws"])
    return ref, out


def test_inducing_posterior_matches_reference_in_float64():
    # float64 on both sides (JAX under enable_x64), the reference's draws, a
    # 5-iteration CG budget: v_mean, alpha, the mean and the sample paths at
    # the test points, held at 1e-9 of scale (measured ~4e-15 on the solve)
    with jax.enable_x64(True):
        pb = _problem(np.float64)
        ref, out = _both(pb, dict(max_iters=5, tol=1e-12))
        assert out.solve_info.iterations == 5 and out.alpha.dtype == torch.float64
        np.testing.assert_array_equal(out.prior.ff.omega.numpy(), np.asarray(ref.prior.ff.omega))
        assert _rel(out.v_mean.numpy(), ref.v_mean) <= 1e-9
        assert _rel(out.alpha.numpy(), ref.alpha) <= 1e-9
        xt, jxt = pb["t"]["xt"], pb["j"]["xt"]
        assert _rel(out.mean(xt).numpy(), ref.mean(jxt)) <= 1e-9
        assert _rel(out(xt).numpy(), ref(jxt)) <= 1e-9


def test_inducing_posterior_matches_reference_in_fp32():
    # fp32: the NormalEq's chunked products and the RFF prior round apart
    # between the packages, and CG amplifies it ~100× from its 3rd iteration
    # to its 5th (alpha 9.5e-6 → 1.3e-3 of scale), so the budget is 3:
    # measured 5.4e-6 (v_mean), 9.5e-6 (alpha), 2.6e-6 (mean) and 2.5e-5 (the
    # sample paths, whose K(x*, Z)(v − α) cancels) of scale; held at 1e-4
    # and, for the paths, 5e-4
    pb = _problem(np.float32)
    ref, out = _both(pb, dict(max_iters=3, tol=1e-12))
    xt, jxt = pb["t"]["xt"], pb["j"]["xt"]
    np.testing.assert_array_equal(out.prior.ff.omega.numpy(), np.asarray(ref.prior.ff.omega))
    assert _rel(out.v_mean.numpy(), ref.v_mean) <= 1e-4
    assert _rel(out.alpha.numpy(), ref.alpha) <= 1e-4
    assert _rel(out.mean(xt).numpy(), ref.mean(jxt)) <= 1e-4
    assert _rel(out(xt).numpy(), ref(jxt)) <= 5e-4


def test_inducing_posterior_default_budget_holds_the_references_claims():
    # the reference's default CG(200, 1e-5), fp32: the twin of
    # tests/test_svgp_inducing.py:81-91 (mean within 5e-2 of the dense SGPR
    # posterior's, the 256 paths' variance within 0.12 of its variance), and
    # the port's mean within the same 5e-2 of the reference's
    pb = _problem(np.float32)
    j, t = pb["j"], pb["t"]
    ref = jinducing_posterior(pb["jp"], j["x"], j["y"], j["x"][::4], pb["key"],
                              num_samples=S, num_features=F)
    out = inducing_posterior(pb["tp"], t["x"], t["y"], t["x"][::4], num_samples=S,
                             num_features=F, **pb["draws"])
    assert out.solve_info.iterations == 200 and out.solve_info.healthy
    dense = sgpr(pb["tp"], t["x"], t["y"], t["x"][::4])
    mean = out.mean(t["xt"])
    np.testing.assert_allclose(mean.numpy(), dense.mean(t["xt"]).numpy(), atol=5e-2)
    np.testing.assert_allclose(torch.var(out(t["xt"]), dim=1, correction=0).numpy(),
                               dense.var(t["xt"]).numpy(), atol=0.12)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref.mean(j["xt"])), atol=5e-2)


def test_inducing_posterior_draws_from_its_generator():
    # no injected draws: the prior and ε come from the generator, so one seed
    # gives one posterior, and the feature count and sample shape hold
    pb = _problem(np.float32)
    t = pb["t"]
    kw = dict(num_samples=4, num_features=64, spec=CG(max_iters=3))
    a = inducing_posterior(pb["tp"], t["x"], t["y"], t["x"][::20],
                           generator=torch.Generator().manual_seed(3), **kw)
    b = inducing_posterior(pb["tp"], t["x"], t["y"], t["x"][::20],
                           generator=torch.Generator().manual_seed(3), **kw)
    assert a.alpha.shape == (30, 4) and a.prior.ff.num_features == 64
    torch.testing.assert_close(a(t["xt"]), b(t["xt"]), rtol=0, atol=0)


def test_select_inducing_greedy_on_injected_and_drawn_indices():
    # the reference's own subset (jax.random.choice without replacement)
    # injected gives the reference's points exactly; drawn from a generator,
    # the m points are distinct rows (the reference test's spread check)
    x = jax.random.normal(KEY, (200, 2))
    ref = jselect(x, 20, jax.random.PRNGKey(1))
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(1), 200, (20,), replace=False))
    tx = torch.from_numpy(np.array(x))
    z = select_inducing_greedy(tx, 20, idx=torch.from_numpy(idx).long())
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref))
    z = select_inducing_greedy(tx, 20, generator=torch.Generator().manual_seed(1))
    assert z.shape == (20, 2)
    d = np.linalg.norm(z.numpy()[:, None] - z.numpy()[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 1e-6
