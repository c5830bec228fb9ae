"""MLL optimisation in the port (repro_torch.core.mll, IterativeGP.optimize)
against the JAX reference's repro.core.mll, with the reference's own random
draws injected, on the problem of tests/test_mll.py:15-24."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.gp import exact_mll as jexact_mll
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.mll import mll_grad as jmll_grad
from repro.core.mll import optimize_mll as jmll_optimize
from repro.core.solvers.spec import CG as JCG
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import (
    CG, IterativeGP, MLLDraws, exact_mll, make_params, mll_grad, optimize_mll,
)
from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_bwd

LEAVES = ("log_lengthscale", "log_signal", "log_noise")
#: Gradients of one estimate, port vs reference, on the same draws with both
#: solves at CG tol 1e-6 in fp32: the solutions agree to ~1e-5, so each leaf's
#: gradient agrees to 1e-3 relative (measured: ≤ 3e-5).
GRAD_RTOL = 1e-3
#: θ after each Adam step, port vs reference (log space, absolute)
THETA_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_torch(jp):
    return params_from_numpy(*(np.asarray(getattr(jp, k)) for k in LEAVES), jp.kind,
                             device="cpu")


@pytest.fixture(scope="module")
def problem():
    key = jax.random.PRNGKey(0)
    n, d = 300, 2
    x = jax.random.normal(key, (n, d))
    y = jnp.sin(2 * x[:, 0]) * jnp.cos(x[:, 1])
    y = y + 0.1 * jax.random.normal(jax.random.fold_in(key, 1), (n,))
    return dict(x=x, y=y, n=n, d=d, tx=torch.from_numpy(np.array(x)),
                ty=torch.from_numpy(np.array(y)))


def _jax_draws(key, kind, n, d, estimator, num_probes=8, num_features=1024):
    """The base draws the reference's mll_grad makes from ``key``
    (mll.py:85-97, rff.py:291-293, kernels_fn.py:188-199), before θ scales
    them."""
    kp, ke, _ = jax.random.split(key, 3)
    noise = np.array(jax.random.normal(ke, (n, num_probes), jnp.float32))
    if estimator == "hutchinson":
        return MLLDraws(noise=torch.from_numpy(noise))
    kf, kw = jax.random.split(kp)
    m = num_features // 2
    normals = np.array(jax.random.normal(kf, (m, d)))
    gammas = None
    if kind != "se":
        nu = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[kind]
        gammas = torch.from_numpy(np.array(
            jax.random.gamma(jax.random.fold_in(kf, 1), nu, (m, 1))))
    w = np.array(jax.random.normal(kw, (num_features, num_probes)))
    return MLLDraws(noise=torch.from_numpy(noise), normals=torch.from_numpy(normals),
                    gammas=gammas, w=torch.from_numpy(w))


@pytest.mark.parametrize("kind,estimator", [
    ("se", "pathwise"), ("se", "hutchinson"), ("matern32", "pathwise"),
])
def test_mll_grad_matches_jax(problem, kind, estimator):
    # the port on both of its CPU routes: "chunked" (plain autograd) and
    # "cuda" (the Gram Function with the plain versions standing in)
    t = problem
    jp = jmake_params(kind, lengthscale=1.2, signal=0.8, noise=0.3, d=t["d"])
    key = jax.random.PRNGKey(5)
    ref = jmll_grad(jp, t["x"], t["y"], key, estimator=estimator,
                    spec=JCG(max_iters=500, tol=1e-6))
    draws = _jax_draws(key, kind, t["n"], t["d"], estimator)
    for backend in ("chunked", "cuda"):
        out = mll_grad(_to_torch(jp), t["tx"], t["ty"], estimator=estimator, draws=draws,
                       spec=CG(max_iters=500, tol=1e-6, backend=backend))
        for name in LEAVES:
            a, b = getattr(out.grad, name).numpy(), np.asarray(getattr(ref.grad, name))
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=0, err_msg=f"{backend} {name}")
        assert out.solve_info.converged and out.solve_info.healthy
        assert abs(out.solver_iterations - int(ref.solver_iterations)) <= 2
        assert not out.v_y.requires_grad and not out.alpha.requires_grad


def test_optimize_mll_trajectory_matches_jax(problem):
    # five warm-started steps on one set of draws: θ after every step, and the
    # total inner iterations within the 15% of benchmarks/check_matvecs.py
    t = problem
    jp0 = jmake_params("se", lengthscale=2.0, signal=0.5, noise=0.5, d=t["d"])
    key = jax.random.PRNGKey(0)
    kw = dict(num_steps=5, lr=0.05, num_probes=8)
    jtraj, ttraj = [], []
    ref = jmll_optimize(jp0, t["x"], t["y"], key, spec=JCG(max_iters=500, tol=1e-6),
                        callback=lambda i, st: jtraj.append(st.params), **kw)
    out = optimize_mll(_to_torch(jp0), t["tx"], t["ty"], spec=CG(max_iters=500, tol=1e-6),
                       draws=_jax_draws(key, "se", t["n"], t["d"], "pathwise"),
                       callback=lambda i, st: ttraj.append(st.params), **kw)
    assert len(ttraj) == len(jtraj) == 5 and out.step == 5
    for a, b in zip(ttraj, jtraj):
        for name in LEAVES:
            np.testing.assert_allclose(getattr(a, name).numpy(), np.asarray(getattr(b, name)),
                                       rtol=0, atol=THETA_ATOL)
    assert abs(out.total_solver_iters - ref.total_solver_iters) <= 0.15 * ref.total_solver_iters
    # a warm solve spends its iterations plus the initial residual's matvec
    assert out.last_solve.matvecs == out.last_solve.iterations + 1


def test_exact_mll_matches_jax(problem):
    t = problem
    jp = jmake_params("matern52", lengthscale=0.9, signal=1.1, noise=0.4, d=t["d"])
    ref = float(jexact_mll(jp, t["x"], t["y"]))
    out = exact_mll(_to_torch(jp), t["tx"], t["ty"])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    out64 = exact_mll(_to_torch(jp), t["tx"].double(), t["ty"].double())
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(float(out64), ref, rtol=1e-5)


def test_optimize_mll_improves_evidence(problem):
    # the twin of tests/test_mll.py:59, on the port's own draws
    t = problem
    p0 = make_params("se", lengthscale=3.0, signal=0.3, noise=0.8, d=t["d"], device="cpu")
    before = float(exact_mll(p0, t["tx"], t["ty"]))
    st = optimize_mll(p0, t["tx"], t["ty"], generator=torch.Generator().manual_seed(0),
                      num_steps=15, lr=0.1, num_probes=8, spec=CG(max_iters=200, tol=1e-6))
    after = float(exact_mll(st.params, t["tx"], t["ty"]))
    assert after > before + 1.0, (before, after)


def test_warm_start_cuts_total_iterations(problem):
    # the twin of tests/test_mll.py:69: warm starts on fixed draws cut the
    # inner iterations, and the model they reach is as good
    t = problem
    p0 = make_params("se", lengthscale=2.0, signal=0.5, noise=0.5, d=t["d"], device="cpu")
    kw = dict(num_steps=10, lr=0.05, num_probes=8, spec=CG(max_iters=500, tol=1e-4))
    warm = optimize_mll(p0, t["tx"], t["ty"], generator=torch.Generator().manual_seed(0),
                        warm_start=True, **kw)
    cold = optimize_mll(p0, t["tx"], t["ty"], generator=torch.Generator().manual_seed(0),
                        warm_start=False, **kw)
    assert warm.total_solver_iters < cold.total_solver_iters
    lw = float(exact_mll(warm.params, t["tx"], t["ty"]))
    lc = float(exact_mll(cold.params, t["tx"], t["ty"]))
    assert lw > lc - 3.0


def test_injected_draws_need_a_warm_start(problem):
    t = problem
    p0 = make_params("se", d=t["d"], device="cpu")
    draws = MLLDraws(noise=torch.zeros(t["n"], 8))
    with pytest.raises(ValueError, match="warm_start"):
        optimize_mll(p0, t["tx"], t["ty"], draws=draws, warm_start=False, num_steps=1)
    with pytest.raises(ValueError, match="unknown estimator"):
        mll_grad(p0, t["tx"], t["ty"], estimator="exact")


def test_iterative_gp_optimize(problem):
    # the façade runs optimize_mll on its spec, takes the new θ, keeps the
    # state and drops the cached posterior; on CPU tensors nothing is launched
    t = problem
    x, y = t["tx"].numpy(), t["ty"].numpy()
    gp = IterativeGP("se", lengthscale=2.0, signal=0.5, noise=0.5, seed=3,
                     spec=CG(max_iters=300, tol=1e-4), device="cpu").fit(x, y)
    post = gp.posterior()
    launches = (gram_matvec.launches, gram_matvec_bwd.launches)
    steps = []
    assert gp.optimize(num_steps=3, lr=0.05, generator=torch.Generator().manual_seed(3),
                       callback=lambda i, st: steps.append(i)) is gp
    assert steps == [0, 1, 2] and gp.last_optim.step == 3
    assert (gram_matvec.launches, gram_matvec_bwd.launches) == launches
    ref = optimize_mll(make_params("se", lengthscale=2.0, signal=0.5, noise=0.5, d=t["d"],
                                   device="cpu"),
                       t["tx"], t["ty"], generator=torch.Generator().manual_seed(3),
                       num_steps=3, lr=0.05, spec=CG(max_iters=300, tol=1e-4))
    for name in LEAVES:
        torch.testing.assert_close(getattr(gp.params, name), getattr(ref.params, name))
    assert gp.posterior() is not post
    mean, var = gp.predict(x[:20])
    assert bool(torch.isfinite(mean).all() and (var > 0).all())


def test_params_to_numpy_round_trip():
    p = make_params("matern32", lengthscale=[0.5, 2.0], signal=1.3, noise=0.2, device="cpu")
    back = params_from_numpy(*params_to_numpy(p), device="cpu")
    assert back.kind == "matern32"
    for name in LEAVES:
        torch.testing.assert_close(getattr(back, name), getattr(p, name))
