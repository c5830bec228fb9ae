"""The port's stochastic solvers (SGD, SDD, AP) against the JAX reference's, on
the CPU, with the reference's own per-step ``fold_in(key, t)`` draws injected
(``SGDDraws``/``RowDraws``): iterates after 1, 5 and 20 steps within 1e-4 and
after 200 within 2e-3 (the fused-vs-features tolerance of
tests/test_features.py:283), the matvec counts of
tests/test_backends_and_counts.py:65,88,102, the regulariser that never
materialises features (tests/test_features.py:256), the generator
requirement, per-column freezing, and the whole pathwise posterior on each
solver."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import spectral_sample as jspectral_sample
from repro.core.operators import Gram as JGram
from repro.core.pathwise import posterior_functions as jposterior_functions
from repro.core.rff import sample_prior as jsample_prior
from repro.core.solvers.spec import AP as JAP
from repro.core.solvers.spec import SDD as JSDD
from repro.core.solvers.spec import SGD as JSGD
from repro.core.solvers.spec import solve as jsolve
from repro_torch.convert import params_from_numpy, row_draws_from_numpy, sgd_draws_from_numpy
from repro_torch.core.operators import Gram, matvec_counts, reset_matvec_counts
from repro_torch.core.pathwise import posterior_functions
from repro_torch.core.solvers import (
    AP, FLAG_NONFINITE, SDD, SGD, RowDraws, SGDDraws, solve,
)
from repro_torch.kernels import ops

KEY = jax.random.PRNGKey(3)
#: step-by-step parity, and after 200 steps (tests/test_features.py:283)
STEP_TOL, LONG_TOL = 1e-4, 2e-3
#: small-problem step sizes: the paper's defaults (0.5/n, 50/n) are set for
#: large n and diverge on 400 points; SDD's default averaging
#: r = 100/num_steps exceeds 1 below 100 steps, so the short runs fix r
SGD_KW = dict(batch_size=32, num_features=16, step_size_times_n=0.5)
SDD_KW = dict(batch_size=32, step_size_times_n=2.0, averaging=0.05)
AP_KW = dict(block_size=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(toy, **kw):
    jp = toy["params"]
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), jp.kind, device="cpu")
    return Gram(x=torch.from_numpy(np.array(toy["x"])), params=tp, **kw)


def _rhs(toy, s=2):
    y = np.asarray(toy["y"])
    extra = np.random.default_rng(0).normal(size=(y.shape[0], s)).astype(np.float32)
    return np.concatenate([y[:, None], extra], axis=1)


def _delta(toy, s=3):
    d = np.random.default_rng(1).normal(size=(toy["n"], s)).astype(np.float32)
    d[:, 0] = 0.0  # the mean column has no noise, as in pathwise_target_rows
    return d


def _row_draws(key, num_steps, batch, n):
    """The reference's blocks (sdd.py/ap.py): randint(fold_in(key, t))."""
    return np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, t), (batch,), 0, n))
                     for t in range(num_steps)])


def _sgd_draws(key, num_steps, batch, q, toy):
    """The reference's SGD draws (sgd.py): split(fold_in(key, t)) into the
    minibatch key and the feature key."""
    idx, omega = [], []
    for t in range(num_steps):
        ki, kf = jax.random.split(jax.random.fold_in(key, t))
        idx.append(np.asarray(jax.random.randint(ki, (batch,), 0, toy["n"])))
        omega.append(np.asarray(jspectral_sample(toy["params"], kf, q, toy["d"])))
    return np.stack(idx), np.stack(omega)


def _both(toy, name, num_steps, *, backend=None, delta=None):
    """(port, reference) solutions of one solve on the reference's draws."""
    b = _rhs(toy)
    jop = JGram(x=toy["x"], params=toy["params"])
    op = _port(toy)
    d_j = None if delta is None else jnp.asarray(delta)
    d_t = None if delta is None else torch.from_numpy(delta)
    if name == "sgd":
        jspec, spec = JSGD(num_steps=num_steps, **SGD_KW), SGD(num_steps=num_steps, **SGD_KW)
        draws = sgd_draws_from_numpy(*_sgd_draws(KEY, num_steps, 32, 16, toy), device="cpu")
    elif name == "sdd":
        jspec, spec = JSDD(num_steps=num_steps, **SDD_KW), SDD(num_steps=num_steps, **SDD_KW)
        draws = row_draws_from_numpy(_row_draws(KEY, num_steps, 32, toy["n"]), device="cpu")
    else:
        jspec, spec = JAP(num_steps=num_steps, **AP_KW), AP(num_steps=num_steps, **AP_KW)
        draws = row_draws_from_numpy(_row_draws(KEY, num_steps, 32, toy["n"]), device="cpu")
    if backend is not None:
        spec = dataclasses.replace(spec, backend=backend)
    ref = jsolve(jop, jnp.asarray(b), jspec, key=KEY, delta=d_j)
    out = solve(op, torch.from_numpy(b), spec, draws=draws, delta=d_t)
    return out, ref


@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
@pytest.mark.parametrize("num_steps", [1, 5, 20])
def test_solver_steps_match_the_reference(toy_regression, name, num_steps):
    delta = _delta(toy_regression) if name == "sgd" else None
    out, ref = _both(toy_regression, name, num_steps, delta=delta)
    np.testing.assert_allclose(out.solution.numpy(), np.asarray(ref.solution),
                               rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(out.rel_residual.numpy(), np.asarray(ref.rel_residual),
                               rtol=STEP_TOL, atol=STEP_TOL)
    assert out.iterations == int(ref.iterations) == num_steps
    assert out.matvecs == int(ref.matvecs)
    assert out.flags.tolist() == np.asarray(ref.flags).tolist()


@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
def test_solver_200_steps_match_the_reference(toy_regression, name):
    delta = _delta(toy_regression) if name == "sgd" else None
    out, ref = _both(toy_regression, name, 200, delta=delta)
    np.testing.assert_allclose(out.solution.numpy(), np.asarray(ref.solution),
                               rtol=LONG_TOL, atol=LONG_TOL)


@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
def test_kernel_route_on_cpu_matches_the_reference(toy_regression, name):
    # backend="cuda" on CPU tensors: the pair, rows and feature-pair wrappers
    # with their plain versions behind them, against the reference's chunked
    # solve on the same draws
    delta = _delta(toy_regression) if name == "sgd" else None
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    out, ref = _both(toy_regression, name, 5, backend="cuda", delta=delta)
    np.testing.assert_allclose(out.solution.numpy(), np.asarray(ref.solution),
                               rtol=STEP_TOL, atol=STEP_TOL)
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert ops.FEATURE_TRACE_COUNTS["features"] == 0


def test_ap_solve_spends_zero_full_matvecs(toy_regression):
    # twin of tests/test_backends_and_counts.py:65
    op = _port(toy_regression, instrument=True)
    reset_matvec_counts()
    res = solve(op, torch.from_numpy(np.array(toy_regression["y"])),
                AP(num_steps=20, block_size=32), generator=torch.Generator().manual_seed(0))
    assert matvec_counts() == {"mv": 0, "rows": 20}
    assert res.matvecs == 0
    assert float(res.rel_residual.max()) < 1.0  # the tracked residual is real


@pytest.mark.parametrize("x0_ndim", [1, 2])
def test_ap_warm_start_leaves_x0_as_it_was(toy_regression, x0_ndim):
    """AP scatters into its iterate in place: a warm start is copied first,
    and the warm-started solve is the cold one's continuation."""
    op = _port(toy_regression)
    y = torch.from_numpy(np.array(toy_regression["y"]))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    x0 = solve(op, y, AP(num_steps=5, **AP_KW), generator=gen()).solution
    x0 = x0 if x0_ndim == 1 else x0[:, None]
    kept = x0.clone()
    res = solve(op, y if x0_ndim == 1 else y[:, None], AP(num_steps=5, **AP_KW), x0=x0,
                generator=gen())
    assert torch.equal(x0, kept)
    assert not torch.equal(res.solution, x0)
    assert res.matvecs == 1  # the warm start's residual b − A x0


@pytest.mark.parametrize("spec,rows_per_step", [
    (SGD(num_steps=15, batch_size=32, num_features=16), 2),
    (SDD(num_steps=15, batch_size=32), 1),
], ids=["sgd", "sdd"])
def test_stochastic_solvers_spend_one_full_matvec(toy_regression, spec, rows_per_step):
    # twin of tests/test_backends_and_counts.py:88: the one full matvec is
    # finalize's honest residual; the pair counts as two row matvecs
    op = _port(toy_regression, instrument=True)
    reset_matvec_counts()
    res = solve(op, torch.from_numpy(np.array(toy_regression["y"])), spec,
                generator=torch.Generator().manual_seed(1))
    assert matvec_counts() == {"mv": 1, "rows": 15 * rows_per_step}
    assert res.matvecs == 1


def test_solve_result_matvecs_consistent_across_solvers(toy_regression):
    # twin of tests/test_backends_and_counts.py:102
    op = _port(toy_regression)
    y = torch.from_numpy(np.array(toy_regression["y"]))
    gen = torch.Generator().manual_seed(2)
    assert solve(op, y, AP(num_steps=5, block_size=16), generator=gen).matvecs == 0
    assert solve(op, y, SGD(num_steps=5, batch_size=16, num_features=8),
                 generator=gen).matvecs == 1
    assert solve(op, y, SDD(num_steps=5, batch_size=16), generator=gen).matvecs == 1


def test_sgd_regulariser_never_materialises_features(toy_regression):
    # twin of tests/test_features.py:256: with backend="cuda" every feature
    # matvec goes through the pair wrapper (on CPU tensors its plain version),
    # never the materialising "features" path; two per step
    op = _port(toy_regression)
    ops.reset_feature_trace_counts()
    solve(op, torch.from_numpy(np.array(toy_regression["y"])),
          SGD(num_steps=3, batch_size=32, num_features=16, backend="cuda"),
          generator=torch.Generator().manual_seed(0))
    assert ops.FEATURE_TRACE_COUNTS == {"cuda": 6, "features": 0}


def test_sgd_regulariser_backend_follows_operator(toy_regression):
    # twin of tests/test_features.py:269: auto (features on the CPU) and the
    # kernel route agree after 200 steps on one generator seed
    op = _port(toy_regression)
    y = torch.from_numpy(np.array(toy_regression["y"]))
    spec = SGD(num_steps=200, batch_size=64, num_features=32)
    ops.reset_feature_trace_counts()
    auto = solve(op, y, spec, generator=torch.Generator().manual_seed(4))
    assert ops.FEATURE_TRACE_COUNTS["features"] > 0
    fused = solve(op, y, dataclasses.replace(spec, backend="cuda"),
                  generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(auto.solution, fused.solution, rtol=LONG_TOL, atol=LONG_TOL)


@pytest.mark.parametrize("spec", [SGD(num_steps=5, batch_size=16, num_features=8),
                                  SDD(num_steps=5, batch_size=16),
                                  AP(num_steps=5, block_size=16)],
                         ids=["sgd", "sdd", "ap"])
def test_stochastic_solver_requires_a_generator(toy_regression, spec):
    # twin of tests/test_solver_spec.py's test_stochastic_solver_requires_key;
    # one seed gives one solution, and injected draws of the wrong shape raise
    op = _port(toy_regression)
    y = torch.from_numpy(np.array(toy_regression["y"]))
    with pytest.raises(ValueError, match="stochastic"):
        solve(op, y, spec)
    a = solve(op, y, spec, generator=torch.Generator().manual_seed(7))
    b = solve(op, y, spec, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a.solution, b.solution)
    bad = (SGDDraws(idx=torch.zeros((4, 16), dtype=torch.int64), omega=torch.zeros((4, 8, 3)))
           if spec.name == "sgd" else RowDraws(idx=torch.zeros((4, 16), dtype=torch.int64)))
    with pytest.raises(ValueError, match="num_steps"):
        solve(op, y, spec, draws=bad)


@pytest.mark.parametrize("spec", [SGD(num_steps=30, batch_size=32, num_features=16),
                                  SDD(num_steps=30, **SDD_KW),
                                  AP(num_steps=30, block_size=32)],
                         ids=["sgd", "sdd", "ap"])
def test_nonfinite_column_is_flagged_and_frozen(toy_regression, spec):
    # a NaN in one column flags that column alone, with no host sync in the
    # loop; the healthy columns solve as they would alone
    op = _port(toy_regression)
    b = torch.from_numpy(_rhs(toy_regression))
    bad = b.clone()
    bad[7, 1] = float("nan")
    out = solve(op, bad, spec, generator=torch.Generator().manual_seed(5))
    alone = solve(op, b, spec, generator=torch.Generator().manual_seed(5))
    assert out.flags.tolist()[1] & FLAG_NONFINITE
    assert out.flags.tolist()[0] == out.flags.tolist()[2] == alone.flags.tolist()[0]
    torch.testing.assert_close(out.solution[:, [0, 2]], alone.solution[:, [0, 2]])
    assert not out.converged


@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
def test_posterior_functions_match_the_reference(toy_regression, name):
    # the slice as a whole: posterior_functions on each solver with every
    # draw of the reference injected (prior, ε and the solver's own), 20 steps
    t = toy_regression
    s, q, steps = 4, 64, 20
    spec_kw = {"sgd": SGD_KW, "sdd": SDD_KW, "ap": AP_KW}[name]
    jspec = {"sgd": JSGD, "sdd": JSDD, "ap": JAP}[name](num_steps=steps, **spec_kw)
    spec = {"sgd": SGD, "sdd": SDD, "ap": AP}[name](num_steps=steps, **spec_kw)
    ref = jposterior_functions(t["params"], t["x"], t["y"], KEY, num_samples=s,
                               num_features=q, spec=jspec)
    kp, ke, ks = jax.random.split(KEY, 3)
    prior = jsample_prior(t["params"], kp, s, q, t["d"])
    eps = np.asarray(jnp.sqrt(t["params"].noise) * jax.random.normal(ke, (t["n"], s)))
    if name == "sgd":
        draws = sgd_draws_from_numpy(*_sgd_draws(ks, steps, 32, 16, t), device="cpu")
    else:
        draws = row_draws_from_numpy(_row_draws(ks, steps, 32, t["n"]), device="cpu")
    op = _port(t)
    post = posterior_functions(op.params, op.x, torch.from_numpy(np.array(t["y"])),
                               num_samples=s, num_features=q, spec=spec,
                               omega=torch.from_numpy(np.asarray(prior.ff.omega)),
                               w=torch.from_numpy(np.asarray(prior.w)),
                               eps=torch.from_numpy(eps), solver_draws=draws)
    np.testing.assert_allclose(post.v_mean.numpy(), np.asarray(ref.v_mean),
                               rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(post.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=STEP_TOL, atol=STEP_TOL)
    xt = np.asarray(t["x_test"])
    np.testing.assert_allclose(post(torch.from_numpy(xt)).numpy(),
                               np.asarray(ref(jnp.asarray(xt))), rtol=STEP_TOL, atol=STEP_TOL)
