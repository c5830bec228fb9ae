"""The latent Kronecker GP of the port (repro_torch.core.kronecker, the
LatentKroneckerOp operator, data.pipeline.grid_curves and train.curve_gp)
against the JAX reference, on the reference tests' grids
(tests/test_kronecker.py, tests/test_features.py:376-398,
tests/test_train.py:124) with the reference's own draws injected."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.core.kernels_fn import kronecker_grams as jkronecker_grams
from repro.core.kernels_fn import make_params as jmake_params
from repro.core import kronecker as jkron
from repro.core.operators import LatentKroneckerOp as JLatentKroneckerOp
from repro.data.pipeline import grid_curves as jgrid_curves
from repro.train import curve_gp as jcurve_gp
from repro_torch.convert import lkgp_draws_from_numpy, lkgp_from_numpy, params_from_numpy
from repro_torch.core import CG, Jacobi, LatentKroneckerOp, Nystrom, SGD, map_params, solve
from repro_torch.core import kronecker
from repro_torch.core.kernels_fn import kronecker_grams
from repro_torch.data.pipeline import grid_curves
from repro_torch.train import curve_gp


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


def _tparams(jp, kind):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), kind, device="cpu")


def _problem(n1=12, n2=9, density=0.7, seed=0, noise=0.05):
    """tests/test_kronecker.py's _make_problem, in both packages."""
    rng = np.random.default_rng(seed)
    g1 = rng.normal(size=(n1, 3)).astype(np.float32)
    g2 = rng.normal(size=(n2, 1)).astype(np.float32)
    mask = rng.random((n1, n2)) < density
    p1 = jmake_params("matern52", lengthscale=1.0, d=3)
    p2 = jmake_params("matern52", lengthscale=1.0, d=1)
    jgp = jkron.make_lkgp(p1, p2, jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(mask), noise)
    tgp = kronecker.make_lkgp(_tparams(p1, "matern52"), _tparams(p2, "matern52"),
                              torch.from_numpy(g1), torch.from_numpy(g2), mask, noise)
    return jgp, tgp


def _dense(jgp):
    kfull = np.kron(np.asarray(jgp.k1(), np.float64), np.asarray(jgp.k2(), np.float64))
    idx = np.asarray(jgp.obs_idx)
    return kfull, idx, kfull[np.ix_(idx, idx)] + float(jgp.noise) * np.eye(len(idx))


@pytest.mark.parametrize("n_configs,n_steps,density,seed",
                         [(24, 30, 0.7, 0), (64, 50, 0.7, 1), (512, 50, 0.7, 0), (7, 3, 0.2, 5)])
def test_grid_curves_equal_the_reference(n_configs, n_steps, density, seed):
    # the same numpy stream: bit for bit, dtypes included
    ref = jgrid_curves(n_configs, n_steps, density, seed=seed)
    out = grid_curves(n_configs, n_steps, density, seed=seed)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]))


def test_full_size_grid_has_the_benchmarks_observation_count():
    # bench_kronecker's full size, which chip_smoke drives: 17,742 observed cells
    assert int(grid_curves(512, 50, 0.7, seed=0)["mask"].sum()) == 17_742


def test_kronecker_grams_and_factor_grams_match_reference():
    # fp32 dense Grams on both sides: measured ~1e-7 of scale, held at 1e-5
    jgp, tgp = _problem()
    ref = jkronecker_grams([jgp.params1, jgp.params2], [jgp.grid1, jgp.grid2])
    out = kronecker_grams([tgp.params1, tgp.params2], [tgp.grid1, tgp.grid2])
    for a, b in zip(out, ref):
        assert _rel(a.numpy(), b) <= 1e-5
    assert _rel(tgp.k1().numpy(), jgp.k1()) <= 1e-5
    assert tgp.shape == jgp.shape
    np.testing.assert_array_equal(tgp.obs_idx.numpy(), np.asarray(jgp.obs_idx))


def test_projections_mv_and_cross_mv_match_reference():
    # the scatter and gather are exact; the latent Kronecker matvec and the
    # cross matvec are two fp32 products (measured 1.0e-7 of scale; held at
    # 1e-5), and agree with the dense P(K₁⊗K₂)Pᵀ + σ²I in float64 to 1e-5
    jgp, tgp = _problem()
    n_obs = tgp.obs_idx.shape[0]
    v = np.random.default_rng(1).normal(size=(n_obs, 3)).astype(np.float32)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    np.testing.assert_array_equal(tgp.project_up(tv).numpy(), np.asarray(jgp.project_up(jv)))
    np.testing.assert_array_equal(tgp.project_down(tgp.project_up(tv)).numpy(), v)
    assert _rel(tgp.mv(tv).numpy(), jgp.mv(jv)) <= 1e-5
    assert _rel(tgp.mv(tv[:, 0]).numpy(), jgp.mv(jv[:, 0])) <= 1e-5
    assert _rel(tgp.cross_mv(tv).numpy(), jgp.cross_mv(jv)) <= 1e-5
    assert _rel(tgp.cross_mv(tv[:, 0]).numpy(), jgp.cross_mv(jv[:, 0])) <= 1e-5
    _, _, kobs = _dense(jgp)
    assert _rel(tgp.mv(tv).numpy(), kobs @ v.astype(np.float64)) <= 1e-5
    # the reference's GP carried across as arrays is the same GP
    conv = lkgp_from_numpy(tgp.params1, tgp.params2, np.asarray(jgp.grid1),
                           np.asarray(jgp.grid2), np.asarray(jgp.obs_idx),
                           np.asarray(jgp.noise), device="cpu")
    torch.testing.assert_close(conv.mv(tv), tgp.mv(tv), rtol=0, atol=0)


def test_prior_sample_grid_on_injected_normals_matches_reference():
    # the reference's (n1, n2, s) normals through both Kronecker Cholesky
    # factors: measured 3.9e-6 of scale (two fp32 Cholesky factors), held at 1e-4
    jgp, tgp = _problem()
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (*jgp.shape, 16)))
    out = tgp.prior_sample_grid(16, w=torch.from_numpy(w))
    assert _rel(out.numpy(), jgp.prior_sample_grid(key, 16)) <= 1e-4
    drawn = tgp.prior_sample_grid(5, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (*tgp.shape, 5)


def _reference_draws(jgp, key, num_samples):
    """lkgp_posterior's own draws (kronecker.py:131-135): the grid normals
    from ``key`` and ε from ``fold_in(key, 1)``."""
    n_obs = int(jgp.obs_idx.shape[0])
    w = jax.random.normal(key, (*jgp.shape, num_samples))
    eps = jnp.sqrt(jgp.noise) * jax.random.normal(jax.random.fold_in(key, 1),
                                                  (n_obs, num_samples))
    return lkgp_draws_from_numpy(np.asarray(w), np.asarray(eps), device="cpu")


def test_lkgp_posterior_matches_reference_on_its_draws():
    # tests/test_kronecker.py:54's problem, 256 samples, CG(400, 1e-4) in
    # fp32 on both sides from the same draws: measured 6.7e-5 (mean) and
    # 1.5e-4 (samples) of scale; held at 1e-3. Then the reference's own claims
    # against the dense posterior (its 2e-2 on the mean, 0.16 on the variance).
    jgp, tgp = _problem(n1=10, n2=8, density=0.65, seed=3)
    y_full = np.asarray(jgp.prior_sample_grid(jax.random.PRNGKey(0), 1))[..., 0]
    y_obs = y_full.reshape(-1)[np.asarray(jgp.obs_idx)]
    key = jax.random.PRNGKey(1)
    jmean, jsamples = jkron.lkgp_posterior(jgp, jnp.asarray(y_obs), key, num_samples=256,
                                           max_iters=400)
    out = kronecker.lkgp_posterior(tgp, torch.from_numpy(y_obs), num_samples=256,
                                   max_iters=400, **_reference_draws(jgp, key, 256))
    (mean, samples), info = out, out.solve_info
    assert info.converged and info.matvecs == info.iterations
    assert _rel(mean.numpy(), jmean) <= 1e-3
    assert _rel(samples.numpy(), jsamples) <= 1e-3
    kfull, idx, kobs = _dense(jgp)
    n1, n2 = tgp.shape
    mean_ref = (kfull[:, idx] @ np.linalg.solve(kobs, y_obs.astype(np.float64))).reshape(n1, n2)
    np.testing.assert_allclose(mean.numpy(), mean_ref, atol=2e-2)
    cov_ref = kfull - kfull[:, idx] @ np.linalg.solve(kobs, kfull[idx, :])
    var_emp = np.var(samples.numpy(), axis=-1).reshape(-1)
    np.testing.assert_allclose(var_emp, np.clip(np.diag(cov_ref), 0, None), atol=0.16)


def test_lkgp_at_the_bench_budget_misses_where_the_reference_does():
    # bench_kronecker's full size (512 × 50, 17,742 observed cells, Matérn-5/2
    # factors, σ² = 1e-2) at its 200 iterations, which chip_smoke times: CG
    # stops far from converged there, so the fp32 mean's gap from the exact
    # posterior mean (float64 CG on the port's operator to a relative
    # residual of 1e-8) is the budget's, and the reference's own fp32 gap is
    # the yardstick. Measured: the reference 0.328, the port 0.203 (float64
    # at the same budget 0.221); the port's held within 1.5× the
    # reference's, the multiple chip_smoke holds the card's run to
    # (LKGP_REF_GAP quotes the reference's gap).
    data = grid_curves(512, 50, 0.7, seed=0)
    g1, g2, mask = data["grid1"], data["grid2"], data["mask"]
    idx = np.nonzero(mask.reshape(-1))[0]
    y = data["curves"].reshape(-1)[idx]
    y = (y - y.mean()).astype(np.float32)
    p1 = jmake_params("matern52", lengthscale=1.0, d=g1.shape[1])
    p2 = jmake_params("matern52", lengthscale=1.0, d=1)
    jgp = jkron.make_lkgp(p1, p2, jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(mask), 1e-2)
    tps = (_tparams(p1, "matern52"), _tparams(p2, "matern52"))
    tgp = kronecker.make_lkgp(*tps, torch.from_numpy(g1), torch.from_numpy(g2), mask, 1e-2)
    gp64 = kronecker.make_lkgp(*(map_params(lambda a: a.double(), p) for p in tps),
                               torch.from_numpy(g1).double(), torch.from_numpy(g2).double(),
                               mask, 1e-2)
    exact = solve(LatentKroneckerOp(gp=gp64), torch.from_numpy(y).double(),
                  CG(max_iters=5000, tol=1e-8))
    assert exact.converged
    mean_ref = gp64.cross_mv(exact.solution).numpy()

    def gap(mean):
        return float(np.abs(np.asarray(mean, np.float64) - mean_ref).max())

    jmean, _ = jkron.lkgp_posterior(jgp, jnp.asarray(y), jax.random.PRNGKey(0), num_samples=1,
                                    max_iters=200)
    out = kronecker.lkgp_posterior(tgp, torch.from_numpy(y), num_samples=1, max_iters=200,
                                   generator=torch.Generator().manual_seed(0))
    assert out.solve_info.iterations == 200 and not out.solve_info.converged
    ref_gap, port_gap = gap(jmean), gap(out[0].numpy())
    print(f"LKGP at 200 iterations: reference fp32 gap {ref_gap}, port {port_gap}")
    assert 0.1 < ref_gap and port_gap <= 1.5 * ref_gap


def test_latent_kronecker_op_diag_jacobi_and_refusals():
    # tests/test_features.py:376-398: diag_part against the reference and the
    # dense diagonal (fp32, held at 1e-6 of scale); Jacobi-preconditioned CG
    # against the dense solve (the reference's rtol/atol 1e-3); Nystrom and
    # SGD refused with a capability TypeError
    rng = np.random.default_rng(0)
    g1 = rng.normal(size=(11, 3)).astype(np.float32)
    g2 = rng.normal(size=(8, 1)).astype(np.float32)
    mask = rng.random((11, 8)) < 0.7
    p1 = jmake_params("matern52", lengthscale=1.0, d=3)
    p2 = jmake_params("matern52", lengthscale=1.0, d=1)
    jop = JLatentKroneckerOp(gp=jkron.make_lkgp(p1, p2, jnp.asarray(g1), jnp.asarray(g2),
                                                jnp.asarray(mask), 0.05))
    op = LatentKroneckerOp(gp=kronecker.make_lkgp(_tparams(p1, "matern52"),
                                                  _tparams(p2, "matern52"),
                                                  torch.from_numpy(g1), torch.from_numpy(g2),
                                                  mask, 0.05))
    n = op.shape[0]
    _, _, dense = _dense(jop.gp)
    assert op.shape == jop.shape and float(op.noise) == pytest.approx(0.05)
    assert _rel(op.diag_part().numpy(), jop.diag_part()) <= 1e-6
    assert _rel(op.diag_part().numpy(), np.diag(dense)) <= 1e-6
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,)))
    with pytest.raises(TypeError, match="precond_factor"):
        solve(op, torch.from_numpy(b), CG(precond=Nystrom(rank=8)))
    with pytest.raises(TypeError, match="rows_mv"):
        solve(op, torch.from_numpy(b), SGD(num_steps=2), generator=torch.Generator())
    res = solve(op, torch.from_numpy(b), CG(max_iters=300, tol=1e-8, precond=Jacobi()))
    np.testing.assert_allclose(res.solution.numpy(), np.linalg.solve(dense, b),
                               rtol=1e-3, atol=1e-3)
    ref = solve(op, torch.from_numpy(b), CG(max_iters=500, tol=1e-8))
    assert ref.matvecs == ref.iterations  # cold CG: one matvec an iteration


@settings(max_examples=20, deadline=None)
@given(st.integers(4, 200), st.integers(4, 200))
def test_break_even_formula(n1, n2):
    # §6.2.6 (tests/test_kronecker.py:79): at ρ* the two matvecs cost the same,
    # above it the latent Kronecker one wins; ρ* and the flop counts equal the
    # reference's (its ρ* is rounded to float32: rtol 1e-6)
    rho = kronecker.break_even_density(n1, n2)
    assert rho == pytest.approx(jkron.break_even_density(n1, n2), rel=1e-6)
    lk, direct = kronecker.lkgp_matvec_flops(n1, n2, rho)
    np.testing.assert_allclose(lk, direct, rtol=1e-6)
    assert (lk, direct) == jkron.lkgp_matvec_flops(n1, n2, rho)
    lk_hi, direct_hi = kronecker.lkgp_matvec_flops(n1, n2, min(1.0, rho * 1.5))
    if rho * 1.5 <= 1.0:
        assert lk_hi < direct_hi


@pytest.fixture(scope="module")
def curves():
    """tests/test_train.py:124's grid and fit, in both packages, the port on
    the reference's own draws (fit_curve_gp's key is PRNGKey(0))."""
    data = jgrid_curves(n_configs=24, n_steps=30, density=0.7, seed=0)
    ref = jcurve_gp.fit_curve_gp(data["curves"], data["mask"], data["grid1"],
                                 max_iters=200, num_samples=32)
    tdata = grid_curves(24, 30, 0.7, seed=0)
    key = jax.random.PRNGKey(0)
    n_obs = int(tdata["mask"].sum())
    w = jax.random.normal(key, (24, 30, 32))
    eps = jnp.sqrt(jnp.float32(1e-2)) * jax.random.normal(jax.random.fold_in(key, 1),
                                                          (n_obs, 32))
    out = curve_gp.fit_curve_gp(tdata["curves"], tdata["mask"], tdata["grid1"],
                                max_iters=200, num_samples=32, device="cpu",
                                **lkgp_draws_from_numpy(np.asarray(w), np.asarray(eps),
                                                        device="cpu"))
    return dict(data=tdata, ref=ref, out=out)


def test_fit_curve_gp_matches_reference(curves):
    # fp32 CG(200) from the same draws: measured 8.6e-5 (mean), 2.5e-4 (std)
    # and 1.4e-4 (final mean) of scale; held at 1e-3. The reference's claim:
    # the mean error on the observed cells under 0.1 (measured 7.3e-3).
    ref, out, data = curves["ref"], curves["out"], curves["data"]
    assert out.mean.shape == out.std.shape == (24, 30) and out.mean.device.type == "cpu"
    assert _rel(out.mean.numpy(), ref.mean) <= 1e-3
    assert _rel(out.std.numpy(), ref.std) <= 1e-3
    assert _rel(out.final_mean.numpy(), ref.final_mean) <= 1e-3
    assert _rel(out.final_std.numpy(), ref.final_std) <= 1e-3
    err = np.abs(out.mean.numpy() - data["curves"])[data["mask"]]
    assert err.mean() < 0.1


def test_should_stop_early_and_divergence_score_match_reference(curves):
    # the same decisions as the reference's on every config, and z-scores
    # within 1e-3 relative of its (tests/test_train.py:131-141's claims too)
    ref, out, data = curves["ref"], curves["out"], curves["data"]
    for i in range(24):
        assert curve_gp.should_stop_early(out, i) == jcurve_gp.should_stop_early(ref, i)
    worst = int(np.argmax(out.final_mean.numpy()))
    best = int(np.argmin(out.final_mean.numpy()))
    if out.final_mean[worst] - out.final_mean[best] > 2 * out.final_std[worst]:
        assert curve_gp.should_stop_early(out, worst, margin=1.0)
    assert not curve_gp.should_stop_early(out, best, margin=1.0)
    for i, step, shift in ((0, 10, 10.0), (3, 29, 0.05), (17, 2, -0.3)):
        loss = float(data["curves"][i, step]) + shift
        z, jz = (curve_gp.divergence_score(out, i, step, loss),
                 jcurve_gp.divergence_score(ref, i, step, loss))
        assert z == pytest.approx(jz, rel=1e-3)
    assert curve_gp.divergence_score(out, 0, 10, float(data["curves"][0, 10]) + 10.0) > 3.0


def test_fit_curve_gp_device_rule(monkeypatch):
    # arrays with no device named go to the card; without one that raises
    data = grid_curves(6, 5, 0.7, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        curve_gp.fit_curve_gp(data["curves"], data["mask"], data["grid1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kronecker.make_lkgp(None, None, data["grid1"], data["grid2"], data["mask"], 0.1)
    pred = curve_gp.fit_curve_gp(torch.from_numpy(data["curves"]), data["mask"],
                                 data["grid1"], max_iters=20, num_samples=4)
    assert pred.mean.device.type == "cpu"
