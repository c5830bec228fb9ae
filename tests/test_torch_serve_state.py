"""The port's serving state (``repro_torch.serve.state``) against the JAX
reference's ``repro.serve.state`` on the CPU:

* ``hypers_fingerprint`` gives the reference's digest for the same float32
  params, for every kernel kind and two n;
* ``fit_state`` on the reference's own draws (its prior's ω and w, its ε):
  v_mean and alpha within 1e-4 of scale, the same CG iterations within ±1;
* ``update_state_lowrank`` against ``extend_state`` at matching draws, within
  the reference's own parity tolerances (tests/test_serve.py:408-452), and
  the port's rank-k update of the reference's carried state against the
  reference's own update;
* the cost accounting (k columns at the old n plus one certification matvec,
  the prior evaluated on the new rows only);
* the warm-start and refit counts against the committed reference rows of
  results/BENCH_bench_serve.json at n = 512 (benchmarks/bench_serve.py:54-75's
  specs, on the port's draws), within the 15% that
  benchmarks/check_matvecs.py allows.

Tolerances are max|Δ| ≤ tol·max(1, max|ref|).
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro_torch.core.kernels_fn import KINDS
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.solvers.spec import CG as JCG
from repro.core.solvers.spec import spec_to_dict as jspec_to_dict
from repro.serve import GPEngine as jGPEngine
from repro.serve import extend_state as jextend_state
from repro.serve import fit_state as jfit_state
from repro.serve import hypers_fingerprint as jhypers_fingerprint
from repro.serve import update_state_lowrank as jupdate_state_lowrank
from repro_torch.convert import (
    params_from_numpy, posterior_state_from_numpy, request_draws_from_numpy,
)
from repro_torch.core import CG, SGD
from repro_torch.core.rff import PriorSamples
from repro_torch.device import make_generator
from repro_torch.kernels.gram_matvec import gram_plan
from repro_torch.serve import (
    GPEngine, WarmStartCache, extend_state, fit_state, hypers_fingerprint,
    update_state_lowrank,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the repo's count gate (benchmarks/check_matvecs.py --slack 0.15)
COUNT_SLACK = 0.15
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float64)


def _assert_close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _tparams(jp):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), jp.kind, device="cpu")


def _carry(jst):
    res = jst.fit_result
    return posterior_state_from_numpy(
        _tparams(jst.params), np.asarray(jst.x), np.asarray(jst.y),
        np.asarray(jst.prior.ff.omega), np.asarray(jst.prior.w),
        np.asarray(jst.post.v_mean), np.asarray(jst.post.alpha), np.asarray(jst.eps),
        np.asarray(jst.f_x), jspec_to_dict(jst.spec), iterations=int(res.iterations),
        matvecs=int(res.matvecs), rel_residual=np.asarray(res.rel_residual),
        flags=np.asarray(res.flags), device="cpu")


@pytest.fixture(scope="module")
def small_problem():
    """tests/test_serve.py:35-43's problem."""
    key = jax.random.PRNGKey(0)
    n, d = 96, 2
    x = jax.random.uniform(key, (n, d))
    y = jnp.sin(4.0 * x[:, 0]) + 0.5 * jnp.cos(3.0 * x[:, 1])
    jp = jmake_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=d)
    return dict(x=x, y=y, jp=jp, params=_tparams(jp), n=n, d=d)


@pytest.mark.parametrize("n", [96, 45_730])
@pytest.mark.parametrize("kind", KINDS)
def test_hypers_fingerprint_equals_the_reference(kind, n):
    d = 1 if kind == "tanimoto" else 3
    jp = jmake_params(kind, lengthscale=0.7, signal=1.3, noise=0.2, d=d)
    assert hypers_fingerprint(_tparams(jp), n) == jhypers_fingerprint(jp, n)
    other = jmake_params(kind, lengthscale=0.7, signal=1.3, noise=0.21, d=d)
    assert hypers_fingerprint(_tparams(other), n) != hypers_fingerprint(_tparams(jp), n)


def _fit_pair(p, max_iters, tol):
    """The reference's fit_state (tests/test_serve.py:313's key) and the
    port's on the same draws: the prior's ω and w, and ε, taken from the
    reference's own state."""
    jst = jfit_state(p["jp"], p["x"], p["y"], jax.random.PRNGKey(9),
                     spec=JCG(max_iters=max_iters, tol=tol), num_samples=4, num_features=128)
    tst = fit_state(p["params"], np.asarray(p["x"]), np.asarray(p["y"]),
                    spec=CG(max_iters=max_iters, tol=tol), num_samples=4, num_features=128,
                    omega=torch.as_tensor(np.asarray(jst.prior.ff.omega)),
                    w=torch.as_tensor(np.asarray(jst.prior.w)),
                    eps=torch.as_tensor(np.asarray(jst.eps)))
    return jst, tst


@pytest.fixture(scope="module")
def fitted(small_problem):
    return _fit_pair(small_problem, 300, 1e-4)


def test_fit_state_matches_the_reference_on_its_draws(small_problem):
    """At CG(1000, 1e-5), where both packages converge: v_mean and alpha
    within 1e-4 of scale (alpha's scale is 1/σ² = 100 here, and its fp32
    floor between the packages 7.8e-5), the iterations within ±1."""
    jst, tst = _fit_pair(small_problem, 1000, 1e-5)
    _assert_close(tst.f_x, jst.f_x)
    _assert_close(tst.post.v_mean, jst.post.v_mean)
    _assert_close(tst.post.alpha, jst.post.alpha)
    assert abs(tst.fit_result.iterations - int(jst.fit_result.iterations)) <= 1
    assert tst.fit_result.matvecs == tst.fit_result.iterations
    assert tst.fit_result.converged and tst.hypers_key == jst.hypers_key
    assert tst.n == jst.n and tuple(tst.eps.shape) == (96, 4)


def test_fit_state_at_the_reference_tests_spec(fitted):
    """At tests/test_serve.py's CG(300, 1e-4) the two packages' fp32 CG
    drift apart (ROADMAP queue 3; 78 and 80 iterations here): the count
    within 15%, the mean's representer weights within 1e-4 of scale."""
    jst, tst = fitted
    ji = int(jst.fit_result.iterations)
    assert abs(tst.fit_result.iterations - ji) <= COUNT_SLACK * ji
    _assert_close(tst.post.v_mean, jst.post.v_mean)
    assert tst.fit_result.converged and tst.fit_result.healthy


def test_carried_state_matches_the_reference_state(fitted):
    jst, _ = fitted
    st = _carry(jst)
    xt = jax.random.uniform(jax.random.PRNGKey(22), (20, 2))
    m, v = st.post.sample_mean_and_var(torch.as_tensor(np.asarray(xt)))
    jm, jv = jst.post.sample_mean_and_var(xt)
    _assert_close(m, jm)
    _assert_close(v, jv)
    assert st.hypers_key == jst.hypers_key and st.fit_result.iterations == int(
        jst.fit_result.iterations)


@pytest.fixture(scope="module")
def update_problem():
    """tests/test_serve.py:378's problem: n = 64 rows plus k = 5 to append."""
    key = jax.random.PRNGKey(21)
    n, k, d = 64, 5, 2
    x = jax.random.uniform(key, (n + k, d))
    y = jnp.sin(4.0 * x[:, 0]) + 0.5 * jnp.cos(3.0 * x[:, 1])
    jp = jmake_params("matern32", lengthscale=0.5, signal=1.0, noise=0.5, d=d)
    xt = jax.random.uniform(jax.random.PRNGKey(22), (20, d))
    return dict(x=np.asarray(x), y=np.asarray(y), jp=jp, params=_tparams(jp), n=n, k=k,
                xt=torch.as_tensor(np.asarray(xt)), jxt=xt)


@pytest.mark.parametrize("spec,parity_tol", [
    (CG(max_iters=400, tol=1e-6), 1e-4),
    (SGD(num_steps=2000, batch_size=32, num_features=64), 5e-2),
], ids=["cg", "sgd"])
def test_lowrank_update_matches_full_refit(update_problem, spec, parity_tol):
    """Twin of tests/test_serve.py:389 on the port's draws: both paths
    extend the same linear system at matching draws (the new rows' ε, the
    solver's steps), so their posteriors agree to solver accuracy; SGD at its
    optimisation floor reports the drift honestly (converged=False)."""
    t = update_problem
    n = t["n"]
    st = fit_state(t["params"], t["x"][:n], t["y"][:n], spec=spec, num_samples=4,
                   num_features=128, generator=make_generator(2, "cpu"))
    eps = torch.sqrt(t["params"].noise) * torch.randn((t["k"], 4),
                                                      generator=make_generator(3, "cpu"))
    lo = update_state_lowrank(st, t["x"][n:], t["y"][n:], eps=eps,
                              generator=make_generator(4, "cpu"))
    fu = extend_state(st, t["x"][n:], t["y"][n:], eps=eps, warm=True,
                      generator=make_generator(4, "cpu"))
    ml, vl = lo.post.sample_mean_and_var(t["xt"])
    mf, vf = fu.post.sample_mean_and_var(t["xt"])
    _assert_close(ml, mf, parity_tol)
    _assert_close(vl, vf, parity_tol)
    _assert_close(lo.post.mean(t["xt"]), fu.post.mean(t["xt"]), parity_tol)
    drift = float(torch.max(lo.fit_result.rel_residual))
    assert lo.fit_result.healthy
    if isinstance(spec, CG):
        assert drift <= 1e-4  # certified against the extended operator
    else:
        assert drift <= 2.0 * float(torch.max(fu.fit_result.rel_residual))
        assert not lo.fit_result.converged  # the auto policy sees the floor


@pytest.mark.parametrize("path", ["lowrank", "full"])
def test_update_of_the_carried_state_matches_the_reference(update_problem, path):
    """The port's update of the reference's fitted state, on the reference's
    new-row ε, against the reference's own update: the posterior mean and
    variance within 1e-4 of scale."""
    t = update_problem
    n = t["n"]
    jst = jfit_state(t["jp"], jnp.asarray(t["x"][:n]), jnp.asarray(t["y"][:n]),
                     jax.random.PRNGKey(2), spec=JCG(max_iters=400, tol=1e-6),
                     num_samples=4, num_features=128)
    ukey = jax.random.PRNGKey(3)
    jx, jy = jnp.asarray(t["x"][n:]), jnp.asarray(t["y"][n:])
    if path == "lowrank":
        jnew = jupdate_state_lowrank(jst, jx, jy, ukey)
    else:
        jnew = jextend_state(jst, jx, jy, ukey, warm=True)
    eps = torch.as_tensor(np.asarray(jnew.eps[n:]))
    st = _carry(jst)
    if path == "lowrank":
        new = update_state_lowrank(st, t["x"][n:], t["y"][n:], eps=eps)
    else:
        new = extend_state(st, t["x"][n:], t["y"][n:], eps=eps, warm=True)
    m, v = new.post.sample_mean_and_var(t["xt"])
    jm, jv = jnew.post.sample_mean_and_var(t["jxt"])
    _assert_close(m, jm)
    _assert_close(v, jv)
    _assert_close(new.f_x, jnew.f_x)
    assert new.hypers_key == jnew.hypers_key and new.n == n + t["k"]
    assert new.fit_result.matvecs == new.fit_result.iterations + 1
    assert float(torch.max(new.fit_result.rel_residual)) <= 1e-4


def test_lowrank_update_solves_only_k_columns(small_problem, fitted):
    """Twin of tests/test_serve.py:449 on the reference's draws (its fit at
    key 9, its new rows' ε at key 10): the rank-k path spends k correction
    columns against the OLD operator plus ONE certification matvec. Its Z
    solve draws nothing, so its count is held to the reference's (62) and the
    warm full refit's to the reference's (65), each within 15%. The
    reference's strict ``lowrank < full`` is not held: its margin here, 3
    iterations, is inside the packages' fp32 CG drift, and over the
    reference's own draws the two counts meet (62 and 62 at keys 5, 6)."""
    jst, _ = fitted
    x_new, y_new = small_problem["x"][:6] + 0.02, small_problem["y"][:6]
    jlo = jupdate_state_lowrank(jst, x_new, y_new, jax.random.PRNGKey(10))
    jfu = jextend_state(jst, x_new, y_new, jax.random.PRNGKey(10), warm=True)
    st = _carry(jst)
    eps = torch.as_tensor(np.asarray(jlo.eps[96:]))
    lo = update_state_lowrank(st, np.asarray(x_new), np.asarray(y_new), eps=eps)
    fu = extend_state(st, np.asarray(x_new), np.asarray(y_new), eps=eps, warm=True)
    assert lo.fit_result.matvecs == lo.fit_result.iterations + 1
    assert fu.fit_result.matvecs == fu.fit_result.iterations + 1  # warm start
    for got, want in ((lo, jlo), (fu, jfu)):
        want_iters = int(want.fit_result.iterations)
        assert abs(got.fit_result.iterations - want_iters) <= COUNT_SLACK * want_iters
    assert lo.n == st.n + 6
    assert float(torch.max(lo.fit_result.rel_residual)) <= 4.0 * 1e-4
    assert torch.equal(lo.eps, fu.eps)


def test_incremental_updates_evaluate_prior_on_new_rows_only(small_problem, monkeypatch):
    p = small_problem
    st = fit_state(p["params"], np.asarray(p["x"]), np.asarray(p["y"]),
                   spec=CG(max_iters=300, tol=1e-4), num_samples=4, num_features=128,
                   generator=make_generator(9, "cpu"))
    x_new, y_new = np.asarray(p["x"][:6]) + 0.02, np.asarray(p["y"][:6])
    rows_seen = []
    orig_call = PriorSamples.__call__

    def spy(self, xs):
        rows_seen.append(int(xs.shape[0]))
        return orig_call(self, xs)

    monkeypatch.setattr(PriorSamples, "__call__", spy)
    lo = update_state_lowrank(st, x_new, y_new, generator=make_generator(10, "cpu"))
    fu = extend_state(st, x_new, y_new, warm=True, generator=make_generator(10, "cpu"))
    assert rows_seen and max(rows_seen) == 6, rows_seen
    assert torch.equal(lo.f_x[:96], st.f_x) and torch.equal(fu.f_x[:96], st.f_x)


def test_warm_start_cache_lru_and_purge():
    cache = WarmStartCache(max_entries=2)
    for seed in range(3):
        cache.store("k", "sample", seed, torch.full((4, 2), float(seed)))
    assert len(cache) == 2 and not cache.probe("k", "sample", 0)
    hit = cache.lookup("k", "sample", 1)
    assert isinstance(hit, np.ndarray) and hit.shape == (4, 2) and hit[0, 0] == 1.0
    cache.store("k2", "sample", 5, torch.zeros((4, 2)))  # evicts seed 2, not 1
    assert cache.probe("k", "sample", 1) and not cache.probe("k", "sample", 2)
    assert cache.purge("k2") == 1 and len(cache) == 1


def test_every_engine_width_has_a_compiled_gram_instance():
    """The bucketed widths the engine produces (8…64 columns a solve batch,
    1 + s at fit, s = 16 at predict) map onto the Gram kernel's compiled tile
    widths (``REPRO_GRAM_TILE_BUCKETS`` in csrc/gram_matvec.cu)."""
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_matvec.cu").read_text()
    line = next(ln for ln in src.splitlines() if ln.startswith("#define REPRO_GRAM_TILE_BUCKETS"))
    buckets = [int(v) for v in line.split(None, 2)[2].split(",")]
    for s in (8, 16, 32, 64, 17, 65, 5, 9):
        plan = gram_plan(45_730, 45_730, 9, s)
        assert plan.width % 8 == 0 and plan.width // 8 <= max(buckets)
        assert plan.slices * plan.width >= s


# ---------------------------------------------------------------------------
# the committed reference rows of results/BENCH_bench_serve.json at n = 512
# ---------------------------------------------------------------------------


def _bench_rows():
    rows = json.loads((ROOT / "results/BENCH_bench_serve.json").read_text())["rows"]
    return {(r["table"], r["method"]): r["metrics"] for r in rows}


def _bench_dataset(n, d):
    """benchmarks/bench_serve.py:62's dataset."""
    kx, kw = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.uniform(kx, (n, d))
    w = jax.random.normal(kw, (d,))
    y = jnp.sin(4.0 * (x @ w)) + 0.1 * jnp.cos(7.0 * x[:, 0])
    return np.asarray(x), np.asarray(y)


def _within(got, want):
    return abs(got - want) <= COUNT_SLACK * want


def _warm_waves(eng, seeds):
    """bench_serve's warm-start section (benchmarks/bench_serve.py:144-165):
    one cold wave of depth 8 × 4 columns, then its repeat; returns the two
    batches' iterations."""
    out = []
    for _ in range(2):
        hs = [eng.sample(np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(7), s), (16, 3))), num_samples=4, seed=s)
            for s in seeds]
        eng.run_until_idle()
        assert len({h.result().metrics["iterations"] for h in hs}) == 1  # one batch
        out.append(hs[0].result().metrics["iterations"])
    assert all(h.result().metrics["warm"] for h in hs) and eng.stats()["warm_hits"] == 8
    return out


def _bench_engines():
    """The bench's engine (benchmarks/bench_serve.py:68-77) at n = 512, the
    reference's and the port's."""
    x, y = _bench_dataset(512, 3)
    jp = jmake_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=3)
    kw = dict(num_samples=4, num_features=256, seed=0, max_batch_requests=8,
              max_rhs_columns=128)
    jeng = jGPEngine(jp, jnp.asarray(x), jnp.asarray(y), spec=JCG(max_iters=200, tol=1e-4),
                     **kw)
    return jeng, x, y, _tparams(jp), kw


#: the reference's warm counts on bench_serve's seeds 100–107 when its cold
#: batch stops at 190, 195, 200, 205 and 210 iterations: 28, 28, 18, 13, 11
#: (this container, JAX on the CPU), and on seeds 200, 300, 400 at 200:
#: 23, 24, 26
REFERENCE_WARM_BAND = (11, 28)


@pytest.mark.parametrize("draws", ["reference", "port"])
def test_warm_and_cold_batch_iterations_against_the_committed_rows(draws):
    """bench_serve's cold batch and its warm repeat (committed: 200 and 18
    iterations). The cold batch stops at its 200-iteration budget just short
    of 1e-4, so the warm count measures how far short, and moves steeply with
    it: the reference's own takes 28 warm iterations after 195 cold ones and
    13 after 205. The packages' fp32 CG drifts by a few iterations at n = 512
    (ROADMAP queue 3), so the port's warm count is held to that band
    (REFERENCE_WARM_BAND, within 15%), on the reference's draws (its fitted
    state carried across, its per-request draws injected) and on the port's;
    the cold count to the committed row within 15%; the warm batch below a
    quarter of the cold (the chip check's gate)."""
    rows = _bench_rows()
    jeng, x, y, params, kw = _bench_engines()
    extra = {}
    if draws == "reference":
        extra = dict(state=_carry(jeng.state), draws_fn=lambda req: request_draws_from_numpy(
            *(np.asarray(a) for a in jeng._request_draws(req)[:2]), device="cpu"))
    eng = GPEngine(params, x, y, spec=CG(max_iters=200, tol=1e-4), device="cpu", **kw,
                   **extra)
    cold, warm = _warm_waves(eng, range(100, 108))
    assert _within(cold, rows[("serve_warmstart", "cold")]["iterations"]), cold
    lo, hi = REFERENCE_WARM_BAND
    assert (1 - COUNT_SLACK) * lo <= warm <= (1 + COUNT_SLACK) * hi, warm
    assert warm < cold / 4


def test_refit_matvec_columns_match_the_committed_rows():
    """bench_serve's write-heavy section (benchmarks/bench_serve.py:167-213):
    k = 4 rows appended at n = 512 to a 16-sample state fitted at
    CG(600, 1e-5); the committed rows are 777 (lowrank) and 3,196 (full-warm)
    matvec columns, the lowrank certified at ≤ 1e-4."""
    rows = _bench_rows()
    n, k, s = 512, 4, 16
    x, y = _bench_dataset(n + 4 * k, 3)
    params = _tparams(jmake_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=3))
    st = fit_state(params, x[:n], y[:n], spec=CG(max_iters=600, tol=1e-5), num_samples=s,
                   num_features=256, generator=make_generator(2, "cpu"))
    new = (x[n + k:n + 2 * k], y[n + k:n + 2 * k])
    lo = update_state_lowrank(st, *new, generator=make_generator(3, "cpu"))
    fu = extend_state(st, *new, warm=True, generator=make_generator(3, "cpu"))
    lo_cols = (lo.fit_result.matvecs - 1) * k + (1 + s)
    fu_cols = fu.fit_result.matvecs * (1 + s)
    assert _within(lo_cols, rows[("serve_refit", "lowrank")]["matvec_columns"]), lo_cols
    assert _within(fu_cols, rows[("serve_refit", "full-warm")]["matvec_columns"]), fu_cols
    assert float(torch.max(lo.fit_result.rel_residual)) <= 1e-4
    xt = torch.rand((32, 3), generator=make_generator(9, "cpu"))
    ml, vl = lo.post.sample_mean_and_var(xt)
    mf, vf = fu.post.sample_mean_and_var(xt)
    _assert_close(ml, mf)
    _assert_close(vl, vf)
