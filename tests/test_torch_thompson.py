"""Parallel Thompson sampling in the port (``repro_torch.core.thompson``) against
the JAX reference's ``repro.core.thompson`` on the CPU, with the reference's
own draws injected (``ThompsonDraws``): the candidates and their values, the
top-k selection, the ascent's gradient, the iterates after 1, 5 and 20 Adam
steps and the acquisitions, on the reference's own CG(max_iters=100) and SDD
posteriors; a whole ``thompson_step`` on SDD with the reference's per-step
``RowDraws``; and a twin of tests/test_thompson.py's
``test_thompson_improves_over_random`` on the port's own generator.

Tolerances: 1e-4 for values, gradients and iterates, as max|Δ| ≤
tol·max(1, max|ref|) (the reference's fused-VJP tolerance,
tests/test_kernels_pallas.py:131-134). A whole step on CG is not held to
1e-4: fp32 CG on this problem stops at max_iters = 100 short of its
tolerance, and the two packages' iterates drift apart in that time
(ROADMAP queue 3), so the stage tests take the reference's own posterior."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import make_params as jmake_params
from repro.core.pathwise import posterior_functions as jposterior_functions
from repro.core.rff import sample_prior as jsample_prior
from repro.core.solvers.spec import CG as JCG
from repro.core.solvers.spec import SDD as JSDD
from repro.core.thompson import ThompsonState as JState
from repro.core.thompson import _maximise_samples as jmaximise
from repro.core.thompson import thompson_step as jthompson_step
from repro_torch.convert import (
    params_from_numpy, posterior_from_numpy, prior_from_numpy, row_draws_from_numpy,
    thompson_draws_from_numpy, thompson_state_from_numpy,
)
from repro_torch.core import CG, SDD, ThompsonState, ascend_samples, make_params, thompson_step
from repro_torch.core.rff import sample_prior
from repro_torch.core.thompson import _maximise_samples, ascent_value, thompson_candidates
from repro_torch.kernels import ops

TOL = 1e-4
D, N0, ACQ, CANDS, TOP, FEATURES, LR = 2, 100, 16, 256, 4, 1024, 1e-3
KEY = jax.random.PRNGKey(0)
STEP_KEY = jax.random.fold_in(KEY, 10)
SPECS = {
    "cg": (JCG(max_iters=100), CG(max_iters=100)),
    "sdd": (JSDD(num_steps=300, batch_size=32, step_size_times_n=2.0),
            SDD(num_steps=300, batch_size=32, step_size_times_n=2.0)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _reference_draws(jp, x, y, key, spec_name, jspec):
    """Every draw of the reference's thompson_step(key) as numpy arrays, in
    the order it makes them (thompson.py:112,51-56,134; pathwise.py:172-175;
    the SDD blocks of sdd.py, randint(fold_in(ks, t)))."""
    n, d = x.shape
    kd, km, ko = jax.random.split(key, 3)
    kp, ke, ks = jax.random.split(kd, 3)
    prior = jsample_prior(jp, kp, ACQ, FEATURES, d)
    eps = jnp.sqrt(jp.noise) * jax.random.normal(ke, (n, ACQ))
    ku, kc, kn = jax.random.split(km, 3)
    n_exploit = int(CANDS * 0.9)
    rows = None
    if spec_name == "sdd":
        rows = row_draws_from_numpy(np.stack([
            np.asarray(jax.random.randint(jax.random.fold_in(ks, t), (jspec.batch_size,), 0, n))
            for t in range(jspec.num_steps)]), device="cpu")
    return dict(
        omega=np.array(prior.ff.omega), w=np.array(prior.w), eps=np.array(eps),
        uniform=np.array(jax.random.uniform(ku, (CANDS - n_exploit, d))),
        pick=np.array(jax.random.choice(kc, n, (n_exploit,), p=jax.nn.softmax(y))),
        perturb=np.array(jax.random.normal(kn, (n_exploit, d))),
        obs=np.array(jax.random.normal(ko, (ACQ,))), solver_draws=rows, km=km, kd=kd,
    )


@pytest.fixture(scope="module")
def toy():
    """tests/test_thompson.py's problem: a Matérn-3/2 prior draw on 2,048
    features as the objective, 100 uniform points in 2-D."""
    jp = jmake_params("matern32", lengthscale=0.3, signal=1.0, noise=0.01, d=D)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "matern32", device="cpu")
    target = jsample_prior(jp, jax.random.PRNGKey(42), 1, 2048, D)
    tprior = prior_from_numpy(np.array(target.ff.omega), np.array(target.w),
                              np.array(target.ff.signal), device="cpu")
    x0 = jax.random.uniform(jax.random.fold_in(KEY, 1), (N0, D))
    return dict(jp=jp, tp=tp, jobjective=lambda x: target(x)[:, 0],
                objective=lambda x: tprior(x)[:, 0], x0=x0, y0=target(x0)[:, 0])


@pytest.fixture(scope="module", params=sorted(SPECS))
def stage(request, toy):
    """One spec's reference posterior at the reference's draws, the same
    posterior carried into the port, the reference's candidates and their
    top-k starts."""
    name = request.param
    jspec, _ = SPECS[name]
    jp, x0, y0 = toy["jp"], toy["x0"], toy["y0"]
    dr = _reference_draws(jp, x0, y0, STEP_KEY, name, jspec)
    jpost = jposterior_functions(jp, x0, y0, dr["kd"], num_samples=ACQ,
                                 num_features=FEATURES, spec=jspec)
    prior = prior_from_numpy(np.array(jpost.prior.ff.omega), np.array(jpost.prior.w),
                             np.array(jpost.prior.ff.signal), device="cpu")
    post = posterior_from_numpy(toy["tp"], np.array(x0), np.array(jpost.v_mean),
                                np.array(jpost.alpha), prior, device="cpu")
    ls = float(jnp.mean(jp.lengthscale))
    cands = jnp.clip(jnp.concatenate(
        [dr["uniform"], x0[dr["pick"]] + (ls / 2.0) * dr["perturb"]], axis=0), 0.0, 1.0)
    vals = jpost(cands)
    top = jnp.argsort(-vals, axis=0)[:TOP]
    return dict(name=name, draws=dr, jpost=jpost, post=post, ls=ls, cands=np.array(cands),
                vals=np.array(vals), top=np.array(top), x0=np.array(cands[top]))


def _jax_value(jpost):
    """The reference's ascent objective (thompson.py:62-66)."""
    def value(xs_flat):
        v = jpost(xs_flat).reshape(TOP, ACQ, ACQ)
        return jnp.sum(jnp.einsum("tss->ts", v))
    return value


def _jax_ascent(jpost, x0, steps):
    """The reference's Adam steps (thompson.py:72-80) from x0, all iterates."""
    value = _jax_value(jpost)
    xs = jnp.asarray(x0).reshape(TOP * ACQ, D)
    m, vv = jnp.zeros_like(xs), jnp.zeros_like(xs)
    for t in range(steps):
        g = jax.grad(value)(xs)
        m = 0.9 * m + 0.1 * g
        vv = 0.999 * vv + 0.001 * g * g
        mh = m / (1 - 0.9 ** (t + 1.0))
        vh = vv / (1 - 0.999 ** (t + 1.0))
        xs = jnp.clip(xs + LR * mh / (jnp.sqrt(vh) + 1e-8), 0.0, 1.0)
    return np.array(xs).reshape(TOP, ACQ, D)


def test_candidates_values_and_topk_match_reference(stage, toy):
    dr = stage["draws"]
    cands = thompson_candidates(
        torch.from_numpy(np.array(toy["x0"])), torch.from_numpy(np.array(toy["y0"])), CANDS,
        lengthscale=stage["ls"], uniform=torch.from_numpy(dr["uniform"]),
        pick=torch.from_numpy(dr["pick"].astype(np.int64)),
        perturb=torch.from_numpy(dr["perturb"]))
    _assert_close(cands.numpy(), stage["cands"], 1e-6)
    vals = stage["post"](cands).detach()
    _assert_close(vals.numpy(), stage["vals"])
    top = torch.argsort(-vals, dim=0, stable=True)[:TOP]
    np.testing.assert_array_equal(top.numpy(), stage["top"])
    # the selection is decided by more than the tolerance: the k-th and the
    # (k+1)-th values of every sample are further apart than 2·TOL·scale
    ranked = np.sort(stage["vals"], axis=0)[::-1]
    scale = max(1.0, float(np.abs(stage["vals"]).max()))
    assert float((ranked[TOP - 1] - ranked[TOP]).min()) > 2 * TOL * scale


def test_ascent_gradient_matches_reference(stage):
    x0 = torch.from_numpy(stage["x0"]).requires_grad_()
    (got,) = torch.autograd.grad(ascent_value(stage["post"], x0), [x0])
    want = jax.grad(_jax_value(stage["jpost"]))(jnp.asarray(stage["x0"]).reshape(TOP * ACQ, D))
    _assert_close(got.numpy(), np.array(want).reshape(TOP, ACQ, D))


@pytest.mark.parametrize("steps", [1, 5, 20])
def test_ascent_iterates_and_acquisitions_match_reference(stage, toy, steps):
    # every start's iterate from the reference's x0, and the acquisitions of
    # the reference's own _maximise_samples (candidates, top-k, ascent,
    # argmax) against the port's on the same draws
    got = ascend_samples(stage["post"], torch.from_numpy(stage["x0"]), ascent_steps=steps,
                         lr=LR)
    _assert_close(got.numpy(), _jax_ascent(stage["jpost"], stage["x0"], steps))
    dr = stage["draws"]
    want = jmaximise(stage["jpost"], toy["y0"], dr["km"], num_candidates=CANDS, num_top=TOP,
                     ascent_steps=steps, lr=LR, lengthscale=stage["ls"])
    out = _maximise_samples(
        stage["post"], torch.from_numpy(np.array(toy["y0"])), num_candidates=CANDS,
        num_top=TOP, ascent_steps=steps, lr=LR, lengthscale=stage["ls"],
        uniform=torch.from_numpy(dr["uniform"]),
        pick=torch.from_numpy(dr["pick"].astype(np.int64)),
        perturb=torch.from_numpy(dr["perturb"]))
    _assert_close(out.numpy(), want)


def test_kernel_route_on_cpu_matches_reference(stage):
    # backend="cuda" on CPU tensors: the Gram and RFF autograd Functions with
    # their plain versions behind the wrappers, the route the card takes
    post = stage["post"]
    post = dataclasses.replace(post, backend="cuda", prior=dataclasses.replace(
        post.prior, ff=dataclasses.replace(post.prior.ff, backend="cuda")))
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    got = ascend_samples(post, torch.from_numpy(stage["x0"]), ascent_steps=5, lr=LR)
    _assert_close(got.numpy(), _jax_ascent(stage["jpost"], stage["x0"], 5))
    assert ops.MATVEC_TRACE_COUNTS == {"cuda": 5, "chunked": 0, "dense": 0}
    assert ops.FEATURE_TRACE_COUNTS == {"cuda": 5, "features": 0}


def test_thompson_step_matches_reference_on_sdd(toy):
    jspec, spec = SPECS["sdd"]
    jp, x0, y0 = toy["jp"], toy["x0"], toy["y0"]
    dr = _reference_draws(jp, x0, y0, STEP_KEY, "sdd", jspec)
    want = jthompson_step(jp, JState(x=x0, y=y0, best=float(y0.max())), toy["jobjective"],
                          STEP_KEY, acq_batch=ACQ, num_candidates=CANDS, num_top=TOP,
                          ascent_steps=20, spec=jspec)
    draws = thompson_draws_from_numpy(dr["omega"], dr["w"], dr["eps"], dr["uniform"],
                                      dr["pick"], dr["perturb"], dr["obs"],
                                      solver_draws=dr["solver_draws"], device="cpu")
    state = thompson_state_from_numpy(np.array(x0), np.array(y0), device="cpu")
    got = thompson_step(toy["tp"], state, toy["objective"], draws=draws, acq_batch=ACQ,
                        num_candidates=CANDS, num_top=TOP, ascent_steps=20, spec=spec)
    assert got.x.shape == (N0 + ACQ, D) and got.y.shape == (N0 + ACQ,)
    _assert_close(got.x.numpy(), want.x)
    _assert_close(got.y.numpy(), want.y)
    assert abs(got.best - want.best) <= TOL * max(1.0, abs(want.best))


def test_thompson_step_needs_a_generator_and_reproduces_from_one(toy):
    state = thompson_state_from_numpy(np.array(toy["x0"]), np.array(toy["y0"]), device="cpu")
    kw = dict(acq_batch=4, num_candidates=32, num_top=2, ascent_steps=3, spec=CG(max_iters=20))
    with pytest.raises(ValueError, match="Generator"):
        thompson_step(toy["tp"], state, toy["objective"], **kw)
    a = thompson_step(toy["tp"], state, toy["objective"],
                      generator=torch.Generator().manual_seed(3), **kw)
    b = thompson_step(toy["tp"], state, toy["objective"],
                      generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert a.x.device == state.x.device and torch.equal(a.x[:N0], state.x)


def test_thompson_improves_over_random():
    # twin of tests/test_thompson.py:10, every draw from the port's generators
    gen = torch.Generator().manual_seed(0)
    p = make_params("matern32", lengthscale=0.3, signal=1.0, noise=0.01, d=D, device="cpu")
    target = sample_prior(p, 1, 2048, D, generator=torch.Generator().manual_seed(42))

    def objective(x):
        return target(x)[:, 0]

    x0 = torch.rand((N0, D), generator=gen)
    y0 = objective(x0)
    state = ThompsonState(x=x0, y=y0, best=float(y0.max()))
    best0 = state.best
    for _ in range(3):
        state = thompson_step(p, state, objective, generator=gen, acq_batch=16,
                              num_candidates=256, num_top=4, ascent_steps=20,
                              spec=CG(max_iters=100))
    # random-search baseline with the same total evaluation budget
    xr = torch.rand((3 * 16, D), generator=gen)
    best_rand = max(float(objective(xr).max()), best0)
    assert state.best >= best0
    assert state.best >= best_rand - 0.15  # at least competitive with random
    assert state.x.shape[0] == N0 + 3 * 16
