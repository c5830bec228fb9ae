"""The port's CG (repro_torch.core.solvers) against the JAX reference's, on the
CPU: iteration and matvec counts, solutions, flags, and the committed pol row
of results/BENCH_bench_solvers.json."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.operators import Gram as JGram
from repro.core.pathwise import posterior_functions as jposterior_functions
from repro.core.rff import sample_prior as jsample_prior
from repro.core.solvers.spec import CG as JCG
from repro.core.solvers.cg import solve_cg as jsolve_cg
from repro.core.kernels_fn import make_params as jmake_params
from repro_torch.convert import params_from_numpy
from repro_torch.core.operators import Gram, matvec_counts, reset_matvec_counts
from repro_torch.core.pathwise import posterior_functions
from repro_torch.core.solvers import (
    CG, FLAG_NONFINITE, SolverSpec, as_spec, flag_names, solve, solve_cg,
)
from repro_torch.data.pipeline import regression_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(toy):
    jp = toy["params"]
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), jp.kind, device="cpu")
    x = torch.from_numpy(np.array(toy["x"]))
    return Gram(x=x, params=tp), JGram(x=toy["x"], params=jp)


def _rhs(toy):
    y = np.asarray(toy["y"])
    extra = np.random.default_rng(0).normal(size=(y.shape[0], 2)).astype(np.float32)
    return np.concatenate([y[:, None], extra], axis=1)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _gate(baseline: int) -> int:
    """Iterations allowed against a reference count: the repo's matvec gate
    (benchmarks/check_matvecs.py --slack 0.15) tolerates ceil(15%) for fp32
    reduction-order jitter. fp32 CG amplifies last-bit differences: on this
    toy problem the port's and JAX's residuals agree to 1e-7 for 7 iterations
    and differ by 20% at iteration 10, as two fp32 runs of one recursion do."""
    return int(np.ceil(baseline * 1.15)) - baseline


@pytest.mark.parametrize("k", [1, 3, 6])
def test_cg_recursion_matches_jax_step_by_step(toy_regression, k):
    # Before rounding is amplified, the k-step iterates are the same numbers
    # to fp32 round-off (measured ≤ 2e-6 relative; 1e-4 leaves room for BLAS).
    op, jop = _port(toy_regression)
    b = _rhs(toy_regression)
    ref = jsolve_cg(jop, jnp.asarray(b), max_iters=k, tol=1e-9)
    out = solve_cg(op, torch.from_numpy(b), max_iters=k, tol=1e-9)
    assert out.iterations == int(ref.iterations) == k == out.matvecs
    assert _rel(out.solution.numpy(), ref.solution) <= 1e-4
    np.testing.assert_allclose(out.rel_residual.numpy(), np.asarray(ref.rel_residual),
                               rtol=1e-4)


@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_cg_matches_jax_counts_and_solution(toy_regression, tol):
    # Converged solves: counts within the gate's slack, matvecs == iterations
    # exactly, and solutions within 1e-3 relative (both fp32 CG iterates
    # stopped at the same tolerance).
    op, jop = _port(toy_regression)
    b = _rhs(toy_regression)
    ref = jsolve_cg(jop, jnp.asarray(b), max_iters=500, tol=tol)
    out = solve_cg(op, torch.from_numpy(b), max_iters=500, tol=tol)
    ji = int(ref.iterations)
    assert abs(out.iterations - ji) <= _gate(ji)
    assert out.matvecs == out.iterations and int(ref.matvecs) == ji
    assert out.converged and bool(ref.converged)
    assert _rel(out.solution.numpy(), ref.solution) <= 1e-3
    np.testing.assert_array_equal(out.flags.numpy(), np.asarray(ref.flags))


def test_cg_solution_matches_dense_solve(toy_regression):
    op, _ = _port(toy_regression)
    out = solve_cg(op, torch.from_numpy(np.array(toy_regression["y"])), tol=1e-5,
                   max_iters=1000)
    assert out.solution.shape == (toy_regression["n"],)
    assert _rel(out.solution.numpy(), toy_regression["v_star"]) <= 1e-3


def test_cg_warm_start_and_budget_accounting(toy_regression):
    op, jop = _port(toy_regression)
    b = _rhs(toy_regression)
    cold = solve_cg(op, torch.from_numpy(b), max_iters=8, tol=1e-6)
    assert cold.iterations == cold.matvecs == 8 and not cold.converged
    warm = solve_cg(op, torch.from_numpy(b), x0=cold.solution, max_iters=500, tol=1e-4)
    jcold = jsolve_cg(jop, jnp.asarray(b), max_iters=8, tol=1e-6)
    jwarm = jsolve_cg(jop, jnp.asarray(b), x0=jcold.solution, max_iters=500, tol=1e-4)
    assert warm.matvecs == warm.iterations + 1  # the warm-start residual matvec
    assert int(jwarm.matvecs) == int(jwarm.iterations) + 1
    assert abs(warm.iterations - int(jwarm.iterations)) <= _gate(int(jwarm.iterations))
    assert _rel(warm.solution.numpy(), jwarm.solution) <= 1e-3


def test_cg_flags_freeze_nonfinite_columns_like_jax(toy_regression):
    op, jop = _port(toy_regression)
    b = _rhs(toy_regression)
    b[3, 1] = np.nan
    ref = jsolve_cg(jop, jnp.asarray(b), max_iters=500, tol=1e-4)
    out = solve_cg(op, torch.from_numpy(b), max_iters=500, tol=1e-4)
    np.testing.assert_array_equal(out.flags.numpy(), np.asarray(ref.flags))
    assert flag_names(int(out.flags[1])) == ("nonfinite",)
    assert int(out.flags[1]) & FLAG_NONFINITE and not out.healthy and not out.converged
    # the healthy columns still converge, unharmed by the NaN column
    assert (out.rel_residual[[0, 2]] <= 1e-4).all()
    assert abs(out.iterations - int(ref.iterations)) <= _gate(int(ref.iterations))


def test_instrumented_counts_match_matvecs(toy_regression):
    op, _ = _port(toy_regression)
    import dataclasses
    op = dataclasses.replace(op, instrument=True)
    reset_matvec_counts()
    out = solve(op, torch.from_numpy(_rhs(toy_regression)), CG(tol=1e-3))
    assert matvec_counts() == {"mv": out.matvecs, "rows": 0}


def test_solve_spec_dispatch_and_refusals(toy_regression):
    op, _ = _port(toy_regression)
    b = torch.from_numpy(_rhs(toy_regression))
    assert isinstance(as_spec("cg"), SolverSpec) and as_spec(CG, tol=0.5).tol == 0.5
    pinned = solve(op, b, "cg", tol=1e-3, backend="dense")
    auto = solve(op, b, CG(tol=1e-3))
    assert pinned.iterations == auto.iterations
    # the δ channel folds into the RHS: (K+σ²I)V = b + σ²δ
    delta = torch.ones_like(b)
    folded = solve(op, b + op.noise * delta, CG(tol=1e-4))
    via_delta = solve(op, b, CG(tol=1e-4), delta=delta)
    np.testing.assert_array_equal(folded.solution.numpy(), via_delta.solution.numpy())
    # the stochastic solvers are ported: they run from a generator, and
    # refuse to run without one or injected draws
    gen = torch.Generator().manual_seed(0)
    for name, kw in (("sgd", dict(num_steps=5, batch_size=16, num_features=8)),
                     ("sdd", dict(num_steps=5, batch_size=16)),
                     ("ap", dict(num_steps=5, block_size=16))):
        out = solve(op, b, name, generator=gen, **kw)
        assert out.solution.shape == b.shape and out.iterations == 5
        with pytest.raises(ValueError, match="stochastic"):
            solve(op, b, name, **kw)
    with pytest.raises(TypeError, match="preconditioner spec"):
        solve(op, b, CG(precond=object()))
    with pytest.raises(ValueError, match="unknown solver"):
        as_spec("lbfgs")
    with pytest.raises(ValueError, match="must match b exactly"):
        solve(op, b, "cg", x0=b[:, 0])
    with pytest.raises(ValueError, match="unknown backend"):
        solve(op, b, CG(backend="pallas2"))


def test_pol_3750_iterations_match_committed_bench():
    # The committed CG row of results/BENCH_bench_solvers.json: pol at
    # n = 15,000·0.25 = 3,750, Matérn-3/2 with ℓ = √d·0.5, σ_f² = 1, σ² = 0.1,
    # 16 samples on 2,048 features, CG(max_iters=150, tol=1e-3), PRNGKey(0).
    # JAX's own draws for that key are injected (pathwise.py:172 split), and
    # JAX is run on the same problem here. The committed row says 24; the
    # reference itself takes 26 in this environment (fp32 CG counts move with
    # reduction order), so the port is held to the reference run beside it
    # within one iteration, and to the committed row within the repo gate's
    # 15% (benchmarks/check_matvecs.py).
    rows = json.loads((ROOT / "results" / "BENCH_bench_solvers.json").read_text())["rows"]
    row = next(r for r in rows if r["dataset"] == "pol" and r["method"] == "CG"
               and r["table"] == "solvers(T3.1/4.1)")
    assert row["metrics"]["iters"] == row["metrics"]["matvecs"] == 24
    data = regression_dataset("pol", seed=0)
    n, d = int(data["n"] * 0.25), data["d"]
    x, y = data["x"][:n], data["y"][:n]
    jp = jmake_params("matern32", lengthscale=float(np.sqrt(d)) * 0.5, signal=1.0,
                      noise=0.1, d=d)
    spec = dict(num_samples=16, num_features=2048)
    key = jax.random.PRNGKey(0)
    kp, ke, _ = jax.random.split(key, 3)
    prior = jsample_prior(jp, kp, 16, 2048, d)
    eps = np.array(jnp.sqrt(jp.noise) * jax.random.normal(ke, (n, 16)))
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "matern32", device="cpu")
    post = posterior_functions(
        tp, torch.from_numpy(x), torch.from_numpy(y), spec=CG(max_iters=150, tol=1e-3),
        omega=torch.from_numpy(np.array(prior.ff.omega)),
        w=torch.from_numpy(np.array(prior.w)), eps=torch.from_numpy(eps), **spec,
    )
    ref = jposterior_functions(jp, jnp.asarray(x), jnp.asarray(y), key,
                               spec=JCG(max_iters=150, tol=1e-3), **spec)
    info, ji = post.solve_info, int(ref.solve_info.iterations)
    assert abs(info.iterations - ji) <= 1
    assert info.iterations - 24 <= _gate(24)
    assert info.matvecs == info.iterations
    assert info.converged and info.healthy
    assert _rel(post.v_mean.numpy(), ref.v_mean) <= 1e-2
