"""The port's escalation ladder (repro_torch.core.solvers.robust) and fault
injection (repro_torch.testing) against the JAX reference on the CPU: twins
of tests/test_robustness.py:78-247,437 (not the scheduler and engine tests,
which wait for the serving engine) and of
tests/test_robustness_property.py:52, on the reference's own problem arrays,
and benchmarks/bench_robust.py's three problems against the committed
results/BENCH_bench_robust.json."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import EscalationPolicy as JEscalationPolicy
from repro.core import solve as jsolve
from repro.core import solve_robust as jsolve_robust
from repro.testing import near_singular_problem as jnear_singular_problem
from repro_torch.core import (
    SGD, EscalationPolicy, FourierFeatures, Gram, IterativeGP, make_params, solve,
    solve_robust,
)
from repro_torch.core.solvers import (
    FLAG_BREAKDOWN, FLAG_NONFINITE, FLAG_STAGNATION, FROZEN_FLAGS, flag_names,
)
from repro_torch.core.solvers.robust import _JitteredOp
from repro_torch.testing import (
    DenseOperator, FaultyFeatureOperator, FaultyOperator, nan_columns, near_singular_problem,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the repo's count gate (benchmarks/check_matvecs.py --slack 0.15)
COUNT_SLACK = 0.15
SPECS = {
    "cg": dict(spec="cg", max_iters=40, tol=1e-5),
    "sgd": dict(spec="sgd", num_steps=200, batch_size=32),
    "sdd": dict(spec="sdd", num_steps=200, batch_size=32, step_size_times_n=1.0),
    "ap": dict(spec="ap", num_steps=100, block_size=32),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def well_posed():
    """tests/test_robustness.py:57's problem in both packages."""
    from repro.core import Gram as JGram
    from repro.core import make_params as jmake_params

    kx, kb = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.uniform(kx, (80, 2))
    b = jax.random.normal(kb, (80, 3))
    params = make_params("se", lengthscale=0.7, signal=1.0, noise=0.3, device="cpu")
    jop = JGram(x=x, params=jmake_params("se", lengthscale=0.7, signal=1.0, noise=0.3))
    return Gram(x=_t(x), params=params), _t(b), jop, b


@pytest.fixture(scope="module")
def near_singular():
    """The reference's near_singular_problem(96, 3) arrays, in both packages."""
    jop, jb, _, jx = jnear_singular_problem(96, 3)
    op, b, _, _ = near_singular_problem(96, 3, x=_t(jx), b=_t(jb), device="cpu")
    return op, b, jop, jb


def _flags(res):
    return np.atleast_1d(res.flags.numpy()).astype(np.int64)


# ---------------------------------------------------------------------------
# solver layer: in-loop detection + isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(SPECS))
def test_nan_rhs_flags_only_its_column(well_posed, family):
    # a NaN column is flagged and frozen; the other columns are bit-identical
    # to a fault-free solve on the same draws
    op, b, _, _ = well_posed
    kw = dict(SPECS[family])
    spec = kw.pop("spec")
    clean = solve(op, b, spec, generator=_gen(11), **kw)
    dirty = solve(op, nan_columns(b, (1,)), spec, generator=_gen(11), **kw)
    fl = _flags(dirty)
    assert fl[1] & FLAG_NONFINITE
    assert not (fl[0] | fl[2]) & FLAG_NONFINITE
    assert not dirty.healthy and clean.healthy and not dirty.converged
    assert torch.equal(dirty.solution[:, 0], clean.solution[:, 0])
    assert torch.equal(dirty.solution[:, 2], clean.solution[:, 2])


def test_cg_breakdown_flag():
    op = DenseOperator(a=torch.diag(torch.tensor([1.0, -1.0])))
    res = solve(op, torch.ones((2, 1)), "cg", max_iters=10, tol=1e-6)
    assert _flags(res)[0] & FLAG_BREAKDOWN
    assert not res.converged


def test_cg_stagnation_flag_and_no_silent_nan(near_singular):
    # on the reference's arrays: every column stagnates in both packages,
    # nothing is frozen, and no family returns an unflagged non-finite column
    op, b, jop, jb = near_singular
    res = solve(op, b, "cg", max_iters=400, tol=1e-6, stall_window=30)
    ref = jsolve(jop, jb, "cg", max_iters=400, tol=1e-6, stall_window=30)
    assert (_flags(res) & FLAG_STAGNATION).all()
    assert (np.asarray(ref.flags) & FLAG_STAGNATION).all()
    assert res.healthy
    for family, kw in SPECS.items():
        kw = dict(kw)
        spec = kw.pop("spec")
        r = solve(op, b, spec, generator=_gen(0), **kw)
        bad_cols = ~torch.isfinite(r.solution).all(dim=0).numpy()
        flagged = (_flags(r) & FROZEN_FLAGS) != 0
        assert (~bad_cols | flagged).all(), f"{family}: non-finite column without a flag"


def test_faulty_operator_isolation(well_posed):
    # a matvec fault in one column flags that column only, and vanishes below
    # min_width (the solo re-run)
    op, b, _, _ = well_posed
    fop = FaultyOperator(op, columns=(1,), min_width=2)
    assert fop.shape == op.shape and fop.x is op.x  # capabilities forward
    clean = solve(op, b, "cg", max_iters=40, tol=1e-5)
    dirty = solve(fop, b, "cg", max_iters=40, tol=1e-5)
    fl = _flags(dirty)
    assert fl[1] & FLAG_NONFINITE and not fl[0] and not fl[2]
    assert torch.equal(dirty.solution[:, 0], clean.solution[:, 0])
    assert solve(fop, b[:, :1], "cg", max_iters=40, tol=1e-5).healthy


def test_faulty_feature_operator_poisons_its_columns():
    omega = torch.randn((8, 2), generator=_gen(1))
    ff = FourierFeatures(omega=omega, phase=torch.zeros(8), signal=torch.tensor(1.0))
    fff = FaultyFeatureOperator(ff, columns=(0,))
    x, w = torch.rand((5, 2), generator=_gen(2)), torch.randn((16, 2), generator=_gen(3))
    out = fff.phi_mv(x, w)
    assert torch.isnan(out[:, 0]).all() and torch.equal(out[:, 1], ff.phi_mv(x, w)[:, 1])
    assert torch.equal(fff.phi_t_mv(x, out[:, 1:]), ff.phi_t_mv(x, out[:, 1:]))
    assert fff.num_features == 16 and torch.equal(fff.features(x), ff.features(x))


def test_facade_warns_with_flag_names():
    gp = IterativeGP("se", noise=0.1, spec="cg", device="cpu")
    y = torch.zeros(16)
    y[3] = float("nan")
    gp.fit(torch.rand((16, 1), generator=_gen(0)), y)
    with pytest.warns(RuntimeWarning, match="nonfinite"):
        gp.posterior(num_samples=4, num_features=64)


# ---------------------------------------------------------------------------
# ladder layer: solve_robust
# ---------------------------------------------------------------------------


def test_ladder_happy_path_is_free(well_posed):
    op, b, _, _ = well_posed
    plain = solve(op, b, "cg", max_iters=40, tol=1e-5)
    rep = solve_robust(op, b, "cg", max_iters=40, tol=1e-5)
    assert not rep.escalated and rep.rungs == () and rep.recovered
    assert rep.result.matvecs == plain.matvecs
    assert torch.equal(rep.result.solution, plain.solution)


@pytest.mark.parametrize("n,s,stall", [(96, 3, 30), (64, 2, 25)])
def test_ladder_recovers_stagnation_like_the_reference(n, s, stall):
    # the reference's arrays: the same rungs, ladder string and recovered
    # columns, the matvec bill within the gate's 15%
    jop, jb, _, jx = jnear_singular_problem(n, s)
    op, b, _, _ = near_singular_problem(n, s, x=_t(jx), b=_t(jb), device="cpu")
    kw = dict(max_iters=200, tol=1e-6, stall_window=stall)
    rep = solve_robust(op, b, "cg", policy=EscalationPolicy(), **kw)
    ref = jsolve_robust(jop, jb, "cg", policy=JEscalationPolicy(), **kw)
    assert rep.escalated and rep.recovered and rep.failed_columns == ()
    assert rep.ladder == ref.ladder
    assert [r.recovered for r in rep.rungs] == [r.recovered for r in ref.rungs]
    assert [r.columns for r in rep.rungs] == [r.columns for r in ref.rungs]
    want = int(ref.result.matvecs)
    assert abs(rep.result.matvecs - want) <= np.ceil(COUNT_SLACK * want)
    assert (_flags(rep.result) == 0).all()
    assert torch.isfinite(rep.result.solution).all()
    for rec in rep.rungs:  # auditable: every rung says what it attempted
        assert rec.columns and len(rec.flags_before) == len(rec.columns)
        assert all(isinstance(names, tuple) for names in rec.flag_names_before)


def test_ladder_structured_failure_on_nan_rhs(well_posed):
    op, b, _, _ = well_posed
    base = solve(op, b, "cg", max_iters=40, tol=1e-5)
    rep = solve_robust(op, nan_columns(b, (2,)), "cg", max_iters=40, tol=1e-5)
    assert rep.escalated and not rep.recovered
    assert rep.failed_columns == (2,)
    assert _flags(rep.result)[2] & FLAG_NONFINITE
    assert torch.equal(rep.result.solution[:, 0], base.solution[:, 0])


def test_ladder_switches_stochastic_family_to_cg(well_posed):
    op, b, jop, jb = well_posed
    policy = dict(dense_fallback_max_n=0)
    rep = solve_robust(op, nan_columns(b, (0,)), SGD(num_steps=40, batch_size=32),
                       generator=_gen(0), policy=EscalationPolicy(**policy))
    ref = jsolve_robust(jop, jnp.asarray(jb).at[:, 0].set(jnp.nan), "sgd", num_steps=40,
                        batch_size=32, key=jax.random.PRNGKey(0),
                        policy=JEscalationPolicy(**policy))
    assert "switch:cg" in rep.ladder and rep.ladder == ref.ladder
    assert rep.failed_columns == (0,) == ref.failed_columns


def test_ladder_indefinite_unrescuable_is_structured():
    op = DenseOperator(a=torch.diag(torch.tensor([1.0, -1.0])))
    rep = solve_robust(op, torch.ones((2, 1)), "cg", max_iters=10, tol=1e-6)
    assert rep.escalated and not rep.recovered
    assert rep.failed_columns == (0,)
    assert all(r.recovered == () for r in rep.rungs)


@pytest.mark.parametrize("n,s", [(64, 2), (96, 3)])
def test_ladder_precond_rung_then_dense_rescue(n, s):
    # with the jitter rungs off, a stagnating CG takes the Nyström precondition
    # rung (its subset holds duplicated rows, so the factor is NaN in both
    # packages and the rung recovers nothing), then the dense Cholesky
    # fallback at jitter 1e-2. The fallback accepts a column at max(tol,
    # 1e-4): its fp32 residuals land at 4e-5..1.2e-4 in either package, so
    # tol = 3e-4 keeps the comparison off that edge
    jop, jb, _, jx = jnear_singular_problem(n, s)
    op, b, _, _ = near_singular_problem(n, s, x=_t(jx), b=_t(jb), device="cpu")
    kw = dict(max_iters=60, tol=3e-4, stall_window=25)
    policy = dict(jitter=(), cg_max_iters=60)
    rep = solve_robust(op, b, "cg", policy=EscalationPolicy(**policy), **kw)
    ref = jsolve_robust(jop, jb, "cg", policy=JEscalationPolicy(**policy), **kw)
    assert rep.ladder == ref.ladder == ("precond:nystrom", "dense:cholesky(jitter=0.01)")
    assert [r.recovered for r in rep.rungs] == [r.recovered for r in ref.rungs]
    assert rep.recovered and ref.recovered
    want = np.asarray(ref.result.solution)
    np.testing.assert_allclose(rep.result.solution.numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def test_jittered_op_forwards_capabilities(well_posed):
    op, b, _, _ = well_posed
    jop = _JitteredOp(inner=op, eps=torch.tensor(0.5))
    assert jop.x is op.x and hasattr(jop, "rows_mv") and hasattr(jop, "precond_factor")
    np.testing.assert_allclose(jop.mv(b).numpy(), (op.mv(b) + 0.5 * b).numpy(), rtol=1e-6)
    np.testing.assert_allclose(jop.dense().numpy(), (op.dense() + 0.5 * torch.eye(80)).numpy(),
                               rtol=1e-6)
    assert float(jop.noise) == pytest.approx(float(op.noise) + 0.5)


def test_flag_names_roundtrip():
    assert flag_names(0) == ()
    assert flag_names(FLAG_NONFINITE | FLAG_STAGNATION) == ("nonfinite", "stagnation")
    assert "breakdown" in flag_names(FROZEN_FLAGS)


# ---------------------------------------------------------------------------
# benchmarks/bench_robust.py's three problems, from the port's generator,
# against the committed rows
# ---------------------------------------------------------------------------


def _committed(table):
    rows = json.loads((ROOT / "results" / "BENCH_bench_robust.json").read_text())["rows"]
    return {r["method"]: r["metrics"] for r in rows if r["table"] == table}


def test_bench_robust_problems_from_the_ports_generator():
    gen = _gen(0)
    x = torch.rand((512, 3), generator=gen)
    b = torch.randn((512, 16), generator=gen)
    op = Gram(x=x, params=make_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1,
                                      d=3, device="cpu"))
    kw = dict(max_iters=120, tol=1e-4)
    plain = solve(op, b, "cg", **kw)
    robust = solve_robust(op, b, "cg", **kw)
    assert not robust.escalated and robust.result.matvecs == plain.matvecs
    assert plain.matvecs == _committed("robust_overhead")["plain"]["matvecs"]
    ns_op, ns_b, _, _ = near_singular_problem(96, 3, generator=_gen(0), device="cpu")
    rep = solve_robust(ns_op, ns_b, "cg", max_iters=200, tol=1e-6, stall_window=30)
    want = _committed("robust_recovery")["ladder"]
    assert rep.recovered and " > ".join(rep.ladder) == want["ladder"]
    assert len(rep.rungs) == want["rungs"]
    assert abs(rep.result.matvecs - want["matvecs"]) <= np.ceil(COUNT_SLACK * want["matvecs"])
    bad = solve_robust(op, nan_columns(b, (1,)), "cg", **kw)
    assert bad.escalated and bad.failed_columns == (1,)
    assert torch.equal(bad.result.solution[:, 0], plain.solution[:, 0])
