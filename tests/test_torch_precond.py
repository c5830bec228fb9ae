"""The port's preconditioners (repro_torch.core.precond), preconditioned CG,
``RFFGram``, the spec JSON round trip, ``solve_batched``/``solve_bordered`` and
a preconditioned MLL step, against the JAX reference on the CPU with the
reference's own draws injected (the Nyström subset ``jax.random.choice``
draws, the RFF preconditioner's spectral base draws). Twins of
tests/test_solvers.py:92, tests/test_solver_spec.py:162,245-293,
tests/test_operators.py:80,123 and tests/test_features.py:298-401."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import precond as jpre
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.mll import mll_grad as jmll_grad
from repro.core.operators import Gram as JGram
from repro.core.operators import RFFGram as JRFFGram
from repro.core.rff import make_fourier_features as jmake_ff
from repro.core.solvers import spec as jspec
from repro.core.solvers.cg import solve_cg as jsolve_cg
from repro_torch.convert import features_from_numpy, params_from_numpy, precond_draws_from_numpy
from repro_torch.core import (
    CG, SGD, Gram, IterativeGP, Jacobi, JacobiPrecond, MLLDraws, Nystrom, PivotedCholesky,
    RFF, RFFGram, WoodburyPrecond, jacobi_preconditioner, mll_grad, nystrom_preconditioner,
    solve, solve_batched, solve_bordered, woodbury_from_factor,
)
from repro_torch.core import precond as tpre
from repro_torch.core.operators import capabilities
from repro_torch.core.solvers import (
    SolverSpec, get_precond, get_solver, registered_preconds, registered_solvers, solve_cg,
    spec_from_dict, spec_from_json, spec_to_dict, spec_to_json,
)
from repro_torch.testing import DenseOperator

KEY = jax.random.PRNGKey(1)
#: the repo's count gate (benchmarks/check_matvecs.py --slack 0.15): fp32 CG
#: counts move with reduction order (ROADMAP queue 3)
COUNT_SLACK = 0.15
#: the reference's own solution tolerance against the dense solve
#: (tests/test_solvers.py:104, tests/test_features.py:379)
SOL_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(jp):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), jp.kind, device="cpu")


@pytest.fixture(scope="module")
def toy(toy_regression):
    t = toy_regression
    tp = _params(t["params"])
    tx = torch.from_numpy(np.array(t["x"]))
    return dict(t, tp=tp, tx=tx, ty=torch.from_numpy(np.array(t["y"])),
                op=Gram(x=tx, params=tp), jop=JGram(x=t["x"], params=t["params"]))


def _nystrom_idx(key, n, rank):
    """The reference's subset (precond.py:139)."""
    return np.array(jax.random.choice(key, n, (min(rank, n),), replace=False))


def _spectral_base(key, kind, m, d):
    """The base draws of the reference's spectral_sample(params, key, m, d)
    (kernels_fn.py:188-199): normals from ``key``, Matérn gammas from
    ``fold_in(key, 1)``."""
    normals = np.array(jax.random.normal(key, (m, d)))
    gammas = None
    if kind != "se":
        nu = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[kind]
        gammas = np.array(jax.random.gamma(jax.random.fold_in(key, 1), nu, (m, 1)))
    return normals, gammas


def _draws(pspec, key, t):
    """The port's PrecondDraws for the reference's ``pspec.build(op, key)``."""
    if isinstance(pspec, Nystrom):
        return precond_draws_from_numpy(idx=_nystrom_idx(key, t["n"], pspec.rank),
                                        device="cpu")
    if isinstance(pspec, RFF):
        normals, gammas = _spectral_base(key, t["params"].kind, pspec.rank // 2, t["d"])
        return precond_draws_from_numpy(normals=normals, gammas=gammas, device="cpu")
    return None


def _pivots(l, signal):
    """The pivot sequence of a pivoted-Cholesky factor, replayed: step i picks
    the first maximum of the diagonal left by columns < i, as both builds do."""
    l = np.asarray(l, dtype=np.float64)
    diag = np.full(l.shape[0], float(signal))
    out = []
    for i in range(l.shape[1]):
        p = int(np.argmax(diag))
        out.append(p)
        diag = np.maximum(diag - l[:, i] ** 2, 0.0)
        diag[p] = 0.0
    return out


# ---------------------------------------------------------------------------
# factors and applies
# ---------------------------------------------------------------------------


def test_nystrom_factor_on_the_reference_subset(toy):
    # L = K_xz chol(inv(K_zz + 1e-6 I)) in fp32: the inverse then Cholesky
    # amplify rounding by K_zz's condition number; measured 1.0e-4 on the
    # 400 × 100 factor (entries up to 1), held at 1e-3
    t = toy
    lj = np.asarray(jpre.nystrom_factor(t["params"], t["x"], KEY, 100))
    idx = torch.from_numpy(_nystrom_idx(KEY, t["n"], 100))
    lt = tpre.nystrom_factor(t["tp"], t["tx"], 100, idx=idx).numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="subset"):
        tpre.nystrom_factor(t["tp"], t["tx"], 50, idx=idx)


def test_pivoted_cholesky_factor_same_pivots(toy):
    # the diagonal starts constant and both argmaxes take the first maximum:
    # all 100 pivots agree at n = 400, and the factors to 1e-4 (measured 2.4e-6)
    t = toy
    lj = np.asarray(jpre._pivoted_cholesky_factor(t["params"], t["x"], 100))
    lt = tpre._pivoted_cholesky_factor(t["tp"], t["tx"], 100).numpy()
    signal = float(t["params"].signal)
    assert _pivots(lt, signal) == _pivots(lj, signal)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_rff_factor_on_the_reference_frequencies(kind):
    # Φ(x) on the reference's ω (its base draws rescaled by θ): 1e-6 (measured 7e-9)
    x = jax.random.normal(jax.random.PRNGKey(3), (200, 3))
    jp = jmake_params(kind, lengthscale=0.8, signal=1.3, noise=0.2, d=3)
    lj = np.asarray(jpre.rff_factor(jp, x, KEY, 64))
    normals, gammas = _spectral_base(KEY, kind, 32, 3)
    lt = tpre.rff_factor(_params(jp), torch.from_numpy(np.array(x)), 64,
                         normals=torch.from_numpy(normals),
                         gammas=None if gammas is None else torch.from_numpy(gammas))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="even"):
        tpre.rff_factor(_params(jp), torch.from_numpy(np.array(x)), 33)


def test_woodbury_and_jacobi_applies_match_the_reference(toy):
    # the same factor L through both packages' Woodbury builds: mv, diag_part
    # and M⁻¹r to 1e-4 of scale (fp32 m × m Cholesky; measured ≤ 6e-7)
    t = toy
    l = np.array(jpre.nystrom_factor(t["params"], t["x"], KEY, 32))
    jw = jpre.woodbury_from_factor(jnp.asarray(l), t["params"].noise)
    tw = woodbury_from_factor(torch.from_numpy(l), t["tp"].noise)
    assert isinstance(tw, WoodburyPrecond) and tw.rank == 32 and tw.shape == (t["n"], t["n"])
    r = np.random.default_rng(0).normal(size=(t["n"], 3)).astype(np.float32)
    tr = torch.from_numpy(r)
    for got, want in [(tw.mv(tr), jw.mv(r)), (tw(tr), jw(r)), (tw(tr[:, 0]), jw(r[:, 0])),
                      (tw.diag_part(), jw.diag_part())]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    jj = jpre.jacobi_preconditioner(t["jop"])
    tj = jacobi_preconditioner(t["op"])
    assert isinstance(tj, JacobiPrecond)
    np.testing.assert_allclose(tj(tr).numpy(), np.asarray(jj(r)), rtol=1e-6)
    np.testing.assert_allclose(tj.mv(tr[:, 1]).numpy(), np.asarray(jj.mv(r[:, 1])), rtol=1e-6)


def test_woodbury_precond_is_an_operator(toy):
    # twin of tests/test_operators.py:123: mv is the forward apply, __call__
    # the inverse; M⁻¹M = I to 1e-3 as the reference holds it
    t = toy
    pc = nystrom_preconditioner(t["tp"], t["tx"], 32,
                                idx=torch.from_numpy(_nystrom_idx(KEY, t["n"], 32)))
    m_dense = pc.l @ pc.l.T + pc.sigma2 * torch.eye(t["n"])
    r = torch.from_numpy(np.random.default_rng(1).normal(size=(t["n"], 2)).astype(np.float32))
    np.testing.assert_allclose(pc.mv(r).numpy(), (m_dense @ r).numpy(), atol=1e-3)
    np.testing.assert_allclose(pc(r).numpy(), torch.linalg.solve(m_dense, r).numpy(), atol=1e-3)
    np.testing.assert_allclose(pc(pc.mv(r)).numpy(), r.numpy(), atol=1e-3)


def test_non_positive_definite_factor_gives_nan_not_an_error():
    # jnp.linalg.cholesky's convention: NaN where the factorisation fails
    l = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    w = woodbury_from_factor(l, torch.tensor(-1.0))  # LᵀL − I = 0: not PD
    assert torch.isnan(w.chol).all()
    assert torch.isnan(tpre.cholesky_or_nan(-torch.eye(3))).all()


# ---------------------------------------------------------------------------
# preconditioned CG
# ---------------------------------------------------------------------------

PRECONDS = [Nystrom(rank=100), PivotedCholesky(rank=100), RFF(rank=256), Jacobi()]
JPRECONDS = {"nystrom": jspec.Nystrom(rank=100), "pivoted_cholesky":
             jspec.PivotedCholesky(rank=100), "rff": jspec.RFF(rank=256), "jacobi": jspec.Jacobi()}


@pytest.mark.parametrize("pspec", PRECONDS, ids=lambda p: p.name)
def test_precond_specs_match_reference_counts(toy, pspec):
    # twins of tests/test_solvers.py:92 and tests/test_solver_spec.py:162:
    # no more iterations than unpreconditioned CG, the dense solution to
    # 5e-3, and the count within the gate's 15% of the reference's on the
    # same draws (measured: equal, or one apart)
    t = toy
    plain = solve(t["op"], t["ty"], CG(max_iters=400, tol=1e-6))
    fast = solve(t["op"], t["ty"], CG(max_iters=400, tol=1e-6, precond=pspec),
                 draws=_draws(pspec, KEY, t))
    ref = jspec.solve(t["jop"], t["y"], jspec.CG(max_iters=400, tol=1e-6,
                                                 precond=JPRECONDS[pspec.name]), key=KEY)
    assert fast.converged and fast.healthy
    assert fast.iterations <= plain.iterations
    assert abs(fast.iterations - int(ref.iterations)) <= np.ceil(COUNT_SLACK * int(ref.iterations))
    assert fast.matvecs == fast.iterations
    np.testing.assert_allclose(fast.solution.numpy(), np.asarray(t["v_star"]), atol=SOL_ATOL)


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("name", ["nystrom", "jacobi"])
def test_preconditioned_recursion_matches_step_by_step(toy, name, k):
    # before fp32 rounding is amplified, the k-step preconditioned iterates
    # are the reference's to 1e-4 (the unpreconditioned test's tolerance)
    t = toy
    b = np.concatenate([np.asarray(t["y"])[:, None], np.random.default_rng(0).normal(
        size=(t["n"], 2)).astype(np.float32)], axis=1)
    if name == "nystrom":
        jpc = jpre.nystrom_preconditioner(t["params"], t["x"], KEY, rank=100)
        tpc = nystrom_preconditioner(t["tp"], t["tx"], 100,
                                     idx=torch.from_numpy(_nystrom_idx(KEY, t["n"], 100)))
    else:
        jpc, tpc = jpre.jacobi_preconditioner(t["jop"]), jacobi_preconditioner(t["op"])
    ref = jsolve_cg(t["jop"], jnp.asarray(b), max_iters=k, tol=1e-9, precond=jpc)
    out = solve_cg(t["op"], torch.from_numpy(b), max_iters=k, tol=1e-9, precond=tpc)
    assert out.iterations == int(ref.iterations) == k
    want = np.asarray(ref.solution)
    assert np.linalg.norm(out.solution.numpy() - want) <= 1e-4 * np.linalg.norm(want)


def test_unpreconditioned_cg_is_bitwise_unchanged(toy):
    # precond=None keeps z = r: the same arithmetic as before preconditioning
    # existed, so an identity apply reproduces it bit for bit
    t = toy
    a = solve_cg(t["op"], t["ty"], max_iters=30, tol=1e-9)
    b = solve_cg(t["op"], t["ty"], max_iters=30, tol=1e-9, precond=lambda r: r)
    assert torch.equal(a.solution, b.solution) and a.iterations == b.iterations == 30


def test_precond_draws_default_to_a_seeded_generator(toy):
    # without a generator or draws the Nyström subset comes from seed 0 (the
    # reference's PRNGKey(0) fallback): two solves agree bit for bit
    t = toy
    spec = CG(max_iters=400, tol=1e-6, precond=Nystrom(rank=50))
    a, b = solve(t["op"], t["ty"], spec), solve(t["op"], t["ty"], spec)
    assert torch.equal(a.solution, b.solution)
    g = torch.Generator().manual_seed(7)
    c = solve(t["op"], t["ty"], spec, generator=g)
    assert c.converged


def test_precond_capability_refused_by_matvec_only_ops(toy):
    # twin of tests/test_operators.py:80, on a dense matvec-only operator
    op = DenseOperator(a=torch.from_numpy(np.array(toy["kmat"])))
    with pytest.raises(TypeError, match="precond_factor"):
        solve(op, torch.ones(toy["n"]), CG(max_iters=10, precond=Nystrom(rank=4)))


def test_jacobi_precond_on_gram(toy):
    # twin of tests/test_features.py:364
    t = toy
    pc = jacobi_preconditioner(t["op"])
    r = torch.from_numpy(np.random.default_rng(2).normal(size=(t["n"], 2)).astype(np.float32))
    np.testing.assert_allclose(pc(pc.mv(r)).numpy(), r.numpy(), atol=1e-5)
    np.testing.assert_allclose(pc.diag_part().numpy(), t["op"].diag_part().numpy(), atol=1e-6)
    res = solve(t["op"], t["ty"], CG(max_iters=300, tol=1e-6, precond=Jacobi()))
    np.testing.assert_allclose(res.solution.numpy(), np.asarray(t["v_star"]), atol=SOL_ATOL)


def test_jacobi_precond_on_matvec_only_operator():
    # twin of tests/test_features.py:376 (the reference's operator there is
    # LatentKroneckerOp, not ported): a badly scaled dense SPD operator with
    # no precond_factor; Nystrom raises, Jacobi matches the dense solve
    rng = np.random.default_rng(0)
    g = rng.normal(size=(60, 60))
    s = np.diag(10.0 ** rng.uniform(-2, 2, 60))
    a = (s @ (g @ g.T / 60 + np.eye(60)) @ s).astype(np.float32)
    op = DenseOperator(a=torch.from_numpy(a), sigma2=torch.tensor(0.05))
    b = torch.from_numpy(rng.normal(size=60).astype(np.float32))
    with pytest.raises(TypeError, match="precond_factor"):
        solve(op, b, CG(precond=Nystrom(rank=8)))
    res = solve(op, b, CG(max_iters=300, tol=1e-8, precond=Jacobi()))
    want = np.linalg.solve(a.astype(np.float64) + 0.05 * np.eye(60), b.numpy())
    np.testing.assert_allclose(res.solution.numpy(), want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# RFFGram
# ---------------------------------------------------------------------------


def _rff_gram(n=150, m=256, d=3, seed=4):
    """tests/test_features.py:290's operator in both packages."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, d))
    p = jmake_params("matern32", lengthscale=0.9, signal=1.1, noise=0.25, d=d)
    ff = jmake_ff(p, jax.random.fold_in(key, 1), m, d)
    jop = JRFFGram(x=x, ff=ff, sigma2=p.noise)
    tff = features_from_numpy(np.asarray(ff.omega), np.asarray(ff.phase), np.asarray(ff.signal),
                              device="cpu")
    top = RFFGram(x=torch.from_numpy(np.array(x)), ff=tff, sigma2=torch.tensor(float(p.noise)))
    return top, jop, x


def test_rff_gram_matches_dense_and_the_reference():
    top, jop, _ = _rff_gram()
    dense = top.dense()
    assert top.shape == (150, 150)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(150, 3)).astype(np.float32))
    np.testing.assert_allclose(top.mv(v).numpy(), (dense @ v).numpy(), atol=1e-4)
    np.testing.assert_allclose(top.mv(v).numpy(), np.asarray(jop.mv(v.numpy())), atol=1e-4)
    np.testing.assert_allclose(top.diag_part().numpy(), np.asarray(jop.diag_part()), atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jop.dense()), atol=1e-5)


def test_rff_gram_solve_and_exact_feature_precond():
    # twin of tests/test_features.py:309: RFF() on RFFGram is its own Φ, an
    # exact inverse, so preconditioned CG converges in at most 3 iterations
    top, jop, x = _rff_gram()
    y = torch.sin(torch.from_numpy(np.array(x)).sum(dim=1))
    want = torch.linalg.solve(top.dense().double(), y.double()).float().numpy()
    plain = solve(top, y, CG(max_iters=300, tol=1e-8))
    np.testing.assert_allclose(plain.solution.numpy(), want, atol=1e-3)
    pre = solve(top, y, CG(max_iters=300, tol=1e-8, precond=RFF()))
    np.testing.assert_allclose(pre.solution.numpy(), want, atol=1e-3)
    ref = jspec.solve(jop, jnp.asarray(y.numpy()), jspec.CG(max_iters=300, tol=1e-8,
                                                              precond=jspec.RFF()), key=KEY)
    assert pre.iterations <= 3 < plain.iterations
    assert abs(pre.iterations - int(ref.iterations)) <= 1


def test_rff_gram_refuses_row_specs_and_foreign_factor_methods():
    # twins of tests/test_features.py:323,330
    top, _, _ = _rff_gram()
    assert capabilities(top) == ("precond_factor",)
    ones = torch.ones(top.shape[0])
    with pytest.raises(TypeError, match="rows_mv"):
        solve(top, ones, SGD(num_steps=5), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="nystrom"):
        solve(top, ones, CG(precond=Nystrom(rank=16)))
    solve(top, ones, CG(max_iters=5, precond=RFF()))
    solve(top, ones, CG(max_iters=5, precond=Jacobi()))


def test_rff_precond_spec_on_gram(toy):
    # twin of tests/test_features.py:343
    t = toy
    base = solve(t["op"], t["ty"], CG(max_iters=400, tol=1e-6))
    pre = solve(t["op"], t["ty"], CG(max_iters=400, tol=1e-6, precond=RFF(rank=256)),
                draws=_draws(RFF(rank=256), KEY, t))
    np.testing.assert_allclose(pre.solution.numpy(), np.asarray(t["v_star"]), atol=SOL_ATOL)
    assert pre.iterations < base.iterations
    with pytest.raises(ValueError, match="even"):
        solve(t["op"], t["ty"], CG(precond=RFF(rank=33)))


# ---------------------------------------------------------------------------
# spec JSON (twins of tests/test_solver_spec.py:245-293)
# ---------------------------------------------------------------------------


def test_every_registered_spec_roundtrips_json():
    assert set(registered_solvers()) == {"ap", "cg", "sdd", "sgd"}
    for name in registered_solvers():
        spec = get_solver(name)()
        again = SolverSpec.from_json(spec.to_json())
        assert again == spec and type(again) is type(spec)
    assert set(registered_preconds()) == {"jacobi", "nystrom", "pivoted_cholesky", "rff"}
    for name in registered_preconds():
        cls = get_precond(name)
        fields = {f.name for f in dataclasses.fields(cls)}
        pspec = cls(rank=38) if "rank" in fields else cls()
        again = spec_from_json(pspec.to_json())
        assert again == pspec and type(again) is type(pspec)


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(va):
            _same_fields(va, vb)
        else:
            assert va == vb, f.name


SPEC_PAIRS = [
    (dict(solver="cg", max_iters=123, tol=3e-5, precond=dict(precond="nystrom", rank=17),
          backend="chunked")),
    (dict(solver="cg", precond=dict(precond="pivoted_cholesky", rank=9), stall_window=7)),
    (dict(solver="cg", precond=dict(precond="rff", rank=64))),
    (dict(solver="cg", precond=dict(precond="jacobi"))),
    (dict(solver="sdd", num_steps=77, batch_size=19, step_size_times_n=3.5, backend="dense")),
    (dict(solver="sgd", num_features=50, average_tail=0.25)),
    (dict(solver="ap", block_size=31, tol=1e-3)),
]


@pytest.mark.parametrize("d", SPEC_PAIRS, ids=lambda d: d["solver"])
def test_json_crosses_between_the_packages(d):
    # the reference's JSON loads in the port with equal fields, and back
    jspec_ = jspec.spec_from_dict(d)
    tspec = spec_from_json(jspec.spec_to_json(jspec_))
    _same_fields(tspec, jspec_)
    back = jspec.spec_from_json(spec_to_json(tspec))
    assert back == jspec_
    assert json.loads(spec_to_json(tspec)) == json.loads(jspec.spec_to_json(jspec_))
    assert spec_to_dict(tspec) == jspec.spec_to_dict(jspec_)


def test_spec_json_rejects_runtime_objects_and_bad_tags():
    with pytest.raises(TypeError, match="cannot be serialized"):
        spec_to_json(CG(precond=lambda r: r))
    with pytest.raises(ValueError, match="unknown solver"):
        spec_from_dict({"solver": "cholesky"})
    with pytest.raises(ValueError, match="unknown preconditioner"):
        spec_from_dict({"precond": "ilu"})
    with pytest.raises(ValueError, match="tagged"):
        spec_from_dict({"max_iters": 3})


def test_spec_json_drives_solve(toy):
    t = toy
    spec = spec_from_json('{"solver": "cg", "max_iters": 300, "tol": 1e-6, '
                          '"precond": {"precond": "pivoted_cholesky", "rank": 50}}')
    res = solve(t["op"], t["ty"], spec)
    np.testing.assert_allclose(res.solution.numpy(), np.asarray(t["v_star"]), atol=1e-3)


# ---------------------------------------------------------------------------
# solve_batched / solve_bordered
# ---------------------------------------------------------------------------


def test_solve_batched_matches_the_reference(toy):
    # shared counts within the gate's 15% and per-block results to the
    # reference's within CG's tolerance; zero padding converges at once
    t = toy
    rng = np.random.default_rng(5)
    blocks = [np.asarray(t["y"]), rng.normal(size=(t["n"], 2)).astype(np.float32),
              rng.normal(size=(t["n"], 3)).astype(np.float32)]
    x0 = [None, 0.1 * blocks[1], None]
    spec = dict(max_iters=400, tol=1e-5)
    ref = jspec.solve_batched(t["jop"], [jnp.asarray(b) for b in blocks], jspec.CG(**spec),
                              x0_blocks=[None if e is None else jnp.asarray(e) for e in x0],
                              pad_columns_to=8)
    out = solve_batched(t["op"], [torch.from_numpy(b) for b in blocks], CG(**spec),
                        x0_blocks=[None if e is None else torch.from_numpy(e) for e in x0],
                        pad_columns_to=8)
    assert len(out) == len(ref) == 3
    assert out[0].solution.ndim == 1 and tuple(out[2].solution.shape) == (t["n"], 3)
    for o, r in zip(out, ref):
        assert o.iterations == out[0].iterations and o.matvecs == out[0].matvecs
        assert abs(o.iterations - int(r.iterations)) <= np.ceil(COUNT_SLACK * int(r.iterations))
        assert o.converged == bool(r.converged)
        want = np.asarray(r.solution)
        np.testing.assert_allclose(o.solution.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
        assert tuple(o.flags.shape) == tuple(np.shape(r.flags))
    with pytest.raises(ValueError, match="one entry per block"):
        solve_batched(t["op"], [t["ty"]], "cg", x0_blocks=[None, None])
    assert solve_batched(t["op"], [], "cg") == []


def test_solve_bordered_extends_a_solved_system(toy):
    # the bordered identity against a dense solve of the extended system,
    # and the port against the reference on the same blocks
    t = toy
    n0, k = t["n"] - 5, 5
    x, tx = t["x"], t["tx"]
    jp, tp = t["params"], t["tp"]
    from repro.core.kernels_fn import gram as jgram
    from repro_torch.core import gram as tgram
    rhs = np.stack([np.asarray(t["y"]), np.random.default_rng(6).normal(size=t["n"])], 1)
    rhs = rhs.astype(np.float32)
    old = Gram(x=tx[:n0], params=tp)
    jold = JGram(x=x[:n0], params=jp)
    spec = dict(max_iters=500, tol=1e-6)
    sol_old = solve(old, torch.from_numpy(rhs[:n0]), CG(**spec)).solution
    b_cols, c_new = tgram(tp, tx[:n0], tx[n0:]), tgram(tp, tx[n0:])
    sol, zres = solve_bordered(old, b_cols, c_new, torch.from_numpy(rhs[n0:]), sol_old,
                               CG(**spec))
    dense = np.asarray(t["kmat"], dtype=np.float64)
    want = np.linalg.solve(dense, rhs.astype(np.float64))
    np.testing.assert_allclose(sol.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())
    assert zres.converged and tuple(zres.flags.shape) == (k,)
    jsol, jz = jspec.solve_bordered(jold, jgram(jp, x[:n0], x[n0:]), jgram(jp, x[n0:]),
                                    jnp.asarray(rhs[n0:]), jnp.asarray(sol_old.numpy()),
                                    jspec.CG(**spec))
    np.testing.assert_allclose(sol.numpy(), np.asarray(jsol), rtol=0,
                               atol=1e-3 * np.abs(want).max())
    assert abs(zres.iterations - int(jz.iterations)) <= np.ceil(COUNT_SLACK * int(jz.iterations))
    with pytest.raises(ValueError, match="c_new"):
        solve_bordered(old, b_cols, c_new[:2, :2], torch.from_numpy(rhs[n0:]), sol_old)


# ---------------------------------------------------------------------------
# preconditioned MLL step and the façade
# ---------------------------------------------------------------------------


def test_preconditioned_mll_grad_matches_the_reference(toy):
    # one estimate with CG(precond=Nystrom(...)): the port on the reference's
    # draws (its solve key ks draws the Nyström subset, mll.py:84,100),
    # gradients to 1e-3 relative (tests/test_torch_mll.py's GRAD_RTOL) and
    # iterations within 2
    t = toy
    key = jax.random.PRNGKey(5)
    spec = dict(max_iters=500, tol=1e-6)
    ref = jmll_grad(t["params"], t["x"], t["y"], key,
                    spec=jspec.CG(precond=jspec.Nystrom(rank=60), **spec))
    kp, ke, ks = jax.random.split(key, 3)
    kf, kw = jax.random.split(kp)
    normals, gammas = _spectral_base(kf, "matern32", 512, t["d"])
    draws = MLLDraws(
        noise=torch.from_numpy(np.array(jax.random.normal(ke, (t["n"], 8), jnp.float32))),
        normals=torch.from_numpy(normals), gammas=torch.from_numpy(gammas),
        w=torch.from_numpy(np.array(jax.random.normal(kw, (1024, 8)))),
        precond=precond_draws_from_numpy(idx=_nystrom_idx(ks, t["n"], 60), device="cpu"))
    out = mll_grad(t["tp"], t["tx"], t["ty"], draws=draws,
                   spec=CG(precond=Nystrom(rank=60), **spec))
    for name in ("log_lengthscale", "log_signal", "log_noise"):
        np.testing.assert_allclose(getattr(out.grad, name).numpy(),
                                   np.asarray(getattr(ref.grad, name)), rtol=1e-3, atol=0)
    assert out.solve_info.converged
    assert abs(out.solver_iterations - int(ref.solver_iterations)) <= 2


def test_iterative_gp_takes_a_preconditioned_spec(toy):
    # fit → optimize → predict with Nyström CG; optimize draws one subset and
    # holds it across its warm-started steps, like its other draws
    t = toy
    gp = IterativeGP("matern32", lengthscale=0.8, noise=0.3, device="cpu",
                     spec=CG(max_iters=200, tol=1e-6, precond=Nystrom(rank=50)))
    seen = []
    gp.fit(np.asarray(t["x"]), np.asarray(t["y"])).optimize(
        num_steps=2, lr=0.02, callback=lambda i, st: seen.append(st.last_solve))
    assert len(seen) == 2 and all(s.converged for s in seen)
    mu, var = gp.predict(np.asarray(t["x_test"]), num_samples=16)
    assert mu.shape == (t["x_test"].shape[0],) and bool(torch.isfinite(mu).all())
    assert bool((var >= 0).all())


def test_rff_precond_at_small_noise_slows_cg():
    # the serving path's θ on protein-shaped data (Matérn-3/2, ℓ = 1.5 in 9-D,
    # σ² = 0.01), n = 1,000: RFF(256)'s 128-frequency surrogate ΦΦᵀ + σ²I is
    # a worse preconditioner than none, in the reference as in the port on
    # its draws (counts within the gate's 15%), while Nyström(100) helps
    from repro.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=0)
    n, d = 1000, 9
    x = jnp.asarray(data["x"][:n])
    jp = jmake_params("matern32", lengthscale=1.5, signal=1.0, noise=0.1, d=d)
    jop = JGram(x=x, params=jp)
    op = Gram(x=torch.from_numpy(np.array(x)), params=_params(jp))
    b = np.asarray(data["y"][:n], dtype=np.float32)
    counts = {}
    for name, pspec in (("none", None), ("rff", RFF(rank=256)), ("nystrom", Nystrom(rank=100))):
        t = dict(n=n, d=d, params=jp)
        ref = jspec.solve(jop, jnp.asarray(b), jspec.CG(
            max_iters=1000, tol=1e-3, precond=None if pspec is None else JPRECONDS[pspec.name]),
            key=KEY)
        out = solve(op, torch.from_numpy(b), CG(max_iters=1000, tol=1e-3, precond=pspec),
                    draws=None if pspec is None else _draws(pspec, KEY, t))
        assert out.converged and bool(ref.converged)
        want = int(ref.iterations)
        assert abs(out.iterations - want) <= np.ceil(COUNT_SLACK * want), name
        counts[name] = (out.iterations, want)
    assert all(c > n_ for c, n_ in zip(counts["rff"], counts["none"]))
    assert all(c < n_ for c, n_ in zip(counts["nystrom"], counts["none"]))
