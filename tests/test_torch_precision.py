"""The port's bf16 tile precision against the JAX reference's, on the CPU:
each bf16 kernel entry's plain version (the Gram matvec, the row panel and
its pair, Φ̃W, Φ̃ᵀu and the feature pair) against the Pallas kernel in
interpret mode with ``precision="bf16"``, the plain backends (``ops._dot``)
against the reference's chunked/dense/features backends, and the twins of
tests/test_pair_and_precision.py's precision tests at its bounds. The bf16
entries are held within BF16_TOL of max(scale, 1), about one bf16 ulp of a
single panel entry: the kernels' casts are emulated exactly, and what is left
is fp32 summation order, which now and then flips a bf16 rounding (bf16 and
fp32 differ by 4e-3-7e-3 of scale at these shapes)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import make_params as jmake_params
from repro.core.kernels_fn import spectral_sample as jspectral_sample
from repro.core.operators import Gram as JGram
from repro.core.solvers.spec import SGD as JSGD
from repro.core.solvers.spec import solve as jsolve
from repro.kernels import ops as jops
from repro.kernels.gram_matvec import gram_matvec_pallas, gram_rows_pair_pallas
from repro.kernels.rff_matvec import rff_matvec_pallas, rff_pair_pallas, rff_t_matvec_pallas
from repro_torch.convert import params_from_numpy, sgd_draws_from_numpy
from repro_torch.core.operators import Gram
from repro_torch.core.rff import FourierFeatures
from repro_torch.core.solvers import CG, SGD, solve
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import (
    gram_matvec, gram_rows_matvec, gram_rows_pair,
)
from repro_torch.kernels.rff_matvec import rff_matvec, rff_pair, rff_t_matvec

KINDS = ["se", "matern12", "matern32", "matern52"]
#: one bf16 ulp of a single panel entry, of max(scale, 1)
BF16_TOL = 2e-3
#: the reference's bf16-vs-fp32 bounds (tests/test_pair_and_precision.py:164,
#: 174, 209-221)
TRACK_TOL, SOLVE_TOL = 5e-2, 8e-2
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _points(rng, n, d, kind):
    """Normal points, on a 1/8 grid for Matérn-1/2 (bf16-exact, every d²
    exact: its 1 − k ~ √d² would turn a coincident pair's few ulp into a
    flipped bf16 entry)."""
    x = _np(rng, n, d)
    return np.round(x * 8) / 8 if kind == "matern12" else x


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _port_params(jp):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), jp.kind, device="cpu")


def _assert_close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels, precision="bf16"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,s", [(256, 384, 3), (128, 256, 1)])
def test_gram_matvec_bf16_matches_pallas(kind, n, m, s):
    rng = np.random.default_rng(n + m + s)
    x, z, v = _points(rng, n, 3, kind), _points(rng, m, 3, kind), _np(rng, m, s)
    want = gram_matvec_pallas(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v), kind=kind,
                              block_m=128, block_n=128, interpret=True, precision="bf16")
    before = gram_matvec.launches
    got = gram_matvec(_t(x), _t(z), _t(v), kind=kind, precision="bf16")
    assert gram_matvec.launches == before  # the plain version, not a launch
    _assert_close(got.numpy(), want, BF16_TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,p_true,s", [(256, 121, 3), (384, 128, 1)])
def test_gram_rows_pair_bf16_matches_pallas(kind, n, p_true, s):
    # the pair, and its first phase alone (SDD's rows matvec, in the reference
    # the Gram kernel on (x[idx], x))
    rng = np.random.default_rng(n + p_true)
    x = _points(rng, n, 3, kind)
    idx = rng.integers(0, n, size=p_true)
    xi = np.zeros((128, 3), np.float32)
    xi[:p_true] = x[idx]
    look, b = _np(rng, n, s), _np(rng, 128, s)
    err, g = gram_rows_pair_pallas(jnp.asarray(xi), jnp.asarray(x), jnp.asarray(look),
                                   jnp.asarray(b), kind=kind, block_n=128, interpret=True,
                                   p_true=p_true, precision="bf16")
    terr, tg = gram_rows_pair(_t(xi), _t(x), _t(look), _t(b), kind=kind, p_true=p_true,
                              precision="bf16")
    assert (terr[p_true:] == 0).all()
    _assert_close(terr.numpy(), err, BF16_TOL)
    _assert_close(tg.numpy(), g, BF16_TOL)
    rows = gram_matvec_pallas(jnp.asarray(xi), jnp.asarray(x), jnp.asarray(look), kind=kind,
                              block_m=128, block_n=128, interpret=True, precision="bf16")
    got = gram_rows_matvec(_t(xi), _t(x), _t(look), kind=kind, precision="bf16")
    _assert_close(got.numpy()[:p_true], np.asarray(rows)[:p_true], BF16_TOL)


@pytest.mark.parametrize("n,m,s", [(256, 128, 3), (128, 256, 1)])
def test_rff_matvec_and_transpose_bf16_match_pallas(n, m, s):
    rng = np.random.default_rng(n + m)
    x, omega = _np(rng, n, 4), _np(rng, m, 4)
    w, u = _np(rng, 2 * m, s), _np(rng, n, s)
    kw = dict(block_m=128, block_f=128, interpret=True, precision="bf16")
    want = rff_matvec_pallas(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(w), **kw)
    _assert_close(rff_matvec(_t(x), _t(omega), _t(w), precision="bf16").numpy(), want,
                  BF16_TOL)
    want_t = rff_t_matvec_pallas(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(u), **kw)
    _assert_close(rff_t_matvec(_t(x), _t(omega), _t(u), precision="bf16").numpy(), want_t,
                  BF16_TOL)


@pytest.mark.parametrize("n,m,m_true,s", [(256, 128, 128, 3), (128, 128, 100, 2)])
def test_rff_pair_bf16_matches_pallas(n, m, m_true, s):
    # the second phase casts the scaled, masked intermediate, as the kernel's
    rng = np.random.default_rng(n + m_true)
    x, omega, u = _np(rng, n, 4), _np(rng, m, 4), _np(rng, n, s)
    omega[m_true:] = 0.0  # padded frequencies, masked by m_true
    want = rff_pair_pallas(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(u), block_m=128,
                           interpret=True, precision="bf16", m_true=m_true)
    got = rff_pair(_t(x), _t(omega), _t(u), m_true=m_true, precision="bf16")
    _assert_close(got.numpy(), want, BF16_TOL)


# ---------------------------------------------------------------------------
# the ops layer: the port's backends against the reference's, bf16
# ---------------------------------------------------------------------------


def _pair_problem(n=150, d=3, p=24, s=2, seed=0):
    """tests/test_pair_and_precision.py:35-43's problem, as numpy arrays."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, d))
    idx = jax.random.randint(jax.random.fold_in(key, 1), (p,), 0, n)
    look = jax.random.normal(jax.random.fold_in(key, 2), (n, s))
    b = jax.random.normal(jax.random.fold_in(key, 3), (p, s))
    jp = jmake_params("matern32", lengthscale=0.9, signal=1.3, d=d, noise=0.1)
    return jp, x, idx, look, b


@pytest.mark.parametrize("backend,jbackend", [("chunked", "chunked"), ("dense", "chunked"),
                                              ("cuda", "pallas")])
def test_row_panel_backends_match_the_reference_in_bf16(backend, jbackend):
    # the rows matvec, its transpose and the pair: the plain backends cast the
    # fp32 panel's contractions (the reference's ops._dot), the cuda backend
    # (the kernels' plain versions on CPU tensors) casts as the kernels do
    jp, x, idx, look, b = _pair_problem()
    tp, tx, tidx = _port_params(jp), _t(x), torch.from_numpy(np.asarray(idx))
    kw = dict(precision="bf16")
    jkw = dict(precision="bf16", **(dict(interpret=True) if jbackend == "pallas" else {}))
    err, g = ops.gram_rows_pair(tp, tx, tidx, _t(look), _t(b), backend=backend, **kw)
    jerr, jg = jops.gram_rows_pair(jp, x, idx, look, b, backend=jbackend, **jkw)
    _assert_close(err.numpy(), jerr, BF16_TOL)
    _assert_close(g.numpy(), jg, BF16_TOL)
    mv = ops.gram_rows_matvec(tp, tx, tidx, _t(look), backend=backend, **kw)
    _assert_close(mv.numpy(), jops.gram_rows_matvec(jp, x, idx, look, backend=jbackend, **jkw),
                  BF16_TOL)
    mt = ops.gram_rows_matvec(tp, tx, tidx, _t(b), transpose=True, backend=backend, **kw)
    _assert_close(mt.numpy(), jops.gram_rows_matvec(jp, x, idx, b, transpose=True,
                                                    backend=jbackend, **jkw), BF16_TOL)


@pytest.mark.parametrize("backend,jbackend", [("features", "features"), ("cuda", "pallas")])
def test_feature_backends_match_the_reference_in_bf16(backend, jbackend):
    # Φw, Φᵀu and the pair at σ_f² = 1.2; the features backend casts the
    # materialised features, σ_f² and √(1/m) included (the reference's
    # ops.py:433,459,499); m = 48 pads to the Pallas pair's 128 frequencies
    rng = np.random.default_rng(9)
    x, omega = _np(rng, 130, 4), _np(rng, 48, 4)
    w, u = _np(rng, 96, 3), _np(rng, 130, 3)
    jkw = dict(signal=1.2, backend=jbackend, precision="bf16",
               **(dict(interpret=True) if jbackend == "pallas" else {}))
    kw = dict(signal=1.2, backend=backend, precision="bf16")
    _assert_close(ops.rff_mv(_t(x), _t(omega), _t(w), **kw).numpy(),
                  jops.rff_mv(x, omega, w, **jkw), BF16_TOL)
    _assert_close(ops.rff_t_mv(_t(x), _t(omega), _t(u), **kw).numpy(),
                  jops.rff_t_mv(x, omega, u, **jkw), BF16_TOL)
    _assert_close(ops.rff_pair_mv(_t(x), _t(omega), _t(u), **kw).numpy(),
                  jops.rff_pair_mv(x, omega, u, **jkw), BF16_TOL)


@pytest.mark.parametrize("backend", ["chunked", "dense"])
def test_plain_gram_mv_ignores_precision(backend):
    # the reference's gram_mv on chunked/dense takes no cast (ops.py:199-203)
    jp, x, _, look, _ = _pair_problem()
    tp, tx = _port_params(jp), _t(x)
    fp32 = ops.gram_mv(tp, tx, _t(look), jitter=tp.noise, backend=backend)
    bf16 = ops.gram_mv(tp, tx, _t(look), jitter=tp.noise, backend=backend, precision="bf16")
    assert torch.equal(bf16, fp32)
    _assert_close(bf16.numpy(), jops.gram_mv(jp, x, look, jitter=jp.noise, backend="chunked",
                                             precision="bf16"), 1e-5)


# ---------------------------------------------------------------------------
# twins of tests/test_pair_and_precision.py's precision tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["chunked", "cuda"])
def test_gram_pair_bf16_tracks_fp32(backend):
    # twin of tests/test_pair_and_precision.py:157
    jp, x, idx, look, b = _pair_problem()
    tp, tx, tidx = _port_params(jp), _t(x), torch.from_numpy(np.asarray(idx))
    err32, g32 = ops.gram_rows_pair(tp, tx, tidx, _t(look), _t(b), backend=backend)
    err16, g16 = ops.gram_rows_pair(tp, tx, tidx, _t(look), _t(b), backend=backend,
                                    precision="bf16")
    scale = max(float(g32.abs().max()), 1.0)
    assert float((err16 - err32).abs().max()) <= TRACK_TOL * scale
    assert float((g16 - g32).abs().max()) <= TRACK_TOL * scale
    assert not torch.equal(g16, g32)  # the bf16 tiles did run


@pytest.mark.parametrize("backend", ["features", "cuda"])
def test_rff_pair_bf16_tracks_fp32(backend):
    # twin of tests/test_pair_and_precision.py:168
    key = jax.random.PRNGKey(5)
    x = np.asarray(jax.random.normal(key, (128, 3)))
    omega = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (64, 3)))
    u = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (128, 2)))
    out32 = ops.rff_pair_mv(_t(x), _t(omega), _t(u), backend=backend)
    out16 = ops.rff_pair_mv(_t(x), _t(omega), _t(u), backend=backend, precision="bf16")
    scale = max(float(out32.abs().max()), 1.0)
    assert float((out16 - out32).abs().max()) <= TRACK_TOL * scale
    assert not torch.equal(out16, out32)


def test_unknown_precision_rejected():
    # twin of tests/test_pair_and_precision.py:179, on every entry
    jp, x, idx, look, b = _pair_problem(n=128, p=16, s=1)
    tp, tx, tidx = _port_params(jp), _t(x), torch.from_numpy(np.asarray(idx))
    with pytest.raises(ValueError, match="precision"):
        ops.gram_rows_pair(tp, tx, tidx, _t(look), _t(b), precision="fp16")
    with pytest.raises(ValueError, match="precision"):
        gram_matvec(tx, tx, _t(look), precision="tf32")
    with pytest.raises(ValueError, match="precision"):
        rff_pair(tx, tx[:8], _t(look), precision="fp16")


def test_fp32_defaults():
    # twin of tests/test_pair_and_precision.py:191
    assert ops.PRECISIONS[0] == "fp32"
    tp = _port_params(jmake_params("se", d=2))
    op = Gram(x=torch.zeros((4, 2)), params=tp)
    assert op.precision == "fp32"
    assert CG().precision is None  # inherits the operator's fp32
    assert SGD().precision is None
    ff = FourierFeatures(omega=torch.zeros((4, 2)), phase=torch.zeros(4),
                         signal=torch.tensor(1.0))
    assert ff.precision == "fp32"


def _sgd_draws(t, key, num_steps, batch, q):
    """The reference's SGD draws (sgd.py): split(fold_in(key, t)) into the
    minibatch key and the feature key."""
    idx, omega = [], []
    for step in range(num_steps):
        ki, kf = jax.random.split(jax.random.fold_in(key, step))
        idx.append(np.asarray(jax.random.randint(ki, (batch,), 0, t["n"])))
        omega.append(np.asarray(jspectral_sample(t["params"], kf, q, t["d"])))
    return sgd_draws_from_numpy(np.stack(idx), np.stack(omega), device="cpu")


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_spec_pins_precision_through_solve(toy_regression, backend):
    # twin of tests/test_pair_and_precision.py:200, on the reference's draws:
    # the bf16 solve within the reference's bound of the fp32 one, on the
    # plain route ("auto" on the CPU) and on the kernels' plain versions, and
    # the plain route's bf16 solve within it of the reference's own
    t = toy_regression
    jp = t["params"]
    op = Gram(x=_t(t["x"]), params=_port_params(jp))
    kw = dict(num_steps=150, batch_size=32, num_features=16)
    draws = _sgd_draws(t, KEY, 150, 32, 16)
    res32 = solve(op, _t(t["y"]), SGD(backend=backend, **kw), draws=draws)
    res16 = solve(op, _t(t["y"]), SGD(backend=backend, precision="bf16", **kw), draws=draws)
    scale = max(float(res32.solution.abs().max()), 1.0)
    assert float((res16.solution - res32.solution).abs().max()) <= SOLVE_TOL * scale
    assert not torch.equal(res16.solution, res32.solution)
    if backend == "auto":
        jop = JGram(x=t["x"], params=jp)
        ref16 = jsolve(jop, t["y"], JSGD(precision="bf16", **kw), key=KEY)
        _assert_close(res16.solution.numpy(), ref16.solution, SOLVE_TOL)
    with pytest.raises(ValueError, match="precision"):
        solve(op, _t(t["y"]), CG(precision="tf32"))


def test_spec_precision_serializes():
    # twin of tests/test_pair_and_precision.py:221
    spec = SGD(num_steps=10, precision="bf16")
    assert SGD.from_json(spec.to_json()) == spec
    assert dataclasses.replace(spec, precision=None).precision is None


def test_ap_bf16_drift_is_the_reference_s():
    # AP solves each block exactly in fp32 and updates the residual through
    # the bf16 contraction, so its bf16 iterate drifts from its fp32 one: 4.3e-2
    # of scale in 100 steps here, in the reference's own route, and past
    # SOLVE_TOL at protein's n (test_ap_bf16_reference_gap_at_protein_n). On
    # the reference's blocks the port's plain route gives the reference's bf16
    # iterate (3.4e-3 of its scale, within 5 × BF16_TOL: 100 steps carry the
    # summation order's flips), and the kernel route's plain versions drift no
    # further than 1.5 × the reference's gap (chip_smoke.py's bf16 route
    # parity holds the card's kernels to the same multiple)
    from repro.core.solvers.spec import AP as JAP
    from repro_torch.convert import row_draws_from_numpy
    from repro_torch.core.solvers import AP
    from repro_torch.data.pipeline import regression_dataset

    n, steps, block = 2000, 100, 256
    data = regression_dataset(n, d=9, seed=0)
    b = np.concatenate([data["y"][:, None],
                        0.3 * _np(np.random.default_rng(0), n, 8)], axis=1)
    jp = jmake_params("matern32", lengthscale=1.5, signal=1.0, noise=0.1, d=9)
    key = jax.random.PRNGKey(1)
    blocks = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, t), (block,), 0, n))
                       for t in range(steps)])
    jop = JGram(x=jnp.asarray(data["x"]), params=jp)
    ref = {p: np.asarray(jsolve(jop, jnp.asarray(b), JAP(num_steps=steps, block_size=block,
                                                         precision=p), key=key).solution)
           for p in ("fp32", "bf16")}
    op = Gram(x=_t(data["x"]), params=_port_params(jp))
    draws = row_draws_from_numpy(blocks, device="cpu")

    def run(backend, precision):
        return solve(op, _t(b), AP(num_steps=steps, block_size=block, backend=backend,
                                   precision=precision), draws=draws).solution.numpy()

    def gap(a, r):
        return float(np.abs(a - r).max()) / max(1.0, float(np.abs(r).max()))

    ref_gap = gap(ref["bf16"], ref["fp32"])
    assert ref_gap > 1e-2  # the drift is real, and the reference's
    plain16 = run("chunked", "bf16")
    _assert_close(plain16, ref["bf16"], 5 * BF16_TOL)
    assert gap(run("cuda", "bf16"), run("cuda", "fp32")) <= 1.5 * ref_gap


def test_ap_bf16_reference_gap_at_protein_n():
    # The JAX package's own AP, 200 steps (PARITY_STEPS) in bf16 and in fp32
    # on the same blocks of 512, at chip_smoke.py's route-parity problem:
    # protein's n = 45,730, Matérn-3/2 at ℓ = √d/2, σ_f² = 1, σ² = 0.1, and
    # pathwise targets from 64 prior draws on 2,048 features (the
    # reference's own draws). Its bf16-vs-fp32 gap of max(1, scale) is the
    # constant AP_REF_GAP that chip_smoke.py holds the card's bf16 AP to
    # (within AP_REF_RATIO × it): measured 0.2343, past SOLVE_TOL.
    import re
    from pathlib import Path

    from repro.core.pathwise import pathwise_targets as jpathwise_targets
    from repro.core.rff import sample_prior as jsample_prior
    from repro.core.solvers.spec import AP as JAP
    from repro.data.pipeline import regression_dataset

    text = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    ref_gap = float(re.search(r"^AP_REF_GAP, AP_REF_RATIO = ([0-9.]+),", text, re.M).group(1))
    steps = int(re.search(r"^PARITY_STEPS, [^=]*= (\d+),", text, re.M).group(1))
    data = regression_dataset("protein", seed=0)
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    d = x.shape[1]
    jp = jmake_params("matern32", lengthscale=float(np.sqrt(d) * 0.5), signal=1.0, noise=0.1,
                      d=d)
    jop = JGram(x=x, params=jp)
    key = jax.random.PRNGKey(0)
    prior = jsample_prior(jp, jax.random.fold_in(key, 0), 64, 2048, d)
    b, delta = jpathwise_targets(jop, y, prior, jax.random.fold_in(key, 1))
    sol = {p: np.asarray(jsolve(jop, b, JAP(num_steps=steps, block_size=512, precision=p),
                                key=jax.random.fold_in(key, 2), delta=delta).solution)
           for p in ("fp32", "bf16")}
    gap = float(np.abs(sol["bf16"] - sol["fp32"]).max()) / max(1.0, float(np.abs(sol["fp32"]).max()))
    print(f"the reference's AP bf16-vs-fp32 gap at n = {x.shape[0]}, {steps} steps: {gap}")
    assert x.shape[0] == 45_730 and b.shape[1] == 65 and steps == 200
    assert gap > SOLVE_TOL
    assert abs(gap - ref_gap) <= 0.02 * ref_gap
