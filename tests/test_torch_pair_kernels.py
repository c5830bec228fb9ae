"""The port's row-panel and feature pair kernels (their plain versions and
dispatch) against the JAX reference's, on the CPU: ``gram_rows_pair`` against
``gram_rows_pair_pallas`` (interpret mode) and against the two-call
composition, its VJP against ``jax.grad``, ``rff_t_matvec`` against
``rff_t_matvec_pallas``, ``rff_pair`` with a padded Ω against
``rff_pair_pallas``, and the ``Gram`` row-block capabilities. Tolerances are
the reference's own (tests/test_pair_and_precision.py:62,75,95,116,
tests/test_features.py:75)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import gram as jgram
from repro.core.kernels_fn import make_params as jmake_params
from repro.kernels import ops as jops
from repro.kernels.gram_matvec import gram_rows_pair_fused, gram_rows_pair_pallas
from repro.kernels.rff_matvec import rff_pair_pallas, rff_t_matvec_pallas
from repro_torch.convert import params_from_numpy
from repro_torch.core.operators import (
    Gram, LinearOperator, capabilities, require_capabilities, supports,
)
from repro_torch.core.rff import FourierFeatures
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import gram_rows_matvec, gram_rows_pair
from repro_torch.kernels.rff_matvec import rff_matvec, rff_pair, rff_t_matvec

KINDS = ["se", "matern12", "matern32", "matern52"]
#: tests/test_pair_and_precision.py:62,95,116 and the VJP's :75
PAIR_TOL, PAIR_GRAD_TOL = 3e-4, 2e-3
#: tests/test_features.py:75
RFF_T_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(rng, n, d, kind):
    """Normal points; on a 1/8 grid for Matérn-1/2, where d² is exact in
    fp32 for every formula: its 1 − k(d²) ~ √d² turns the distance identity's
    few ulp on coincident pairs into ~1e-3 (ROADMAP queue 3), and a panel of
    gathered rows holds such pairs."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    return np.round(x * 8) / 8 if kind == "matern12" else x


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _port_params(jp):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), jp.kind, device="cpu")


# ---------------------------------------------------------------------------
# gram_rows_pair: the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,p_true,s", [(256, 121, 3), (384, 128, 1), (128, 17, 2)])
def test_gram_rows_pair_matches_pallas(kind, n, p_true, s):
    # the Pallas kernel takes p padded to 128 rows and masks err rows ≥ p_true
    rng = np.random.default_rng(n + p_true)
    x = _points(rng, n, 3, kind)
    idx = rng.integers(0, n, size=p_true)
    xi = np.zeros((128, 3), np.float32)
    xi[:p_true] = x[idx]
    look, b = _np(rng, n, s), _np(rng, 128, s)
    err, g = gram_rows_pair_pallas(jnp.asarray(xi), jnp.asarray(x), jnp.asarray(look),
                                   jnp.asarray(b), kind=kind, block_n=128,
                                   interpret=True, p_true=p_true)
    before = gram_rows_pair.launches
    terr, tg = gram_rows_pair(_t(xi), _t(x), _t(look), _t(b), kind=kind, p_true=p_true)
    assert gram_rows_pair.launches == before  # the plain version, not a launch
    assert terr.shape == (128, s) and tg.shape == (n, s)
    assert (terr[p_true:] == 0).all()
    np.testing.assert_allclose(terr.numpy(), np.asarray(err), rtol=PAIR_TOL, atol=PAIR_TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=PAIR_TOL, atol=PAIR_TOL)


@pytest.mark.parametrize("backend", ["cuda", "chunked"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,p,s", [(200, 40, 3), (128, 32, 1), (130, 17, 2)])
def test_gram_rows_pair_matches_composition(backend, kind, n, p, s):
    # ops.gram_rows_pair (σ_f² = 1.3 outside the core, σ_f⁴ on g) against the
    # reference's two-call composition on the same panel, and the same for the
    # rows matvec and its transpose; "cuda" on CPU tensors runs the plain
    # versions behind the kernel wrappers. ℓ = 0.5 keeps x/ℓ on the grid.
    rng = np.random.default_rng(n + p)
    x = _points(rng, n, 3, kind)
    idx = rng.integers(0, n, size=p)
    look, b = _np(rng, n, s), _np(rng, p, s)
    jp = jmake_params(kind, lengthscale=0.5, signal=1.3, d=3, noise=0.1)
    panel = jgram(jp, jnp.asarray(x)[idx], jnp.asarray(x))
    err_ref = panel @ look - b
    g_ref = panel.T @ err_ref
    tp = _port_params(jp)
    tidx = torch.from_numpy(idx)
    err, g = ops.gram_rows_pair(tp, _t(x), tidx, _t(look), _t(b), backend=backend)
    assert err.shape == (p, s) and g.shape == (n, s)
    np.testing.assert_allclose(err.numpy(), np.asarray(err_ref), rtol=PAIR_TOL, atol=PAIR_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=PAIR_TOL, atol=PAIR_TOL)
    mv = ops.gram_rows_matvec(tp, _t(x), tidx, _t(look), backend=backend)
    np.testing.assert_allclose(mv.numpy(), np.asarray(panel @ look), rtol=PAIR_TOL,
                               atol=PAIR_TOL)
    tmv = ops.gram_rows_matvec(tp, _t(x), tidx, _t(b), transpose=True, backend=backend)
    np.testing.assert_allclose(tmv.numpy(), np.asarray(panel.T @ b), rtol=PAIR_TOL,
                               atol=PAIR_TOL)


@pytest.mark.parametrize("kind", ["se", "matern32"])
@pytest.mark.parametrize("p_true", [24, 19])
def test_gram_rows_pair_grads_match_jax(kind, p_true):
    # ∂/∂{x, look, b, log ℓ} of Σerr² + Σsin(g) through the pair's autograd
    # Function (plain versions behind it on the CPU) against jax.grad of the
    # Pallas pair's composed VJP, interpret mode; p_true < p masks the
    # padded rows in both
    rng = np.random.default_rng(p_true)
    n, p, s = 150, 24, 2
    x = rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=p)
    look, b = _np(rng, n, s), _np(rng, p, s)
    jp = jmake_params(kind, lengthscale=0.9, signal=1.3, d=3, noise=0.1)

    def jloss(x_, look_, b_, log_ls):
        q = dataclasses.replace(jp, log_lengthscale=log_ls)
        xs = x_ / q.lengthscale
        err, g = gram_rows_pair_fused(kind, 128, True, "fp32", p_true,
                                      jnp.pad(xs[idx], ((0, 128 - p), (0, 0))),
                                      jnp.pad(xs, ((0, 256 - n), (0, 0))),
                                      jnp.pad(look_, ((0, 256 - n), (0, 0))),
                                      jnp.pad(b_, ((0, 128 - p), (0, 0))))
        return jnp.sum(err[:p] ** 2) + jnp.sum(jnp.sin(g[:n]))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(look), jnp.asarray(b), jp.log_lengthscale)
    tx, tl, tb = (_t(a).requires_grad_() for a in (x, look, b))
    tls = _t(np.asarray(jp.log_lengthscale)).requires_grad_()
    xs = tx / torch.exp(tls)
    err, g = gram_rows_pair(xs[torch.from_numpy(idx)], xs, tl, tb, kind=kind,
                            p_true=p_true)
    loss = torch.sum(err ** 2) + torch.sum(torch.sin(g))
    got = torch.autograd.grad(loss, [tx, tl, tb, tls])
    for name, a, w in zip(("x", "look", "b", "log_lengthscale"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=PAIR_GRAD_TOL,
                                   atol=PAIR_GRAD_TOL, err_msg=name)


def test_gram_rows_pair_grads_through_ops_match_jax():
    # the same VJP one layer up: θ-gradients through ops.gram_rows_pair
    # ("cuda" on CPU tensors) against jax.grad through the reference's
    # ops.gram_rows_pair on its Pallas backend, σ_f² included
    rng = np.random.default_rng(3)
    n, p, s = 150, 24, 2
    x = rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=p)
    look, b = _np(rng, n, s), _np(rng, p, s)
    jp = jmake_params("matern32", lengthscale=0.9, signal=1.3, d=3, noise=0.1)

    def jloss(log_ls, log_sig):
        q = dataclasses.replace(jp, log_lengthscale=log_ls, log_signal=log_sig)
        err, g = jops.gram_rows_pair(q, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(look),
                                     jnp.asarray(b), backend="pallas", interpret=True)
        return jnp.sum(err ** 2) + jnp.sum(jnp.sin(g))

    want = jax.grad(jloss, argnums=(0, 1))(jp.log_lengthscale, jp.log_signal)
    tp = _port_params(jp)
    leaves = [tp.log_lengthscale.requires_grad_(), tp.log_signal.requires_grad_()]
    err, g = ops.gram_rows_pair(tp, _t(x), torch.from_numpy(idx), _t(look), _t(b),
                                backend="cuda")
    got = torch.autograd.grad(torch.sum(err ** 2) + torch.sum(torch.sin(g)), leaves)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=PAIR_GRAD_TOL,
                                   atol=PAIR_GRAD_TOL)


# ---------------------------------------------------------------------------
# rff_t_matvec and rff_pair: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,s", [(64, 64, 1), (128, 128, 2), (256, 192, 4)])
def test_rff_t_matvec_matches_pallas(n, m, s):
    rng = np.random.default_rng(n + m)
    x, omega, u = _np(rng, n, 3), _np(rng, m, 3), _np(rng, n, s)
    want = rff_t_matvec_pallas(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(u),
                               block_m=64, block_f=64, interpret=True)
    before = rff_t_matvec.launches
    got = rff_t_matvec(_t(x), _t(omega), _t(u))
    assert rff_t_matvec.launches == before and got.shape == (2 * m, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RFF_T_TOL, atol=RFF_T_TOL)


@pytest.mark.parametrize("n,m_true,s", [(128, 100, 2), (256, 64, 1), (192, 128, 3)])
def test_rff_pair_with_padded_omega_matches_pallas(n, m_true, s):
    # Ω padded with zero frequencies to a multiple of 128: their cos features
    # are 1, and m_true masks their rows of the intermediate in both packages
    rng = np.random.default_rng(n + m_true)
    m = -(-m_true // 128) * 128
    x, u = _np(rng, n, 3), _np(rng, n, s)
    omega = np.zeros((m, 3), np.float32)
    omega[:m_true] = _np(rng, m_true, 3)
    want = rff_pair_pallas(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(u), block_m=64,
                           interpret=True, m_true=m_true)
    before = rff_pair.launches
    got = rff_pair(_t(x), _t(omega), _t(u), m_true=m_true)
    assert rff_pair.launches == before and got.shape == (n, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PAIR_TOL, atol=PAIR_TOL)
    # the transpose's mask is the pair's: its padded rows are exactly 0
    t = rff_t_matvec(_t(x), _t(omega), _t(u), m_true=m_true)
    assert (t[m_true:m] == 0).all() and (t[m + m_true:] == 0).all()


@pytest.mark.parametrize("backend", ["cuda", "features"])
@pytest.mark.parametrize("n,m,s", [(128, 64, 2), (130, 48, 1), (96, 128, 3)])
def test_feature_pair_and_transpose_match_reference(backend, n, m, s):
    # ops.rff_pair_mv / rff_t_mv (σ_f² = 1.2 outside the cores) against the
    # reference's pair on its Pallas backend (interpret mode) and its
    # transpose on materialised features
    rng = np.random.default_rng(n + m)
    x, omega, u = _np(rng, n, 4), _np(rng, m, 4), _np(rng, n, s)
    jx, jo, ju = jnp.asarray(x), jnp.asarray(omega), jnp.asarray(u)
    want_pair = jops.rff_pair_mv(jx, jo, ju, signal=1.2, backend="pallas", interpret=True)
    want_t = jops.rff_t_mv(jx, jo, ju, signal=1.2, backend="features")
    ops.reset_feature_trace_counts()
    got_pair = ops.rff_pair_mv(_t(x), _t(omega), _t(u), signal=1.2, backend=backend)
    got_t = ops.rff_t_mv(_t(x), _t(omega), _t(u), signal=1.2, backend=backend)
    assert ops.FEATURE_TRACE_COUNTS[backend] == 3  # the pair counts as two
    np.testing.assert_allclose(got_pair.numpy(), np.asarray(want_pair), rtol=PAIR_TOL,
                               atol=PAIR_TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RFF_T_TOL,
                               atol=RFF_T_TOL)


def test_phi_t_mv_and_phi_pair_mv_agree_across_backends():
    # FourierFeatures' transpose and pair on both backends, and the pair equals
    # Φ(Φᵀu) (twin of tests/test_features.py:143)
    rng = np.random.default_rng(5)
    ff = FourierFeatures(omega=_t(_np(rng, 64, 3)), phase=torch.zeros(64),
                         signal=torch.tensor(0.9))
    x, v = _t(_np(rng, 75, 3)), _t(_np(rng, 75, 2))
    tc = ff.phi_t_mv(x, v, backend="cuda")
    tf = ff.phi_t_mv(x, v, backend="features")
    torch.testing.assert_close(tc, tf, rtol=RFF_T_TOL, atol=RFF_T_TOL)
    pair = ff.phi_pair_mv(x, v, backend="cuda")
    torch.testing.assert_close(pair, ff.phi_mv(x, tf, backend="features"),
                               rtol=PAIR_TOL, atol=PAIR_TOL)
    # the bf16 pair runs on both backends, within the reference's bf16-vs-fp32
    # bound (tests/test_pair_and_precision.py:164-174), and so does the
    # gradient through its kernel forward, which runs at bf16 too
    scale = max(1.0, float(pair.abs().max()))
    for backend in ("cuda", "features"):
        torch.testing.assert_close(ff.phi_pair_mv(x, v, backend=backend, precision="bf16"),
                                   pair, rtol=0, atol=5e-2 * scale)
    grads = {}
    for precision in ("bf16", "fp32"):
        xg = x.clone().requires_grad_()
        ff.phi_pair_mv(xg, v, backend="cuda", precision=precision).sum().backward()
        grads[precision] = xg.grad
    gscale = max(1.0, float(grads["fp32"].abs().max()))
    torch.testing.assert_close(grads["bf16"], grads["fp32"], rtol=0, atol=5e-2 * gscale)


# ---------------------------------------------------------------------------
# Gram's row-block capabilities
# ---------------------------------------------------------------------------


def test_gram_row_capabilities_match_composition(toy_regression):
    # twin of tests/test_pair_and_precision.py::test_gram_rows_pair_operator_capability
    t = toy_regression
    op = Gram(x=_t(t["x"]), params=_port_params(t["params"]))
    assert supports(op, "rows_mv", "rows_t_mv", "rows_pair_mv", "block_at")
    assert capabilities(op) == ("rows_mv", "rows_t_mv", "rows_pair_mv", "block_at",
                                "precond_factor")
    idx = torch.arange(16)
    look, b = torch.ones((op.n, 2)), torch.zeros((16, 2))
    err, g = op.rows_pair_mv(idx, look, b)
    err_ref = op.rows_mv(idx, look) - b
    g_ref = op.rows_t_mv(idx, err_ref)
    torch.testing.assert_close(err, err_ref, rtol=PAIR_TOL, atol=PAIR_TOL)
    torch.testing.assert_close(g, g_ref, rtol=PAIR_TOL, atol=PAIR_TOL)
    dense = op.dense()
    noise = op.noise * torch.eye(op.n)
    torch.testing.assert_close(op.block_at(idx), (dense - noise)[idx][:, idx],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(op.rows(idx), (dense - noise)[idx], rtol=1e-5, atol=1e-5)
    v = torch.randn(op.n)
    torch.testing.assert_close(op.mv_k(v), op.mv(v) - op.noise * v, rtol=1e-4, atol=1e-4)


def test_row_solvers_refuse_a_matvec_only_operator():
    class MatvecOnly(LinearOperator):
        shape = (4, 4)
        noise = torch.tensor(0.1)

        def mv(self, v):
            return v

        def diag_part(self):
            return torch.ones(4)

    for caps, name in ((("rows_mv",), "sdd"), (("rows_t_mv", "block_at"), "ap"),
                       (("rows_mv", "rows_t_mv", "x", "params"), "sgd")):
        with pytest.raises(TypeError, match=f"solver '{name}' needs operator capabilities"):
            require_capabilities(MatvecOnly(), caps, consumer=f"solver {name!r}")


def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(9)
    x, xi, u = _t(_np(rng, 40, 3)), _t(_np(rng, 7, 3)), _t(_np(rng, 40, 2))
    before = (gram_rows_matvec.launches, gram_rows_pair.launches, rff_t_matvec.launches,
              rff_pair.launches, rff_matvec.launches)
    gram_rows_matvec(xi, x, u, kind="se")
    gram_rows_pair(xi, x, u, torch.zeros(7, 2), kind="se")
    rff_t_matvec(x, xi, u)
    rff_pair(x, xi, u)
    assert (gram_rows_matvec.launches, gram_rows_pair.launches, rff_t_matvec.launches,
            rff_pair.launches, rff_matvec.launches) == before
    with pytest.raises(ValueError, match="m_true"):
        rff_pair(x, xi, u, m_true=8)
    with pytest.raises(ValueError, match="no fused covariance map"):
        gram_rows_pair(xi, x, u, torch.zeros(7, 2), kind="tanimoto")
