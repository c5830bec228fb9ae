"""The port's RFF backward (``rff_bwd`` and the VJPs of the three RFF autograd
Functions) against the JAX reference's, on the CPU: ``rff_bwd_ref`` against
``rff_bwd_pallas`` in interpret mode in both orientations, and ∂x, ∂ω and
∂w/∂u of ``rff_matvec``, ``rff_t_matvec`` and ``rff_pair`` (their plain route)
against ``jax.grad`` of ``rff_matvec_fused``, ``rff_t_matvec_fused`` and
``rff_pair_fused`` in interpret mode, with a zero-padded Ω and ``m_true`` for
the transpose and the pair. Tolerances are the reference's own: 1e-4 for the
RFF gradients (tests/test_features.py:87-119), 2e-3 for the pair's
(tests/test_pair_and_precision.py:131-150), as
max|Δ| ≤ tol·max(1, max|ref|)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels.rff_matvec import (
    rff_bwd_pallas, rff_matvec_fused, rff_pair_fused, rff_t_matvec_fused,
)
from repro_torch.kernels import rff_matvec as rff_module
from repro_torch.kernels.ref import rff_bwd_ref, rff_matvec_ref, rff_t_matvec_ref
from repro_torch.kernels.rff_matvec import rff_bwd, rff_matvec, rff_pair, rff_t_matvec

RFF_GRAD_TOL, PAIR_GRAD_TOL = 1e-4, 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _assert_close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# rff_bwd: the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orientation", ["dx", "domega", "general"])
@pytest.mark.parametrize("s", [1, 5])
def test_rff_bwd_ref_matches_pallas(orientation, s):
    # dx: rows are points and P1 = P2 (the cotangent); domega: rows are
    # frequencies and Q1 = Q2; general: four distinct factors. Block-multiple
    # shapes, as the Pallas kernel asserts; ω spread as 1/ℓ at ℓ = 0.3 so the
    # projections reach tens of radians.
    rng = np.random.default_rng(s + len(orientation))
    n, m, d = 256, 128, 3
    x, omega = _np(rng, n, d), _np(rng, m, d, scale=3.3)
    g, w_sin, w_cos = _np(rng, n, s), _np(rng, m, s), _np(rng, m, s)
    if orientation == "dx":
        args, bm, bn = (x, omega, g, g, w_sin, w_cos), 128, 64
    elif orientation == "domega":
        args, bm, bn = (omega, x, w_sin, w_cos, g, g), 64, 128
    else:
        args, bm, bn = (x, omega, g, _np(rng, n, s), w_sin, w_cos), 128, 128
    scale = math.sqrt(1.0 / m)
    want = rff_bwd_pallas(*(jnp.asarray(a) for a in args), scale=scale, block_m=bm,
                          block_n=bn, interpret=True)
    before = rff_bwd.launches
    got = rff_bwd(*(torch.from_numpy(a) for a in args), scale=scale)
    assert rff_bwd.launches == before  # the plain version, not a launch
    _assert_close(got.numpy(), want, RFF_GRAD_TOL)
    # the row chunks of the plain version sum to the same
    chunked = rff_bwd_ref(*(torch.from_numpy(a) for a in args), scale=scale, row_chunk=96)
    _assert_close(chunked.numpy(), got.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# The three RFF Functions' VJPs against jax.grad of the reference's fused cores
# ---------------------------------------------------------------------------


def _torch_grads(fn, args, gbar):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    return [t.numpy() for t in torch.autograd.grad(torch.sum(torch.from_numpy(gbar) * out), ts)]


@pytest.mark.parametrize("s", [1, 3])
def test_rff_matvec_vjp_matches_jax(s):
    rng = np.random.default_rng(s)
    n, m, d = 128, 128, 4
    x, omega, w = _np(rng, n, d), _np(rng, m, d, scale=2.0), _np(rng, 2 * m, s)
    gbar = _np(rng, n, s)

    def jloss(x_, om_, w_):
        return jnp.sum(gbar * rff_matvec_fused(64, 64, True, "fp32", x_, om_, w_))

    want = jax.grad(jloss, argnums=(0, 1, 2))(x, omega, w)
    got = _torch_grads(rff_matvec, (x, omega, w), gbar)
    for a, b in zip(got, want):
        _assert_close(a, b, RFF_GRAD_TOL)


@pytest.mark.parametrize("m_true", [128, 101])
def test_rff_t_matvec_vjp_matches_jax(m_true):
    # the reference's transposed core has no mask: its padded rows are
    # dropped by the caller, which is a zero cotangent on them here
    rng = np.random.default_rng(m_true)
    n, m, d, s = 128, 128, 3, 2
    x, omega, u = _np(rng, n, d), _np(rng, m, d, scale=2.0), _np(rng, n, s)
    omega[m_true:] = 0.0
    gbar = _np(rng, 2 * m, s)
    keep = (np.arange(2 * m) % m < m_true)[:, None]

    def jloss(x_, om_, u_):
        t = rff_t_matvec_fused(64, 64, True, "fp32", x_, om_, u_)
        return jnp.sum(jnp.where(keep, gbar, 0.0) * t)

    want = jax.grad(jloss, argnums=(0, 1, 2))(x, omega, u)
    got = _torch_grads(lambda a, b, c: rff_t_matvec(a, b, c, m_true=m_true),
                       (x, omega, u), gbar)
    for a, b in zip(got, want):
        _assert_close(a, b, RFF_GRAD_TOL)


@pytest.mark.parametrize("m_true", [128, 100])
def test_rff_pair_vjp_matches_jax(m_true):
    rng = np.random.default_rng(m_true + 1)
    n, m, d, s = 256, 128, 3, 2
    x, omega, u = _np(rng, n, d), _np(rng, m, d), _np(rng, n, s)
    omega[m_true:] = 0.0
    gbar = _np(rng, n, s)

    def jloss(x_, om_, u_):
        return jnp.sum(gbar * rff_pair_fused(128, True, "fp32", m_true, x_, om_, u_))

    want = jax.grad(jloss, argnums=(0, 1, 2))(x, omega, u)
    got = _torch_grads(lambda a, b, c: rff_pair(a, b, c, m_true=m_true), (x, omega, u), gbar)
    for a, b in zip(got, want):
        _assert_close(a, b, PAIR_GRAD_TOL)


def test_rff_functions_compute_only_the_cotangents_asked_for():
    # each Function's backward runs the parts autograd needs, and no others:
    # ∂x alone is one rff_bwd call and no transposed matvec (the Thompson
    # ascent's case); spies count the calls of each implementation
    calls = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    ops = {k: spy(k, f) for k, f in rff_module._PLAIN_OPS.items()}
    rng = np.random.default_rng(0)
    x, omega = torch.from_numpy(_np(rng, 40, 3)), torch.from_numpy(_np(rng, 8, 3))
    w, u = torch.from_numpy(_np(rng, 16, 2)), torch.from_numpy(_np(rng, 40, 2))
    cases = [
        (rff_module._RFFMatvecFn, (x, omega, w), (), {"mv": 1, "bwd": 1}),
        (rff_module._RFFTMatvecFn, (x, omega, u), (8,), {"t": 1, "bwd": 1}),
        (rff_module._RFFPairFn, (x, omega, u), (8,), {"pair": 1, "t": 2, "bwd": 1}),
    ]
    for fn, tensors, extra, want in cases:
        for which in range(3):  # one input at a time asks for a gradient
            calls.clear()
            ins = [t.clone().requires_grad_(i == which) for i, t in enumerate(tensors)]
            out = fn.apply(*ins, *extra, ops)
            torch.autograd.grad(out.sum(), [ins[which]])
            if which < 2:
                assert calls == want, (fn.__name__, which, calls)
            else:  # ∂w of Φ̃w is the transpose, ∂u of Φ̃ᵀu the forward, of the pair the pair
                assert "bwd" not in calls, (fn.__name__, calls)


def test_rff_bwd_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    r, c = torch.from_numpy(_np(rng, 30, 2)), torch.from_numpy(_np(rng, 20, 2))
    p, q = torch.from_numpy(_np(rng, 30, 4)), torch.from_numpy(_np(rng, 20, 4))
    before = rff_bwd.launches
    out = rff_bwd(r, c, p, p, q, q, scale=0.5)
    np.testing.assert_array_equal(out.numpy(),
                                  rff_bwd_ref(r, c, p, p, q, q, scale=0.5).numpy())
    assert rff_bwd.launches == before
    # the Functions' forwards on CPU tensors are the plain versions themselves
    w = torch.from_numpy(_np(rng, 40, 3))
    np.testing.assert_array_equal(rff_matvec(r, c, w).numpy(), rff_matvec_ref(r, c, w).numpy())
    np.testing.assert_array_equal(rff_t_matvec(r, c, p[:, :3], m_true=17).numpy(),
                                  rff_t_matvec_ref(r, c, p[:, :3], m_true=17).numpy())
