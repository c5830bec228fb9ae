"""The port's matvec backends (repro_torch.kernels.ops) against the JAX
reference's Pallas kernels (interpret mode) and chunked backend, on the CPU.
The CUDA kernels themselves are held against their plain versions on the card
in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import kernels_fn as jkf
from repro.kernels import ops as jops
from repro.kernels.gram_matvec import gram_matvec_bwd_pallas
from repro_torch.convert import params_from_numpy
from repro_torch.core.kernels_fn import map_params
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import _GramMatvecFn, gram_matvec, gram_matvec_bwd
from repro_torch.kernels.ref import gram_matvec_bwd_ref, gram_matvec_ref, rff_matvec_ref
from repro_torch.kernels.rff_matvec import rff_matvec

KINDS = ["se", "matern12", "matern32", "matern52"]

#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57):
#: fused vs dense Gram matvec 2e-4, fused vs materialised RFF matvec 1e-4
GRAM_TOL = 2e-4
RFF_TOL = 1e-4
#: the reference's fused-vs-dense gradient tolerance (test_kernels_pallas.py:
#: 131-134), as max|Δ| ≤ tol·max|ref| per gradient
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kind, d, lengthscale=0.8, signal=1.4, noise=0.3):
    jp = jkf.make_params(kind, lengthscale=lengthscale, signal=signal, noise=noise, d=d)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), kind, device="cpu")
    return jp, tp


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 17])
@pytest.mark.parametrize("shape", ["square", "cross"])
def test_gram_mv_matches_jax_pallas_and_chunked(kind, s, shape):
    n, m, d = 96, (96 if shape == "square" else 80), 4
    x, v = _normal(n + s, n, d), _normal(m + s, m, s)
    z = None if shape == "square" else _normal(m, m, d)
    if z is None:
        # Points on a 1/8 grid make d² = 2‖x‖² − 2x·x exactly 0 in fp32 on the
        # diagonal whatever the summation order; with arbitrary points the
        # rounding of that 0 differs between backends, and Matérn-1/2 turns it
        # into ~1e-3 (test_matern12_diagonal_wobble_square below).
        x = np.round(x * 8) / 8
    jp, tp = _params(kind, d)
    jz = None if z is None else jnp.asarray(z)
    jit = jp.noise if z is None else None
    j_pallas = np.asarray(jops.gram_matvec(jp, jnp.asarray(x), jnp.asarray(v), z=jz,
                                           jitter=jit, block=64, interpret=True))
    j_chunked = np.asarray(jops.gram_mv(jp, jnp.asarray(x), jnp.asarray(v), z=jz,
                                        jitter=jit, backend="chunked"))
    tz = None if z is None else torch.from_numpy(z)
    tit = tp.noise if z is None else None
    for backend in ("chunked", "dense", "cuda"):  # "cuda" on CPU: the plain version
        out = ops.gram_mv(tp, torch.from_numpy(x), torch.from_numpy(v), z=tz,
                          jitter=tit, backend=backend).numpy()
        np.testing.assert_allclose(out, j_pallas, rtol=GRAM_TOL, atol=GRAM_TOL)
        np.testing.assert_allclose(out, j_chunked, rtol=GRAM_TOL, atol=GRAM_TOL)


def test_matern12_diagonal_wobble_square():
    # Arbitrary points: d² on the diagonal is 0 only up to a few ulp of ‖x‖²,
    # rounded differently by each backend, and Matérn-1/2 maps d² ≈ 1e-6 to
    # 1 − k ≈ 1e-3 — the reference's own Pallas and chunked backends differ by
    # ~5e-3 here. The bound is that diagonal term: 3e-3·σ_f²·max|v|, with
    # 3e-3 the reference's diagonal tolerance (tests/test_kernels_fn.py).
    x, v = _normal(97, 96, 4), _normal(98, 96, 1)
    jp, tp = _params("matern12", 4)
    ref = np.asarray(jops.gram_mv(jp, jnp.asarray(x), jnp.asarray(v), jitter=jp.noise,
                                  backend="chunked"))
    out = ops.gram_mv(tp, torch.from_numpy(x), torch.from_numpy(v), jitter=tp.noise).numpy()
    bound = 3e-3 * float(tp.signal) * np.abs(v).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=bound)


def test_gram_mv_vector_rhs_and_counts():
    x, v = _normal(0, 50, 2), _normal(1, 50)
    jp, tp = _params("matern32", 2)
    ops.reset_matvec_trace_counts()
    out = ops.gram_mv(tp, torch.from_numpy(x), torch.from_numpy(v), jitter=tp.noise)
    ref = np.asarray(jops.gram_mv(jp, jnp.asarray(x), jnp.asarray(v), jitter=jp.noise,
                                  backend="chunked"))
    assert out.shape == (50,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=GRAM_TOL, atol=GRAM_TOL)
    # auto on CPU tensors is the chunked backend
    assert ops.MATVEC_TRACE_COUNTS == {"cuda": 0, "chunked": 1, "dense": 0}


@pytest.mark.parametrize("n,f,s", [(64, 64, 1), (100, 90, 2), (130, 70, 16)])
def test_rff_mv_matches_jax_pallas(n, f, s):
    x, omega, w = _normal(n, n, 3), _normal(f, f, 3), _normal(s, 2 * f, s)
    ref = np.asarray(jops.rff_matvec(jnp.asarray(x), jnp.asarray(omega), jnp.asarray(w),
                                     signal=1.3, block=64, interpret=True))
    for backend in ("features", "cuda", "chunked"):  # chunked coerces to features
        out = ops.rff_mv(torch.from_numpy(x), torch.from_numpy(omega),
                         torch.from_numpy(w), signal=1.3, backend=backend).numpy()
        np.testing.assert_allclose(out, ref, rtol=RFF_TOL, atol=RFF_TOL)


def test_backend_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_backend("auto", "se", cpu) == "chunked"
    assert ops.resolve_backend("auto", "se", cuda) == "cuda"
    assert ops.resolve_backend("auto", "tanimoto", cuda) == "chunked"
    with pytest.raises(ValueError, match="not supported by the fused CUDA"):
        ops.resolve_backend("cuda", "tanimoto", cuda)
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.resolve_backend("pallas", "se", cuda)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("triton", "se", cpu)
    assert ops.resolve_feature_backend("auto", cpu) == "features"
    assert ops.resolve_feature_backend("auto", cuda) == "cuda"
    assert ops.resolve_feature_backend("dense", cuda) == "features"
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.resolve_feature_backend("pallas", cpu)


def test_bf16_is_not_ported_yet():
    # the bf16 branches are ported: the bf16 forward runs on every backend,
    # the backward of a bf16 kernel forward runs at bf16 (within the
    # reference's bf16-vs-fp32 bound of the fp32 gradient,
    # tests/test_pair_and_precision.py:164) and bf16 flash inputs give a
    # bf16 output; only an unknown precision raises
    _, tp = _params("se", 2)
    x = torch.from_numpy(_normal(0, 12, 2))
    v = torch.from_numpy(_normal(1, 12, 3))
    for backend in ("cuda", "chunked", "dense"):
        out = ops.gram_mv(tp, x, v, backend=backend, precision="bf16")
        assert out.shape == (12, 3) and bool(torch.isfinite(out).all())
    grads = {}
    for precision in ("bf16", "fp32"):
        xg = x.clone().requires_grad_()
        ops.gram_mv(tp, xg, v, backend="cuda", precision=precision).sum().backward()
        grads[precision] = xg.grad
    assert bool(torch.isfinite(grads["bf16"]).all())
    scale = max(1.0, float(grads["fp32"].abs().max()))
    assert float((grads["bf16"] - grads["fp32"]).abs().max()) <= 5e-2 * scale
    q = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    assert ops.flash_attention(q, q, q).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        ops.gram_mv(tp, x, torch.ones(12), precision="fp16")


def test_wrappers_take_the_plain_version_on_cpu():
    x, z, v = (torch.from_numpy(_normal(i, *sh)) for i, sh in
               enumerate([(30, 3), (20, 3), (20, 5)]))
    before = (gram_matvec.launches, rff_matvec.launches)
    out = gram_matvec(x, z, v, kind="matern52")
    np.testing.assert_array_equal(out.numpy(),
                                  gram_matvec_ref(x, z, v, kind="matern52").numpy())
    w = torch.from_numpy(_normal(9, 40, 5))
    np.testing.assert_array_equal(rff_matvec(x, z, w).numpy(),
                                  rff_matvec_ref(x, z, w).numpy())
    assert (gram_matvec.launches, rff_matvec.launches) == before
    with pytest.raises(ValueError, match="no fused covariance map"):
        gram_matvec(x, z, v, kind="tanimoto")


# ---------------------------------------------------------------------------
# The backward: gram_matvec_bwd's plain version and the autograd Function
# ---------------------------------------------------------------------------


def _grid(seed, *shape):
    """Normal points rounded to a 1/8 grid: every d² is exact in fp32, so the
    distance identity of the reference and the differences of the plain
    version agree on which pairs coincide, whatever the summation order."""
    return np.round(_normal(seed, *shape) * 8) / 8


def _rel_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("shape", ["square", "cross"])
def test_gram_matvec_bwd_ref_matches_jax_pallas(kind, s, shape):
    n, m, d = 128, (128 if shape == "square" else 64), 3
    x = _grid(n + s, n, d)
    z = x if shape == "square" else _grid(m + s, m, d)
    rowv, colv = _normal(1, n, s), _normal(2, m, s)
    ref = np.asarray(gram_matvec_bwd_pallas(
        *(jnp.asarray(a) for a in (x, z, rowv, colv)), kind=kind, block_m=64,
        block_n=64, interpret=True))
    tx, tz, tr, tc = (torch.from_numpy(a) for a in (x, z, rowv, colv))
    out = gram_matvec_bwd_ref(tx, tz, tr, tc, kind=kind, row_chunk=48)
    assert _rel_max(out.numpy(), ref) <= GRAD_TOL
    # the wrapper takes the plain version on CPU tensors and launches nothing
    before = gram_matvec_bwd.launches
    torch.testing.assert_close(gram_matvec_bwd(tx, tz, tr, tc, kind=kind),
                               gram_matvec_bwd_ref(tx, tz, tr, tc, kind=kind))
    assert gram_matvec_bwd.launches == before


def _grad_params(tp):
    return map_params(lambda t: t.clone().requires_grad_(), tp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m", [(96, 96), (96, 130)])
def test_gram_vjp_matches_jax_pallas_grad(kind, n, m):
    """∂/∂{log ℓ, log σ_f, x, z, v} of uᵀ(σ_f²K̃)v through the port's "cuda"
    backend on CPU tensors (the Function with the plain versions) against
    jax.grad through the reference's Pallas backend — the twin of
    tests/test_kernels_pallas.py:114."""
    x, z = _grid(n, n, 3), _grid(m + 1, m, 3)
    v, u = _normal(2, m, 4), _normal(3, n, 4)
    jp, tp = _params(kind, 3, lengthscale=0.9, signal=1.3)

    def fused(p, x, z, v):
        return jnp.sum(u * jops.gram_mv(p, x, v, z=z, backend="pallas", block=64,
                                        interpret=True))

    jg = jax.grad(fused, argnums=(0, 1, 2, 3))(jp, *(jnp.asarray(a) for a in (x, z, v)))
    p = _grad_params(tp)
    tx, tz, tv = (torch.from_numpy(a).requires_grad_() for a in (x, z, v))
    out = torch.sum(torch.from_numpy(u) * ops.gram_mv(p, tx, tv, z=tz, backend="cuda"))
    tg = torch.autograd.grad(out, [p.log_lengthscale, p.log_signal, tx, tz, tv])
    assert _rel_max(tg[0], jg[0].log_lengthscale) <= GRAD_TOL
    assert _rel_max(tg[1], jg[0].log_signal) <= GRAD_TOL
    for a, b in zip(tg[2:], jg[1:]):
        assert _rel_max(a, b) <= GRAD_TOL


@pytest.mark.parametrize("kind", KINDS)
def test_gram_vjp_symmetric_matches_jax_pallas_grad(kind):
    """z = None (K(X, X), x passed as both operands, so dx and dz add up) —
    the twin of tests/test_kernels_pallas.py:138, with Matérn-1/2 too on
    grid points."""
    x, v, u = _grid(5, 100, 3), _normal(1, 100, 2), _normal(2, 100, 2)
    jp, tp = _params(kind, 3, lengthscale=1.1, signal=0.8)

    def fused(p, x):
        return jnp.sum(u * jops.gram_mv(p, x, v, backend="pallas", block=64,
                                        interpret=True))

    jg = jax.grad(fused, argnums=(0, 1))(jp, jnp.asarray(x))
    p = _grad_params(tp)
    tx = torch.from_numpy(x).requires_grad_()
    out = torch.sum(torch.from_numpy(u) * ops.gram_mv(p, tx, torch.from_numpy(v),
                                                      backend="cuda"))
    g_ls, g_x = torch.autograd.grad(out, [p.log_lengthscale, tx])
    assert _rel_max(g_ls, jg[0].log_lengthscale) <= GRAD_TOL
    assert _rel_max(g_x, jg[1]) <= GRAD_TOL


def test_gram_vjp_matern12_diagonal_is_finite():
    """Arbitrary points, z = None: the Function keeps the reference's
    zero-distance mask for Matérn-1/2, so ∂x stays finite and bounded where
    plain autodiff through √(d²+ε) blows up on the diagonal — the twin of
    tests/test_kernels_pallas.py:158."""
    x = torch.from_numpy(_normal(6, 64, 3)).requires_grad_()
    v = torch.from_numpy(_normal(7, 64, 2))
    _, tp = _params("matern12", 3, lengthscale=1.0, signal=1.0)
    (g,) = torch.autograd.grad(ops.gram_mv(tp, x, v, backend="cuda").sum(), [x])
    assert bool(torch.isfinite(g).all())
    assert float(g.abs().max()) < 1e3


def test_gram_vjp_grad_through_jitter():
    """∂/∂{log σ_n, log ℓ} of vᵀ(σ_f²K + σ²I)v flows through the jitter and
    1/ℓ, outside the Function — the twin of tests/test_kernels_pallas.py:174."""
    x, v = _normal(7, 64, 2), _normal(8, 64)
    jp, tp = _params("se", 2, lengthscale=1.0, noise=0.3)

    def fused(p):
        return jnp.sum(v * jops.gram_mv(p, jnp.asarray(x), jnp.asarray(v), jitter=p.noise,
                                        backend="pallas", block=64, interpret=True))

    jg = jax.grad(fused)(jp)
    p = _grad_params(tp)
    tv = torch.from_numpy(v)
    out = torch.sum(tv * ops.gram_mv(p, torch.from_numpy(x), tv, jitter=p.noise,
                                     backend="cuda"))
    g_noise, g_ls = torch.autograd.grad(out, [p.log_noise, p.log_lengthscale])
    np.testing.assert_allclose(g_noise.numpy(), jg.log_noise, rtol=GRAD_TOL)
    np.testing.assert_allclose(g_ls.numpy(), jg.log_lengthscale, rtol=GRAD_TOL)


def test_gram_vjp_runs_only_the_parts_autograd_needs():
    """dx = bwd(x, z, ḡ, v), dz = bwd(z, x, v, ḡ) and dv = fwd(z, x, ḡ), each
    only for an input that requires grad — as the training path's quadratic
    forms, with detached solutions, launch no dv."""
    calls = []

    def fwd(x, z, v, *, kind):
        calls.append(("fwd", x.shape[0], z.shape[0]))
        return gram_matvec_ref(x, z, v, kind=kind)

    def bwd(x, z, rowv, colv, *, kind):
        calls.append(("bwd", x.shape[0], z.shape[0]))
        return gram_matvec_bwd_ref(x, z, rowv, colv, kind=kind)

    x = torch.from_numpy(_normal(1, 30, 3)).requires_grad_()
    z = torch.from_numpy(_normal(2, 20, 3)).requires_grad_()
    v = torch.from_numpy(_normal(3, 20, 2))
    out = _GramMatvecFn.apply(x, z, v, "matern32", fwd, bwd)
    out.sum().backward()
    assert calls == [("fwd", 30, 20), ("bwd", 30, 20), ("bwd", 20, 30)]
    calls.clear()
    v.requires_grad_()
    _GramMatvecFn.apply(x.detach(), z.detach(), v, "matern32", fwd, bwd).sum().backward()
    assert calls == [("fwd", 30, 20), ("fwd", 20, 30)]
    torch.testing.assert_close(v.grad, gram_matvec_ref(z.detach(), x.detach(),
                                                       torch.ones(30, 2), kind="matern32"))
