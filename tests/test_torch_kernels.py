"""The port's matvec backends (repro_torch.kernels.ops) against the JAX
reference's Pallas kernels (interpret mode) and chunked backend, on the CPU.
The CUDA kernels themselves are held against their plain versions on the card
in test_torch_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import kernels_fn as jkf
from repro.kernels import ops as jops
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import gram_matvec
from repro_torch.kernels.ref import gram_matvec_ref, rff_matvec_ref
from repro_torch.kernels.rff_matvec import rff_matvec

KINDS = ["se", "matern12", "matern32", "matern52"]

#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57):
#: fused vs dense Gram matvec 2e-4, fused vs materialised RFF matvec 1e-4
GRAM_TOL = 2e-4
RFF_TOL = 1e-4


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
    _, tp = _params("se", 2)
    x = torch.zeros(4, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        ops.gram_mv(tp, x, torch.ones(4), precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        ops.gram_mv(tp, x, torch.ones(4), precision="fp16")


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
