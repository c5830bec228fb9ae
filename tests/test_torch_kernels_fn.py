"""Parity of the port's covariance functions (repro_torch.core.kernels_fn) with
the JAX reference (repro.core.kernels_fn), on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core import kernels_fn as jkf
from repro_torch.core import kernels_fn as tkf
from repro_torch.convert import params_from_numpy

KINDS = ["se", "matern12", "matern32", "matern52", "tanimoto"]
STATIONARY = KINDS[:4]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(kind, d, lengthscale=0.9, signal=1.3, noise=0.2):
    jp = jkf.make_params(kind, lengthscale=lengthscale, signal=signal, noise=noise, d=d)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), kind, device="cpu")
    return jp, tp


def _inputs(kind, n, m, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "tanimoto":  # binary fingerprints
        return ((rng.random((n, d)) < 0.3).astype(np.float32),
                (rng.random((m, d)) < 0.3).astype(np.float32))
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_gram_cross_matches_jax(kind):
    # Cross Gram on distinct points: every entry is a smooth function of fp32
    # inputs, so the two frameworks agree to fp32 round-off (rtol 1e-5).
    x, z = _inputs(kind, 37, 29, 4, seed=1)
    jp, tp = _params(kind, 4)
    ref = np.asarray(jkf.gram(jp, jnp.asarray(x), jnp.asarray(z)))
    out = tkf.gram(tp, torch.from_numpy(x), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_square_matches_jax(kind):
    # The diagonal of a square Gram is d² = 2‖x‖² − 2x·x, which is 0 up to a
    # few ulp of ‖x‖², and the two frameworks may round it differently. The
    # non-smooth Matérn-1/2 turns d² ≈ 1e-6 into r ≈ 1e-3, so its diagonal is
    # compared at the 3e-3 the reference's own test allows
    # (tests/test_kernels_fn.py::test_gram_symmetric_psd); off the diagonal
    # rtol 1e-5 holds for every kind.
    x, _ = _inputs(kind, 33, 1, 3, seed=2)
    jp, tp = _params(kind, 3)
    ref = np.asarray(jkf.gram(jp, jnp.asarray(x)))
    out = tkf.gram(tp, torch.from_numpy(x)).numpy()
    off = ~np.eye(33, dtype=bool)
    np.testing.assert_allclose(out[off], ref[off], rtol=1e-5, atol=1e-6)
    diag_rtol = 3e-3 if kind == "matern12" else 1e-5
    np.testing.assert_allclose(np.diag(out), np.diag(ref), rtol=diag_rtol)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_diag_matches_jax(kind):
    x, _ = _inputs(kind, 11, 1, 3, seed=3)
    jp, tp = _params(kind, 3)
    np.testing.assert_allclose(tkf.gram_diag(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jkf.gram_diag(jp, jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cross", [False, True])
def test_chunked_matvec_matches_jax(kind, cross):
    # Sums of 45 products of O(1) terms: fp32 round-off stays under 1e-5
    # relative to the largest output; the square case adds the jitter path.
    x, z = _inputs(kind, 45, 45 if not cross else 31, 3, seed=4)
    v = np.random.default_rng(5).normal(size=(x.shape[0] if not cross else 31, 3))
    v = v.astype(np.float32)
    jp, tp = _params(kind, 3)
    jz = jnp.asarray(z) if cross else None
    tz = torch.from_numpy(z) if cross else None
    jit = None if cross else jp.noise
    tit = None if cross else tp.noise
    ref = np.asarray(jkf.matvec(jp, jnp.asarray(x), jnp.asarray(v), z=jz,
                                row_chunk=16, jitter=jit))
    out = tkf.matvec(tp, torch.from_numpy(x), torch.from_numpy(v), z=tz,
                     row_chunk=16, jitter=tit).numpy()
    scale = np.abs(ref).max()
    if kind == "matern12" and not cross:
        # diagonal entries carry the Matérn-1/2 wobble explained above
        np.testing.assert_allclose(out, ref, rtol=0, atol=3e-3 * scale)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)


def test_matvec_vector_rhs_shape():
    x, _ = _inputs("se", 20, 1, 2, seed=6)
    _, tp = _params("se", 2)
    out = tkf.matvec(tp, torch.from_numpy(x), torch.ones(20))
    assert out.shape == (20,)


@pytest.mark.parametrize("kind", STATIONARY)
def test_spectral_sample_injected_matches_jax(kind):
    # With the reference's own normal and Gamma draws injected, the port's
    # formula ω = n/√(g/ν)/ℓ reproduces JAX's frequencies to fp32 round-off.
    m, d = 64, 3
    jp, tp = _params(kind, d, lengthscale=0.7)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jkf.spectral_sample(jp, key, m, d))
    normals = np.array(jax.random.normal(key, (m, d)))
    gammas = None
    if kind != "se":
        nu = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[kind]
        gammas = torch.from_numpy(np.array(
            jax.random.gamma(jax.random.fold_in(key, 1), nu, (m, 1))))
    out = tkf.spectral_sample(tp, m, d, normals=torch.from_numpy(normals),
                              gammas=gammas).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_half_integer_gamma_draws(nu):
    # χ²₂ν/2 ~ Gamma(ν, 1): mean ν, variance ν. 200k draws put the sample
    # mean within 1% and the variance within 3% (≥ 5 standard errors).
    g = torch.Generator().manual_seed(0)
    draws = tkf._gamma_half_integer(nu, 200_000, g, torch.device("cpu")).double()
    assert abs(draws.mean().item() - nu) < 0.01 * nu + 5 * (nu / 2e5) ** 0.5
    assert abs(draws.var().item() - nu) < 0.03 * nu + 0.02


@pytest.mark.parametrize("kind", STATIONARY)
def test_spectral_sample_generator_shape_and_scale(kind):
    # SE frequencies are N(0, 1/ℓ²): sample variance within 3% at 100k draws.
    _, tp = _params(kind, 2, lengthscale=0.5)
    g = torch.Generator().manual_seed(1)
    om = tkf.spectral_sample(tp, 50_000, 2, generator=g)
    assert om.shape == (50_000, 2) and torch.isfinite(om).all()
    if kind == "se":
        assert abs(om.var().item() * 0.25 - 1.0) < 0.03


def test_make_params_needs_a_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkf.make_params("se", d=2)
    assert tkf.make_params("se", d=2, device="cpu").log_lengthscale.shape == (2,)
