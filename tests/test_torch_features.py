"""The port's cos-only random-feature map, the feature backends' resolution,
``with_backend`` and ``ExactPosterior.sample`` against the JAX reference
(repro.core.rff, repro.kernels.ops, repro.core.gp), with the reference's own
frequencies, phases and normals injected."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.gp import exact_posterior as jexact_posterior
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.operators import RFFGram as JRFFGram
from repro.core.rff import make_fourier_features as jmake_fourier_features
from repro.core.rff import sample_prior as jsample_prior
from repro.kernels.ops import resolve_feature_backend as jresolve_feature_backend
from repro_torch.convert import features_from_numpy, params_from_numpy, prior_from_numpy
from repro_torch.core import RFFGram, make_fourier_features, make_params
from repro_torch.core.gp import exact_posterior
from repro_torch.kernels import ops
from repro_torch.kernels.ops import FEATURE_TRACE_COUNTS, resolve_feature_backend

KEY = jax.random.PRNGKey(21)
N, D, M = 75, 3, 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    """Largest entry error relative to the reference's largest entry."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def cos_only():
    """The reference's cos-only map (its ω and uniform phases) and the port's
    on the same draws, with inputs and operands from a numpy seed."""
    jp = jmake_params("matern32", lengthscale=0.9, signal=1.3, d=D)
    jff = jmake_fourier_features(jp, KEY, M, D, paired=False)
    ff = features_from_numpy(np.asarray(jff.omega), np.asarray(jff.phase),
                             np.asarray(jff.signal), paired=False, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=(M, 4)).astype(np.float32)
    u = rng.normal(size=(N, 4)).astype(np.float32)
    return dict(jp=jp, jff=jff, ff=ff, x=x, w=w, u=u)


def test_cos_only_map_matches_reference(cos_only):
    # √(2σ_f²/m)·cos(xΩᵀ + b), m = num_features frequencies: fp32 on both
    # sides, measured 1.1e-7 (features) to 2.3e-7 (the pair) of scale; held
    # at 1e-5
    c = cos_only
    ff, jff = c["ff"], c["jff"]
    x, jx = torch.from_numpy(c["x"]), jnp.asarray(c["x"])
    assert ff.num_features == jff.num_features == M and not ff.paired
    assert ff.shape == (None, M)
    assert _rel(ff.features(x).numpy(), jff.features(jx)) <= 1e-5
    assert _rel(ff.phi_mv(x, torch.from_numpy(c["w"])).numpy(),
                jff.phi_mv(jx, jnp.asarray(c["w"]))) <= 1e-5
    assert _rel(ff.phi_t_mv(x, torch.from_numpy(c["u"])).numpy(),
                jff.phi_t_mv(jx, jnp.asarray(c["u"]))) <= 1e-5
    assert _rel(ff.phi_pair_mv(x, torch.from_numpy(c["u"])).numpy(),
                jff.phi_pair_mv(jx, jnp.asarray(c["u"]))) <= 1e-5


def test_cos_only_map_counts_materialised_features(cos_only):
    # each cos-only matvec materialises Φ: one "features" dispatch (two for
    # the pair, as the reference counts), never a kernel dispatch
    c = cos_only
    ff, x = c["ff"], torch.from_numpy(c["x"])
    ops.reset_feature_trace_counts()
    ff.phi_mv(x, torch.from_numpy(c["w"]))
    ff.phi_t_mv(x, torch.from_numpy(c["u"]))
    ff.phi_pair_mv(x, torch.from_numpy(c["u"]))
    assert FEATURE_TRACE_COUNTS == {"cuda": 0, "features": 4}


def test_rff_gram_diag_of_the_cos_only_map_matches_reference(cos_only):
    # the cos-only map has no closed-form diagonal: Σ_j Φ_ij² from the
    # materialised rows (fp32, measured 2.2e-7 of scale, held at 1e-5)
    c = cos_only
    jop = JRFFGram(x=jnp.asarray(c["x"]), ff=c["jff"], sigma2=jnp.float32(0.04))
    op = RFFGram(x=torch.from_numpy(c["x"]), ff=c["ff"], sigma2=torch.tensor(0.04))
    assert _rel(op.diag_part().numpy(), jop.diag_part()) <= 1e-5


def test_feature_backend_resolution_matches_reference():
    # the reference's table (tests/test_features.py:168-178) with "cuda" in
    # place of "pallas": "auto" is the kernel on the card for the paired map
    # only, the cos-only map materialises, and asking the kernel for it raises
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert jresolve_feature_backend("auto", paired=False) == "features"
    assert resolve_feature_backend("auto", cpu, paired=False) == "features"
    assert resolve_feature_backend("auto", card, paired=False) == "features"
    assert resolve_feature_backend("auto", card) == "cuda"
    assert resolve_feature_backend("auto", cpu) == "features"
    assert resolve_feature_backend("chunked", card, paired=False) == "features"
    assert resolve_feature_backend("dense", cpu) == "features"
    with pytest.raises(ValueError, match="paired"):
        jresolve_feature_backend("pallas", paired=False)
    with pytest.raises(ValueError, match="paired"):
        resolve_feature_backend("cuda", cpu, paired=False)
    with pytest.raises(ValueError, match="backend='cuda'"):
        resolve_feature_backend("pallas", cpu)
    with pytest.raises(ValueError, match="unknown feature backend"):
        resolve_feature_backend("triton", cpu)


def test_cos_only_map_refuses_the_kernel(cos_only):
    # the twin of tests/test_features.py:181: an explicit "cuda" raises on
    # every matvec; "auto" falls back to the materialised features
    c = cos_only
    ff, x = c["ff"], torch.from_numpy(c["x"])
    w = torch.from_numpy(c["w"])
    for call, operand in ((ff.phi_mv, w), (ff.phi_t_mv, torch.from_numpy(c["u"])),
                          (ff.phi_pair_mv, torch.from_numpy(c["u"]))):
        with pytest.raises(ValueError, match="paired"):
            call(x, operand, backend="cuda")
    with pytest.raises(ValueError, match="paired"):
        ff.with_backend("cuda").phi_mv(x, w)
    torch.testing.assert_close(ff.phi_mv(x, w), ff.features(x) @ w, rtol=0, atol=0)


def test_make_fourier_features_cos_only_draws_and_injection():
    # m = num_features frequencies; phases uniform on [0, 2π) from the
    # generator, or injected; one seed gives one map
    p = make_params("se", lengthscale=0.7, d=2, device="cpu")
    a = make_fourier_features(p, 40, 2, paired=False, generator=torch.Generator().manual_seed(4))
    b = make_fourier_features(p, 40, 2, paired=False, generator=torch.Generator().manual_seed(4))
    assert a.omega.shape == (40, 2) and a.num_features == 40 and not a.paired
    assert float(a.phase.min()) >= 0.0 and float(a.phase.max()) < 2 * np.pi
    torch.testing.assert_close(a.phase, b.phase, rtol=0, atol=0)
    phase = torch.linspace(0.0, 1.0, 40)
    c = make_fourier_features(p, 40, 2, paired=False, omega=a.omega, phase=phase)
    assert c.phase is phase and c.omega is a.omega
    paired = make_fourier_features(p, 40, 2, generator=torch.Generator().manual_seed(4))
    assert paired.paired and paired.omega.shape == (20, 2) and paired.num_features == 40
    with pytest.raises(ValueError, match="even"):
        make_fourier_features(p, 41, 2)


def test_with_backend_on_features_and_prior_samples():
    # with_backend returns a copy whose backend every matvec takes: "cuda"
    # on CPU tensors runs the kernel wrapper's plain version and is counted
    # as a "cuda" dispatch; PriorSamples carries the reference's backend
    # field (None: the map's own), which a call's own backend overrides
    jp = jmake_params("se", lengthscale=1.1, signal=0.9, d=3)
    prior = jsample_prior(jp, KEY, 5, 64, 3)
    tp = prior_from_numpy(np.asarray(prior.ff.omega), np.asarray(prior.w),
                          np.asarray(prior.ff.signal), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(30, 3)).astype(np.float32))
    assert tp.backend is None and tp.num_samples == 5
    ff = tp.ff.with_backend("features")
    assert ff.backend == "features" and tp.ff.backend == "auto"
    pc = tp.with_backend("cuda")
    assert pc.backend == "cuda" and pc.ff is tp.ff
    ops.reset_feature_trace_counts()
    out_cuda = pc(x)
    assert FEATURE_TRACE_COUNTS == {"cuda": 1, "features": 0}
    out_auto = tp(x)
    assert FEATURE_TRACE_COUNTS == {"cuda": 1, "features": 1}
    pc.phi_t_mv(x, torch.ones(30, 2), backend="features")
    assert FEATURE_TRACE_COUNTS == {"cuda": 1, "features": 2}
    assert _rel(out_cuda.numpy(), prior(jnp.asarray(x.numpy()))) <= 1e-5
    assert _rel(out_auto.numpy(), prior.with_backend("features")(jnp.asarray(x.numpy()))) <= 1e-5


def test_exact_posterior_sample_on_injected_normals_matches_reference():
    # Eq. 2.9 with the 1e-6 jitter on the reference's own normals: the mean
    # plus the Cholesky factor of the posterior covariance; fp32 on both
    # sides, measured 4.2e-6 of scale, held at 1e-3
    rng = np.random.default_rng(3)
    x = rng.normal(size=(60, 2)).astype(np.float32)
    y = np.sin(2 * x[:, 0]).astype(np.float32)
    xs = rng.normal(size=(15, 2)).astype(np.float32)
    jp = jmake_params("matern52", lengthscale=0.9, signal=1.1, noise=0.2, d=2)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "matern52", device="cpu")
    ref = jexact_posterior(jp, jnp.asarray(x), jnp.asarray(y))
    key = jax.random.PRNGKey(5)
    want = ref.sample(key, jnp.asarray(xs), 7)
    w = np.asarray(jax.random.normal(key, (15, 7)))
    post = exact_posterior(tp, torch.from_numpy(x), torch.from_numpy(y))
    got = post.sample(torch.from_numpy(xs), 7, w=torch.from_numpy(w.copy()))
    assert got.shape == (15, 7)
    assert _rel(got.numpy(), want) <= 1e-3
    drawn = post.sample(torch.from_numpy(xs), 3, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (15, 3) and bool(torch.isfinite(drawn).all())
