"""The port on the card: each CUDA kernel against its plain PyTorch version, and
the fit → predict and MLL-optimisation paths through the kernels against the
same paths on the CPU.

Every test is marked ``gpu`` and skips without a card, deciding inside the
``card`` fixture. This file imports neither JAX nor the reference package, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (
    CG, KernelParams, MLLDraws, make_params, map_params, optimize_mll, posterior_functions,
    sample_prior,
)
from repro_torch.core.mll import draw_mll
from repro_torch.data.pipeline import regression_dataset
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_bwd, plain_gram_matvec
from repro_torch.kernels.ref import gram_matvec_bwd_ref, gram_matvec_ref, rff_matvec_ref
from repro_torch.kernels.rff_matvec import rff_matvec

KINDS = ["se", "matern12", "matern32", "matern52"]
#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57),
#: as max|Δ| ≤ tol·max(1, max|ref|)
GRAM_TOL = 2e-4
RFF_TOL = 1e-4
#: the reference's fused-VJP tolerance (tests/test_kernels_pallas.py:131-134)
GRAD_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False  # an fp32 plain version
    return torch.device("cuda")


def _normal(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(x.astype(np.float32)).cuda()


def _max_err(out, ref64):
    """max|Δ| against the plain version run in float64 on the same fp32 inputs,
    and the tolerance scale. In fp32 the plain version rounds d² on the
    diagonal of K(x, x) to a few ulp instead of 0, which Matérn-1/2 turns into
    ~1e-3: an error of the yardstick, not of the kernel."""
    return (out.double() - ref64).abs().max().item(), max(1.0, ref64.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d,s", [
    (1000, 1000, 9, 1), (1000, 777, 3, 17), (777, 1000, 9, 65),
    (130, 70, 128, 130), (65, 129, 1, 3),
])
def test_gram_kernel_matches_plain_on_card(card, kind, n, m, d, s):
    x = _normal(1, n, d, scale=0.6)
    z = x if n == m else _normal(2, m, d, scale=0.6)
    v = _normal(3, m, s)
    out = gram_matvec(x, z, v, kind=kind)
    err, scale = _max_err(out, gram_matvec_ref(x.double(), z.double(), v.double(), kind=kind))
    assert err <= GRAM_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,d,s", [(1000, 1024, 9, 64), (333, 70, 3, 17), (64, 1, 128, 1)])
def test_rff_kernel_matches_plain_on_card(card, n, f, d, s):
    x, omega, w = _normal(1, n, d), _normal(2, f, d, scale=0.7), _normal(3, 2 * f, s)
    out = rff_matvec(x, omega, w)
    err, scale = _max_err(out, rff_matvec_ref(x.double(), omega.double(), w.double()))
    assert err <= RFF_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d,s", [
    (1000, 1000, 9, 1), (1000, 1000, 9, 8), (1000, 777, 3, 8), (777, 1000, 13, 130),
    (130, 70, 128, 3), (65, 129, 3, 1),
])
def test_gram_bwd_kernel_matches_plain_on_card(card, kind, n, m, d, s):
    # square shapes pass x as z: the kernel's d² on that diagonal is exactly 0,
    # as the plain version's (from differences) is, so Matérn-1/2's mask
    # agrees. Points spread as 1.8/√d, so that d² stays O(1) at every d.
    x = _normal(1, n, d, scale=1.8 / d ** 0.5)
    z = x if n == m else _normal(2, m, d, scale=1.8 / d ** 0.5)
    rowv, colv = _normal(3, n, s), _normal(4, m, s)
    out = gram_matvec_bwd(x, z, rowv, colv, kind=kind)
    ref = gram_matvec_bwd_ref(*(t.double() for t in (x, z, rowv, colv)), kind=kind)
    err, scale = _max_err(out, ref)
    assert err <= GRAD_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_gram_function_gradients_match_plain_on_card(card, kind):
    # dx, dz and dv of uᵀK̃(x, z)v through the kernels against the plain
    # Function in float64, for a cross and the symmetric case
    u = _normal(5, 600, 4)
    for x, z in ((_normal(1, 600, 5), _normal(2, 500, 5)), (_normal(3, 600, 5), None)):
        v = _normal(6, 600 if z is None else z.shape[0], 4)
        got, want = [], []
        for fn, dt, sink in ((gram_matvec, torch.float32, got),
                             (plain_gram_matvec, torch.float64, want)):
            xi = x.to(dt).detach().requires_grad_()
            zi = xi if z is None else z.to(dt).detach().requires_grad_()
            vi = v.to(dt).detach().requires_grad_()
            out = torch.sum(u.to(dt) * fn(xi, zi, vi, kind=kind))
            sink.extend(torch.autograd.grad(out, [xi, vi] if z is None else [xi, zi, vi]))
        for a, b in zip(got, want):
            err, scale = _max_err(a, b)
            assert err <= GRAD_TOL * scale


@pytest.mark.gpu
def test_kernels_count_launches_and_refuse_gradients(card):
    x = _normal(1, 100, 3).requires_grad_()
    v = _normal(2, 100, 2)
    before, before_bwd = gram_matvec.launches, gram_matvec_bwd.launches
    out = gram_matvec(x, x, v, kind="se")
    assert gram_matvec.launches == before + 1
    out.sum().backward()  # dx and dz, no dv: v needs no gradient
    assert (gram_matvec.launches, gram_matvec_bwd.launches) == (before + 1, before_bwd + 2)
    omega, w = _normal(3, 8, 3), _normal(4, 16, 2)
    before = rff_matvec.launches
    out = rff_matvec(x, omega, w)
    assert rff_matvec.launches == before + 1
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 items 3 and 7"):
        out.sum().backward()


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_do_not_take(card):
    x, v = _normal(1, 10, 3), _normal(2, 10, 2)
    with pytest.raises(TypeError, match="float32"):
        gram_matvec(x.double(), x.double(), v.double(), kind="se")
    with pytest.raises(ValueError, match="contiguous"):
        gram_matvec(x, x, _normal(3, 2, 10).T, kind="se")
    with pytest.raises(ValueError, match="one CUDA device"):
        gram_matvec(x, x.cpu(), v, kind="se")
    wide = _normal(4, 10, 129)
    with pytest.raises(ValueError, match="d <= 128"):
        gram_matvec(wide, wide, v, kind="se")
    with pytest.raises(ValueError, match="do not chain"):
        gram_matvec_bwd(x, x, v, _normal(5, 10, 3), kind="se")
    with pytest.raises(ValueError, match="2m rows"):
        rff_matvec(x, _normal(5, 4, 3), _normal(6, 7, 2))


@pytest.mark.gpu
def test_fit_predict_on_card_matches_cpu(card):
    # One problem and one set of draws (made on the CPU) solved on both
    # devices: CG to 1e-5 in fp32 on each, so the posterior mean and the
    # sample variance agree to 1e-3 relative.
    data = regression_dataset(600, d=4, seed=1, n_test=100)
    params = make_params("matern52", lengthscale=0.9, d=4, device="cpu")
    x, y, xt = (torch.from_numpy(data[k]) for k in ("x", "y", "x_test"))
    prior = sample_prior(params, 16, 512, 4, generator=torch.Generator().manual_seed(0))
    eps = 0.3 * torch.randn((600, 16), generator=torch.Generator().manual_seed(1))
    spec = CG(max_iters=500, tol=1e-5)
    on_cpu = posterior_functions(params, x, y, num_samples=16, num_features=512,
                                 spec=spec, omega=prior.ff.omega, w=prior.w, eps=eps)
    gparams = KernelParams(*(t.cuda() for t in (params.log_lengthscale, params.log_signal,
                                                params.log_noise)), kind=params.kind)
    ops.reset_matvec_trace_counts()
    on_card = posterior_functions(gparams, x.cuda(), y.cuda(), num_samples=16,
                                  num_features=512, spec=spec, omega=prior.ff.omega.cuda(),
                                  w=prior.w.cuda(), eps=eps.cuda())
    assert ops.MATVEC_TRACE_COUNTS["cuda"] == on_card.solve_info.iterations
    assert on_card.solve_info.converged
    m_cpu, v_cpu = on_cpu.sample_mean_and_var(xt)
    m_gpu, v_gpu = on_card.sample_mean_and_var(xt.cuda())
    assert float((m_gpu.cpu() - m_cpu).norm() / m_cpu.norm()) <= 1e-3
    assert float((v_gpu.cpu() - v_cpu).norm() / v_cpu.norm()) <= 1e-3


@pytest.mark.gpu
def test_optimize_on_card_matches_cpu(card):
    # Three warm-started MLL steps on one problem and one set of draws (made
    # on the CPU), on both devices: CG to 1e-5 in fp32 on each, so θ after
    # every step agrees to 1e-3 in log space; on the card the gradients go
    # through the backward kernel, four launches per step.
    data = regression_dataset(600, d=4, seed=1, n_test=100)
    params = make_params("matern52", lengthscale=0.9, d=4, device="cpu")
    x, y = (torch.from_numpy(data[k]) for k in ("x", "y"))
    draws = draw_mll("matern52", 600, 4, generator=torch.Generator().manual_seed(0))
    kw = dict(num_steps=3, lr=0.05, spec=CG(max_iters=500, tol=1e-5))
    on_cpu = optimize_mll(params, x, y, draws=draws, **kw)
    before = gram_matvec_bwd.launches
    card_draws = MLLDraws(**{f.name: getattr(draws, f.name).cuda()
                             for f in dataclasses.fields(draws)})
    on_card = optimize_mll(map_params(torch.Tensor.cuda, params), x.cuda(), y.cuda(),
                           draws=card_draws, **kw)
    assert gram_matvec_bwd.launches == before + 4 * 3
    for name in ("log_lengthscale", "log_signal", "log_noise"):
        a, b = getattr(on_card.params, name).cpu(), getattr(on_cpu.params, name)
        assert float((a - b).abs().max()) <= 1e-3
