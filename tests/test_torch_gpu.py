"""The port on the card: each CUDA kernel against its plain PyTorch version, and
the fit → predict, MLL-optimisation, stochastic-solver and Thompson-sampling
paths through the kernels against the same paths on the CPU, LM serving's
kernel route against its plain route, and the serving engine's launches.

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
    CG, KernelParams, MLLDraws, ThompsonDraws, ThompsonState, make_params, map_params,
    optimize_mll, posterior_functions, sample_prior, thompson_step,
)
from repro_torch.core.mll import draw_mll
from repro_torch.data.pipeline import regression_dataset
from repro_torch.kernels import ops
from repro_torch.core.operators import Gram
from repro_torch.core.solvers import AP, SDD, SGD, RowDraws, SGDDraws, solve
from repro_torch.core.solvers.sgd import draw_sgd
from repro_torch.kernels.gram_matvec import (
    gram_matvec, gram_matvec_bwd, gram_rows_matvec, gram_rows_pair, plain_gram_matvec,
    plain_gram_rows_pair,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (
    flash_attention_ref, gram_matvec_bwd_ref, gram_matvec_ref, gram_rows_matvec_ref, gram_rows_pair_ref,
    rff_bwd_ref, rff_matvec_ref, rff_pair_ref, rff_t_matvec_ref,
)
from repro_torch.kernels.rff_matvec import (
    plain_rff_matvec, plain_rff_pair, plain_rff_t_matvec, rff_bwd, rff_matvec, rff_pair,
    rff_t_matvec,
)

KINDS = ["se", "matern12", "matern32", "matern52"]
#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57),
#: as max|Δ| ≤ tol·max(1, max|ref|)
GRAM_TOL = 2e-4
RFF_TOL = 1e-4
#: the reference's fused-VJP tolerance (tests/test_kernels_pallas.py:131-134)
GRAD_TOL = 1e-4
#: the reference's pair tolerances (tests/test_pair_and_precision.py:62,75)
PAIR_TOL, PAIR_GRAD_TOL = 3e-4, 2e-3
#: the reference's fused-vs-features tolerance after 200 SGD steps
#: (tests/test_features.py:283)
ROUTE_TOL = 2e-3


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
    # v padded to multiples of 8 and sliced at 128 columns, every d
    (1000, 1000, 9, 8), (1000, 1000, 9, 9), (999, 1001, 1, 101), (333, 517, 128, 129),
    (1000, 1000, 3, 65),
    # few rows: the chunked plan and its fixed-order sum (ragged n and m)
    (130, 20_000, 9, 17), (400, 20_001, 8, 101), (1, 5000, 3, 1), (70, 3001, 128, 9),
    # many rows against few columns: two row blocks per CTA
    (34_000, 512, 9, 65), (34_001, 300, 3, 1),
])
def test_gram_kernel_matches_plain_on_card(card, kind, n, m, d, s):
    x = _normal(1, n, d, scale=0.6)
    z = x if n == m else _normal(2, m, d, scale=0.6)
    v = _normal(3, m, s)
    out = gram_matvec(x, z, v, kind=kind)
    err, scale = _max_err(out, gram_matvec_ref(x.double(), z.double(), v.double(), kind=kind))
    assert err <= GRAM_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,d,s", [(1000, 9, 128), (200, 3, 65), (1000, 128, 1),
                                   (5000, 9, 129)])
def test_gram_kernel_self_gram_diagonal_is_exactly_one_on_card(card, kind, n, d, s):
    # K(x, x) against one-hot columns: column c of the output is column c of
    # K, so its entry c is k(x_c, x_c) = 1 exactly when d² is exactly 0 (the
    # tensor cores' TF32 split keeps 1·1 exact, and the other entries meet v's
    # zeros), on the one-chunk, the chunked (n = 200) and the sliced (s = 129)
    # plans
    x = _normal(1, n, d, scale=0.6)
    v = torch.zeros((n, s), device="cuda")
    v[torch.arange(s), torch.arange(s)] = 1.0
    out = gram_matvec(x, x, v, kind=kind)
    assert bool((out[torch.arange(s), torch.arange(s)] == 1.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,s", [(45_730, 4096, 9, 65), (400, 50_000, 8, 100),
                                     (45_730, 512, 9, 65)])
def test_gram_kernel_gives_the_same_bits_twice_on_card(card, n, m, d, s):
    # no float atomics: the one-chunk, chunked and row-looped plans each give
    # the same bits on every run
    x, z, v = _normal(1, n, d, scale=0.6), _normal(2, m, d, scale=0.6), _normal(3, m, s)
    first = gram_matvec(x, z, v, kind="matern32")
    assert torch.equal(first, gram_matvec(x, z, v, kind="matern32"))
    assert bool(torch.isfinite(first).all())


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
    # the RFF matvec's ∂w is the transposed kernel, against the plain version,
    # and its ∂x is the RFF backward kernel alone: no gradient is refused,
    # and none is computed that autograd did not ask for
    omega, w = _normal(3, 8, 3), _normal(4, 16, 2).requires_grad_()
    u = _normal(5, 100, 2)
    before, before_t = rff_matvec.launches, rff_t_matvec.launches
    out = rff_matvec(x.detach(), omega, w)
    assert rff_matvec.launches == before + 1
    (dw,) = torch.autograd.grad(torch.sum(u * out), [w])
    assert rff_t_matvec.launches == before_t + 1
    want = rff_t_matvec_ref(x.detach().double(), omega.double(), u.double())
    err, scale = _max_err(dw, want)
    assert err <= RFF_TOL * scale
    before = (rff_t_matvec.launches, rff_bwd.launches)
    (dx,) = torch.autograd.grad(torch.sum(u * rff_matvec(x, omega, w.detach())), [x])
    assert (rff_t_matvec.launches, rff_bwd.launches) == (before[0], before[1] + 1)
    x64 = x.detach().double().requires_grad_()
    (want,) = torch.autograd.grad(torch.sum(u.double() * plain_rff_matvec(
        x64, omega.double(), w.detach().double())), [x64])
    err, scale = _max_err(dx, want)
    assert err <= GRAD_TOL * scale


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
    card_draws = MLLDraws(**{f.name: None if getattr(draws, f.name) is None
                             else getattr(draws, f.name).cuda()
                             for f in dataclasses.fields(draws)})
    on_card = optimize_mll(map_params(torch.Tensor.cuda, params), x.cuda(), y.cuda(),
                           draws=card_draws, **kw)
    assert gram_matvec_bwd.launches == before + 4 * 3
    for name in ("log_lengthscale", "log_signal", "log_noise"):
        a, b = getattr(on_card.params, name).cpu(), getattr(on_cpu.params, name)
        assert float((a - b).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p,p_true,s", [(70, 63, 5), (512, 505, 65), (128, 121, 101),
                                         (1024, 1000, 9), (300, 300, 129)])
def test_gram_rows_kernels_match_plain_on_card(card, kind, p, p_true, s):
    # the row-panel pair and rows matvec against their plain versions in
    # float64, at n over three column chunks, ragged p, one launch each
    n = 3000
    x = _normal(1, n, 3)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, n, size=p)).cuda()
    xi, look, b = x[idx].contiguous(), _normal(3, n, s), _normal(4, p, s)
    before = (gram_rows_pair.launches, gram_rows_matvec.launches)
    err, g = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p_true)
    mv = gram_rows_matvec(xi, x, look, kind=kind)
    assert (gram_rows_pair.launches, gram_rows_matvec.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    want_e, want_g = gram_rows_pair_ref(xi.double(), x.double(), look.double(), b.double(),
                                        kind=kind, p_true=p_true)
    want_mv = gram_rows_matvec_ref(xi.double(), x.double(), look.double(), kind=kind)
    for got, want in ((err, want_e), (g, want_g), (mv, want_mv)):
        e, scale = _max_err(got, want)
        assert e <= GRAM_TOL * scale
    assert bool((err[p_true:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_gram_rows_pair_at_protein_n_matches_plain_on_card(card, kind):
    # SGD's pair at its own shape (p = 512 of n = 45,730, s = 65): phase 0 on
    # 35 column chunks, phase 2 with two row blocks per CTA
    n, p, s = 45_730, 512, 65
    x = _normal(1, n, 9, scale=0.6)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, n, size=p)).cuda()
    xi, look, b = x[idx].contiguous(), _normal(3, n, s), _normal(4, p, s)
    err, g = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p - 7)
    want_e, want_g = gram_rows_pair_ref(xi.double(), x.double(), look.double(), b.double(),
                                        kind=kind, p_true=p - 7)
    for got, want in ((err, want_e), (g, want_g)):
        e, scale = _max_err(got, want)
        assert e <= GRAM_TOL * scale
    again = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p - 7)
    assert torch.equal(again[0], err) and torch.equal(again[1], g)


@pytest.mark.gpu
@pytest.mark.parametrize("m,m_true", [(100, 100), (128, 100), (1024, 1024)])
@pytest.mark.parametrize("s", [1, 65])
def test_rff_t_and_pair_kernels_match_plain_on_card(card, m, m_true, s):
    n = 5000
    x, u = _normal(1, n, 9), _normal(2, n, s)
    omega = _normal(3, m, 9, scale=0.8)
    omega[m_true:] = 0.0  # padded frequencies: cos = 1, masked by m_true
    before = (rff_t_matvec.launches, rff_pair.launches)
    t = rff_t_matvec(x, omega, u, m_true=m_true)
    out = rff_pair(x, omega, u, m_true=m_true)
    assert (rff_t_matvec.launches, rff_pair.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((t, rff_t_matvec_ref(x.double(), omega.double(), u.double(),
                                           m_true=m_true)),
                      (out, rff_pair_ref(x.double(), omega.double(), u.double(),
                                         m_true=m_true))):
        e, scale = _max_err(got, want)
        assert e <= RFF_TOL * scale
    # the pair's ∂u is the pair itself: one more pair launch, no refusal
    ur = u.clone().requires_grad_()
    before = rff_pair.launches
    (du,) = torch.autograd.grad(rff_pair(x, omega, ur, m_true=m_true).sum(), [ur])
    assert rff_pair.launches == before + 2
    e, scale = _max_err(du, rff_pair_ref(x.double(), omega.double(),
                                         torch.ones_like(u).double(), m_true=m_true))
    assert e <= RFF_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,s,m_true", [
    (45_730, 100, 9, 65, 100), (45_730, 100, 9, 65, 93),  # SGD's pair, and padded
    (1001, 77, 5, 33, 70), (4097, 100, 9, 130, 100),  # ragged; two slices
    (400, 512, 8, 100, 512), (63, 1, 3, 1, 1), (3000, 40, 128, 9, 40),
])
def test_rff_kernel_orientations_match_plain_on_card(card, n, m, d, s, m_true):
    # Φ̃W, Φ̃ᵀu and the pair, one kernel in two orientations, against the
    # plain versions in float64: one chunk and several (few rows: frequency
    # chunks of Φ̃W), ragged m (skipped k-steps and m-tiles), ragged s
    x, u, w = _normal(1, n, d, scale=1.5 / d ** 0.5), _normal(2, n, s), _normal(4, 2 * m, s)
    omega = _normal(3, m, d, scale=0.8)
    omega[m_true:] = 0.0
    x64, om64 = x.double(), omega.double()
    for got, want in ((rff_matvec(x, omega, w), rff_matvec_ref(x64, om64, w.double())),
                      (rff_t_matvec(x, omega, u, m_true=m_true),
                       rff_t_matvec_ref(x64, om64, u.double(), m_true=m_true)),
                      (rff_pair(x, omega, u, m_true=m_true),
                       rff_pair_ref(x64, om64, u.double(), m_true=m_true))):
        e, scale = _max_err(got, want)
        assert e <= RFF_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,s", [(45_730, 100, 9, 65), (400, 512, 8, 100)])
def test_rff_kernels_give_the_same_bits_twice_on_card(card, n, m, d, s):
    # no float atomics: the row chunks of Φ̃ᵀu and the frequency chunks of
    # Φ̃W are summed in a fixed order
    x, u, w = _normal(1, n, d), _normal(2, n, s), _normal(4, 2 * m, s)
    omega = _normal(3, m, d, scale=0.8)
    for fn in (lambda: rff_matvec(x, omega, w), lambda: rff_t_matvec(x, omega, u),
               lambda: rff_pair(x, omega, u)):
        first = fn()
        assert torch.equal(first, fn()) and bool(torch.isfinite(first).all())


def _thompson_bwd_operands(kind_seed=0):
    # the Thompson ascent's backward: 400 query rows in [0, 1)^8 against
    # 50,000 observations, ℓ = 0.3, s = 100
    rng = np.random.default_rng(kind_seed)
    xq = torch.from_numpy((rng.random((400, 8)) / 0.3).astype(np.float32)).cuda()
    xs = torch.from_numpy((rng.random((50_000, 8)) / 0.3).astype(np.float32)).cuda()
    return xq, xs, _normal(5, 400, 100), _normal(6, 50_000, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("stage2", ["tc", "fma"])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_bwd_kernel_at_the_thompson_shape_on_card(card, kind, stage2):
    # 7 row blocks cut into gram_bwd_plan's 40 column chunks (280 CTAs),
    # G = rowv·colvᵀ on the tensor cores, both stage-2 variants
    xq, xs, g, v = _thompson_bwd_operands()
    out = gram_matvec_bwd._launch(xq, xs, g, v, kind, stage2)
    ref = gram_matvec_bwd_ref(xq.double(), xs.double(), g.double(), v.double(), kind=kind)
    err, scale = _max_err(out, ref)
    assert err <= GRAD_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("stage2", ["tc", "fma"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d,s", [
    (1000, 1000, 9, 8), (777, 1000, 8, 100), (130, 20_001, 9, 17), (70, 3001, 16, 1),
    (65, 129, 3, 20), (2000, 2000, 12, 128),
])
def test_gram_bwd_stage2_variants_match_plain_on_card(card, kind, stage2, n, m, d, s):
    # square shapes pass x as z, so the self-pairs' raw d² is exactly 0 (the
    # mask's ½, Matérn-1/2's drop); one part and several (chunks), G on the
    # FMA pipe (s ≤ 16) and on the tensor cores
    x = _normal(1, n, d, scale=1.8 / d ** 0.5)
    z = x if n == m else _normal(2, m, d, scale=1.8 / d ** 0.5)
    rowv, colv = _normal(3, n, s), _normal(4, m, s)
    out = gram_matvec_bwd._launch(x, z, rowv, colv, kind, stage2)
    ref = gram_matvec_bwd_ref(*(t.double() for t in (x, z, rowv, colv)), kind=kind)
    err, scale = _max_err(out, ref)
    assert err <= GRAD_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("stage2", ["tc", "fma"])
def test_gram_bwd_kernel_gives_the_same_bits_twice_on_card(card, stage2):
    # no float atomics: one part at training's n, 40 parts at the Thompson
    # shape, each summed in a fixed order
    x = _normal(1, 45_730, 9, scale=0.6)
    g, v = _normal(2, 45_730, 8), _normal(3, 45_730, 8)
    for args in ((x, x, g, v), _thompson_bwd_operands()):
        first = gram_matvec_bwd._launch(*args, "matern32", stage2)
        again = gram_matvec_bwd._launch(*args, "matern32", stage2)
        assert torch.equal(first, again) and bool(torch.isfinite(first).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_gram_rows_pair_grads_match_plain_on_card(card, kind):
    # the pair's VJP through the kernels (rows matvec, Gram forward, Gram
    # backward) against the same Function with the plain versions in float64
    n, p, s = 2000, 70, 3
    x = _normal(1, n, 3)
    idx = torch.from_numpy(np.random.default_rng(4).integers(0, n, size=p)).cuda()
    look, b, cot = _normal(2, n, s), _normal(3, p, s), _normal(5, n, s)
    got, want = [], []
    for dt, sink in ((torch.float32, got), (torch.float64, want)):
        xs = x.to(dt).detach().requires_grad_()
        lk = look.to(dt).detach().requires_grad_()
        bb = b.to(dt).detach().requires_grad_()
        xi = xs[idx]
        if dt == torch.float32:
            err, g = gram_rows_pair(xi.contiguous(), xs, lk, bb, kind=kind, p_true=p - 5)
        else:  # the plain versions behind the same Function: CPU tensors
            err, g = gram_rows_pair(xi.cpu(), xs.cpu(), lk.cpu(), bb.cpu(), kind=kind,
                                    p_true=p - 5)
        loss = torch.sum(err ** 2) + torch.sum(cot.to(dt).to(g.device) * g)
        sink.extend(t.double().cpu() for t in torch.autograd.grad(loss, [xs, lk, bb]))
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= PAIR_GRAD_TOL * max(1.0, float(w.abs().max()))


def _toy_card_problem():
    data = regression_dataset(600, d=4, seed=1, n_test=100)
    params = make_params("matern32", lengthscale=0.9, noise=0.3, d=4, device="cpu")
    x, y = (torch.from_numpy(data[k]) for k in ("x", "y"))
    b = torch.stack([y, torch.randn(600, generator=torch.Generator().manual_seed(3))], 1)
    return params, x, b


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
def test_stochastic_solvers_on_card_match_cpu(card, name):
    # 50 steps on one problem and one set of injected draws (made on the
    # CPU), on both devices; on the card every row panel and feature pair is
    # a kernel launch, and no plain backend is dispatched
    params, x, b = _toy_card_problem()
    op = Gram(x=x, params=params)
    gen = torch.Generator().manual_seed(0)
    if name == "sgd":
        spec = SGD(num_steps=50, batch_size=64, num_features=32)
        draws = draw_sgd(op, 50, 64, 32, generator=gen)
        card_draws = SGDDraws(idx=draws.idx.cuda(), omega=draws.omega.cuda())
    else:
        spec = (SDD(num_steps=50, batch_size=64, step_size_times_n=1.0, averaging=0.05)
                if name == "sdd"
                else AP(num_steps=50, block_size=64))
        draws = RowDraws(idx=torch.randint(0, 600, (50, 64), generator=gen))
        card_draws = RowDraws(idx=draws.idx.cuda())
    on_cpu = solve(op, b, spec, draws=draws)
    gop = Gram(x=x.cuda(), params=map_params(torch.Tensor.cuda, params))
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    before = (gram_rows_pair.launches, gram_rows_matvec.launches, rff_pair.launches,
              gram_matvec.launches)
    on_card = solve(gop, b.cuda(), spec, draws=card_draws)
    launched = tuple(k.launches - b0 for k, b0 in zip(
        (gram_rows_pair, gram_rows_matvec, rff_pair, gram_matvec), before))
    want = {"sgd": (50, 0, 50, 1), "sdd": (0, 50, 0, 1), "ap": (0, 0, 0, 50)}[name]
    assert launched == want
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert ops.FEATURE_TRACE_COUNTS["features"] == 0
    torch.testing.assert_close(on_card.solution.cpu(), on_cpu.solution, rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,d,s", [
    (400, 512, 8, 100), (3000, 100, 9, 130), (100, 3000, 9, 130), (1000, 777, 3, 17),
    (65, 129, 1, 1), (130, 70, 128, 3),
])
def test_rff_bwd_kernel_matches_plain_on_card(card, rows, cols, d, s):
    # both orientations: rows of points against frequencies (dx, with
    # P1 = P2), rows of frequencies against points (dω, with Q1 = Q2), and
    # four distinct factors; s in slices, one and several chunks: one launch
    # of the C entry a call at every s
    r, c = _normal(1, rows, d), _normal(2, cols, d, scale=2.0)
    p1, q1, q2 = _normal(3, rows, s), _normal(4, cols, s), _normal(5, cols, s)
    scale = (1.0 / min(rows, cols)) ** 0.5
    for args in ((r, c, p1, p1, q1, q2), (c, r, q1, q2, p1, p1),
                 (r, c, p1, _normal(6, rows, s), q1, q2)):
        before = rff_bwd.launches
        out = rff_bwd(*args, scale=scale)
        assert rff_bwd.launches == before + 1
        err, sc = _max_err(out, rff_bwd_ref(*(t.double() for t in args), scale=scale))
        assert err <= GRAD_TOL * sc


#: the RFF backward's cases of chip_smoke.py's kernels phase (rows, cols, d,
#: s): the Thompson ascent's dx, protein's dx and dω of the forward VJP and of
#: the SGD pair's VJP
RFF_BWD_CASES = [(400, 512, 8, 100), (45_730, 1024, 9, 65), (1024, 45_730, 9, 65),
                 (45_730, 100, 9, 130), (100, 45_730, 9, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,d,s", RFF_BWD_CASES)
@pytest.mark.parametrize("products", [None, "fma", "tc"])
def test_rff_bwd_kernel_at_the_path_shapes_on_card(card, rows, cols, d, s, products):
    # four distinct factors (P1 != P2, Q1 != Q2), the plan's variant of the
    # factor products and both forced, against the plain version in float64
    # on the first 4,096 output rows; one launch a call
    r, c = _normal(1, rows, d), _normal(2, cols, d, scale=2.0)
    p1, p2 = _normal(3, rows, s), _normal(4, rows, s)
    q1, q2 = _normal(5, cols, s), _normal(6, cols, s)
    scale = (1.0 / min(rows, cols)) ** 0.5
    before = rff_bwd.launches
    out = rff_bwd._launch(r, c, p1, p2, q1, q2, scale, products)
    assert rff_bwd.launches == before + 1
    k = min(rows, 4096)
    want = rff_bwd_ref(r[:k].double(), c.double(), p1[:k].double(), p2[:k].double(),
                       q1.double(), q2.double(), scale=scale)
    err, sc = _max_err(out[:k], want)
    assert err <= GRAD_TOL * sc


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,d,s", [(400, 512, 8, 100), (100, 45_730, 9, 130)])
def test_rff_bwd_kernel_gives_the_same_bits_twice_on_card(card, rows, cols, d, s):
    # several parts (chunks x slices), summed in a fixed order: no atomics
    r, c = _normal(1, rows, d), _normal(2, cols, d, scale=2.0)
    args = (r, c, _normal(3, rows, s), _normal(4, rows, s), _normal(5, cols, s),
            _normal(6, cols, s))
    a = rff_bwd(*args, scale=0.1)
    b = rff_bwd(*args, scale=0.1)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("m,m_true", [(100, 100), (128, 93)])
def test_rff_function_gradients_match_plain_on_card(card, m, m_true):
    # ∂x, ∂ω and ∂w/∂u of the three RFF Functions through the kernels against
    # the plain Functions in float64
    n, s = 3000, 5
    x, omega = _normal(1, n, 9), _normal(2, m, 9, scale=0.8)
    omega[m_true:] = 0.0
    w, u = _normal(3, 2 * m, s), _normal(4, n, s)
    cases = ((rff_matvec, plain_rff_matvec, w, (n, s), {}),
             (rff_t_matvec, plain_rff_t_matvec, u, (2 * m, s), {"m_true": m_true}),
             (rff_pair, plain_rff_pair, u, (n, s), {"m_true": m_true}))
    for seed, (kernel, plain, operand, gshape, kw) in enumerate(cases):
        gbar = _normal(10 + seed, *gshape)
        grads = []
        for fn, dt in ((kernel, torch.float32), (plain, torch.float64)):
            ins = [t.to(dt).detach().requires_grad_() for t in (x, omega, operand)]
            grads.append(torch.autograd.grad(
                torch.sum(gbar.to(dt) * fn(*ins, **kw)), ins))
        for a, b in zip(*grads):
            err, sc = _max_err(a, b)
            assert err <= GRAD_TOL * sc


@pytest.mark.gpu
def test_thompson_step_on_card_matches_cpu(card):
    # one acquisition step on SDD from one set of draws made on the CPU, on
    # both devices: on the card every ascent step is one RFF backward and one
    # Gram backward launch, and no plain backend is dispatched
    gen = torch.Generator().manual_seed(0)
    n, d, acq, steps = 400, 3, 8, 5
    params = make_params("matern32", lengthscale=0.4, noise=0.01, d=d, device="cpu")
    target = sample_prior(params, 1, 512, d, generator=gen)
    x = torch.rand((n, d), generator=gen)
    spec = SDD(num_steps=200, batch_size=32, step_size_times_n=2.0)
    prior = sample_prior(params, acq, 256, d, generator=gen)
    draws = ThompsonDraws(
        omega=prior.ff.omega, w=prior.w, eps=0.1 * torch.randn((n, acq), generator=gen),
        uniform=torch.rand((7, d), generator=gen),
        pick=torch.randint(0, n, (57,), generator=gen),
        perturb=torch.randn((57, d), generator=gen), obs=torch.randn((acq,), generator=gen),
        solver_draws=RowDraws(idx=torch.randint(0, n, (200, 32), generator=gen)))
    kw = dict(acq_batch=acq, num_features=256, num_candidates=64, num_top=2,
              ascent_steps=steps, spec=spec)
    state = ThompsonState(x=x, y=target(x)[:, 0], best=0.0)
    on_cpu = thompson_step(params, state, lambda z: target(z)[:, 0], draws=draws, **kw)
    cuda = lambda t: t.cuda()  # noqa: E731
    gparams = map_params(cuda, params)
    gtarget = dataclasses.replace(target, w=target.w.cuda(), ff=dataclasses.replace(
        target.ff, omega=target.ff.omega.cuda(), phase=target.ff.phase.cuda(),
        signal=target.ff.signal.cuda()))
    gdraws = ThompsonDraws(**{f.name: (RowDraws(idx=draws.solver_draws.idx.cuda())
                                       if f.name == "solver_draws" else
                                       getattr(draws, f.name).cuda())
                              for f in dataclasses.fields(draws)})
    gstate = ThompsonState(x=x.cuda(), y=state.y.cuda(), best=0.0)
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    before = (rff_bwd.launches, gram_matvec_bwd.launches, rff_t_matvec.launches)
    on_card = thompson_step(gparams, gstate, lambda z: gtarget(z)[:, 0], draws=gdraws, **kw)
    launched = tuple(k.launches - b0 for k, b0 in zip(
        (rff_bwd, gram_matvec_bwd, rff_t_matvec), before))
    assert launched == (steps, steps, 0)
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert ops.FEATURE_TRACE_COUNTS["features"] == 0
    assert on_card.x.device.type == "cuda"
    torch.testing.assert_close(on_card.x.cpu(), on_cpu.x, rtol=ROUTE_TOL, atol=ROUTE_TOL)


#: the reference's own flash-kernel tolerance (tests/test_kernels_pallas.py:72)
FLASH_TOL = 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(1, 130, 8, 2, 128), (2, 256, 4, 2, 64),
                                          (3, 1000, 32, 8, 128)])
def test_flash_kernel_matches_plain_on_card(card, causal, b, s, hq, hkv, d):
    q, k, v = _normal(1, b, s, hq, d), _normal(2, b, s, hkv, d), _normal(3, b, s, hkv, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    err, scale = _max_err(out, flash_attention_ref(q.double(), k.double(), v.double(),
                                                   causal=causal))
    assert err <= FLASH_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 17, 64, 65])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (32, 32, 64)])
def test_flash_kernel_short_sequences_on_card(card, causal, s, hq, hkv, d):
    # b·hq = 128 CTAs a query block: one key tile or two, ragged or whole;
    # within 1e-5 of scale of float64
    q, k, v = _normal(1, 4, s, hq, d), _normal(2, 4, s, hkv, d), _normal(3, 4, s, hkv, d)
    out = flash_attention(q, k, v, causal=causal)
    err, scale = _max_err(out, flash_attention_ref(q.double(), k.double(), v.double(),
                                                   causal=causal))
    assert err <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_gives_the_same_bits_twice_on_card(card, causal):
    q, k, v = _normal(1, 2, 300, 8, 128), _normal(2, 2, 300, 2, 128), _normal(3, 2, 300, 2, 128)
    assert torch.equal(flash_attention(q, k, v, causal=causal),
                       flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(card):
    q, k = _normal(1, 1, 64, 4, 64), _normal(2, 1, 64, 2, 64)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="head dimension"):
        flash_attention(_normal(3, 1, 64, 4, 96), _normal(4, 1, 64, 2, 96),
                        _normal(5, 1, 64, 2, 96))
    with pytest.raises(ValueError, match="do not chain"):
        flash_attention(q, _normal(6, 1, 64, 3, 64), _normal(7, 1, 64, 3, 64))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, k)
    # bf16 inputs are taken (csrc/flash_attention_bf16.cu), a mix of dtypes is not
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_attention(q.bfloat16(), k, k.bfloat16())


@pytest.mark.gpu
def test_generate_on_card_matches_plain_route(card):
    """A reduced llama3-8b (2 layers, d 256, 4 → 2 heads of 64) served on the
    card: prefill's attention through the flash kernel (one launch a layer,
    no plain dispatch), its logits within 1e-4 of the plain route's, and the
    same greedy tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib

    cfg = get_config("llama3-8b").reduced(num_layers=2)
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = token_batch(0, 0, 3, 200, cfg.vocab_size)["tokens"]
    logits = {}
    for backend in ("cuda", "plain"):
        with torch.no_grad():
            logits[backend], _ = model_lib.prefill(
                cfg, model, {"tokens": tokens}, model_lib.zero_cache(cfg, 3, 200),
                backend=backend)
    err, scale = _max_err(logits["cuda"], logits["plain"].double())
    assert err <= 1e-4 * scale
    ops.reset_attention_trace_counts()
    before = flash_attention.launches
    out, timings = generate(cfg, model, tokens, 216, 16)
    assert flash_attention.launches - before == cfg.num_layers
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": cfg.num_layers, "plain": 0}
    plain, _ = generate(cfg, model, tokens, 216, 16, backend="plain")
    assert out.shape == (3, 16) and torch.equal(out, plain)
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0


@pytest.mark.gpu
def test_forward_train_gradients_on_card_match_plain_route(card):
    """``torch.autograd.grad`` of a loss through ``forward_train`` of a reduced
    llama3-8b (2 layers, d 256, 4 → 2 heads of 64) on the card: the kernel
    route launches the flash kernel once a layer and gives the plain route's
    gradients for every weight, each to 1e-4 of its largest entry."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.models import model as model_lib

    cfg = get_config("llama3-8b").reduced(num_layers=2)
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    tokens = token_batch(0, 0, 2, 130, cfg.vocab_size)["tokens"]
    grads = {}
    for backend in ("cuda", "plain"):
        before = flash_attention.launches
        logits = model_lib.forward_train(cfg, model, {"tokens": tokens}, backend=backend)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        grads[backend] = torch.autograd.grad(loss, params)
        launched = flash_attention.launches - before
        assert launched == (cfg.num_layers if backend == "cuda" else 0)
    mixer = {id(p) for blk in model.modules() if isinstance(blk, model_lib.Block)
             for p in blk.mixer.values()}
    for p, a, b in zip(params, grads["cuda"], grads["plain"]):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
        if id(p) in mixer:  # the attention weights' gradients are not dropped
            assert a.abs().max().item() > 0


@pytest.mark.gpu
def test_engine_on_card_follows_the_launch_identities(card):
    # A small serving engine on the card: a predict batch is 2 Gram launches
    # and 1 RFF launch; a solve batch is its solve's matvecs in Gram launches
    # plus 1 for the sample evaluation, an RFF launch for each RHS_SLICE
    # columns of its right-hand sides plus 1 for the evaluation, and each
    # Thompson request of T ascent steps T + 3 launches of each forward
    # kernel and T of each backward; no plain dispatch anywhere. A request
    # served in a batch and alone gets the same solved columns, bit for bit.
    from repro_torch.serve import GPEngine
    from repro_torch.serve.engine import RHS_SLICE

    data = regression_dataset(2000, d=4, seed=1, n_test=64)
    params = make_params("matern32", lengthscale=0.9, noise=0.1, d=4, device="cuda")
    eng = GPEngine(params, data["x"], data["y"], spec=CG(max_iters=500, tol=1e-4),
                   num_samples=8, num_features=256, seed=0)
    assert eng.device.type == "cuda" and eng.state.fit_result.converged
    xt = torch.as_tensor(data["x_test"], device="cuda")
    wrappers = (gram_matvec, gram_matvec_bwd, rff_matvec, rff_bwd)

    def run_step():
        ops.reset_matvec_trace_counts()
        ops.reset_feature_trace_counts()
        for w in wrappers:
            w.launches = 0
        comps = eng.step()
        assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
        assert ops.FEATURE_TRACE_COUNTS["features"] == 0
        return comps, [w.launches for w in wrappers]

    for i in range(3):
        eng.predict(xt[8 * i:8 * i + 5])
    comps, (g, gb, r, rb) = run_step()
    assert len(comps) == 3 and (g, gb, r, rb) == (2, 0, 1, 0)
    steps = 3
    hs = [eng.sample(xt[:7], num_samples=4, seed=1), eng.sample(xt[7:20], num_samples=3, seed=2),
          eng.thompson_step(num_samples=2, seed=3, ascent_steps=steps, num_candidates=64)]
    comps, (g, gb, r, rb) = run_step()
    assert [c.request_id for c in comps] == [h.request.id for h in hs]
    matvecs = comps[0].metrics["matvecs"]
    assert comps[0].metrics["bucket_columns"] == 16 and matvecs > 0
    assert g == matvecs + 1 + steps + 3 and r == 16 // RHS_SLICE + 1 + steps + 3
    assert gb == rb == steps
    assert all(c.ok and all(bool(torch.isfinite(v).all()) for v in c.value.values())
               for c in comps)
    batched = torch.as_tensor(eng.cache.lookup(eng.state.hypers_key, "sample", 1))
    eng.cache.purge("")  # served again alone and cold, in an 8-column bucket
    again = eng.sample(xt[:7], num_samples=4, seed=1)
    eng.run_until_idle()
    assert not again.request.warm and again.result().metrics["bucket_columns"] == 8
    solo = torch.as_tensor(eng.cache.lookup(eng.state.hypers_key, "sample", 1))
    assert torch.equal(batched, solo)
    a, b = hs[0].result().value["samples"], again.result().value["samples"]
    assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


def _width_solves(x, params, b_col, companions, spec):
    """CG on (K + σ²I) for ``b_col`` as column 0 beside ``companions`` (n, k)."""
    b = torch.cat([b_col[:, None], companions], dim=1).contiguous()
    return b, solve(Gram(x=x, params=params), b, spec)


@pytest.mark.gpu
def test_cg_column_does_not_move_with_its_batch_width_on_card(card):
    # One column solved at width 8 and beside 63 others at width 64: the 8
    # columns both batches share (it and its first 7 companions) have the
    # same ‖b‖ (the stop test's denominator), relative residual, residual
    # norm and solved bits, since CG's dots and norms, finalize's included, run
    # in float64 on the card and the Gram kernel's columns do not depend on
    # the width. With zero companions, which converge at once, the batch's
    # iteration count is the column's own, and it is the same too.
    from repro_torch.core.solvers.base import _col_norm

    data = regression_dataset(4096, d=5, seed=2, n_test=8)
    x = torch.as_tensor(data["x"], device="cuda")
    params = make_params("matern32", lengthscale=1.1, noise=0.1, d=5, device="cuda")
    y = torch.as_tensor(data["y"], device="cuda")
    others = _normal(3, 4096, 63)
    spec = CG(max_iters=500, tol=1e-4)
    for companions in ((others[:, :7], others), (torch.zeros_like(others[:, :7]),
                                                 torch.zeros_like(others))):
        (b8, r8), (b64, r64) = (_width_solves(x, params, y, c, spec) for c in companions)
        # all 8 columns the widths share: the column and its first 7 companions
        assert torch.equal(_col_norm(b8), _col_norm(b64)[:8])
        assert torch.equal(r8.rel_residual, r64.rel_residual[:8])
        assert torch.equal(r8.residual_norm, r64.residual_norm[:8])
        assert torch.equal(r8.solution, r64.solution[:, :8])
        assert r8.converged and r64.converged
    assert r8.iterations == r64.iterations > 0


@pytest.mark.gpu
def test_normal_eq_on_card_matches_its_chunked_route(card):
    # NormalEq's three products (K_XZ·u, K_ZX·(K_XZ·u), K_ZZ·u) through the
    # Gram kernel on the cross shapes n × m, m × n and m × m, against the
    # chunked route in float64 on the same fp32 inputs: the reference's Gram
    # tolerance relative to the largest entry; 3 launches, no plain dispatch
    from repro_torch.core import NormalEq

    n, m, d = 5000, 128, 9
    x, z = _normal(4, n, d, scale=0.5), _normal(5, m, d, scale=0.5)
    params = make_params("matern32", lengthscale=1.2, noise=0.1, d=d, device="cuda")
    p64 = map_params(lambda a: a.double(), params)
    for s in (1, 17):
        u = _normal(6 + s, m, s)
        gram_matvec.launches = 0
        ops.reset_matvec_trace_counts()
        out = NormalEq(x=x, z=z, params=params, ridge=0.5).mv(u)
        torch.cuda.synchronize()
        assert gram_matvec.launches == 3
        assert ops.MATVEC_TRACE_COUNTS == {"cuda": 3, "chunked": 0, "dense": 0}
        ref = NormalEq(x=x.double(), z=z.double(), params=p64, ridge=0.5,
                       backend="chunked").mv(u.double())
        err = (out.double() - ref).abs().max().item()
        assert err <= GRAM_TOL * ref.abs().max().item()


@pytest.mark.gpu
def test_sgpr_iterative_and_inducing_on_card_follow_the_launch_identities(card):
    # sgpr_iterative + mean + var: 3 Gram launches a NormalEq matvec, 1 for
    # K_ZX y; inducing_posterior: 1 + 3 a matvec and 1 RFF launch for f_X,
    # then 1 RFF launch an evaluation of the sample paths; no plain dispatch
    from repro_torch.core import inducing_posterior, sgpr_iterative

    data = regression_dataset(3000, d=5, seed=3, n_test=64)
    x = torch.as_tensor(data["x"], device="cuda")
    y = torch.as_tensor(data["y"], device="cuda")
    xt = torch.as_tensor(data["x_test"], device="cuda")
    params = make_params("matern32", lengthscale=1.1, noise=0.1, d=5, device="cuda")
    z = x[::30][:96]

    def reset():
        ops.reset_matvec_trace_counts()
        ops.reset_feature_trace_counts()
        gram_matvec.launches = rff_matvec.launches = 0

    reset()
    post = sgpr_iterative(params, x, y, z, spec=CG(max_iters=60, tol=1e-6))
    mean = post.mean(xt)
    out = post.var_solve(xt)
    var, info = out.var, out.solve_info
    torch.cuda.synchronize()
    assert gram_matvec.launches == 3 * post.solve_info.matvecs + 1 + 3 * info.matvecs
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
    reset()
    ind = inducing_posterior(params, x, y, z, generator=torch.Generator("cuda").manual_seed(0),
                             num_samples=4, num_features=256, spec=CG(max_iters=40, tol=1e-5))
    f = ind(xt)
    torch.cuda.synchronize()
    assert gram_matvec.launches == 1 + 3 * ind.solve_info.matvecs
    assert rff_matvec.launches == 2 and f.shape == (64, 4)
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert ops.FEATURE_TRACE_COUNTS["features"] == 0


# ---------------------------------------------------------------------------
# the bf16 tiles: each kernel against its bf16 plain version (the same cast
# points, fp32 sums: one bf16 ulp of a panel entry now and then flips with
# the summation order) and within the reference's bf16-vs-fp32 bound of its
# fp32 launch; the stochastic solvers' launch identities in bf16
# ---------------------------------------------------------------------------

#: one bf16 ulp of a single panel entry; the reference's bf16-vs-fp32 bounds
#: (tests/test_pair_and_precision.py:164,174, and :209-221 for a solve)
BF16_TOL, BF16_FP32_TOL, BF16_SOLVE_TOL = 2e-3, 5e-2, 8e-2


def _bf16_err(got, plain, fp32):
    """max|Δ| of a bf16 launch against its bf16 plain version and against the
    fp32 launch, each over its own max(1, scale)."""
    def rel(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())
    return rel(got, plain), rel(got, fp32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d,s", [
    (1000, 1000, 9, 65), (1000, 777, 3, 17), (777, 1000, 9, 1), (999, 1001, 1, 101),
    (333, 517, 128, 129), (130, 20_000, 9, 17), (34_000, 512, 9, 65),
])
def test_bf16_gram_kernel_matches_plain_on_card(card, kind, n, m, d, s):
    x = _normal(1, n, d, scale=0.6)
    z = x if n == m else _normal(2, m, d, scale=0.6)
    v = _normal(3, m, s)
    before = (gram_matvec.launches, gram_matvec.bf16_launches)
    out = gram_matvec(x, z, v, kind=kind, precision="bf16")
    assert (gram_matvec.launches, gram_matvec.bf16_launches) == (before[0], before[1] + 1)
    plain, fp32 = gram_matvec_ref(x, z, v, kind=kind, precision="bf16"), gram_matvec(x, z, v,
                                                                                     kind=kind)
    e_plain, e_fp32 = _bf16_err(out, plain, fp32)
    assert e_plain <= BF16_TOL and e_fp32 <= BF16_FP32_TOL
    assert torch.equal(out, gram_matvec(x, z, v, kind=kind, precision="bf16"))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_bf16_gram_kernel_columns_are_the_same_at_every_width_on_card(card, kind):
    # a column's bf16 result depends on its own P row and v column alone:
    # the same bits beside 7, 63 or 100 other columns (one chunk at n = 8,192)
    x = _normal(1, 8192, 9, scale=0.6)
    v = _normal(2, 8192, 101)
    wide = gram_matvec(x, x, v, kind=kind, precision="bf16")
    for s in (1, 8, 64):
        assert torch.equal(gram_matvec(x, x, v[:, :s].contiguous(), kind=kind,
                                       precision="bf16"), wide[:, :s])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,p,p_true,s", [(3000, 70, 63, 5), (3000, 512, 505, 65),
                                           (45_730, 512, 505, 65)])
def test_bf16_gram_rows_kernels_match_plain_on_card(card, kind, n, p, p_true, s):
    x = _normal(1, n, 9, scale=0.6)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, n, size=p)).cuda()
    xi, look, b = x[idx].contiguous(), _normal(3, n, s), _normal(4, p, s)
    before = (gram_rows_pair.bf16_launches, gram_rows_matvec.bf16_launches)
    err, g = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p_true, precision="bf16")
    mv = gram_rows_matvec(xi, x, look, kind=kind, precision="bf16")
    assert (gram_rows_pair.bf16_launches, gram_rows_matvec.bf16_launches) == (before[0] + 1,
                                                                              before[1] + 1)
    want_e, want_g = gram_rows_pair_ref(xi, x, look, b, kind=kind, p_true=p_true,
                                        precision="bf16")
    e32, g32 = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p_true)
    for got, plain, fp32 in ((err, want_e, e32), (g, want_g, g32),
                             (mv, gram_rows_matvec_ref(xi, x, look, kind=kind, precision="bf16"),
                              gram_rows_matvec(xi, x, look, kind=kind))):
        e_plain, e_fp32 = _bf16_err(got, plain, fp32)
        assert e_plain <= BF16_TOL and e_fp32 <= BF16_FP32_TOL
    assert bool((err[p_true:] == 0).all())
    again = gram_rows_pair(xi, x, look, b, kind=kind, p_true=p_true, precision="bf16")
    assert torch.equal(again[0], err) and torch.equal(again[1], g)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d,s,m_true", [
    (45_730, 100, 9, 65, 100), (45_730, 100, 9, 65, 93), (1001, 77, 5, 33, 70),
    (4097, 100, 9, 130, 100), (45_730, 512, 9, 8, 512), (63, 1, 3, 1, 1),
])
def test_bf16_rff_kernels_match_plain_on_card(card, n, m, d, s, m_true):
    x, u, w = _normal(1, n, d, scale=1.5 / d ** 0.5), _normal(2, n, s), _normal(4, 2 * m, s)
    omega = _normal(3, m, d, scale=0.8)
    omega[m_true:] = 0.0
    kernels = (rff_matvec, rff_t_matvec, rff_pair)
    before = tuple(k.bf16_launches for k in kernels)
    got = (rff_matvec(x, omega, w, precision="bf16"),
           rff_t_matvec(x, omega, u, m_true=m_true, precision="bf16"),
           rff_pair(x, omega, u, m_true=m_true, precision="bf16"))
    assert tuple(k.bf16_launches for k in kernels) == tuple(b0 + 1 for b0 in before)
    plain = (rff_matvec_ref(x, omega, w, precision="bf16"),
             rff_t_matvec_ref(x, omega, u, m_true=m_true, precision="bf16"),
             rff_pair_ref(x, omega, u, m_true=m_true, precision="bf16"))
    fp32 = (rff_matvec(x, omega, w), rff_t_matvec(x, omega, u, m_true=m_true),
            rff_pair(x, omega, u, m_true=m_true))
    for a, b, c in zip(got, plain, fp32):
        e_plain, e_fp32 = _bf16_err(a, b, c)
        assert e_plain <= BF16_TOL and e_fp32 <= BF16_FP32_TOL
    assert torch.equal(got[2], rff_pair(x, omega, u, m_true=m_true, precision="bf16"))


@pytest.mark.gpu
def test_bf16_backward_and_flash_inputs_raise_on_card(card):
    # the bf16 branches are ported: a bf16 forward's gradient runs on bf16
    # backward launches alone (no fp32 launch), within _bf16_grad_tol of the
    # plain bf16 Functions', and bf16 flash inputs run the bf16 kernel
    x = _normal(1, 100, 3)
    v = _normal(2, 100, 2)
    omega = _normal(3, 8, 3)
    for kernel_fn, plain_fn, ins in (
            (lambda a, b: gram_matvec(a, a, b, kind="se", precision="bf16"),
             lambda a, b: plain_gram_matvec(a, a, b, kind="se", precision="bf16"), (x, v)),
            (lambda a, w, b: rff_pair(a, w, b, precision="bf16"),
             lambda a, w, b: plain_rff_pair(a, w, b, precision="bf16"), (x, omega, v))):
        before = (gram_matvec_bwd.launches, rff_bwd.launches,
                  gram_matvec_bwd.bf16_launches + rff_bwd.bf16_launches)
        grads = _grads(kernel_fn, ins)
        assert (gram_matvec_bwd.launches, rff_bwd.launches) == before[:2]
        assert gram_matvec_bwd.bf16_launches + rff_bwd.bf16_launches > before[2]
        _check_bf16_grads(grads, _grads(plain_fn, ins), _grads(plain_fn, ins, torch.float64))
    q = _normal(4, 1, 64, 2, 64).bfloat16()
    before = flash_attention.bf16_launches
    out = ops.flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16 and flash_attention.bf16_launches == before + 1
    ref = flash_attention_ref(q, q, q)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_BF16_TOL * max(
        1.0, ref.float().abs().max().item())


#: flash attention on bf16 inputs against its bf16 plain version and against
#: the fp32 kernel on the same bf16-valued inputs (the reference's bf16
#: tolerance, tests/test_kernels_pallas.py:84), each of max(1, scale)
FLASH_BF16_TOL, FLASH_BF16_FP32_TOL = 1e-2, 3e-2
#: a bf16 backward kernel or gradient against its plain version run in
#: float64 (the bf16 cast points exactly): within BF16_TOL, or
#: BF16_PLAIN_RATIO × the plain version's own error run in fp32, if larger
#: (d² from the identity on rounded points loses ~1e-7 of |x|² to fp32
#: rounding, which κ' amplifies at small distances), of max(1, scale)
BF16_PLAIN_RATIO = 2.0


def _scaled(a, b):
    return (a.double() - b.double()).abs().max().item() / max(1.0, b.abs().max().item())


def _bf16_bwd_tol(plain32, plain64):
    return max(BF16_TOL, BF16_PLAIN_RATIO * _scaled(plain32, plain64))


def _grads(fn, ins, dt=torch.float32):
    """Gradients of Σ ḡ ⊙ fn(*ins) (ḡ from a seed) with respect to every
    input, the inputs cast to ``dt``."""
    leaves = [t.detach().to(dt).requires_grad_() for t in ins]
    out = fn(*leaves)
    gbar = torch.ones_like(out) if out.dim() == 0 else _normal(9, *out.shape).to(dt)
    return torch.autograd.grad(torch.sum(gbar * out), leaves)


def _check_bf16_grads(kernel, plain32, plain64):
    for a, b, b64 in zip(kernel, plain32, plain64):
        assert bool(torch.isfinite(a).all())
        assert _scaled(a, b64) <= _bf16_bwd_tol(b, b64)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d,s", [
    (1000, 1000, 9, 8), (400, 50_000, 8, 100), (777, 1001, 3, 17), (130, 2000, 9, 1),
    (333, 517, 64, 129), (200, 300, 128, 33), (45_730, 2000, 9, 8),
])
def test_bf16_gram_bwd_kernel_matches_plain_on_card(card, kind, n, m, d, s):
    # the bf16 tiles of the Gram backward against their plain version in
    # float64 (the bf16 cast points exactly) and against the fp32 launch; the
    # wrapper's launches are bf16 launches alone
    x, z = _normal(1, n, d, scale=0.6), _normal(2, m, d, scale=0.6)
    rowv, colv = _normal(3, n, s), _normal(4, m, s)
    before = (gram_matvec_bwd.launches, gram_matvec_bwd.bf16_launches)
    got = gram_matvec_bwd(x, z, rowv, colv, kind=kind, precision="bf16")
    assert gram_matvec_bwd.launches == before[0]
    assert gram_matvec_bwd.bf16_launches > before[1]
    k = min(n, 2048)
    plain = gram_matvec_bwd_ref(x[:k].double(), z.double(), rowv[:k].double(), colv.double(),
                                kind=kind, precision="bf16")
    plain32 = gram_matvec_bwd_ref(x[:k], z, rowv[:k], colv, kind=kind, precision="bf16")
    e_plain, e_fp32 = _bf16_err(got[:k].double(), plain,
                                gram_matvec_bwd(x, z, rowv, colv, kind=kind)[:k].double())
    assert bool(torch.isfinite(got).all())
    assert e_plain <= _bf16_bwd_tol(plain32, plain) and e_fp32 <= BF16_FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,d,s", [
    (400, 512, 8, 100), (16, 1024, 9, 8), (45_730, 512, 9, 8), (512, 45_730, 9, 8),
    (100, 130, 3, 17), (300, 200, 40, 65), (130, 257, 128, 9),
])
def test_bf16_rff_bwd_kernel_matches_plain_on_card(card, rows, cols, d, s):
    r, c = _normal(1, rows, d, scale=0.7), _normal(2, cols, d, scale=0.7)
    p1, p2, q1, q2 = _normal(3, rows, s), _normal(4, rows, s), _normal(5, cols, s), _normal(6, cols, s)
    sc = (1.0 / cols) ** 0.5
    before = (rff_bwd.launches, rff_bwd.bf16_launches)
    got = rff_bwd(r, c, p1, p2, q1, q2, scale=sc, precision="bf16")
    assert (rff_bwd.launches, rff_bwd.bf16_launches) == (before[0], before[1] + 1)
    k = min(rows, 2048)
    plain = rff_bwd_ref(r[:k].double(), c.double(), p1[:k].double(), p2[:k].double(),
                        q1.double(), q2.double(), scale=sc, precision="bf16")
    plain32 = rff_bwd_ref(r[:k], c, p1[:k], p2[:k], q1, q2, scale=sc, precision="bf16")
    e_plain, e_fp32 = _bf16_err(got[:k].double(), plain,
                                rff_bwd(r, c, p1, p2, q1, q2, scale=sc)[:k].double())
    assert bool(torch.isfinite(got).all())
    assert e_plain <= _bf16_bwd_tol(plain32, plain) and e_fp32 <= BF16_FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gram_matvec", "gram_rows_pair", "rff_matvec",
                                  "rff_t_matvec", "rff_pair"])
def test_bf16_function_gradients_match_plain_on_card(card, name):
    # every bf16 VJP through the kernels against the plain Functions at bf16
    # on the same card tensors in float64 (_check_bf16_grads): the backward's
    # matvecs and dx, dz at bf16
    n, m, p, d, s = 3000, 100, 256, 9, 8
    x = _normal(1, n, d, scale=0.6)
    omega = _normal(2, m, d, scale=0.8)
    bf = dict(precision="bf16")
    cases = {
        "gram_matvec": ((x, x, _normal(3, n, s)), gram_matvec, plain_gram_matvec,
                        dict(kind="matern32")),
        "gram_rows_pair": ((x[:p].contiguous(), x, _normal(3, n, s), _normal(4, p, s)),
                           gram_rows_pair, plain_gram_rows_pair,
                           dict(kind="matern32", p_true=p - 5)),
        "rff_matvec": ((x, omega, _normal(3, 2 * m, s)), rff_matvec, plain_rff_matvec, {}),
        "rff_t_matvec": ((x, omega, _normal(3, n, s)), rff_t_matvec, plain_rff_t_matvec,
                         dict(m_true=93)),
        "rff_pair": ((x, omega, _normal(3, n, s)), rff_pair, plain_rff_pair, dict(m_true=93)),
    }
    ins, kernel, plain, kw = cases[name]

    def call(fn):
        def f(*a):
            out = fn(*a, **kw, **bf)
            return sum(t.sum() for t in out) if isinstance(out, tuple) else out
        return f

    _check_bf16_grads(_grads(call(kernel), ins), _grads(call(plain), ins),
                      _grads(call(plain), ins, torch.float64))


#: the bf16 kernel's block edges: a CTA holds 128 query rows and walks keys
#: in tiles of 128 (``BLOCKS["bf16"]``), so s one short of, at and one past a
#: block, two blocks and a row, and the ragged 1,000, at d 64 and 128, one kv
#: head a query head and one for four
FLASH_BF16_EDGES = [(2, s, hq, 2, d) for s in (1, 127, 128, 129, 257, 1000)
                    for hq in (2, 8) for d in (64, 128)]


def _check_bf16_flash(q, k, v, causal):
    """One bf16 launch against the bf16 plain version and the fp32 kernel on
    the same bf16-valued inputs, and the same bits on a second launch."""
    before = (flash_attention.launches, flash_attention.bf16_launches)
    out = flash_attention(q, k, v, causal=causal)
    assert (flash_attention.launches, flash_attention.bf16_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    plain = flash_attention_ref(q, k, v, causal=causal)
    fp32 = flash_attention(q.float(), k.float(), v.float(), causal=causal)
    e_plain, e_fp32 = _bf16_err(out.float(), plain.float(), fp32)
    assert e_plain <= FLASH_BF16_TOL and e_fp32 <= FLASH_BF16_FP32_TOL
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(4, 1024, 32, 8, 128), (4, 1000, 32, 8, 128),
                                          (2, 130, 4, 2, 64), (1, 37, 2, 1, 64),
                                          (2, 256, 4, 4, 128)] + FLASH_BF16_EDGES)
def test_bf16_flash_kernel_matches_plain_on_card(card, causal, b, s, hq, hkv, d):
    q = _normal(1, b, s, hq, d).bfloat16()
    k, v = _normal(2, b, s, hkv, d).bfloat16(), _normal(3, b, s, hkv, d).bfloat16()
    _check_bf16_flash(q, k, v, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_flash_kernel_on_slices_of_larger_tensors_on_card(card, causal, d):
    # the kernel's tensor maps start at each operand's data_ptr() and step by
    # its shape's strides: contiguous slices of larger tensors, at offsets
    # past the first batch and, with b = 1, past the first rows, read only
    # their own rows
    s, hq, hkv = 200, 8, 2
    big_q = _normal(1, 3, s, hq, d).bfloat16()
    big_kv = _normal(2, 2, 3, s, hkv, d).bfloat16()
    _check_bf16_flash(big_q[1:], big_kv[0, 1:], big_kv[1, :2], causal)
    q_rows = _normal(3, 1, s + 7, hq, d).bfloat16()
    kv_rows = _normal(4, 2, s + 7, hkv, d).bfloat16()
    q, k, v = q_rows[:, 3:3 + s], kv_rows[:1, 5:5 + s], kv_rows[1:, 1:1 + s]
    assert all(t.is_contiguous() and t.storage_offset() for t in (q, k, v))
    _check_bf16_flash(q, k, v, causal)


@pytest.mark.gpu
def test_bf16_generate_on_card_runs_the_bf16_flash_kernel(card):
    """A reduced llama3-8b cast to bf16 in place and served on the card:
    prefill's attention one bf16 flash launch a layer, no fp32 launch, and
    its last-position logits within 5e-2 of the fp32 model's scale."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib

    cfg = get_config("llama3-8b").reduced(num_layers=2)
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = token_batch(0, 0, 3, 200, cfg.vocab_size)["tokens"]
    with torch.no_grad():
        ref, _ = model_lib.prefill(cfg, model, {"tokens": tokens},
                                   model_lib.zero_cache(cfg, 3, 200))
    model_lib.cast_model_(model, torch.bfloat16)
    before = (flash_attention.launches, flash_attention.bf16_launches)
    toks, _ = generate(cfg, model, tokens, 208, 8)
    assert (flash_attention.launches, flash_attention.bf16_launches) == (
        before[0], before[1] + cfg.num_layers)
    assert toks.shape == (3, 8)
    with torch.no_grad():
        got, _ = model_lib.prefill(cfg, model, {"tokens": tokens},
                                   model_lib.zero_cache(cfg, 3, 200))
    assert (got - ref).abs().max().item() <= 5e-2 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sgd", "sdd", "ap"])
def test_bf16_stochastic_solvers_on_card_follow_the_launch_identities(card, name):
    # 50 bf16 steps on the card on injected draws: every row panel and feature
    # pair a bf16 kernel launch (pair = feature pair = steps for SGD, rows =
    # steps for SDD, Gram = steps for AP, and finalize's Gram matvec for SGD
    # and SDD), no fp32 launch and no plain dispatch; the solution
    # within the route tolerance of the same bf16 steps on the kernels' plain
    # versions (backend "cuda" on the CPU: the same cast points), and within
    # the reference's bf16-vs-fp32 bound of the fp32 solve
    params, x, b = _toy_card_problem()
    gen = torch.Generator().manual_seed(0)
    if name == "sgd":
        spec = SGD(num_steps=50, batch_size=64, num_features=32, precision="bf16")
        draws = draw_sgd(Gram(x=x, params=params), 50, 64, 32, generator=gen)
        card_draws = SGDDraws(idx=draws.idx.cuda(), omega=draws.omega.cuda())
    else:
        spec = (SDD(num_steps=50, batch_size=64, step_size_times_n=1.0, averaging=0.05,
                    precision="bf16")
                if name == "sdd"
                else AP(num_steps=50, block_size=64, precision="bf16"))
        draws = RowDraws(idx=torch.randint(0, 600, (50, 64), generator=gen))
        card_draws = RowDraws(idx=draws.idx.cuda())
    on_cpu = solve(Gram(x=x, params=params), b, dataclasses.replace(spec, backend="cuda"),
                   draws=draws)
    gop = Gram(x=x.cuda(), params=map_params(torch.Tensor.cuda, params))
    fp32 = solve(gop, b.cuda(), dataclasses.replace(spec, precision=None), draws=card_draws)
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    kernels = (gram_rows_pair, gram_rows_matvec, rff_pair, gram_matvec)
    before = tuple((k.launches, k.bf16_launches) for k in kernels)
    on_card = solve(gop, b.cuda(), spec, draws=card_draws)
    launched = tuple(k.bf16_launches - b0[1] for k, b0 in zip(kernels, before))
    assert launched == {"sgd": (50, 0, 50, 1), "sdd": (0, 50, 0, 1), "ap": (0, 0, 0, 50)}[name]
    assert all(k.launches == b0[0] for k, b0 in zip(kernels, before))  # no fp32 launch
    assert ops.MATVEC_TRACE_COUNTS["chunked"] == ops.MATVEC_TRACE_COUNTS["dense"] == 0
    assert ops.FEATURE_TRACE_COUNTS["features"] == 0
    torch.testing.assert_close(on_card.solution.cpu(), on_cpu.solution, rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    scale = max(1.0, fp32.solution.abs().max().item())
    assert (on_card.solution - fp32.solution).abs().max().item() <= BF16_SOLVE_TOL * scale
    assert not torch.equal(on_card.solution, fp32.solution)


def _train_cfg():
    """A reduced olmo-1b (2 layers, d 256, 4 heads of 64, vocab 512)."""
    from repro_torch.configs.base import get_config

    return get_config("olmo-1b").reduced(num_layers=2)


@pytest.mark.gpu
@pytest.mark.parametrize("micro_steps", [1, 2])
def test_train_step_on_card_matches_plain_route(card, micro_steps):
    """One train step's loss and gradients on the kernel route against the
    plain attention route on the card (the loss to 1e-5 relative, every
    gradient leaf to 1e-4 of its scale); the step launches the fp32 flash
    kernel once a layer for each micro-batch, and nothing else."""
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.train import AdamWConfig, init_opt_state

    cfg = _train_cfg()
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = token_batch(0, 0, 4, 130, cfg.vocab_size)
    out = {}
    for backend in ("cuda", "plain"):
        before = flash_attention.launches
        out[backend] = loss_and_grads(cfg, model, batch, micro_steps=micro_steps,
                                      backend=backend)
        assert flash_attention.launches - before == (
            cfg.num_layers * micro_steps if backend == "cuda" else 0)
    (lk, gk), (lp, gp) = out["cuda"], out["plain"]
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for a, b in zip(gk, gp):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    opt = init_opt_state(model, AdamWConfig())
    ops.reset_attention_trace_counts()
    before = (flash_attention.launches, flash_attention.bf16_launches)
    model, opt, metrics = make_train_step(cfg, AdamWConfig(), micro_steps)(model, opt, batch)
    assert np.isfinite(metrics["loss"].item()) and int(metrics["step"]) == 1
    assert (flash_attention.launches, flash_attention.bf16_launches) == (
        before[0] + cfg.num_layers * micro_steps, before[1])
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": cfg.num_layers * micro_steps, "plain": 0}
    assert opt.mu.embed["tok"].dtype == torch.bfloat16 and opt.mu.embed["tok"].is_cuda


@pytest.mark.gpu
def test_train_resume_on_card_is_bit_exact(card, tmp_path):
    """Kill and resume on the card: 6 steps with a checkpoint every 3, and 3
    steps then a fresh Trainer resumed to 6, give the same losses,
    parameters and optimiser state (bf16 mu) bit for bit."""
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.train.optim import leaves

    cfg = _train_cfg()

    def make(steps, name):
        return Trainer(cfg, TrainerConfig(batch=4, seq_len=64, num_steps=steps, log_every=0,
                                          ckpt_dir=str(tmp_path / name), ckpt_every=3,
                                          opt=AdamWConfig(lr=1e-3, warmup_steps=2)))

    full = make(6, "full")
    p_full, o_full = full.run()
    make(3, "resume").run()
    resumed = make(6, "resume")
    p_res, o_res = resumed.run()
    assert resumed.losses == full.losses and len(full.losses) == 6
    for a, b in zip(leaves(p_full) + leaves(o_full.mu) + leaves(o_full.nu) + [o_full.step],
                    leaves(p_res) + leaves(o_res.mu) + leaves(o_res.nu) + [o_res.step]):
        assert a.is_cuda and torch.equal(a, b)


def _flash_layers(cfg) -> int:
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_layer_period
    return cfg.num_layers + cfg.encoder_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_families_on_card_match_the_cpu(card, arch):
    """A reduced model of each ported family (2 layers; jamba its period) on
    the card against the same weights on the CPU: forward_train's logits and
    one step's loss and gradients (the flash kernel once a GQA layer) within
    1e-4 of scale, and greedy generate's tokens equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import init_params, tree_map

    cfg = get_config(arch).reduced(**({} if arch.startswith("jamba") else {"num_layers": 2}))
    tree = init_params(model_lib.param_schema(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    models = {"cpu": model_lib.Transformer(cfg, tree),
              "cuda": model_lib.Transformer(cfg, tree_map(lambda t: t.cuda(), tree))}
    batch = token_batch(0, 0, 2, 64, cfg.vocab_size, device="cpu")
    out = {}
    for dev, model in models.items():
        b = {k: v.to(dev) for k, v in batch.items()}
        before = flash_attention.launches
        with torch.no_grad():
            logits = model_lib.forward_train(cfg, model, b).cpu()
        loss, grads = loss_and_grads(cfg, model, b)
        toks, _ = generate(cfg, model, b["tokens"][:, :32], 40, 8)
        out[dev] = logits, loss.item(), [g.cpu() for g in grads], toks.cpu()
        if dev == "cuda":
            assert flash_attention.launches - before == 3 * _flash_layers(cfg)
    (lc, lsc, gc_, tc), (lg, lsg, gg, tg) = out["cpu"], out["cuda"]
    assert (lg - lc).abs().max().item() <= 1e-4 * max(1.0, lc.abs().max().item())
    assert abs(lsg - lsc) <= 1e-5 * abs(lsc)
    for a, b in zip(gg, gc_):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-30)
    assert torch.equal(tg, tc)


@pytest.mark.gpu
def test_moe_dispatch_on_card_is_deterministic_and_matches_the_cpu(card):
    """An overflowing reduced-dbrx group on the card: two runs give the same
    bits (the dispatch has no duplicate-index scatter), the slot table equals
    the CPU's, and the output is the CPU's within 1e-5 of scale."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.models.param import init_params, tree_map

    cfg = get_config("dbrx-132b").reduced(num_layers=2)
    p = init_params(moe.moe_params(cfg), torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy((0.5 * rng.normal(size=(1, 64, cfg.d_model))
                          + rng.normal(size=cfg.d_model)).astype(np.float32))
    cpu, gpu = model_lib._parameters(p), model_lib._parameters(tree_map(lambda t: t.cuda(), p))
    with torch.no_grad():
        _, flat_e, slot, cap = moe.route(cpu, cfg, x)
        assert int((torch.bincount(flat_e[0], minlength=cfg.num_experts) > cap).sum()) >= 1
        table = moe._slot_table(flat_e, cfg.experts_per_tok, cfg.num_experts, cap)
        _, flat_g, _, _ = moe.route(gpu, cfg, x.cuda())
        table_g = moe._slot_table(flat_g, cfg.experts_per_tok, cfg.num_experts, cap)
        ref = moe.moe_apply(cpu, cfg, x)
        y1, y2 = (moe.moe_apply(gpu, cfg, x.cuda()) for _ in range(2))
    assert torch.equal(y1, y2)
    for a, b in zip(table, table_g):
        assert torch.equal(a, b.cpu())
    assert (y1.cpu() - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
def test_ssd_on_card_matches_sequential_with_a_finite_gradient(card):
    """mamba2-130m's chunk of 256 at its head and state widths: the chunked
    scan against the sequential one on the card (the reference's 2e-3), and
    its gradient finite where the decay sums past exp's range."""
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, p, n = 2, 512, 24, 64, 128
    x = torch.randn((b, s, h, p), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    bm, cm = (0.5 * torch.randn((b, s, n), generator=gen, device="cuda") for _ in range(2))
    a_log, d_skip = torch.ones(h, device="cuda"), torch.ones(h, device="cuda")
    dt.requires_grad_(True)
    y, state = ssm.ssd_chunked(x, dt, a_log, bm, cm, d_skip, 256)
    with torch.no_grad():
        y_seq, state_seq = ssm.ssm_scan_ref(x, dt, a_log, bm, cm, d_skip)
    torch.testing.assert_close(y.detach(), y_seq, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(state.detach(), state_seq, rtol=2e-3, atol=2e-3)
    (g,) = torch.autograd.grad(y.sum(), dt)
    assert torch.isfinite(g).all()


@pytest.mark.gpu
def test_flash_kernel_non_causal_at_whispers_encoder_shape_on_card(card):
    """whisper-tiny's encoder self-attention: 4 × 1,500 frames, 6 heads of
    64, every key visible (the last of 24 query blocks ragged)."""
    q, k, v = (_normal(seed, 4, 1500, 6, 64) for seed in (1, 2, 3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    err, scale = _max_err(out, flash_attention_ref(q.double(), k.double(), v.double(),
                                                   causal=False))
    assert err <= FLASH_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_encdec_and_vlm_on_card_match_the_cpu(card, arch):
    """Reduced whisper (2 encoder layers over 64 frames, 2 decoder layers)
    and reduced qwen2-vl (2 layers, 16 vision tokens) on the card against
    the same weights and stub inputs on the CPU: prefill's logits within
    1e-4 of scale, with one flash launch an encoder or a decoder layer
    (none for cross-attention), and greedy generate's tokens equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import init_params, tree_map

    cfg = get_config(arch).reduced(num_layers=2)
    tree = init_params(model_lib.param_schema(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    models = {"cpu": model_lib.Transformer(cfg, tree),
              "cuda": model_lib.Transformer(cfg, tree_map(lambda t: t.cuda(), tree))}
    inputs = {"tokens": token_batch(0, 0, 2, 32, cfg.vocab_size, device="cpu")["tokens"]}
    rng = np.random.default_rng(1)
    if cfg.is_encdec:
        inputs["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        inputs["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    out = {}
    for dev, model in models.items():
        ins = {k: v.to(dev) for k, v in inputs.items()}
        before = flash_attention.launches
        with torch.no_grad():
            logits, _ = model_lib.prefill(cfg, model, ins,
                                          model_lib.zero_cache(cfg, 2, 40, device=dev))
        if dev == "cuda":
            assert flash_attention.launches - before == _flash_layers(cfg)
        extra = {k: v for k, v in ins.items() if k != "tokens"}
        toks, _ = generate(cfg, model, ins["tokens"], 40, 8, extra)
        out[dev] = logits.cpu(), toks.cpu()
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    assert (lg - lc).abs().max().item() <= 1e-4 * max(1.0, lc.abs().max().item())
    assert torch.equal(tg, tc)


# ---------------------------------------------------------------------------
# the distributed solve on the card: one rank on NCCL, two ranks sharing the
# card on gloo (NCCL refuses two ranks on one card), spawned
# ---------------------------------------------------------------------------

DIST_N, DIST_D, DIST_S = 4096, 9, 8
#: ShardedGram's primitives against the single-device path, of max(1, scale)
DIST_TOL = 1e-5
#: ring's 18 CG iterations against single-device CG with the ring's row sums
#: (``RingOrderGram``), of max(1, scale)
DIST_CG_TOL = 1e-4


def _dist_problem():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, size=(DIST_N, DIST_D)).astype(np.float32)
    v = rng.normal(size=(DIST_N, DIST_S)).astype(np.float32)
    return x, v


def _dist_params():
    return make_params("matern32", lengthscale=1.5, signal=1.0, noise=0.1, d=DIST_D,
                       device="cuda")


def _dist_rank(rank, world, port, x, v, out_dir):
    import torch.distributed as dist

    from repro_torch.core import ShardedGram, distributed_solve, shard_training_rows
    from repro_torch.core import collectives as coll
    from repro_torch.testing.ranks import join_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = join_mesh(rank, world, port, "cuda", timeout=120)
    xs = shard_training_rows(mesh, torch.from_numpy(x).cuda())
    v = torch.from_numpy(v).cuda()
    p = _dist_params()
    res = {"backend": str(dist.get_backend())}
    for comm, once in (("gather", False), ("gather", True), ("ring", False)):
        op = ShardedGram(x=xs, params=p, mesh=mesh, comm=comm,
                         gather_once=once).prepare_for_solve()
        coll.reset_collective_counts()
        out = op.mv(v if comm == "gather" else op.layout.iterate(v))
        tag = "gather_once" if once else comm
        res[tag] = coll.all_gather_rows(out, op._group).cpu() if comm == "ring" else out.cpu()
        res[tag + "/staged"] = coll.collective_counts()["staged_bytes"]
        r = distributed_solve(p, xs, v, mesh, CG(max_iters=18, tol=1e-12), comm=comm,
                              gather_once=once)
        sol = coll.all_gather_rows(r.solution, op._group) if comm == "ring" else r.solution
        res[tag + "/cg"] = (sol.cpu(), r.iterations, r.matvecs)
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


def _dist_run(world, tmp_path):
    from repro_torch.testing.ranks import run_ranks

    x, v = _dist_problem()
    torch.cuda.empty_cache()
    run_ranks(_dist_rank, world, x, v, str(tmp_path), timeout=300)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.gpu
def test_distributed_solve_on_one_nccl_rank_matches_solve_on_card(card, tmp_path):
    x, v = _dist_problem()
    op = Gram(x=torch.from_numpy(x).cuda(), params=_dist_params())
    want_mv = op.mv(torch.from_numpy(v).cuda()).double().cpu()
    want = solve(op, torch.from_numpy(v).cuda(), CG(max_iters=18, tol=1e-12))
    (res,) = _dist_run(1, tmp_path)
    assert res["backend"] == "nccl"
    scale = max(1.0, want.solution.abs().max().item())
    for tag in ("gather", "gather_once", "ring"):
        assert res[tag + "/staged"] == 0
        assert (res[tag].double() - want_mv).abs().max().item() <= DIST_TOL * max(
            1.0, want_mv.abs().max().item())
        sol, iters, matvecs = res[tag + "/cg"]
        assert (iters, matvecs) == (18, 18)
        err = (sol.double() - want.solution.double().cpu()).abs().max().item()
        assert err <= DIST_TOL * scale, (tag, err)


@pytest.mark.gpu
def test_distributed_mv_on_two_ranks_sharing_the_card(card, tmp_path):
    from repro_torch.testing.ranks import RingOrderGram

    x, v = _dist_problem()
    ring_order = solve(RingOrderGram(x=torch.from_numpy(x).cuda(), params=_dist_params(),
                                     world=2),
                       torch.from_numpy(v).cuda(), CG(max_iters=18, tol=1e-12)).solution
    ring_order = ring_order.double().cpu()
    ranks = _dist_run(2, tmp_path)
    for res in ranks:
        assert res["backend"] == "gloo"
        ref = res["gather"].double()
        scale = max(1.0, ref.abs().max().item())
        for tag in ("gather_once", "ring"):
            assert (res[tag].double() - ref).abs().max().item() <= DIST_TOL * scale, tag
            assert res[tag + "/staged"] > 0  # gloo stages CUDA tensors through the host
        # gather_once contracts the same rows with the same launches as
        # gather: the same CG; ring sums a row over two launches, which fp32
        # CG carries far within 18 iterations: held against single-device CG
        # with the ring's row sums
        got, want = res["gather_once/cg"][0].double(), res["gather/cg"][0].double()
        assert (got - want).abs().max().item() <= DIST_TOL * max(1.0, want.abs().max().item())
        assert all(res[tag + "/cg"][1:] == (18, 18) for tag in ("gather", "gather_once", "ring"))
        got = res["ring/cg"][0].double()
        err = (got - ring_order).abs().max().item() / max(1.0, ring_order.abs().max().item())
        assert err <= DIST_CG_TOL, err
