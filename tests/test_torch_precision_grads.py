"""The port's bf16 gradients against the JAX reference's, on the CPU: every
VJP that runs a backward kernel at ``precision="bf16"`` — the pins
``ops.gram_matvec``, ``ops.rff_matvec`` and ``ops.rff_t_matvec``, and
``ops.gram_mv``, ``ops.gram_rows_pair`` and ``ops.rff_pair_mv`` — through the
reference's custom VJPs with its Pallas kernels in interpret mode
(``jax.grad``) and through the port's plain route (autograd of the same
Functions with the plain versions, ``kernels/ref.py``'s bf16 cast points) on
the same inputs, made with numpy from a seed.

Each leaf's gradient is held within GRAD_TOL of max(1, scale) of the
reference's, and its gap from its own fp32 gradient within GAP_RATIO × the
reference's bf16-vs-fp32 gap on the same inputs (or GAP_FLOOR). Matérn-1/2 runs on points of
a 1/8 grid (bf16-exact, every d² exact), Matérn-3/2 on normal points."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.kernels_fn import make_params as jmake_params
from repro.kernels import ops as jops
from repro_torch.convert import params_from_numpy
from repro_torch.core.kernels_fn import map_params
from repro_torch.kernels import ops
from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_bwd
from repro_torch.kernels.rff_matvec import rff_bwd

#: one bf16 ulp of a single entry, of max(1, scale): the packages round at
#: the same points and sum the rounded products in fp32 in other orders,
#: which now and then flips a bf16 rounding (measured ≤ 8.2e-4, most leaves
#: ~1e-6; the bf16-vs-fp32 gaps are 8e-4-8.5e-2)
GRAD_TOL = 2e-3
#: the port's bf16-vs-fp32 gap against the reference's own on the same inputs,
#: or GAP_FLOOR if larger: the two packages' fp32 gradients themselves differ
#: by up to 3.5e-4 of scale (summation order), so a gap below that is noise
GAP_RATIO, GAP_FLOOR = 1.5, 5e-4
KINDS = ["matern12", "matern32"]
ENTRIES = ["gram_matvec", "gram_mv", "gram_rows_pair", "rff_matvec", "rff_t_matvec",
           "rff_pair_mv"]
#: m = 128 frequencies, the reference's feature block: its pins pad ω to a
#: block and scale the cores by √(1/m_pad), then by √(m_pad/m_true) outside,
#: so with padding its bf16 roundings fall on other multiples than the
#: port's, whose kernels mask the feature edge (m_pad = m_true)
N, NT, P, M, S, D = 128, 64, 32, 128, 3, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def points(n):
        x = normal(n, D, scale=0.8)
        return np.round(x * 8) / 8 if kind == "matern12" else x

    return dict(x=points(N), xt=points(NT), v=normal(N, S), vt=normal(NT, S),
                look=normal(N, S), b=normal(P, S), w=normal(2 * M, S), u=normal(N, S),
                omega=normal(M, D, scale=1.2), idx=rng.integers(0, N, size=P),
                signal=np.float32(1.3), gbar_n=normal(N, S), gbar_p=normal(P, S),
                gbar_m=normal(2 * M, S))


def _jax_grads(name, kind, a, precision):
    """The reference's gradients, by leaf name, through its custom VJPs with
    the Pallas kernels in interpret mode."""
    params = jmake_params(kind, lengthscale=0.9, signal=1.2, noise=0.1, d=D)
    kw = dict(precision=precision, interpret=True, block=128)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if name == "gram_matvec":
        def f(p, x, v):
            return jnp.sum(j["gbar_n"] * jops.gram_matvec(p, x, v, **kw))
        args, leaves = (params, j["x"], j["v"]), ("params", "x", "v")
    elif name == "gram_mv":
        def f(p, x, xt, vt):
            out = jops.gram_mv(p, x, vt, z=xt, backend="pallas", **kw)
            return jnp.sum(j["gbar_n"] * out)
        args, leaves = (params, j["x"], j["xt"], j["vt"]), ("params", "x", "xt", "vt")
    elif name == "gram_rows_pair":
        def f(p, x, look, b):
            err, g = jops.gram_rows_pair(p, x, j["idx"], look, b, backend="pallas", **kw)
            return jnp.sum(j["gbar_p"] * err) + jnp.sum(j["gbar_n"] * g)
        args, leaves = (params, j["x"], j["look"], j["b"]), ("params", "x", "look", "b")
    elif name == "rff_matvec":
        def f(x, om, w, sig):
            return jnp.sum(j["gbar_n"] * jops.rff_matvec(x, om, w, signal=sig, **kw))
        args, leaves = (j["x"], j["omega"], j["w"], j["signal"]), ("x", "omega", "w", "signal")
    elif name == "rff_t_matvec":
        def f(x, om, u, sig):
            return jnp.sum(j["gbar_m"] * jops.rff_t_matvec(x, om, u, signal=sig, **kw))
        args, leaves = (j["x"], j["omega"], j["u"], j["signal"]), ("x", "omega", "u", "signal")
    else:
        def f(x, om, u, sig):
            out = jops.rff_pair_mv(x, om, u, signal=sig, backend="pallas", **kw)
            return jnp.sum(j["gbar_n"] * out)
        args, leaves = (j["x"], j["omega"], j["u"], j["signal"]), ("x", "omega", "u", "signal")
    grads = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    out = {}
    for leaf, g in zip(leaves, grads):
        if leaf == "params":
            out["log_lengthscale"] = np.asarray(g.log_lengthscale)
            out["log_signal"] = np.asarray(g.log_signal)
        else:
            out[leaf] = np.asarray(g)
    return out


def _torch_grads(name, kind, a, precision):
    """The port's gradients, by leaf name, through its plain route (CPU
    tensors) at the tile precision."""
    jp = jmake_params(kind, lengthscale=0.9, signal=1.2, noise=0.1, d=D)
    params = map_params(lambda t: t.requires_grad_(), params_from_numpy(
        np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal), np.asarray(jp.log_noise),
        kind, device="cpu"))
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    for k in ("x", "xt", "v", "vt", "look", "b", "w", "u", "omega", "signal"):
        t[k].requires_grad_()
    bf = dict(precision=precision)
    if name == "gram_matvec":
        loss = torch.sum(t["gbar_n"] * ops.gram_matvec(params, t["x"], t["v"], **bf))
        leaves = dict(x=t["x"], v=t["v"])
    elif name == "gram_mv":
        out = ops.gram_mv(params, t["x"], t["vt"], z=t["xt"], backend="cuda", **bf)
        loss = torch.sum(t["gbar_n"] * out)
        leaves = dict(x=t["x"], xt=t["xt"], vt=t["vt"])
    elif name == "gram_rows_pair":
        err, g = ops.gram_rows_pair(params, t["x"], t["idx"], t["look"], t["b"],
                                    backend="cuda", **bf)
        loss = torch.sum(t["gbar_p"] * err) + torch.sum(t["gbar_n"] * g)
        leaves = dict(x=t["x"], look=t["look"], b=t["b"])
    else:
        sig, kw = t["signal"], dict(signal=t["signal"], **bf)
        if name == "rff_matvec":
            loss = torch.sum(t["gbar_n"] * ops.rff_matvec(t["x"], t["omega"], t["w"], **kw))
            leaves = dict(x=t["x"], omega=t["omega"], w=t["w"], signal=sig)
        elif name == "rff_t_matvec":
            loss = torch.sum(t["gbar_m"] * ops.rff_t_matvec(t["x"], t["omega"], t["u"], **kw))
            leaves = dict(x=t["x"], omega=t["omega"], u=t["u"], signal=sig)
        else:
            out = ops.rff_pair_mv(t["x"], t["omega"], t["u"], backend="cuda", **kw)
            loss = torch.sum(t["gbar_n"] * out)
            leaves = dict(x=t["x"], omega=t["omega"], u=t["u"], signal=sig)
    if name.startswith("gram"):
        leaves = dict(log_lengthscale=params.log_lengthscale, log_signal=params.log_signal,
                      **leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.detach().numpy() for k, g in zip(leaves, grads)}


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ENTRIES)
def test_bf16_vjps_match_the_reference(name, kind):
    a = _inputs(kind, seed=ENTRIES.index(name) + 10 * KINDS.index(kind))
    ref = {prec: _jax_grads(name, kind, a, prec) for prec in ("bf16", "fp32")}
    port = {prec: _torch_grads(name, kind, a, prec) for prec in ("bf16", "fp32")}
    assert set(port["bf16"]) == set(ref["bf16"])
    for leaf in ref["bf16"]:
        assert np.isfinite(port["bf16"][leaf]).all()
        assert _scaled_err(port["bf16"][leaf], ref["bf16"][leaf]) <= GRAD_TOL, leaf
        ref_gap = _scaled_err(ref["bf16"][leaf], ref["fp32"][leaf])
        port_gap = _scaled_err(port["bf16"][leaf], port["fp32"][leaf])
        assert port_gap <= max(GAP_RATIO * ref_gap, GAP_FLOOR), leaf


def test_bf16_vjps_run_the_plain_versions_on_the_cpu():
    # the plain route: CPU tensors launch nothing, at either precision
    a = _inputs("matern32", seed=99)
    before = (gram_matvec.launches, gram_matvec.bf16_launches, gram_matvec_bwd.launches,
              gram_matvec_bwd.bf16_launches, rff_bwd.launches, rff_bwd.bf16_launches)
    for name in ("gram_matvec", "rff_pair_mv"):
        _torch_grads(name, "matern32", a, "bf16")
    assert (gram_matvec.launches, gram_matvec.bf16_launches, gram_matvec_bwd.launches,
            gram_matvec_bwd.bf16_launches, rff_bwd.launches, rff_bwd.bf16_launches) == before


def test_pins_match_the_reference_forward():
    # the three pins' values at both precisions, σ_f² and √(m_pad/m_true)
    # outside the core as in the reference (its ω padded to its block, the
    # port's kernel masking the feature edge)
    a = _inputs("matern32", seed=7)
    jp = jmake_params("matern32", lengthscale=0.9, signal=1.2, noise=0.1, d=D)
    tp = params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                           np.asarray(jp.log_noise), "matern32", device="cpu")
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    for prec, tol in (("fp32", 2e-4), ("bf16", 2e-3)):
        kw = dict(precision=prec)
        pairs = (
            (ops.gram_matvec(tp, t["x"], t["v"], jitter=0.3, **kw),
             jops.gram_matvec(jp, jnp.asarray(a["x"]), jnp.asarray(a["v"]), jitter=0.3,
                              interpret=True, **kw)),
            (ops.rff_matvec(t["x"], t["omega"], t["w"], signal=1.3, **kw),
             jops.rff_matvec(jnp.asarray(a["x"]), jnp.asarray(a["omega"]),
                             jnp.asarray(a["w"]), signal=1.3, interpret=True, **kw)),
            (ops.rff_t_matvec(t["x"], t["omega"], t["u"], signal=1.3, **kw),
             jops.rff_t_matvec(jnp.asarray(a["x"]), jnp.asarray(a["omega"]),
                               jnp.asarray(a["u"]), signal=1.3, interpret=True, **kw)),
        )
        for got, want in pairs:
            assert _scaled_err(got.detach().numpy(), want) <= tol
