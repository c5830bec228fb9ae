"""The port's MoE, MLA and Mamba2 (SSD) modules and jamba's period plan
(repro_torch.models.moe, .ssm, .attention's MLA, .model) against the JAX
package on the CPU: the reference's own draws, carried across by
``convert.lm_params_from_numpy``, and the same numpy inputs through both.
Twins of tests/test_models.py:15,33,93,121,141,160,167 and
tests/test_archs_smoke.py:29,40 for dbrx-132b, deepseek-v2-236b,
mamba2-130m and jamba-1.5-large-398b, reduced (2 layers; jamba its one
8-layer period).

Tolerances: 1e-4 of max(1, max|ref|) for every module's and model's
outputs, each gradient leaf within 1e-4 of its own scale and the loss within
1e-6 relative (PR 24's train-step tolerances); the reference's own
tolerances where it sets them (SSD against the sequential scan 2e-3, the
split scan 3e-3, prefill/decode against forward 5e-2 / 5e-3, absorbed MLA
2e-2 / 2e-3). Routing compares sets of experts, so each MoE comparison
first checks that the reference's k-th and (k+1)-th gates are apart by more
than MARGIN: torch's ``topk`` and JAX's ``top_k`` break ties differently.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import token_batch as jtoken_batch
from repro.launch.steps import _next_token_loss as jnext_token_loss
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.param import init_params as jinit_params
from repro.train import checkpoint as jckpt
from repro.train.optim import AdamWConfig as JAdamWConfig
from repro.train.optim import init_opt_state as jinit_opt_state
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, opt_state_from_numpy
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import attention, moe, ssm
from repro_torch.models import model as tmodel
from repro_torch.models.param import leaves
from repro_torch.train import (
    AdamWConfig, Trainer, TrainerConfig, init_opt_state, latest_step, restore_checkpoint,
)
from repro_torch.train.optim import leaves as opt_leaves

TOL = 1e-4
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-4
CONSIST_RTOL, CONSIST_ATOL = 5e-2, 5e-3  # tests/test_models.py:114,118
MARGIN = 1e-5
ARCHS = ["dbrx-132b", "deepseek-v2-236b", "mamba2-130m", "jamba-1.5-large-398b"]


@pytest.fixture(autouse=True)
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"max|Δ| {err} > {tol} × {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, static=(0,)):
    """The reference's function jitted, its config (and mode) static: one
    compile where its eager scans compile op by op."""
    return jax.jit(fn, static_argnums=static)


def _overrides(arch):
    return {} if arch.startswith("jamba") else {"num_layers": 2}


@pytest.fixture(scope="module")
def pairs():
    """arch → (reference cfg, reference params, port cfg, port model on the CPU),
    built once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced(**_overrides(arch))
        params = _jit(jmodel.init_model_params)(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced(**_overrides(arch))
        out[arch] = (jcfg, params, cfg, lm_params_from_numpy(cfg, _np(params), device="cpu"))
    return out


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# -------------------------------------------------------------------- SSD ----


def _ssd_inputs(seed, b, s, h, p, n, a_scale=0.3, d_skip=1.0):
    """tests/test_models.py:17-26's shapes and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(b, s, h)).astype(np.float32)))
    a_log = (a_scale * rng.normal(size=(h,))).astype(np.float32)
    bm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    cm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    return x, dt, a_log, bm, cm, np.full((h,), d_skip, np.float32)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_sequential_and_the_reference(chunk):
    inputs = _ssd_inputs(0, 2, 64, 3, 8, 16)
    y_ref, h_ref = jssm.ssd_chunked(*map(jnp.asarray, inputs), chunk)
    y, h = ssm.ssd_chunked(*map(_t, inputs), chunk)
    _close(y, y_ref)
    _close(h, h_ref)
    y_seq, h_seq = ssm.ssm_scan_ref(*map(_t, inputs))
    ys_ref, hs_ref = jssm.ssm_scan_ref(*map(jnp.asarray, inputs))
    _close(y_seq, ys_ref)
    _close(h_seq, hs_ref)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), h_seq.numpy(), rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.ssd_chunked(*map(_t, _ssd_inputs(0, 1, 36, 3, 8, 16)), 32)


def test_ssd_initial_state_continuation():
    """Splitting a sequence in half and carrying the state == one long scan
    (tests/test_models.py:33), and each half equal to the reference's."""
    x, dt, a_log, bm, cm, d = map(_t, _ssd_inputs(1, 1, 32, 2, 4, 8, d_skip=0.0))
    y_full, h_full = ssm.ssd_chunked(x, dt, a_log, bm, cm, d, 8)
    y1, h1 = ssm.ssd_chunked(x[:, :16], dt[:, :16], a_log, bm[:, :16], cm[:, :16], d, 8)
    y2, h2 = ssm.ssd_chunked(x[:, 16:], dt[:, 16:], a_log, bm[:, 16:], cm[:, 16:], d, 8, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), rtol=3e-3, atol=3e-3)
    j = [jnp.asarray(a.numpy()) for a in (x, dt, a_log, bm, cm, d)]
    jy2, jh2 = jssm.ssd_chunked(*(a[:, 16:] if a.ndim > 1 else a for a in j), 8,
                                h0=jnp.asarray(h1.numpy()))
    _close(y2, jy2)
    _close(h2, jh2)


def test_ssd_gradient_is_finite_where_the_references_overflows():
    """A limit of the reference: at a chunk of 256 with a_log = 1 (the init)
    the decay summed over a chunk passes ~88, exp overflows above the
    diagonal, and the reference's gradient there is 0·∞ = NaN. The port
    masks before the exponential: the same forward, and a finite gradient
    equal to the reference's own at a chunk of 32, where it does not
    overflow."""
    x, dt, _, bm, cm, d = _ssd_inputs(2, 1, 256, 2, 4, 8)
    a_log = np.ones((2,), np.float32)

    def jloss(chunk):
        def f(dtv):
            y, _ = jssm.ssd_chunked(jnp.asarray(x), dtv, jnp.asarray(a_log), jnp.asarray(bm),
                                    jnp.asarray(cm), jnp.asarray(d), chunk)
            return jnp.sum(y)
        return jax.value_and_grad(f)(jnp.asarray(dt))

    ref256, g256 = jloss(256)
    ref32, g32 = jloss(32)
    assert np.isnan(np.asarray(g256)).any() and np.isfinite(np.asarray(g32)).all()
    tdt = _t(dt).requires_grad_(True)
    y, _ = ssm.ssd_chunked(_t(x), tdt, _t(a_log), _t(bm), _t(cm), _t(d), 256)
    (g,) = torch.autograd.grad(y.sum(), tdt)
    assert abs(y.sum().item() - float(ref256)) <= TOL * abs(float(ref256))
    assert torch.isfinite(g).all()
    _close(g, g32)


def test_causal_conv_and_mamba_apply_match_in_every_mode(pairs):
    jcfg, params, cfg, model = pairs["mamba2-130m"]
    jp = jax.tree.map(lambda a: a[0], params["layers"]["mixer"])
    tp = model.layers[0].mixer
    b, s = 2, 12
    rng = np.random.default_rng(3)
    h = rng.normal(size=(b, s + 1, cfg.d_model)).astype(np.float32)
    w = np.asarray(jp["conv_w"])
    xc = rng.normal(size=(b, s, w.shape[1])).astype(np.float32)
    cb = np.linspace(-0.5, 0.5, w.shape[1]).astype(np.float32)  # a nonzero bias
    _close(ssm._causal_conv(_t(xc), _t(w), _t(cb)),
           jssm._causal_conv(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(cb)))

    jmamba = _jit(jssm.mamba_apply, (1, 3))
    ref, _ = jmamba(jp, jcfg, jnp.asarray(h), "train")
    with torch.no_grad():
        out, _ = ssm.mamba_apply(tp, cfg, _t(h), "train")
    _close(out, ref)
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          jssm.mamba_make_cache(jcfg, b, jnp.float32))
    tcache = ssm.mamba_make_cache(cfg, b)
    ref, jcache = jmamba(jp, jcfg, jnp.asarray(h[:, :s]), "prefill", jcache)
    with torch.no_grad():
        out, tcache = ssm.mamba_apply(tp, cfg, _t(h[:, :s]), "prefill", tcache)
    _close(out, ref)
    for k in ("conv", "ssm"):
        _close(tcache[k], jcache[k])
    assert tcache["ssm"].dtype == torch.float32
    ref, jcache = jmamba(jp, jcfg, jnp.asarray(h[:, s:]), "decode", jcache, jnp.asarray(s))
    with torch.no_grad():
        out, tcache = ssm.mamba_apply(tp, cfg, _t(h[:, s:]), "decode", tcache, s)
    _close(out, ref)
    for k in ("conv", "ssm"):
        _close(tcache[k], jcache[k])


# -------------------------------------------------------------------- MoE ----


def _moe_pair(arch, seed=0):
    jcfg = jget_config(arch).reduced(num_layers=2)
    cfg = get_config(arch).reduced(num_layers=2)
    p = _np(jinit_params(jmoe.moe_params(jcfg), jax.random.PRNGKey(seed)))
    return jcfg, p, cfg, tmodel._parameters(jax.tree.map(_t, p))


def _assert_routing_margin(jcfg, p, x):
    """The reference's gates: the k-th and (k+1)-th apart by more than MARGIN
    for every token of every group of ``x`` (b, t, d)."""
    logits = jnp.asarray(x) @ jnp.asarray(p["router"])
    top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.experts_per_tok + 1)[0]
    k = jcfg.experts_per_tok
    assert float(jnp.min(top[..., k - 1] - top[..., k])) > MARGIN


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_apply_matches(arch, mode):
    """Per-row groups (train, prefill) and one group over the batch (decode,
    s = 1, another capacity); deepseek-v2's shared experts."""
    jcfg, p, cfg, tp = _moe_pair(arch)
    s = 24 if mode == "train" else 1
    x = (0.5 * np.random.default_rng(4).normal(size=(6, s, cfg.d_model))).astype(np.float32)
    _assert_routing_margin(jcfg, p, x.reshape(1, -1, cfg.d_model))
    ref = _jit(jmoe.moe_apply, (1,))(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    with torch.no_grad():
        out = moe.moe_apply(tp, cfg, _t(x))
    _close(out, ref)
    assert ("shared" in tp) == (arch == "deepseek-v2-236b")


def _reference_slot_table(jcfg, p, xg):
    """The reference's dispatch table, its own lines (moe.py:50-75 there):
    the duplicate-index scatters, run as XLA runs them on the CPU."""
    g, t, _ = xg.shape
    e, k = jcfg.num_experts, jcfg.experts_per_tok
    cap = jmoe._capacity(jcfg, t)
    logits = (xg @ p["router"]).astype(jnp.float32)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat_e = expert_idx.reshape(g, t * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=1) - onehot
    slot = jnp.take_along_axis(ranks, flat_e[..., None], axis=2)[..., 0]
    keep = slot < cap
    buf_pos = flat_e * cap + jnp.where(keep, slot, cap - 1)
    src = jnp.broadcast_to(jnp.repeat(jnp.arange(t), k)[None], (g, t * k))
    token = jnp.zeros((g, e * cap), jnp.int32).at[jnp.arange(g)[:, None], buf_pos].set(
        jnp.where(keep, src, 0), mode="drop")
    filled = jnp.zeros((g, e * cap), bool).at[jnp.arange(g)[:, None], buf_pos].set(
        keep, mode="drop")
    return np.asarray(token), np.asarray(filled), np.asarray(slot), np.asarray(flat_e), cap


def test_moe_overflow_clears_the_last_slot_as_the_reference_does():
    """A reduced dbrx group of 64 tokens (cap 40) that overflows experts: the
    port's dispatch table equals the reference's, in which slot cap − 1 of
    each overflowing expert ends empty although a kept copy lives there (its
    output is zero, its gate still counts), and so do the outputs."""
    jcfg, p, cfg, tp = _moe_pair("dbrx-132b")
    rng = np.random.default_rng(5)  # tokens that share a direction crowd some experts
    x = (0.5 * rng.normal(size=(1, 64, cfg.d_model)) + rng.normal(size=cfg.d_model)
         ).astype(np.float32)
    _assert_routing_margin(jcfg, p, x)
    token, filled, slot, flat_e, cap = _reference_slot_table(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert cap == 40
    counts = np.bincount(flat_e[0], minlength=cfg.num_experts)
    over = np.flatnonzero(counts > cap)
    assert over.size >= 1
    for ex in over:
        kept_last = (flat_e[0] == ex) & (slot[0] == cap - 1)
        assert kept_last.sum() == 1  # a kept copy lives in the last slot ...
        assert not filled[0, ex * cap + cap - 1] and token[0, ex * cap + cap - 1] == 0  # ... empty
    with torch.no_grad():
        gates, t_flat_e, t_slot, t_cap = moe.route(tp, cfg, _t(x))
        t_token, t_filled = moe._slot_table(t_flat_e, cfg.experts_per_tok, cfg.num_experts,
                                            t_cap)
        out = moe.moe_apply(tp, cfg, _t(x))
    assert t_cap == cap
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    np.testing.assert_array_equal(t_filled.numpy(), filled)
    np.testing.assert_array_equal(t_token.numpy(), token)
    ref = _jit(jmoe.moe_apply, (1,))(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    _close(out, ref)


def test_moe_routing_mass_conservation():
    """tests/test_models.py:121 on the port: doubling every expert's output
    projection doubles the routed output."""
    _, _, cfg, tp = _moe_pair("dbrx-132b")
    x = (0.5 * torch.from_numpy(np.random.default_rng(6).normal(size=(2, 8, cfg.d_model)))
         ).float()
    with torch.no_grad():
        y = moe.moe_apply(tp, cfg, x)
        tp2 = tmodel._parameters({k: (2.0 * v if k == "down" else v) for k, v in tp.items()})
        y2 = moe.moe_apply(tp2, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    np.testing.assert_allclose(y2.numpy(), 2.0 * y.numpy(), rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- MLA ----


def _mla_case(pairs, seed, b, s):
    jcfg, params, cfg, model = pairs["deepseek-v2-236b"]
    jp = jax.tree.map(lambda a: a[0], params["layers"]["mixer"])
    h = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return jcfg, jp, cfg, model.layers[0].mixer, h, pos


def test_mla_apply_matches_in_every_mode(pairs):
    import dataclasses

    jcfg, jp, cfg, tp, h, pos = _mla_case(pairs, 7, 2, 13)
    s, total = 12, 16
    jmla = _jit(jattn.mla_apply, (1, 4))
    ref, _ = jmla(jp, jcfg, jnp.asarray(h), jnp.asarray(pos), "train")
    with torch.no_grad():
        out, _ = attention.mla_apply(tp, cfg, _t(h), _t(pos), "train")
    _close(out, ref)
    jcache = {"ckv": jnp.zeros((2, total, cfg.kv_lora_rank)),
              "krope": jnp.zeros((2, total, cfg.qk_rope_dim))}
    tcache = attention.mla_make_cache(cfg, 2, total)
    ref, jcache = jmla(jp, jcfg, jnp.asarray(h[:, :s]), jnp.asarray(pos[:, :s]), "prefill",
                       jcache)
    with torch.no_grad():
        out, tcache = attention.mla_apply(tp, cfg, _t(h[:, :s]), _t(pos[:, :s]), "prefill",
                                          tcache)
    _close(out, ref)
    for absorb in (False, True):
        jc, tc = dataclasses.replace(jcfg, mla_absorb=absorb), dataclasses.replace(
            cfg, mla_absorb=absorb)
        ref, jnew = jmla(jp, jc, jnp.asarray(h[:, s:]), jnp.asarray(pos[:, s:]), "decode",
                         jcache, jnp.asarray(s))
        tcopy = {k: v.clone() for k, v in tcache.items()}
        with torch.no_grad():
            out, tcopy = attention.mla_apply(tp, tc, _t(h[:, s:]), _t(pos[:, s:]), "decode",
                                             tcopy, s)
        _close(out, ref)
        for k in ("ckv", "krope"):
            _close(tcopy[k], jnew[k])


def test_mla_streams_query_blocks_past_512(pairs):
    """Past _Q_CHUNK = 512 rows both packages attend in 512-row query blocks
    (the reference's lax.scan, :275 there) against the whole key range."""
    jcfg, jp, cfg, tp, h, pos = _mla_case(pairs, 8, 1, 1024)
    ref, _ = _jit(jattn.mla_apply, (1, 4))(jp, jcfg, jnp.asarray(h), jnp.asarray(pos), "train")
    with torch.no_grad():
        out, _ = attention.mla_apply(tp, cfg, _t(h), _t(pos), "train")
    _close(out, ref)
    with pytest.raises(ValueError, match="multiple"):
        attention.mla_apply(tp, cfg, _t(h[:, :700]), _t(pos[:, :700]), "train")


def test_mla_absorbed_matches_baseline(pairs):
    """tests/test_models.py:167 on the port, on the reference's params."""
    import dataclasses

    _, _, cfg, model = pairs["deepseek-v2-236b"]
    cfg_a = dataclasses.replace(cfg, mla_absorb=True)
    b, s = 2, 12
    tokens = torch.from_numpy(_tokens(cfg, 9, b, s))
    with torch.no_grad():
        cache = tmodel.zero_cache(cfg, b, s + 2, device="cpu")
        _, cache = tmodel.prefill(cfg, model, {"tokens": tokens}, cache)
        tok = tokens[:, -1:]
        base, _ = tmodel.decode_step(cfg, model, tok, {k: [dict(c) for c in v]
                                                       for k, v in cache.items()}, s)
        absorbed, _ = tmodel.decode_step(cfg_a, model, tok, cache, s)
    np.testing.assert_allclose(absorbed.numpy(), base.numpy(), rtol=2e-2, atol=2e-3)


# ----------------------------------------------------------------- models ----


@pytest.fixture(scope="module")
def ref_logits(pairs):
    """arch → (tokens (2, 32), the reference's forward_train logits)."""
    out = {}
    for arch in ARCHS:
        jcfg, params, cfg, _ = pairs[arch]
        tokens = _tokens(cfg, 10, 2, 32)
        out[arch] = tokens, np.asarray(_jit(jmodel.forward_train)(
            jcfg, params, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_the_reference(arch, pairs, ref_logits):
    _, _, cfg, model = pairs[arch]
    tokens, ref = ref_logits[arch]
    with torch.no_grad():
        out = tmodel.forward_train(cfg, model, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, 32, cfg.vocab_size) and torch.isfinite(out).all()
    _close(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_the_reference(arch, pairs):
    jcfg, params, cfg, model = pairs[arch]
    b, prompt = 2, 16
    tokens = _tokens(cfg, 11, b, prompt)
    ref, jcache = _jit(jmodel.prefill)(jcfg, params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                       jmodel.zero_cache(jcfg, b, prompt + 4, jnp.float32))
    with torch.no_grad():
        cache = tmodel.zero_cache(cfg, b, prompt + 4, device="cpu")
        out, cache = tmodel.prefill(cfg, model, {"tokens": torch.from_numpy(tokens)}, cache)
    _close(out, ref)
    assert sorted(cache) == sorted(jcache)
    nxt = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
    ref, _ = _jit(jmodel.decode_step)(jcfg, params, jnp.asarray(nxt, jnp.int32), jcache,
                                      jnp.asarray(prompt))
    with torch.no_grad():
        out, _ = tmodel.decode_step(cfg, model, torch.from_numpy(nxt), cache, prompt)
    _close(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py:93 on the port's own draws: forward_train's
    logits at positions s − 2 and s − 1 equal prefill(≤ s − 2)'s and
    decode_step(s − 1)'s."""
    cfg = get_config(arch).reduced(remat=False, **_overrides(arch))
    model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(_tokens(cfg, 12, b, s))
    with torch.no_grad():
        full = model(tokens)
        cache = tmodel.zero_cache(cfg, b, s + 4, device="cpu")
        pre, cache = tmodel.prefill(cfg, model, {"tokens": tokens[:, :-1]}, cache)
        dec, _ = tmodel.decode_step(cfg, model, tokens[:, -1:], cache, s - 1)
    torch.testing.assert_close(pre[:, -1], full[:, -2], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    a = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree
    return {prefix: np.asarray(a, dtype=np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, pairs):
    """One train step (tests/test_archs_smoke.py:40, mu float32): the loss and
    every gradient leaf against jax.value_and_grad of the reference's; then
    the port's step moves the parameters, finite, at step 1."""
    jcfg, params, cfg, _ = pairs[arch]
    model = lm_params_from_numpy(cfg, _np(params), device="cpu")
    batch = jtoken_batch(0, 3, 2, 32, jcfg.vocab_size)

    def jloss(p):
        return jnext_token_loss(jcfg, jmodel.forward_train(jcfg, p, batch), batch["labels"])

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(params)
    ref_g = _flat(_np(ref_g))
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}
    loss, grads = loss_and_grads(cfg, model, tb)
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    got_g = _flat(tmodel.leaf_tree(model, grads))
    assert got_g.keys() == ref_g.keys()
    for k, g in ref_g.items():
        assert np.isfinite(got_g[k]).all(), k
        assert np.abs(got_g[k] - g).max() <= GRAD_TOL * max(np.abs(g).max(), 1e-30), k

    before = [t.clone() for t in opt_leaves(model)]
    opt_cfg = AdamWConfig(mu_dtype=torch.float32)
    model, opt, out = make_train_step(cfg, opt_cfg)(model, init_opt_state(model, opt_cfg), tb)
    assert int(out["step"]) == 1 and np.isfinite(out["loss"].item())
    assert any(not torch.equal(a, b) for a, b in zip(before, opt_leaves(model)))
    assert all(torch.isfinite(t).all() for t in opt_leaves(model))


# ------------------------------------------------------- params, convert ----


@pytest.mark.parametrize("arch", list_configs())
def test_param_counts_match_the_reference(arch):
    """count_params and active_param_count for all ten configs
    (tests/test_models.py:141,160), allocating nothing."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tmodel.count_params(cfg) == jmodel.count_params(jcfg)
    assert tmodel.active_param_count(cfg) == jmodel.active_param_count(jcfg)
    if arch == "dbrx-132b":
        assert tmodel.active_param_count(cfg) < 0.45 * tmodel.count_params(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, pairs):
    """The reference's pytree across and back, bit for bit and in its
    structure (jamba's period leaves (n, 7, …), MoE's nested ``shared``)."""
    _, params, cfg, model = pairs[arch]
    ref = _np(params)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    paths = [(p, len(ts)) for p, ts in tmodel.lm_leaves(model)]
    assert [p for p, _ in paths] == ["/".join(p) for p, _ in leaves(tmodel.param_schema(cfg))]
    if arch.startswith("jamba"):
        assert dict(paths)["layers/mamba_blocks/mixer/in_proj"] == 7
        assert dict(paths)["layers/moe_mlps/mlp/gate"] == 4
        assert back["layers"]["mamba_blocks"]["mixer"]["in_proj"].shape[:2] == (1, 7)


def test_reference_checkpoint_of_a_period_model_restores_in_the_port(tmp_path, pairs):
    """The reference's checkpoint of jamba's params and optimiser state
    (its stacked (n, 7, …) leaves) restored by the port bit for bit."""
    jcfg, params, cfg, _ = pairs["jamba-1.5-large-398b"]
    jopt = jinit_opt_state(params, JAdamWConfig(mu_dtype=jnp.float32))
    jopt = jopt._replace(nu=jax.tree.map(lambda p: p * p, params))
    jckpt.save_checkpoint(str(tmp_path), 3, {"p": params, "o": jopt})
    template_model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(1),
                                              device="cpu")
    template = {"p": template_model,
                "o": init_opt_state(template_model, AdamWConfig(mu_dtype=torch.float32))}
    got, step, _ = restore_checkpoint(str(tmp_path), template)
    assert step == 3
    jax.tree.map(np.testing.assert_array_equal, lm_params_to_numpy(got["p"]), _np(params))
    want = opt_state_from_numpy(cfg, _np(jopt.mu), _np(jopt.nu), np.asarray(jopt.step),
                                device="cpu")
    for a, b in zip(opt_leaves(got["o"].nu), opt_leaves(want.nu)):
        assert torch.equal(a, b)


def test_period_model_kill_and_resume_is_bit_exact(tmp_path):
    """Kill-and-resume of a jamba model (one period, narrowed) reproduces the
    uninterrupted run bit for bit: losses, parameters, moments."""
    cfg = get_config("jamba-1.5-large-398b").reduced(d_model=64, d_ff=128, moe_d_ff=64,
                                                     ssm_state=16, ssm_head_dim=16,
                                                     vocab_size=128)

    def make(steps, name):
        return Trainer(cfg, TrainerConfig(batch=2, seq_len=32, num_steps=steps, log_every=0,
                                          ckpt_dir=str(tmp_path / name), ckpt_every=2,
                                          opt=AdamWConfig(lr=1e-3, warmup_steps=2)),
                       device="cpu")

    p_full, o_full = make(4, "full").run()
    make(2, "resume").run()
    assert latest_step(str(tmp_path / "resume")) == 2
    resumed = make(4, "resume")
    p_res, o_res = resumed.run()
    assert len(resumed.losses) == 4 and np.isfinite(resumed.losses).all()
    for a, b in zip(opt_leaves(p_full) + opt_leaves(o_full.mu) + opt_leaves(o_full.nu),
                    opt_leaves(p_res) + opt_leaves(o_res.mu) + opt_leaves(o_res.nu)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- launchers ----


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_run_on_the_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
        tr = launch_train.main(["--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
                                "--seq-len", "16", "--device", "cpu"])
    assert "[serve] generated (2, 3)" in buf.getvalue()
    assert len(tr.losses) == 1 and np.isfinite(tr.losses).all()
