"""The port's LM serving path (repro_torch.models, repro_torch.launch) against
the JAX package on the CPU: the same params (the reference's own draws,
carried across by ``convert.lm_params_from_numpy``) and the same numpy tokens
through both.

Tolerances: 1e-4 of max(1, max|ref|) for the layers, the attention and the
reduced models' logits. Both packages compute in fp32; RoPE's frequencies are
bit-identical and only the last ulps of sin and cos at hundreds of radians
differ (θ = 500,000, positions to 2,048), which the tolerance covers: the
logits agree to ~2e-6 of their scale.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config, list_configs as jlist_configs
from repro.data.pipeline import token_batch as jtoken_batch
from repro.launch.serve import generate as jgenerate
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data.pipeline import token_batch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import _FlashAttentionFn
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models import model as tmodel
from repro_torch.models.param import P, leaves

TOL = 1e-4
#: the reference's own prefill/decode-vs-forward tolerances (tests/test_models.py:114,118)
CONSIST_RTOL, CONSIST_ATOL = 5e-2, 5e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"max|Δ| {err} > {tol} × {scale}"


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _jax_model(arch, **overrides):
    """(reference cfg, reference params, port cfg, port model on the CPU)."""
    jcfg = jget_config(arch).reduced(**overrides)
    params = jmodel.init_model_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**overrides)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, cfg, model


# ------------------------------------------------------------------ layers ----


@pytest.mark.parametrize("parametric", [True, False])
def test_rmsnorm_matches(parametric):
    x = _normal(0, 2, 5, 256, scale=3.0)
    p = {"scale": _normal(1, 256)} if parametric else {}  # OLMo: non-parametric
    ref = jlayers.rmsnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5)
    out = layers.rmsnorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), 1e-5)
    _close(out, ref)


def test_rope_matches_at_llama3_theta_to_position_2048():
    x = _normal(2, 2, 2049, 4, 128)
    pos = np.broadcast_to(np.arange(2049), (2, 2049))
    freqs = layers.rope_freqs(128, 500_000.0)
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(jlayers.rope_freqs(128, 500_000.0)))
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 500_000.0)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 500_000.0)
    _close(out, ref)


def test_mlp_embed_unembed_match():
    d, ff, vocab = 256, 512, 300
    p = {"gate": _normal(3, d, ff, scale=d ** -0.5), "up": _normal(4, d, ff, scale=d ** -0.5),
         "down": _normal(5, ff, d, scale=ff ** -0.5)}
    x = _normal(6, 2, 5, d)
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa: E731
    _close(layers.mlp(t(p), torch.from_numpy(x)), jlayers.mlp(j(p), jnp.asarray(x)))
    tokens = np.random.default_rng(7).integers(0, vocab, (2, 5))
    for e in ({"tok": _normal(8, vocab, d, scale=0.02)},  # tied: tokᵀ unembeds
              {"tok": _normal(8, vocab, d, scale=0.02), "unembed": _normal(9, d, vocab)}):
        h = layers.embed(t(e), torch.from_numpy(tokens))
        _close(h, jlayers.embed(j(e), jnp.asarray(tokens)))
        _close(layers.unembed(t(e), h), jlayers.unembed(j(e), jnp.asarray(h.numpy())))


def test_gqa_apply_matches_in_every_mode():
    cfg = get_config("llama3-8b").reduced()  # 4 heads → 2 kv heads, head_dim 64, θ 500,000
    jcfg = jget_config("llama3-8b").reduced()
    b, s, total = 2, 12, 16
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    p = {"wq": _normal(10, d, hd, scale=d ** -0.5), "wk": _normal(11, d, kvd, scale=d ** -0.5),
         "wv": _normal(12, d, kvd, scale=d ** -0.5), "wo": _normal(13, hd, d, scale=hd ** -0.5)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    h = _normal(14, b, s + 1, d)
    pos = np.broadcast_to(np.arange(s + 1), (b, s + 1)).copy()

    ref, _ = jattn.gqa_apply(jp, jcfg, jnp.asarray(h), jnp.asarray(pos), "train")
    out, _ = attention.gqa_apply(tp, cfg, torch.from_numpy(h), torch.from_numpy(pos), "train")
    _close(out, ref)

    jcache = {k: jnp.zeros((b, total, cfg.num_kv_heads, cfg.head_dim)) for k in ("k", "v")}
    tcache = attention.gqa_make_cache(cfg, b, total)
    ref, jcache = jattn.gqa_apply(jp, jcfg, jnp.asarray(h[:, :s]), jnp.asarray(pos[:, :s]),
                                  "prefill", jcache)
    out, tcache = attention.gqa_apply(tp, cfg, torch.from_numpy(h[:, :s]),
                                      torch.from_numpy(pos[:, :s]), "prefill", tcache)
    _close(out, ref)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])
    ref, jcache = jattn.gqa_apply(jp, jcfg, jnp.asarray(h[:, s:]), jnp.asarray(pos[:, s:]),
                                  "decode", jcache, jnp.asarray(s))
    out, tcache = attention.gqa_apply(tp, cfg, torch.from_numpy(h[:, s:]),
                                      torch.from_numpy(pos[:, s:]), "decode", tcache, s)
    _close(out, ref)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])


@pytest.fixture
def flash_function_on_cpu(monkeypatch):
    """``ops.flash_attention``'s kernel route on CPU tensors through
    ``_FlashAttentionFn``, the plain version as its forward: the autograd
    chain the card takes, its backward's recomputation included. Yields the
    list of the Function's forward calls."""
    calls = []

    def fwd(q, k, v, *, causal):
        calls.append(q.shape)
        return flash_attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "_flash_kernel", lambda q, k, v, *, causal: _FlashAttentionFn.apply(
        q, k, v, causal, fwd))
    ops.reset_attention_trace_counts()
    yield calls


def _close_grads(grads, ref_grads, tol=TOL):
    """Each gradient within ``tol`` of its own largest reference entry."""
    for (name, g), r in zip(grads.items(), ref_grads):
        r = np.asarray(r)
        err = float(np.abs(np.asarray(g) - r).max())
        scale = float(np.abs(r).max())
        assert scale > 0 and err <= tol * scale, f"{name}: max|Δ| {err} > {tol} × {scale}"


def test_gqa_apply_train_gradients_match_the_reference(flash_function_on_cpu):
    # ∂/∂(h, wq, wk, wv, wo) of ⟨ḡ, gqa_apply(…, "train")⟩, through the
    # flash Function here and jax.grad of the reference's _sdpa there
    cfg = get_config("llama3-8b").reduced()
    jcfg = jget_config("llama3-8b").reduced()
    b, s = 2, 70  # past one 64-row query tile
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    p = {"wq": _normal(20, d, hd, scale=d ** -0.5), "wk": _normal(21, d, kvd, scale=d ** -0.5),
         "wv": _normal(22, d, kvd, scale=d ** -0.5), "wo": _normal(23, hd, d, scale=hd ** -0.5)}
    h, gbar = _normal(24, b, s, d), _normal(25, b, s, d)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()

    def jloss(jp, jh):
        out, _ = jattn.gqa_apply(jp, jcfg, jh, jnp.asarray(pos), "train")
        return jnp.sum(jnp.asarray(gbar) * out)

    ref_p, ref_h = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    th = torch.from_numpy(h).requires_grad_()
    out, _ = attention.gqa_apply(tp, cfg, th, torch.from_numpy(pos), "train", backend="cuda")
    grads = torch.autograd.grad(torch.sum(torch.from_numpy(gbar) * out), [th, *tp.values()])
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": 1, "plain": 0}
    assert len(flash_function_on_cpu) == 1
    _close_grads(dict(zip(["h", *tp], grads)), [ref_h, *(ref_p[k] for k in tp)])


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_forward_train_gradients_match_the_reference(arch, flash_function_on_cpu):
    """∂/∂params of ⟨ḡ, logits⟩ through the port's forward_train (every
    layer's attention through the flash Function) against jax.grad of the
    reference's forward_train on the same params and tokens."""
    jcfg, params, cfg, model = _jax_model(arch, num_layers=2)
    b, s = 2, 24
    tokens = np.random.default_rng(26).integers(0, cfg.vocab_size, (b, s))
    gbar = _normal(27, b, s, cfg.vocab_size)

    def jloss(jp):
        logits = jmodel.forward_train(jcfg, jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
        return jnp.sum(jnp.asarray(gbar) * logits)

    ref = jax.tree.map(np.asarray, jax.grad(jloss)(params))
    for prm in model.parameters():
        prm.requires_grad_(True)
    logits = tmodel.forward_train(cfg, model, {"tokens": torch.from_numpy(tokens)},
                                  backend="cuda")
    torch.sum(torch.from_numpy(gbar) * logits).backward()
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": cfg.num_layers, "plain": 0}
    assert len(flash_function_on_cpu) == cfg.num_layers
    for prm in model.parameters():  # the gradients in the reference's layout
        prm.data = prm.grad
    got = lm_params_to_numpy(model)
    names = [".".join(path) for path, _ in leaves(got)]
    assert names == [".".join(path) for path, _ in leaves(ref)]
    _close_grads(dict(zip(names, (g for _, g in leaves(got)))), [r for _, r in leaves(ref)])


# ------------------------------------------------------------------- model ----


@pytest.mark.parametrize("arch,prompt", [
    ("llama3-8b", 16),
    ("olmo-1b", 16),  # tied embeddings, the non-parametric norm, MHA
    ("llama3-8b", 600),  # the reference's _sdpa streams 2 blocks of 300 rows here
])
def test_prefill_and_decode_step_match(arch, prompt):
    jcfg, params, cfg, model = _jax_model(arch, num_layers=2)
    b = 2
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (b, prompt))
    ref, jcache = jmodel.prefill(jcfg, params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 jmodel.zero_cache(jcfg, b, prompt + 4, jnp.float32))
    ops.reset_attention_trace_counts()
    with torch.no_grad():
        out, cache = tmodel.prefill(cfg, model, {"tokens": torch.from_numpy(tokens)},
                                    tmodel.zero_cache(cfg, b, prompt + 4, device="cpu"))
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": 0, "plain": cfg.num_layers}
    _close(out, ref)
    nxt = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
    ref, _ = jmodel.decode_step(jcfg, params, jnp.asarray(nxt, jnp.int32), jcache,
                                jnp.asarray(prompt))
    with torch.no_grad():
        out, _ = tmodel.decode_step(cfg, model, torch.from_numpy(nxt), cache, prompt)
    assert ops.ATTENTION_TRACE_COUNTS["plain"] == cfg.num_layers  # decode is the plain product
    _close(out, ref)


def test_generate_matches_greedy_tokens():
    jcfg, params, cfg, model = _jax_model("llama3-8b", num_layers=2)
    b, prompt, gen = 2, 24, 8
    tokens = np.random.default_rng(16).integers(0, cfg.vocab_size, (b, prompt))
    ref, _ = jgenerate(jcfg, params, jnp.asarray(tokens, jnp.int32), prompt + gen, gen)
    out, timings = serve.generate(cfg, model, torch.from_numpy(tokens), prompt + gen, gen)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert set(timings) == {"prefill_s", "decode_s"}


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_prefill_decode_matches_forward(arch):
    """The twin of the reference's test_prefill_decode_matches_forward on the
    port's own draws: forward_train's logits at positions s − 2 and s − 1
    equal prefill(≤ s − 2)'s and decode_step(s − 1)'s."""
    cfg = get_config(arch).reduced(remat=False, num_layers=2)
    model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        full = model(tokens)
        cache = tmodel.zero_cache(cfg, b, s + 4, device="cpu")
        pre, cache = tmodel.prefill(cfg, model, {"tokens": tokens[:, :-1]}, cache)
        dec, _ = tmodel.decode_step(cfg, model, tokens[:, -1:], cache, s - 1)
    torch.testing.assert_close(pre[:, -1], full[:, -2], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)


def test_serve_cli_runs_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "4"])
    assert "[serve] generated (2, 4)" in buf.getvalue()


# ------------------------------------------------------------ params, data ----


def test_count_params_matches_for_every_config():
    assert list_configs() == jlist_configs()
    for name in list_configs():
        schema = tmodel.param_schema(get_config(name))
        assert all(isinstance(leaf, P) for _, leaf in leaves(schema))  # nothing allocated
        assert tmodel.count_params(get_config(name)) == jmodel.count_params(jget_config(name))
    assert tmodel.count_params(get_config("llama3-8b")) == 8_030_261_248


def test_init_scale_per_leaf():
    """Each leaf's std within 5% of the reference's rule on the stacked schema:
    fan_in = prod(shape[:-1]) counts the layer axis (1/√(L·d_in) for a stacked
    weight), embeddings 0.02, norms ones."""
    cfg = get_config("llama3-8b").reduced()
    model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = lm_params_to_numpy(model)
    schema = tmodel.param_schema(cfg)
    checked = 0
    for path, leaf in leaves(schema):
        a = tree
        for k in path:
            a = a[k]
        assert a.shape == leaf.shape, path
        if leaf.init == "ones":
            np.testing.assert_array_equal(a, 1.0)
            continue
        want = 0.02 if leaf.init == "embed" else leaf.scale
        assert abs(a.std() / want - 1) < 0.05, (path, a.std(), want)
        checked += 1
    assert checked == 9  # tok, unembed, wq, wk, wv, wo, gate, up, down
    assert tmodel.param_schema(cfg)["layers"]["mixer"]["wq"].scale == (4 * 256) ** -0.5


def test_params_round_trip_keeps_orientation():
    for arch in ("llama3-8b", "olmo-1b"):
        _, params, cfg, model = _jax_model(arch, num_layers=2)
        ref = jax.tree.map(np.asarray, params)
        back = lm_params_to_numpy(model)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        jax.tree.map(np.testing.assert_array_equal, back, ref)
        # (in, out) kept: no nn.Linear, both packages compute h @ W
        wq = model.layers[1].mixer["wq"]
        assert tuple(wq.shape) == (cfg.d_model, cfg.num_heads * cfg.head_dim)
        np.testing.assert_array_equal(wq.numpy(), ref["layers"]["mixer"]["wq"][1])
        assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())


def test_token_batch_plants_the_bigram_chain():
    out = token_batch(0, 3, 4, 512, 1000, device="cpu")
    again = token_batch(0, 3, 4, 512, 1000, device="cpu")
    tok, lab = out["tokens"], out["labels"]
    assert tok.shape == lab.shape == (4, 512) and tok.dtype == torch.int64
    torch.testing.assert_close(tok, again["tokens"], rtol=0, atol=0)
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    assert not torch.equal(tok, token_batch(0, 4, 4, 512, 1000, device="cpu")["tokens"])
    share = ((31 * tok + 17) % 1000 == lab).float().mean().item()
    ref = jtoken_batch(0, 3, 4, 512, 1000)
    jshare = float(((31 * np.asarray(ref["tokens"]) + 17) % 1000
                    == np.asarray(ref["labels"])).mean())
    # the planted share is 0.8 (+ 1/1000 by chance); 2,048 transitions each
    assert abs(share - 0.8) < 0.04 and abs(jshare - 0.8) < 0.04

