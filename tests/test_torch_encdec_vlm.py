"""The port's last two LM families, whisper-tiny's encoder-decoder and
qwen2-vl-7b's M-RoPE (repro_torch.models.layers.apply_mrope,
.attention.gqa_apply's ``cross_kv``/``causal``, .model's encoder, decoder,
positions and vision splice), and ``data.pipeline.molecule_fingerprints``,
against the JAX package on the CPU: the reference's own draws, carried
across by ``convert.lm_params_from_numpy``, and the same numpy inputs through
both. Twins of tests/test_models.py:74,93,141 and
tests/test_archs_smoke.py:29,40 for these two families, reduced (2 layers;
whisper's 2 encoder layers over 64 frames, qwen2-vl's 16 vision tokens).

Tolerances: 1e-4 of max(1, max|ref|) for every module's and model's outputs,
each gradient leaf within 1e-4 of its own scale and the loss within 1e-6
relative (tests/test_torch_train.py's train-step tolerances); the
reference's own where it sets them (M-RoPE against RoPE 1e-5 / 1e-6,
prefill/decode against forward 5e-2 / 5e-3).

Three behaviours of the reference are copied, not repaired: a qwen2-vl
prompt shorter than ``vision_tokens`` comes out ``vision_tokens`` long; text
positions after the vision grid are not shifted past it; whisper's decoder
recomputes cross-attention's keys and values from the memory every step.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import molecule_fingerprints as jmolecule_fingerprints
from repro.data.pipeline import token_batch as jtoken_batch
from repro.launch.serve import generate as jgenerate
from repro.launch.steps import _next_token_loss as jnext_token_loss
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.param import init_params as jinit_params
from repro.train import checkpoint as jckpt
from repro.train.optim import AdamWConfig as JAdamWConfig
from repro.train.optim import init_opt_state as jinit_opt_state
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, opt_state_from_numpy
from repro_torch.data.pipeline import lm_batch, molecule_fingerprints, token_batch
from repro_torch.launch import serve
from repro_torch.launch.steps import _next_token_loss, loss_and_grads, make_train_step
from repro_torch.models import attention, layers
from repro_torch.models import model as tmodel
from repro_torch.models.param import leaves
from repro_torch.train import AdamWConfig, init_opt_state, restore_checkpoint
from repro_torch.train.optim import leaves as opt_leaves

TOL = 1e-4
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-4
CONSIST_RTOL, CONSIST_ATOL = 5e-2, 5e-3  # tests/test_models.py:114,118
ARCHS = ["whisper-tiny", "qwen2-vl-7b"]
#: tests/test_models.py:141's ranges
PARAM_RANGES = {"whisper-tiny": (2e7, 9e7), "qwen2-vl-7b": (6.5e9, 9e9)}


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


def _jit(fn, static=(0,)):
    """The reference's function jitted, its config static."""
    return jax.jit(fn, static_argnums=static)


@pytest.fixture(scope="module")
def pairs():
    """arch → (reference cfg, reference params, port cfg, port model on the
    CPU), 2 layers, built once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced(num_layers=2)
        params = _jit(jmodel.init_model_params)(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced(num_layers=2)
        out[arch] = (jcfg, params, cfg, lm_params_from_numpy(cfg, _np(params), device="cpu"))
    return out


def _inputs(cfg, seed, b, s):
    """numpy tokens (b, s) and the family's stub inputs: whisper's frames (b,
    encoder_seq, d), qwen2-vl's patch embeddings (b, vision_tokens, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(size=(b, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _j(inputs):
    return {k: jnp.asarray(v, jnp.int32) if v.dtype.kind == "i" else jnp.asarray(v)
            for k, v in inputs.items()}


def _t(inputs):
    return {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


# ----------------------------------------------------------------- M-RoPE ----


@pytest.mark.parametrize("head_dim", [128, 64])
def test_apply_mrope_matches_the_reference(head_dim):
    """At qwen2-vl's sections (16, 24, 24) and the reduced (8, 12, 12), on
    positions whose three streams differ (a 4 × 4 vision grid, then text)."""
    cfg = get_config("qwen2-vl-7b").reduced(head_dim=head_dim)
    sections = attention._mrope_sections(cfg)
    assert sections == jattn._mrope_sections(jget_config("qwen2-vl-7b").reduced(
        head_dim=head_dim))
    assert sections == {128: (16, 24, 24), 64: (8, 12, 12)}[head_dim]
    x = np.random.default_rng(0).normal(size=(2, 40, 3, head_dim)).astype(np.float32)
    pos = tmodel._positions_for(cfg, 2, 40, 0)
    assert not torch.equal(pos[0], pos[1])
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos.numpy()), 1e6, sections)
    _close(layers.apply_mrope(torch.from_numpy(x), pos, 1e6, sections), ref)


def test_mrope_text_positions_reduce_to_rope():
    """tests/test_models.py:74: identical (t, h, w) streams are plain RoPE."""
    q = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, 1, 32)).astype(np.float32))
    pos = torch.arange(5)[None].expand(2, 5)
    out_m = layers.apply_mrope(q, torch.stack([pos, pos, pos]), 1e4, (4, 6, 6))
    np.testing.assert_allclose(out_m.numpy(), layers.apply_rope(q, pos, 1e4).numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(q, torch.stack([pos, pos, pos]), 1e4, (4, 6, 7))


@pytest.mark.parametrize("seq,offset", [(24, 0), (16, 0), (9, 0), (1, 37)])
def test_positions_for_matches_the_reference(seq, offset):
    """qwen2-vl's (3, b, s) positions: the vision grid at seq ≥ vision_tokens
    (24, 16), none below it (9), and three equal streams at a decode offset."""
    jcfg, cfg = jget_config("qwen2-vl-7b").reduced(), get_config("qwen2-vl-7b").reduced()
    ref = np.asarray(jmodel._positions_for(jcfg, 2, seq, offset))
    got = tmodel._positions_for(cfg, 2, seq, offset)
    assert got.shape == (3, 2, seq)
    np.testing.assert_array_equal(got.numpy(), ref)
    if seq >= cfg.vision_tokens:
        assert got[1, 0, :cfg.vision_tokens].tolist() == [i // 4 for i in range(16)]
        assert got[2, 0, :cfg.vision_tokens].tolist() == [i % 4 for i in range(16)]
        # text after the grid keeps its own position, not one past the grid
        assert got[1, 0, cfg.vision_tokens:].tolist() == list(range(16, seq))
    else:
        assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


# ------------------------------------------------------------ GQA modes ------


def _gqa_case(arch, seed, b, s):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    p = jinit_params(jattn.gqa_params(jcfg), jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    h = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, tp, h


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_matches_the_reference(mode):
    """whisper's cross-attention to a 64-row memory, in every mode: no
    rotary, no cache, no mask; the port's plain product."""
    jcfg, cfg, p, tp, h = _gqa_case("whisper-tiny", 1, 2, 1 if mode == "decode" else 12)
    mem = np.random.default_rng(2).normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(h.shape[1]) + (7 if mode == "decode" else 0), (2, 1))
    ref, _ = jattn.gqa_apply(p, jcfg, jnp.asarray(h), jnp.asarray(pos), mode, None, None,
                             cross_kv=(jnp.asarray(mem),))
    before = dict(attention.ops.ATTENTION_TRACE_COUNTS)
    out, cache = attention.gqa_apply(tp, cfg, torch.from_numpy(h), torch.from_numpy(pos), mode,
                                     cross_kv=(torch.from_numpy(mem),))
    assert cache is None and dict(attention.ops.ATTENTION_TRACE_COUNTS) == before
    _close(out, ref)


def test_non_causal_train_attention_matches_the_reference():
    """whisper's encoder self-attention (``causal=False``) through
    ``ops.flash_attention``."""
    jcfg, cfg, p, tp, h = _gqa_case("whisper-tiny", 3, 2, 20)
    pos = np.tile(np.arange(20), (2, 1))
    ref, _ = jattn.gqa_apply(p, jcfg, jnp.asarray(h), jnp.asarray(pos), "train", causal=False)
    causal_ref, _ = jattn.gqa_apply(p, jcfg, jnp.asarray(h), jnp.asarray(pos), "train")
    out, _ = attention.gqa_apply(tp, cfg, torch.from_numpy(h), torch.from_numpy(pos), "train",
                                 causal=False)
    _close(out, ref)
    assert np.abs(out.numpy() - np.asarray(causal_ref)).max() > 1e-2


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mrope_attention_matches_the_reference(mode):
    """qwen2-vl's GQA with M-RoPE on (3, b, s) positions over a vision grid;
    prefill fills the cache, decode attends to it."""
    jcfg, cfg, p, tp, h = _gqa_case("qwen2-vl-7b", 4, 2, 20)
    s = 1 if mode == "decode" else 20
    pos = tmodel._positions_for(cfg, 2, s, 20 if mode == "decode" else 0)
    shape = (2, 24, cfg.num_kv_heads, cfg.head_dim)
    kv = {k: np.random.default_rng(seed).normal(size=shape).astype(np.float32)
          for k, seed in (("k", 5), ("v", 6))}
    jcache = {k: jnp.asarray(v) for k, v in kv.items()}
    cache = _t(kv)
    hh = h[:, :s]
    index = 20 if mode == "decode" else None
    ref, rc = jattn.gqa_apply(p, jcfg, jnp.asarray(hh), jnp.asarray(pos.numpy()), mode,
                              jcache if mode != "train" else None,
                              None if index is None else jnp.asarray(index))
    out, c = attention.gqa_apply(tp, cfg, torch.from_numpy(hh), pos, mode,
                                 cache if mode != "train" else None, index)
    _close(out, ref)
    if mode != "train":
        _close(c["k"], rc["k"])
        _close(c["v"], rc["v"])


# ----------------------------------------------------------------- models ----


@pytest.mark.parametrize("arch,seq", [("whisper-tiny", 32), ("qwen2-vl-7b", 32),
                                      ("qwen2-vl-7b", 8)])
def test_forward_train_matches_the_reference(arch, seq, pairs):
    """Reduced whisper on 64 frames and reduced qwen2-vl with the prompt
    longer than its 16 vision tokens and shorter (8 tokens: the logits come
    out 16 long, as the reference's do)."""
    jcfg, params, cfg, model = pairs[arch]
    inputs = _inputs(cfg, 10, 2, seq)
    ref = np.asarray(_jit(jmodel.forward_train)(jcfg, params, _j(inputs)))
    with torch.no_grad():
        out = model(_t(inputs)["tokens"], **{k: v for k, v in _t(inputs).items()
                                              if k != "tokens"})
    assert out.shape == (2, max(seq, cfg.vision_tokens), cfg.vocab_size)
    assert torch.isfinite(out).all()
    _close(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_the_reference(arch, pairs):
    """Prefill (whisper: the memory stored in the cache) and two decode steps
    (whisper: cross keys and values recomputed from the cached memory)."""
    jcfg, params, cfg, model = pairs[arch]
    b, prompt = 2, 20
    inputs = _inputs(cfg, 11, b, prompt)
    ref, jcache = _jit(jmodel.prefill)(jcfg, params, _j(inputs),
                                       jmodel.zero_cache(jcfg, b, prompt + 4, jnp.float32))
    with torch.no_grad():
        cache = tmodel.zero_cache(cfg, b, prompt + 4, device="cpu")
        out, cache = tmodel.prefill(cfg, model, _t(inputs), cache)
    _close(out, ref)
    assert sorted(cache) == sorted(jcache)
    if cfg.is_encdec:
        _close(cache["memory"], jcache["memory"])
        assert len(cache["self"]) == cfg.num_layers
    for i in range(2):
        nxt = np.array(jnp.argmax(ref[:, -1], axis=-1))[:, None]
        ref, jcache = _jit(jmodel.decode_step)(jcfg, params, jnp.asarray(nxt, jnp.int32),
                                               jcache, jnp.asarray(prompt + i))
        with torch.no_grad():
            out, cache = tmodel.decode_step(cfg, model, torch.from_numpy(nxt), cache,
                                            prompt + i)
        _close(out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """tests/test_models.py:93 on the port's own draws (its whisper case, and
    qwen2-vl with the prompt past its vision tokens): forward_train's logits
    at positions s − 2 and s − 1 equal prefill(≤ s − 2)'s and
    decode_step(s − 1)'s."""
    cfg = get_config(arch).reduced(remat=False, num_layers=2)
    model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 24
    inputs = _t(_inputs(cfg, 12, b, s))
    tokens = inputs["tokens"]
    with torch.no_grad():
        full = tmodel.forward_train(cfg, model, inputs)
        cache = tmodel.zero_cache(cfg, b, s + 4, device="cpu")
        pre, cache = tmodel.prefill(cfg, model, dict(inputs, tokens=tokens[:, :-1]), cache)
        dec, _ = tmodel.decode_step(cfg, model, tokens[:, -1:], cache, s - 1)
    torch.testing.assert_close(pre[:, -1], full[:, -2], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=CONSIST_RTOL, atol=CONSIST_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference(arch, pairs):
    """``generate`` with the stub inputs as ``extra_inputs``: the reference's
    greedy tokens."""
    jcfg, params, cfg, model = pairs[arch]
    inputs = _inputs(cfg, 13, 2, 20)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    ref, _ = jgenerate(jcfg, params, jnp.asarray(inputs["tokens"], jnp.int32), 26, 6,
                       {k: jnp.asarray(v) for k, v in extra.items()})
    toks, timings = serve.generate(cfg, model, torch.from_numpy(inputs["tokens"]), 26, 6,
                                   _t(extra))
    assert timings["prefill_s"] > 0
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))


# --------------------------------------------------------------- training ----


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    a = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree
    return {prefix: np.asarray(a, dtype=np.float32)}


def _train_batch(cfg, seed=3, b=2, s=32):
    """The reference's token batch with the family's stub inputs."""
    batch = {k: np.asarray(v) for k, v in jtoken_batch(0, seed, b, s, cfg.vocab_size).items()}
    extra = _inputs(cfg, seed, b, s)
    return dict(batch, **{k: v for k, v in extra.items() if k != "tokens"})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, pairs):
    """One train step (tests/test_archs_smoke.py:40, mu float32): the loss and
    every gradient leaf (whisper's encoder, decoder and cross-attention
    leaves among them) against jax.value_and_grad of the reference's; then
    the port's step moves the parameters, finite, at step 1."""
    jcfg, params, cfg, _ = pairs[arch]
    model = lm_params_from_numpy(cfg, _np(params), device="cpu")
    batch = _train_batch(cfg)

    def jloss(p):
        jb = _j(batch)
        return jnext_token_loss(jcfg, jmodel.forward_train(jcfg, p, jb), jb["labels"])

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(params)
    ref_g = _flat(_np(ref_g))
    tb = _t(batch)
    loss, grads = loss_and_grads(cfg, model, tb)
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    got_g = _flat(tmodel.leaf_tree(model, grads))
    assert got_g.keys() == ref_g.keys()
    if cfg.is_encdec:
        assert {"enc_layers/mixer/wq", "dec_layers/cross/wk", "enc_norm/scale"} <= got_g.keys()
    for k, g in ref_g.items():
        assert np.isfinite(got_g[k]).all(), k
        assert np.abs(got_g[k] - g).max() <= GRAD_TOL * max(np.abs(g).max(), 1e-30), k

    before = [t.clone() for t in opt_leaves(model)]
    opt_cfg = AdamWConfig(mu_dtype=torch.float32)
    model, opt, out = make_train_step(cfg, opt_cfg)(model, init_opt_state(model, opt_cfg), tb)
    assert int(out["step"]) == 1 and np.isfinite(out["loss"].item())
    assert any(not torch.equal(a, b) for a, b in zip(before, opt_leaves(model)))
    assert all(torch.isfinite(t).all() for t in opt_leaves(model))


@pytest.mark.parametrize("arch", ARCHS)
def test_micro_steps_slice_the_stub_inputs(arch, pairs):
    """``micro_steps=2`` cuts frames and patch embeddings with the tokens:
    the loss and gradients of the whole batch."""
    _, params, cfg, _ = pairs[arch]
    model = lm_params_from_numpy(cfg, _np(params), device="cpu")
    tb = _t(_train_batch(cfg, seed=4, b=4))
    loss1, g1 = loss_and_grads(cfg, model, tb)
    loss2, g2 = loss_and_grads(cfg, model, tb, micro_steps=2)
    assert abs(loss2.item() - loss1.item()) <= LOSS_RTOL * abs(loss1.item())
    for a, b in zip(g2, g1):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1e-30)


def test_a_short_vision_prompt_has_more_logits_than_labels(pairs):
    """A qwen2-vl prompt shorter than its vision tokens comes out
    ``vision_tokens`` long (the reference's splice): the loss refuses the
    mismatch instead of broadcasting it."""
    _, _, cfg, model = pairs["qwen2-vl-7b"]
    tb = _t(_train_batch(cfg, b=2, s=8))
    with torch.no_grad():
        logits = tmodel.forward_train(cfg, model, tb)
    assert logits.shape[1] == cfg.vision_tokens
    with pytest.raises(ValueError, match="do not match labels"):
        _next_token_loss(cfg, logits, tb["labels"])


@pytest.mark.parametrize("arch", list_configs())
def test_every_reduced_config_builds_and_takes_a_train_step(arch):
    """tests/test_archs_smoke.py:29,40 for all ten configs in the port, on
    its own draws: the reduced model, its cache, finite logits of the
    expected shape and one step that moves the parameters."""
    cfg = get_config(arch).reduced()
    model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    cache = tmodel.zero_cache(cfg, 2, 40, device="cpu")
    assert cache and all(isinstance(v, (list, torch.Tensor)) for v in cache.values())
    batch = _t(_train_batch(cfg, seed=7))
    with torch.no_grad():
        logits = tmodel.forward_train(cfg, model, batch)
    assert logits.shape == (2, 32, cfg.vocab_size) and torch.isfinite(logits).all()
    opt_cfg = AdamWConfig(mu_dtype=torch.float32)
    before = [t.clone() for t in opt_leaves(model)]
    model, _, out = make_train_step(cfg, opt_cfg)(model, init_opt_state(model, opt_cfg), batch)
    assert np.isfinite(out["loss"].item()) and out["loss"].item() > 0
    assert int(out["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, opt_leaves(model)))


# ------------------------------------------------------- params, convert ----


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_reference(arch):
    """count_params at full size equal to the reference's and within
    tests/test_models.py:141's range."""
    n = tmodel.count_params(get_config(arch))
    assert n == jmodel.count_params(jget_config(arch))
    lo, hi = PARAM_RANGES[arch]
    assert lo <= n <= hi


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, pairs):
    """The reference's pytree across and back, bit for bit and in its
    structure (whisper's ``enc_layers``, ``enc_norm``, ``dec_layers``)."""
    _, params, cfg, model = pairs[arch]
    ref = _np(params)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    paths = [(p, len(ts)) for p, ts in tmodel.lm_leaves(model)]
    assert [p for p, _ in paths] == ["/".join(p) for p, _ in leaves(tmodel.param_schema(cfg))]
    if cfg.is_encdec:
        assert not hasattr(model, "layers")
        assert dict(paths)["enc_layers/mixer/wq"] == cfg.encoder_layers
        assert dict(paths)["dec_layers/cross/wo"] == cfg.num_layers
        assert dict(paths)["enc_norm/scale"] == 1
        np.testing.assert_array_equal(model.dec_layers[1].cross["wv"].numpy(),
                                      ref["dec_layers"]["cross"]["wv"][1])


def test_reference_checkpoint_of_whisper_restores_in_the_port(tmp_path, pairs):
    """The reference's checkpoint of whisper's params and optimiser state
    (its encoder and decoder stacks) restored by the port bit for bit."""
    jcfg, params, cfg, _ = pairs["whisper-tiny"]
    jopt = jinit_opt_state(params, JAdamWConfig(mu_dtype=jnp.float32))
    jopt = jopt._replace(nu=jax.tree.map(lambda p: p * p, params))
    jckpt.save_checkpoint(str(tmp_path), 5, {"p": params, "o": jopt})
    template_model = tmodel.init_model_params(cfg, torch.Generator().manual_seed(1),
                                              device="cpu")
    template = {"p": template_model,
                "o": init_opt_state(template_model, AdamWConfig(mu_dtype=torch.float32))}
    got, step, _ = restore_checkpoint(str(tmp_path), template)
    assert step == 5
    jax.tree.map(np.testing.assert_array_equal, lm_params_to_numpy(got["p"]), _np(params))
    want = opt_state_from_numpy(cfg, _np(jopt.mu), _np(jopt.nu), np.asarray(jopt.step),
                                device="cpu")
    for a, b in zip(opt_leaves(got["o"].nu), opt_leaves(want.nu)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- launchers ----


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch):
    """The launcher gives the stub inputs as ones, as the reference's does
    (the prompt as long as qwen2-vl's 16 vision tokens at least)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "20", "--gen", "3"])
    assert "[serve] generated (2, 3)" in buf.getvalue()


# ------------------------------------------------------------------ data -----


@pytest.mark.parametrize("kwargs", [{}, dict(n=200, dim=64, seed=3, n_test=50)])
def test_molecule_fingerprints_equal_the_reference(kwargs):
    """The reference's arrays exactly, at its default sizes and a small one,
    as float32 tensors on the requested device."""
    got = molecule_fingerprints(**kwargs, device="cpu")
    ref = jmolecule_fingerprints(**kwargs)
    assert got.keys() == ref.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
    x = got["x"]
    assert set(np.unique(x.numpy())) <= {0.0, 1.0, 2.0}
    assert abs(got["y"].mean().item()) < 1e-4


@pytest.mark.parametrize("arch", list_configs())
def test_lm_batch_adds_the_stub_inputs(arch):
    """``lm_batch``: ``token_batch``'s tokens and labels, plus the family's
    stub inputs at the shapes ``forward_train`` takes (frames for an
    encoder-decoder, patch embeddings for a VLM, none otherwise), a pure
    function of (seed, step)."""
    cfg = get_config(arch).reduced()
    b, s = 2, 24
    got = lm_batch(cfg, 5, 3, b, s, device="cpu")
    want = token_batch(5, 3, b, s, cfg.vocab_size, device="cpu")
    stubs = {}
    if cfg.is_encdec:
        stubs["frames"] = (b, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        stubs["vision_embeds"] = (b, cfg.vision_tokens, cfg.d_model)
    assert got.keys() == {"tokens", "labels", *stubs}
    for k in ("tokens", "labels"):
        assert torch.equal(got[k], want[k])
    again, other = lm_batch(cfg, 5, 3, b, s, device="cpu"), lm_batch(cfg, 5, 4, b, s, device="cpu")
    for k, shape in stubs.items():
        assert got[k].shape == shape and got[k].dtype == torch.float32
        assert torch.equal(got[k], again[k]) and not torch.equal(got[k], other[k])
