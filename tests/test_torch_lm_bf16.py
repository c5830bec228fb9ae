"""bf16 LM serving and flash attention's bf16 inputs, the port against the JAX
reference on the CPU, on the same inputs (numpy from a seed, or the
reference's own bf16 params carried across by ``convert.lm_params_from_numpy``
bit for bit).

* ``ops.flash_attention`` on bf16 q, k and v (the plain version with the
  kernel's casts) against the Pallas kernel in interpret mode, at
  tests/test_kernels_pallas.py:60-84's shapes plus a wider GQA group, within
  FLASH_BF16_TOL of max(1, scale), and against fp32 attention at that test's
  3e-2.
* Every cast point of the layers (``layers.py:23-46,108``, ``attention.py:32,
  42`` there) on bf16 inputs: the same output dtypes as the reference's
  (fp32 norms and RoPE returned in the input's dtype, fp32 logits, a bf16
  query against the fp32 cache promoted to fp32), values within
  CAST_TOL of max(1, scale).
* A reduced bf16 llama3-8b (2 layers) through ``launch.serve.generate``
  against the reference: its prefill logits (the reference's ``generate``
  with one token, whose decode never runs) within LM_BF16_TOL, and its greedy
  tokens where the reference's top-2 margins allow. The reference's decode of
  a bf16 model runs its own ``_apply_block`` layer by layer: its
  ``decode_step`` scans the layers with ``lax.scan``, which refuses the carry
  that JAX's promotion turns fp32 (a bf16 query against the fp32 cache), so
  its ``generate`` raises on a bf16 model at the first decode step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.launch.serve import generate as jgenerate
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models import model as tmodel

#: both sides round p to bf16 for p·v, the Pallas kernel against its running
#: max in 64-key blocks and the plain version against the row's final max,
#: and round the output to bf16 (an ulp of an output is 2^-8 of it)
FLASH_BF16_TOL = 1e-2
#: the reference's own bf16 flash tolerance against fp32
#: (tests/test_kernels_pallas.py:84)
FLASH_FP32_TOL = 3e-2
#: a layer's bf16 output: XLA rounds each bf16 elementwise op of a layer
#: (silu's sigmoid, the product) where torch rounds the fused op once, so
#: they differ by ~1 bf16 ulp (2^-8) of an entry
CAST_TOL = 1e-2
#: the bf16 model's prefill logits: the reference's prefill attends through
#: ``_sdpa``, whose logits are bf16 products, the port's through the flash
#: kernel's fp32 logits, and the two round the residual stream at other
#: points (measured 8.1e-3 of scale at 2 layers)
LM_BF16_TOL = 2e-2
#: a greedy token is held to the reference's where its top-2 margin exceeds
#: LM_MARGIN × the measured logit difference, row by row until the first
#: position that does not
LM_MARGIN = 2.0


@pytest.fixture(autouse=True)
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _bf16(a):
    """A numpy array rounded to bf16, as the float32 values it stands for."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _scaled_err(out, ref):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, dtype=np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out.astype(np.float64) - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _dtype_name(a):
    return str(a.dtype).replace("torch.", "")


# --------------------------------------------------------------- flash -------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64),
                                          (1, 130, 2, 1, 32), (2, 128, 8, 2, 64)])
def test_flash_bf16_matches_the_pallas_kernel(causal, b, s, hq, hkv, d):
    q = _bf16(_normal(1, b, s, hq, d))
    k, v = _bf16(_normal(2, b, s, hkv, d)), _bf16(_normal(3, b, s, hkv, d))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    before = (flash_attention.launches, flash_attention.bf16_launches)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert (flash_attention.launches, flash_attention.bf16_launches) == before  # plain route
    assert got.dtype == torch.bfloat16
    # the reference at its default tiling (128, the card kernel's query block
    # and key tile) and at 64; its ops pads s to the block and masks the pad
    for block in (128, 64):
        want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=block, block_k=block,
                                    interpret=True)
        assert want.dtype == jnp.bfloat16
        assert _scaled_err(got, want.astype(jnp.float32)) <= FLASH_BF16_TOL
    fp32 = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert _scaled_err(got, fp32.numpy()) <= FLASH_FP32_TOL


def test_flash_bf16_gradients_run_through_the_plain_version():
    # the kernel's Function recomputes through the plain version in its
    # backward (the reference defines no VJP): bf16 gradients, finite, within
    # the reference's bf16 tolerance of fp32 autograd
    q, k, v = (torch.from_numpy(_bf16(_normal(i, 1, 70, 4, 32))) for i in (4, 5, 6))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    grads = {}
    for dt in (torch.bfloat16, torch.float32):
        ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = flash_attention_ref(*ins, causal=True)
        grads[dt] = torch.autograd.grad(out.float().sum(), ins)
    for a, b in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a.float()).all())
        assert _scaled_err(a, b.numpy()) <= FLASH_FP32_TOL


# ---------------------------------------------------------- cast points ------


def _cast_cases():
    d, ff, vocab, h, kv, hd = 256, 512, 300, 4, 2, 64
    x = _bf16(_normal(10, 2, 5, d))
    scale = _bf16(1.0 + 0.1 * _normal(11, d))
    mlp = {"gate": _bf16(_normal(12, d, ff, scale=d ** -0.5)),
           "up": _bf16(_normal(13, d, ff, scale=d ** -0.5)),
           "down": _bf16(_normal(14, ff, d, scale=ff ** -0.5))}
    emb = {"tok": _bf16(_normal(15, vocab, d, scale=0.02))}
    attn_w = {"wq": _bf16(_normal(16, d, h * hd, scale=d ** -0.5)),
              "wk": _bf16(_normal(17, d, kv * hd, scale=d ** -0.5)),
              "wv": _bf16(_normal(18, d, kv * hd, scale=d ** -0.5)),
              "wo": _bf16(_normal(19, h * hd, d, scale=(h * hd) ** -0.5))}
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    tokens = np.random.default_rng(20).integers(0, vocab, (2, 5))
    cache_k, cache_v = _normal(21, 2, 8, kv, hd), _normal(22, 2, 8, kv, hd)
    return dict(x=x, scale=scale, mlp=mlp, emb=emb, attn=attn_w, pos=pos, tokens=tokens,
                cache_k=cache_k, cache_v=cache_v, x32=_normal(23, 2, 5, d))


CAST_POINTS = ["rmsnorm", "rmsnorm_bf16_scale", "rope", "mlp", "mlp_fp32_input", "embed",
               "unembed", "gqa_prefill", "gqa_decode_fp32_cache"]


@pytest.mark.parametrize("op", CAST_POINTS)
def test_bf16_cast_points_match_the_reference(op):
    c = _cast_cases()
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(np.array(a)).bfloat16()  # noqa: E731
    jcfg, cfg = jget_config("llama3-8b").reduced(), get_config("llama3-8b").reduced()
    if op.startswith("rmsnorm"):
        js = jb(c["scale"]) if op == "rmsnorm_bf16_scale" else jnp.asarray(c["scale"])
        ts = tb(c["scale"]) if op == "rmsnorm_bf16_scale" else torch.from_numpy(c["scale"])
        want = jlayers.rmsnorm({"scale": js}, jb(c["x"]), 1e-5)
        got = layers.rmsnorm({"scale": ts}, tb(c["x"]), 1e-5)
    elif op == "rope":
        x = _bf16(_normal(30, 2, 5, 4, 64))
        want = jlayers.apply_rope(jb(x), jnp.asarray(c["pos"]), 500_000.0)
        got = layers.apply_rope(tb(x), torch.from_numpy(c["pos"]), 500_000.0)
    elif op.startswith("mlp"):
        jx = jnp.asarray(c["x32"]) if op == "mlp_fp32_input" else jb(c["x"])
        tx = torch.from_numpy(c["x32"]) if op == "mlp_fp32_input" else tb(c["x"])
        want = jlayers.mlp({k: jb(v) for k, v in c["mlp"].items()}, jx)
        got = layers.mlp({k: tb(v) for k, v in c["mlp"].items()}, tx)
    elif op == "embed":
        want = jlayers.embed({"tok": jb(c["emb"]["tok"])}, jnp.asarray(c["tokens"]))
        got = layers.embed({"tok": tb(c["emb"]["tok"])}, torch.from_numpy(c["tokens"]))
    elif op == "unembed":
        want = jlayers.unembed({"tok": jb(c["emb"]["tok"])}, jb(c["x"]))
        got = layers.unembed({"tok": tb(c["emb"]["tok"])}, tb(c["x"]))
    else:
        jp = {k: jb(v) for k, v in c["attn"].items()}
        tp = {k: tb(v) for k, v in c["attn"].items()}
        if op == "gqa_prefill":  # bf16 q, k, v through flash: a bf16 output
            jcache = {k: jnp.zeros((2, 8, 2, 64)) for k in ("k", "v")}
            want, jcache = jattn.gqa_apply(jp, jcfg, jb(c["x"]), jnp.asarray(c["pos"]),
                                           "prefill", jcache)
            tcache = attention.gqa_make_cache(cfg, 2, 8)
            got, tcache = attention.gqa_apply(tp, cfg, tb(c["x"]), torch.from_numpy(c["pos"]),
                                              "prefill", tcache)
            for k in ("k", "v"):  # the fp32 cache holds the bf16 keys and values exactly
                assert tcache[k].dtype == torch.float32
                np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(jcache[k]))
        else:  # decode: one bf16 token against the fp32 cache, promoted to fp32
            jcache = {"k": jnp.asarray(c["cache_k"]), "v": jnp.asarray(c["cache_v"])}
            pos = np.full((2, 1), 6)
            want, _ = jattn.gqa_apply(jp, jcfg, jb(c["x"][:, :1]), jnp.asarray(pos), "decode",
                                      jcache, jnp.asarray(6))
            tcache = {"k": torch.from_numpy(c["cache_k"].copy()),
                      "v": torch.from_numpy(c["cache_v"].copy())}
            got, _ = attention.gqa_apply(tp, cfg, tb(c["x"][:, :1]), torch.from_numpy(pos),
                                         "decode", tcache, 6)
    assert _dtype_name(got) == str(want.dtype), (got.dtype, want.dtype)
    assert _scaled_err(got, np.asarray(want.astype(jnp.float32))) <= CAST_TOL


# --------------------------------------------------------------- serving -----


def _models():
    jcfg = jget_config("llama3-8b").reduced(num_layers=2)
    params = jmodel.init_model_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    cfg = get_config("llama3-8b").reduced(num_layers=2)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, cfg, model


def test_bf16_params_cross_bit_for_bit():
    _, params, _, model = _models()
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    back = lm_params_to_numpy(model)
    for path, want in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for key in path:
            got = got[key.key]
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


def _jax_decode_unrolled(jcfg, params, token, cache, index):
    """The reference's ``decode_step`` with its layer scan unrolled into its
    own ``_apply_block`` per layer (see the module docstring)."""
    h = jlayers.embed(params["embed"], token)
    pos = jmodel._positions_for(jcfg, token.shape[0], 1, index)
    ks, vs = [], []
    for i in range(jcfg.num_layers):
        p_l = jax.tree.map(lambda a, i=i: a[i], params["layers"])
        c_l = {k: cache["attn"][k][i] for k in ("k", "v")}
        h, c_new = jmodel._apply_block(p_l, jcfg, h, pos, "decode", c_l, index, "attn", "dense")
        ks.append(c_new["k"])
        vs.append(c_new["v"])
    h = jlayers.rmsnorm(params["final_norm"], h, jcfg.norm_eps)
    return jlayers.unembed(params["embed"], h), {"attn": {"k": jnp.stack(ks),
                                                           "v": jnp.stack(vs)}}


def test_bf16_generate_matches_the_reference():
    jcfg, params, cfg, model = _models()
    b, prompt, gen = 2, 24, 6
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)
    # the reference: generate's first token (its prefill), then the unrolled decode
    first, _ = jgenerate(jcfg, params, jnp.asarray(tokens), prompt + gen, 1)
    cache = jmodel.zero_cache(jcfg, b, prompt + gen, jnp.float32)
    logits, cache = jmodel.prefill(jcfg, params, {"tokens": jnp.asarray(tokens)}, cache)
    ref_prefill = np.asarray(logits[:, -1])
    ref_toks, margins = [], []
    for i in range(gen):
        last = np.asarray(logits[:, -1], dtype=np.float64)
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        ref_toks.append(np.argmax(last, axis=-1))
        if i < gen - 1:
            logits, cache = _jax_decode_unrolled(
                jcfg, params, jnp.asarray(ref_toks[-1][:, None].astype(np.int32)), cache,
                prompt + i)
    ref_toks, margins = np.stack(ref_toks, 1), np.stack(margins, 1)
    np.testing.assert_array_equal(np.asarray(first)[:, 0], ref_toks[:, 0])

    toks, _ = serve.generate(cfg, model, torch.from_numpy(tokens).long(), prompt + gen, gen)
    with torch.no_grad():
        got, _ = tmodel.prefill(cfg, model, {"tokens": torch.from_numpy(tokens).long()},
                                tmodel.zero_cache(cfg, b, prompt + gen, device="cpu"))
    assert got.dtype == torch.float32
    err = _scaled_err(got[:, -1], ref_prefill)
    assert err <= LM_BF16_TOL
    diff = err * max(1.0, float(np.abs(ref_prefill).max()))
    checked = 0
    for row in range(b):
        for i in range(gen):
            if margins[row, i] <= LM_MARGIN * diff:
                break
            checked += 1
            assert int(toks[row, i]) == int(ref_toks[row, i]), (row, i)
    assert checked > 0
