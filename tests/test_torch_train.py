"""The port's LM training (repro_torch.launch.steps' train step,
repro_torch.train's AdamW, checkpoints, compression and Trainer,
repro_torch.launch.train) against the JAX package on the CPU: the same
weights (the reference's own draws, carried across by ``convert``) and the
same batches (the reference's ``token_batch``) through both.

Tolerances, measured on the reference tests' tiny olmo-1b
(tests/test_train.py:22-25) and on each ported dense arch, reduced:

* the loss within 1e-6 relative (measured ≤ 2.9e-7); the gradients within
  1e-4 of each leaf's scale (measured ≤ 1.5e-6);
* after one AdamW step at lr 1e-2 with no warm-up (so that a wrong update
  shows at 1e-5): ``nu`` within 1e-5 of its leaf's scale (measured
  ≤ 2.3e-6), ``mu`` (bf16) within one bf16 ulp of the reference's entry and
  the parameters within 1e-5 of their leaf's scale (measured ≤ 2.1e-6),
  except where Adam's first step m̂/√v̂ = g·c/(|g·c| + ε) ≈ sign(g) (c the
  clip scale) is ill-posed: entries whose gradient is below 100× its
  measured difference between the packages (1,299 of 21.4e6 entries over
  the ten cases, at most 0.015% of a leaf; held ≤ 0.1%), or whose |g·c| is
  below 100 ε, where ε moves the quotient (the embedding rows of the tokens
  absent from the batch: up to 79% of a reduced arch's ``embed/tok``, which
  only the tied unembedding's small gradient reaches);
* compression's int8 payload bit for bit on injected uniforms;
* checkpoints: the same manifest and arrays from either package, each
  restoring the other's exactly; a reference run resumed by the port within
  1e-4 relative of the reference's own losses.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_is_applicable
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import token_batch as jtoken_batch
from repro.launch.steps import _next_token_loss as jnext_token_loss
from repro.launch.steps import input_specs as jinput_specs
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import compress as jcompress
from repro.train.optim import AdamWConfig as JAdamWConfig
from repro.train.optim import adamw_update as jadamw_update
from repro.train.optim import init_opt_state as jinit_opt_state
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.convert import (
    lm_params_from_numpy, lm_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy,
)
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import (
    _next_token_loss, input_specs, loss_and_grads, make_train_step,
)
from repro_torch.models import model as tmodel
from repro_torch.train import (
    AdamWConfig, Trainer, TrainerConfig, adamw_update, compress, decompress,
    init_error_state, init_opt_state, latest_step, restore_checkpoint, save_checkpoint,
    tree_compress_with_feedback, tree_decompress,
)

DENSE = [a for a in list_configs() if get_config(a).family == "dense"
         and not (get_config(a).is_moe or get_config(a).use_mla)]
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, head_dim=32,
            vocab_size=128)
LOSS_RTOL, GRAD_TOL, MOMENT_TOL, PARAM_TOL, ILL_POSED = 1e-6, 1e-4, 1e-5, 1e-5, 100.0
#: one AdamW step that moves every parameter by ~lr: no warm-up, lr 1e-2
STEP_OPT = dict(lr=1e-2, warmup_steps=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(arch, overrides):
    """(reference cfg, reference params, port cfg, port model on the CPU)."""
    jcfg = jget_config(arch).reduced(**overrides)
    params = jmodel.init_model_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**overrides)
    return jcfg, params, cfg, lm_params_from_numpy(cfg, _np(params), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{path: float32 array} of a nested dict (bf16 → float32, exactly)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    a = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree
    return {prefix: np.asarray(a, dtype=np.float32)}


def _ref_grads(jcfg, params, batch, micro_steps):
    """The reference's loss and gradients as its train step forms them:
    micro-batch slices summed onto fp32 zeros, then divided."""
    def loss_fn(p, b):
        return jnext_token_loss(jcfg, jmodel.forward_train(jcfg, p, b), b["labels"])

    m = batch["tokens"].shape[0] // micro_steps
    loss, grads = 0.0, jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    for i in range(micro_steps):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        li, gi = jax.value_and_grad(loss_fn)(params, mb)
        loss, grads = loss + li, jax.tree.map(jnp.add, grads, gi)
    return float(loss / micro_steps), _flat(_np(jax.tree.map(lambda g: g / micro_steps, grads)))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), the smallest normal's below."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


CASES = [("olmo-1b", TINY, 1), ("olmo-1b", TINY, 2)] + [
    (a, {}, m) for a in DENSE for m in (1, 2)]


@pytest.mark.parametrize("arch,overrides,micro_steps", CASES,
                         ids=[f"{a}{'-tiny' if o else ''}-micro{m}" for a, o, m in CASES])
def test_train_step_matches_the_reference(arch, overrides, micro_steps):
    jcfg, params, cfg, model = _pair(arch, overrides)
    batch = jtoken_batch(0, 3, 4, 32, jcfg.vocab_size)
    jopt = jinit_opt_state(params, JAdamWConfig(**STEP_OPT))
    p2, o2, metrics = jax.jit(jmake_train_step(jcfg, JAdamWConfig(**STEP_OPT), micro_steps))(
        params, jopt, batch)
    ref_loss, ref_g = _ref_grads(jcfg, params, batch, micro_steps)
    assert abs(float(metrics["loss"]) - ref_loss) <= 1e-6 * abs(ref_loss)

    tb = _tbatch(batch)
    loss, grads = loss_and_grads(cfg, model, tb, micro_steps=micro_steps)
    got_g = _flat(tmodel.leaf_tree(model, grads))
    assert got_g.keys() == ref_g.keys()
    for k, g in ref_g.items():
        assert np.abs(got_g[k] - g).max() <= GRAD_TOL * np.abs(g).max(), k

    opt = init_opt_state(model, AdamWConfig(**STEP_OPT))
    model, opt, out = make_train_step(cfg, AdamWConfig(**STEP_OPT), micro_steps)(model, opt, tb)
    assert abs(float(out["loss"]) - float(metrics["loss"])) <= LOSS_RTOL * float(metrics["loss"])
    assert int(out["step"]) == int(o2.step) == 1
    assert opt.mu.embed["tok"].dtype == torch.bfloat16
    got_p, ref_p = _flat(lm_params_to_numpy(model)), _flat(_np(p2))
    got_m, ref_m = _flat(lm_params_to_numpy(opt.mu)), _flat(_np(o2.mu))
    got_v, ref_v = _flat(lm_params_to_numpy(opt.nu)), _flat(_np(o2.nu))
    clip = min(1.0, 1.0 / np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                      for g in ref_g.values())))
    for k, g in ref_g.items():
        assert np.abs(got_v[k] - ref_v[k]).max() <= MOMENT_TOL * np.abs(ref_v[k]).max(), k
        noisy = np.abs(g) < ILL_POSED * np.abs(got_g[k] - g)
        assert noisy.mean() <= 1e-3, (k, int(noisy.sum()))
        ok = ~noisy & (np.abs(g) * clip >= ILL_POSED * AdamWConfig().eps)
        dm = np.abs(got_m[k] - ref_m[k])[ok]
        assert np.all(dm <= _bf16_ulp(ref_m[k][ok])), k
        dp = np.abs(got_p[k] - ref_p[k])[ok]
        assert dp.max(initial=0.0) <= PARAM_TOL * np.abs(ref_p[k]).max(), k


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_match_the_reference(arch):
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        if not cell_is_applicable(jget_config(arch), jshape)[0]:
            continue
        ref = jinput_specs(jget_config(arch), jshape)
        got = input_specs(get_config(arch), shape)
        assert got.keys() == ref.keys()
        for k, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(ref[k].shape)
            assert str(spec.dtype).removeprefix("torch.") == str(ref[k].dtype), (name, k)


def test_next_token_loss_and_its_gradient_match():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.normal(size=(2, 5, 37))).astype(np.float32)
    labels = rng.integers(0, 37, (2, 5))
    jcfg = jget_config("olmo-1b")
    ref, ref_g = jax.value_and_grad(lambda z: jnext_token_loss(jcfg, z, jnp.asarray(labels)))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    out = _next_token_loss(get_config("olmo-1b"), t, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(out, t)
    assert abs(out.item() - float(ref)) <= LOSS_RTOL * abs(float(ref))
    assert np.abs(g.numpy() - np.asarray(ref_g)).max() <= 1e-6 * np.abs(ref_g).max()


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_on_injected_trees(mu_dtype):
    """Three steps on a dict tree with injected gradients (away from 0, where
    the first step's g/|g| is ill-posed), through the warm-up and the clip."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2)}}

    def draw(scale, away=0.0):
        def one(shape):
            x = rng.normal(size=shape)
            return (scale * (x + away * np.sign(x))).astype(np.float32)
        return jax.tree.map(one, shapes, is_leaf=lambda s: isinstance(s, tuple))

    cfg_kw = dict(lr=1e-2, warmup_steps=2, grad_clip=0.5)
    jcfg = JAdamWConfig(**cfg_kw, mu_dtype=getattr(jnp, mu_dtype))
    tcfg = AdamWConfig(**cfg_kw, mu_dtype=getattr(torch, mu_dtype))
    p0 = draw(0.5)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.from_numpy, p0)
    jst, tst = jinit_opt_state(jp, jcfg), init_opt_state(tp, tcfg)
    for _ in range(3):
        g = draw(1.0, away=0.2)
        jp, jst = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jst, jcfg)
        tp, tst = adamw_update(tp, jax.tree.map(torch.from_numpy, g), tst, tcfg)
    assert int(tst.step) == int(jst.step) == 3 and tst.step.dtype == torch.int32
    for got, ref in ((tp, jp), (tst.nu, jst.nu)):
        got, ref = _flat(got), _flat(_np(ref))
        for k in ref:
            assert np.abs(got[k] - ref[k]).max() <= 1e-6 * np.abs(ref[k]).max(), k
    got, ref = _flat(tst.mu), _flat(_np(jst.mu))
    for k in ref:
        assert tst.mu["a"].dtype == getattr(torch, mu_dtype)
        assert np.all(np.abs(got[k] - ref[k]) <= (
            _bf16_ulp(ref[k]) if mu_dtype == "bfloat16" else 1e-6 * np.abs(ref[k]).max())), k


# ---------------------------------------------------------------- compress ----


def test_compress_payload_is_bit_equal_on_the_references_uniforms():
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (1000,))
    k = jax.random.fold_in(key, 1)
    ref = jcompress.compress(x, k)
    u = torch.from_numpy(np.asarray(jax.random.uniform(k, x.shape)))
    got = compress(torch.from_numpy(np.asarray(x)), u=u)
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    assert got.scale.item() == float(ref.scale)
    x2 = decompress(got)
    assert float((x2 - torch.from_numpy(np.asarray(x))).abs().max()) <= got.scale.item() + 1e-6


def test_tree_compress_with_feedback_is_bit_equal_on_the_references_uniforms():
    key = jax.random.PRNGKey(2)
    g = {"b": jax.random.normal(key, (10,)),
         "a": 1e-3 * jax.random.normal(jax.random.fold_in(key, 1), (64, 64))}
    e = jax.tree.map(lambda x: 1e-4 * jnp.ones_like(x), g)
    ck = jax.random.fold_in(key, 7)
    ref_c, ref_e = jcompress.tree_compress_with_feedback(g, e, ck)
    keys = jax.random.split(ck, 2)  # one a leaf, in leaf order: "a", then "b"
    u = [torch.from_numpy(np.asarray(jax.random.uniform(kk, g[name].shape)))
         for kk, name in zip(keys, ("a", "b"))]
    tg, te = (jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), t) for t in (g, e))
    got_c, got_e = tree_compress_with_feedback(tg, te, u=u)
    for name in ("a", "b"):
        np.testing.assert_array_equal(got_c[name].q.numpy(), np.asarray(ref_c[name].q))
        np.testing.assert_array_equal(got_e[name].numpy(), np.asarray(ref_e[name]))
    dec = tree_decompress(got_c, tg)
    for name in ("a", "b"):
        np.testing.assert_array_equal(got_e[name].numpy(),
                                      (tg[name] + te[name] - dec[name]).numpy())


def test_compression_error_feedback_unbiased():
    """tests/test_train.py:100's 5% bound, on a generator's draws."""
    gen = torch.Generator().manual_seed(0)
    g = {"a": torch.randn((64, 64), generator=gen) * 1e-3}
    err = init_error_state(g)
    total_true = torch.zeros((64, 64))
    total_comp = torch.zeros((64, 64))
    for t in range(30):
        gt = {"a": g["a"] * (1.0 + 0.1 * t)}
        comp, err = tree_compress_with_feedback(gt, err, gen)
        dec = tree_decompress(comp, gt)
        total_true += gt["a"]
        total_comp += dec["a"]
    rel = float(torch.linalg.norm(total_comp - total_true) / torch.linalg.norm(total_true))
    assert rel < 0.05, rel
    with pytest.raises(ValueError, match="generator"):
        compress(g["a"])


# ----------------------------------------------------------------- trainer ----


def _tiny():
    return jget_config("olmo-1b").reduced(**TINY), get_config("olmo-1b").reduced(**TINY)


def test_straggler_report_equals_the_references():
    jcfg, cfg = _tiny()
    times = [0.1] * 18 + [0.5, 0.1]
    jtr = JTrainer(jcfg, JTrainerConfig(batch=2, seq_len=16, num_steps=1, log_every=0))
    tr = Trainer(cfg, TrainerConfig(batch=2, seq_len=16, num_steps=1, log_every=0),
                 device="cpu")
    jtr.step_times, tr.step_times = list(times), list(times)
    ref, got = jtr.straggler_report(), tr.straggler_report()
    assert (got.median_s, got.slow_steps) == (ref.median_s, ref.slow_steps)
    assert len(got.slow_steps) == 1 and abs(got.median_s - 0.1) < 1e-6


def test_trainer_matches_the_reference_from_its_params_and_batches():
    """The port's Trainer from the reference Trainer's initial parameters
    and on its batches (the two injection points): its 10 losses within
    1e-4 relative of the reference's."""
    jcfg, cfg = _tiny()
    jtc = JTrainerConfig(batch=4, seq_len=32, num_steps=10, log_every=0,
                         opt=JAdamWConfig(lr=1e-3, mu_dtype=jnp.float32))
    ref = JTrainer(jcfg, jtc)
    ref.run()
    params = lm_params_from_numpy(cfg, _np(ref.init_state()[0]), device="cpu")
    tc = TrainerConfig(batch=4, seq_len=32, num_steps=10, log_every=0,
                       opt=AdamWConfig(lr=1e-3, mu_dtype=torch.float32))
    port = Trainer(cfg, tc, device="cpu",
                   batches=lambda step: _tbatch(jtoken_batch(0, step, 4, 32, cfg.vocab_size)))
    port.run(params=params)
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-4, atol=0)


def test_loss_decreases():
    """tests/test_train.py:28 on the port's own batches and draws."""
    _, cfg = _tiny()
    tc = TrainerConfig(batch=4, seq_len=32, num_steps=40, log_every=0,
                       opt=AdamWConfig(lr=3e-3, warmup_steps=10, mu_dtype=torch.float32))
    tr = Trainer(cfg, tc, device="cpu")
    tr.run()
    first, last = np.mean(tr.losses[:5]), np.mean(tr.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_launch_train_on_the_cpu_and_without_a_card(monkeypatch, capsys):
    tr = launch_train.main(["--arch", "olmo-1b", "--reduced", "--steps", "2", "--batch", "2",
                            "--seq-len", "16", "--device", "cpu"])
    assert len(tr.losses) == len(tr.step_times) == 2 and np.isfinite(tr.losses).all()
    assert "[train] done." in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "olmo-1b", "--reduced", "--steps", "1"])


# ------------------------------------------------------------- checkpoints ----


def _state_pair(mu_dtype):
    """The tiny olmo's params and optimiser state after one reference step,
    in both packages (the port's carried across)."""
    jcfg, params, cfg, _ = _pair("olmo-1b", TINY)
    jo = JAdamWConfig(**STEP_OPT, mu_dtype=getattr(jnp, mu_dtype))
    p1, o1, _ = jax.jit(jmake_train_step(jcfg, jo))(
        params, jinit_opt_state(params, jo), jtoken_batch(0, 0, 4, 32, jcfg.vocab_size))
    model = lm_params_from_numpy(cfg, _np(p1), device="cpu")
    opt = opt_state_from_numpy(cfg, _np(o1.mu), _np(o1.nu), np.asarray(o1.step), device="cpu")
    return {"p": p1, "o": o1}, {"p": model, "o": opt}


def _files(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


def _assert_port_state_equal(a, b):
    for x, y in ((lm_params_to_numpy(a["p"], bf16="words"), lm_params_to_numpy(b["p"], bf16="words")),
                 (opt_state_to_numpy(a["o"]), opt_state_to_numpy(b["o"]))):
        fx, fy = jax.tree.leaves(x), jax.tree.leaves(y)
        assert len(fx) == len(fy)
        for u, v in zip(fx, fy):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_checkpoints_are_the_same_files_from_either_package(tmp_path, mu_dtype):
    """The same state written by each package: identical manifests (keys in
    order, shapes, dtypes, step, extra) and identical arrays; a bf16 ``mu``
    as the reference writes it, ``|V2`` words under the dtype
    ``"bfloat16"``."""
    jstate, tstate = _state_pair(mu_dtype)
    extra = {"losses": [4.75, 4.5]}
    jpath = jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate, extra=extra)
    tpath = save_checkpoint(str(tmp_path / "port"), 1, tstate, extra=extra)
    (jm, ja), (tm, ta) = _files(jpath), _files(tpath)
    assert tm == jm and list(tm["leaves"]) == list(jm["leaves"])
    assert list(ta) == list(ja)
    assert tm["leaves"]["o/.mu/embed/tok"]["dtype"] == mu_dtype
    assert tm["leaves"]["p/layers/mlp/up"]["shape"] == [2, 64, 128]
    assert tm["leaves"]["o/.step"] == {"shape": [], "dtype": "int32"}
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].tobytes() == ja[k].tobytes(), k
    if mu_dtype == "bfloat16":
        assert str(ta["o/.mu/embed/tok"].dtype) == "|V2"


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jstate, tstate = _state_pair("float32")
    jtemplate = jax.tree.map(jnp.zeros_like, jstate)
    got, step, extra = jckpt.restore_checkpoint(
        save_checkpoint(str(tmp_path / "port"), 5, tstate, extra={"losses": [1.0]})
        .rsplit("/", 1)[0], jtemplate)
    assert (step, extra) == (5, {"losses": [1.0]})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jckpt.save_checkpoint(str(tmp_path / "ref"), 6, jstate, extra={"losses": [2.0]})
    _, template = _state_pair("float32")
    got, step, extra = restore_checkpoint(str(tmp_path / "ref"), template)
    assert (step, extra) == (6, {"losses": [2.0]})
    _assert_port_state_equal(got, tstate)


def test_the_references_restore_refuses_a_bf16_leaf(tmp_path):
    """A limit of the reference: its restore calls ``jnp.asarray`` on the
    ``|V2`` array that ``np.load`` gives for a bfloat16 leaf, which JAX
    refuses, so it cannot resume its own default (bf16 ``mu``) state. The
    port restores it (test_bf16_mu_round_trips_bit_exact)."""
    jstate, _ = _state_pair("bfloat16")
    jckpt.save_checkpoint(str(tmp_path), 1, jstate)
    with pytest.raises(TypeError):
        jckpt.restore_checkpoint(str(tmp_path), jstate)


def test_bf16_mu_round_trips_bit_exact(tmp_path):
    _, tstate = _state_pair("bfloat16")
    assert tstate["o"].mu.embed["tok"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path), 1, tstate)
    _, template = _state_pair("bfloat16")
    for t in template["o"].mu.parameters():
        t.data.zero_()
    got, step, _ = restore_checkpoint(str(tmp_path), template)
    assert step == 1 and got["o"].mu.embed["tok"].dtype == torch.bfloat16
    _assert_port_state_equal(got, tstate)


def test_reference_run_resumed_by_the_port(tmp_path):
    """tests/test_train.py:39's run: the reference trains to step 10 and
    checkpoints, the port's Trainer resumes from that checkpoint to step 20
    on the reference's batches; its losses 11-20 within 1e-4 relative of the
    reference's uninterrupted run."""
    jcfg, cfg = _tiny()

    def jtc(steps, ckpt_dir):
        return JTrainerConfig(batch=4, seq_len=32, num_steps=steps, log_every=0,
                              ckpt_dir=ckpt_dir, ckpt_every=10,
                              opt=JAdamWConfig(lr=1e-3, mu_dtype=jnp.float32))

    full = JTrainer(jcfg, jtc(20, None))
    full.run()
    JTrainer(jcfg, jtc(10, str(tmp_path))).run()
    assert latest_step(str(tmp_path)) == 10
    tc = TrainerConfig(batch=4, seq_len=32, num_steps=20, log_every=0, ckpt_dir=str(tmp_path),
                       ckpt_every=10, opt=AdamWConfig(lr=1e-3, mu_dtype=torch.float32))
    port = Trainer(cfg, tc, device="cpu",
                   batches=lambda step: _tbatch(jtoken_batch(0, step, 4, 32, cfg.vocab_size)))
    port.run()
    assert port.losses[:10] == full.losses[:10]  # carried in the checkpoint's extra
    np.testing.assert_allclose(port.losses[10:], full.losses[10:], rtol=1e-4, atol=0)
    assert latest_step(str(tmp_path)) == 20


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restart_exact(tmp_path, mu_dtype):
    """Kill-and-resume reproduces the uninterrupted run bit for bit
    (tests/test_train.py:39), also with the default bf16 ``mu``."""
    _, cfg = _tiny()
    opt = AdamWConfig(lr=1e-3, mu_dtype=getattr(torch, mu_dtype))

    def make(steps, ckpt_dir):
        return Trainer(cfg, TrainerConfig(batch=4, seq_len=32, num_steps=steps, log_every=0,
                                          ckpt_dir=ckpt_dir, ckpt_every=10, opt=opt),
                       device="cpu")

    t_full = make(20, str(tmp_path / "full"))
    p_full, o_full = t_full.run()
    make(10, str(tmp_path / "resume")).run()
    assert latest_step(str(tmp_path / "resume")) == 10
    t_b = make(20, str(tmp_path / "resume"))
    p_res, o_res = t_b.run()
    assert t_b.losses == t_full.losses
    _assert_port_state_equal({"p": p_full, "o": o_full}, {"p": p_res, "o": o_res})


def test_port_checkpoint_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    save_checkpoint(d, 5, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # partial tmp dirs are ignored
    assert latest_step(d) == 5
    restored, step, _ = restore_checkpoint(d, tree)
    assert step == 5
    torch.testing.assert_close(restored["w"], tree["w"], rtol=0, atol=0)
