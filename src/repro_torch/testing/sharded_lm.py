"""The sharded LM held against the unsharded one, for the CPU tests (gloo
ranks, ``tests/test_torch_sharded_lm*.py``) and the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``'s ``lm_sharded`` phase).

:func:`compare` runs one reduced (or full) config both ways on the same
weights — drawn once with numpy from a seed, identical on every rank
(:func:`numpy_model`) — and returns the largest differences, each relative
to the unsharded tensor's scale: the logits of ``forward_train``, of a
prefill and of two greedy decode steps (fed the unsharded run's tokens), and
of one train step the loss, every gradient and every updated parameter.

An updated parameter is compared only where Adam's first step is well posed
(``tests/test_torch_train.py``'s rule, with ε's bound at 1000 ε): m̂/√v̂ ≈
sign(g) moves on a gradient entry within 100× its own sharded-vs-unsharded
difference, or below 1000 ε (:data:`EPS_POSED`).
MoE configs record the router's smallest top-k margin over every routing of
the unsharded runs: a margin near rounding would let the two runs route
differently, and the test checks it first.
"""
from __future__ import annotations

import copy
import json
import math
from pathlib import Path
import numpy as np
import torch

from ..configs.base import ModelConfig, get_config
from ..models import model as model_lib
from ..models import moe
from ..models.param import leaves as schema_leaves
from ..models.sharding_ctx import use_mesh
from ..train.optim import AdamWConfig, init_opt_state
from ..train.optim import leaves as param_leaves
from ..launch import sharding, steps
from ..models.layers import at_least_fp32, matmul

#: Adam's first step q = g/(|g| + ε) is compared where |g| > ILL_POSED × its
#: difference and |g| > EPS_POSED × ε: there Δq ≤ ε·Δg/g² ≤ 1/(ILL_POSED·EPS_POSED)
#: = 1e-5, so a zero-initialised leaf, whose updated scale is the learning
#: rate's, still holds 1e-4 of it
ILL_POSED, EPS_POSED = 100.0, 1000.0
#: one AdamW step at this rate with no warm-up, so that a wrong update shows
STEP_OPT = AdamWConfig(lr=1e-2, warmup_steps=1)
#: the reduced configs of the sharded tests: one a family
FAMILIES = ("llama3-8b", "dbrx-132b", "deepseek-v2-236b", "mamba2-130m",
            "jamba-1.5-large-398b", "whisper-tiny", "qwen2-vl-7b")


def reduced(arch: str) -> ModelConfig:
    """A family's reduced config, 2 layers (jamba: one 8-layer period)."""
    cfg = get_config(arch).reduced()
    return cfg if cfg.is_hybrid else cfg.reduced(num_layers=2)


def numpy_model(cfg: ModelConfig, seed: int, dtype=torch.float32, device="cpu"):
    """A ``Transformer`` whose weights are drawn with numpy (the reference's
    scales: 0.02 N(0, 1) embeddings, N(0, 1)/√fan_in, ones, zeros), the
    same on every rank for one seed."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "zeros":
            a = np.zeros(p.shape)
        elif p.init == "ones":
            a = np.ones(p.shape)
        else:
            a = rng.standard_normal(p.shape) * (0.02 if p.init == "embed" else p.scale)
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    schema = model_lib.param_schema(cfg)
    tree = {}
    for path, p in schema_leaves(schema):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw(p)
    for k in ("final_norm", "enc_norm"):  # OLMo's empty norms
        if k in schema and k not in tree:
            tree[k] = {}
    return model_lib.Transformer(cfg, tree)


def numpy_inputs(cfg: ModelConfig, b: int, s: int, seed: int, device="cpu",
                 dtype=torch.float32) -> dict:
    """tokens, labels and the stub inputs (frames, vision embeddings)."""
    rng = np.random.default_rng(seed + 1)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
           "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))}
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(
            rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    return {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
            for k, v in out.items()}


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b| (a may be a DTensor: its full value)."""
    a, b = _full(a).float(), _full(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


class _Margins:
    """The smallest top-k gate margin of every ``moe.route`` call within."""

    def __init__(self):
        self.min = math.inf

    def __enter__(self):
        self._route = moe.route

        def route(p, cfg, xg):
            out = self._route(p, cfg, xg)
            logits = torch.softmax(at_least_fp32(matmul(_full(xg), _full(p["router"]))), dim=-1)
            top = torch.topk(logits, cfg.experts_per_tok + 1, dim=-1)[0]
            k = cfg.experts_per_tok
            self.min = min(self.min, float((top[..., k - 1] - top[..., k]).min()))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def compare(cfg: ModelConfig, mesh, profile: str, *, modes=("forward", "decode", "train"),
            b: int = 4, s: int = 64, seed: int = 0, device="cpu",
            dtype=torch.float32) -> dict:
    """The sharded runs of ``cfg`` on ``mesh`` under ``profile`` against the
    unsharded ones on the same weights; every rank must call it (it runs
    collectives). Returns ``{check: largest relative difference}``, plus
    ``margin`` for MoE configs and ``ill_posed``, the share of updated
    parameter entries (of those whose gradient ε does not swamp: the
    embedding rows of tokens absent from the batch are) left out for a
    gradient within 100× its difference."""
    base = numpy_model(cfg, seed, dtype, device)
    batch = numpy_inputs(cfg, b, s, seed, device, dtype)
    rules = sharding.activation_rules(mesh, profile)
    out: dict = {}
    margins = _Margins()
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    if "forward" in modes:
        with torch.no_grad(), margins:
            ref = model_lib.forward_train(cfg, base, prompt)
        model = sharding.distribute_model_(copy.deepcopy(base), cfg, mesh, profile)
        with torch.no_grad(), use_mesh(mesh, rules):
            got = model_lib.forward_train(cfg, model, sharding.distribute_batch(prompt, mesh))
        out["forward"] = rel(got, ref)
    if "decode" in modes:
        with torch.no_grad(), margins:
            cache = model_lib.zero_cache(cfg, b, s + 2, dtype, device)
            ref, cache = model_lib.prefill(cfg, base, prompt, cache)
            toks, refs = [], [ref]
            for i in range(2):
                toks.append(torch.argmax(refs[-1][:, -1], dim=-1)[:, None])
                lg, cache = model_lib.decode_step(cfg, base, toks[-1], cache, s + i)
                refs.append(lg)
        model = sharding.distribute_model_(copy.deepcopy(base), cfg, mesh, profile)
        dcache = sharding.distribute_cache(model_lib.zero_cache(cfg, b, s + 2, dtype, device),
                                           mesh, b)
        with torch.no_grad(), use_mesh(mesh, rules):
            got, dcache = model_lib.prefill(cfg, model, sharding.distribute_batch(prompt, mesh),
                                            dcache)
            gots = [got]
            for i, tok in enumerate(toks):
                lg, dcache = model_lib.decode_step(
                    cfg, model, sharding.distribute_batch({"t": tok}, mesh)["t"], dcache, s + i)
                gots.append(lg)
        out["prefill"] = rel(gots[0], refs[0])
        out["decode"] = max(rel(g, r) for g, r in zip(gots[1:], refs[1:]))
    if "train" in modes:
        ref_model = copy.deepcopy(base)
        step = steps.make_train_step(cfg, STEP_OPT)
        with margins:
            loss, grads = steps.loss_and_grads(cfg, ref_model, batch)
        ref_model, _, _ = step(ref_model, init_opt_state(ref_model, STEP_OPT), batch)
        model = sharding.distribute_model_(copy.deepcopy(base), cfg, mesh, profile)
        opt = init_opt_state(model, STEP_OPT)
        with use_mesh(mesh, rules):
            placed = sharding.distribute_batch(batch, mesh)
            sloss, sgrads = steps.loss_and_grads(cfg, model, placed)
            model, _, _ = step(model, opt, placed)
        out["loss"] = rel(sloss, loss)
        sgrads = [_full(g) for g in sgrads]
        out["grads"] = max(rel(g, r) for g, r in zip(sgrads, grads))
        worst, left_out, total = 0.0, 0, 0
        for p, r, g, gr in zip(param_leaves(model), param_leaves(ref_model), sgrads, grads):
            posed = gr.abs() > ILL_POSED * (g - gr).abs()
            moved = gr.abs() > EPS_POSED * STEP_OPT.eps  # ε moves the quotient below this
            ok = posed & moved
            diff = (_full(p) - r).abs()
            scale = float(r.abs().max().clamp(min=1e-30))
            if ok.any():
                worst = max(worst, float(diff[ok].max()) / scale)
            left_out += int((moved & ~posed).sum())
            total += int(moved.sum())
        out["params"] = worst
        out["ill_posed"] = left_out / max(total, 1)
    if cfg.is_moe:
        out["margin"] = margins.min
    return out


def rank_main(rank: int, world: int, port: int, shape: tuple, cases: list, out_dir: str) -> None:
    """A spawned gloo rank: joins a ``shape`` mesh over ("data", "model") at
    ``tcp://localhost:port`` and runs ``compare`` for each ``(arch,
    profile)`` of ``cases``; rank 0 writes ``{"arch/profile": result}`` to
    ``out_dir/results.json``. A case that raises records its error and the
    ranks go on (they fail alike: a rule DTensor lacks raises on every rank)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))
    results = {}
    for arch, profile in cases:
        try:
            results[f"{arch}/{profile}"] = compare(reduced(arch), mesh, profile)
        except Exception as err:  # noqa: BLE001 — recorded for the test that reads it
            results[f"{arch}/{profile}"] = {"error": f"{type(err).__name__}: {err}"}
    if rank == 0:
        Path(out_dir, "results.json").write_text(json.dumps(results))
    dist.destroy_process_group()


def run_cases(shape: tuple, cases: list, *, timeout: float = 300.0) -> dict:
    """``rank_main`` on ``prod(shape)`` spawned ranks; rank 0's results."""
    import tempfile

    from .ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(rank_main, math.prod(shape), tuple(shape), list(cases), tmp, timeout=timeout)
        return json.loads(Path(tmp, "results.json").read_text())


def flash_launches_through(mesh, cfg: ModelConfig, model, prompt: dict, cache: dict,
                           profile: str) -> tuple:
    """A sharded prefill (for the card's checks): its logits and the
    attention dispatches it made by route (``ops.ATTENTION_TRACE_COUNTS``)."""
    from ..kernels import ops

    ops.reset_attention_trace_counts()
    with torch.no_grad(), use_mesh(mesh, sharding.activation_rules(mesh, profile)):
        logits, cache = model_lib.prefill(cfg, model, sharding.distribute_batch(prompt, mesh),
                                          cache)
    return logits, dict(ops.ATTENTION_TRACE_COUNTS)



#: the checks of each test case and their tolerances, relative to scale
TOLERANCES = {"forward": {"forward": 1e-5},
              "decode": {"prefill": 1e-5, "decode": 1e-5},
              "train": {"loss": 1e-5, "grads": 1e-4, "params": 1e-4}}
#: the router's k-th and (k+1)-th gates at least this far apart
MARGIN = 1e-5  # tests/test_torch_families.py's
#: the share of updated entries that Adam's ill-posed rule may leave out
ILL_POSED_SHARE = 1e-3
_RUNS: dict = {}


def _run(key: tuple) -> None:
    shape, profile = key
    try:
        _RUNS[key] = run_cases(shape, [(a, profile) for a in FAMILIES])
    except Exception as err:  # noqa: BLE001 — raised to every case that reads it
        _RUNS[key] = err


def prefetch(*keys: tuple) -> None:
    """Run the families on several ``(shape, profile)`` meshes at once (each
    its own spawned ranks), for the cases that :func:`assert_case` reads."""
    import threading

    threads = [threading.Thread(target=_run, args=(tuple((tuple(s), p)),))
               for s, p in keys if (tuple(s), p) not in _RUNS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def assert_case(shape: tuple, profile: str, arch: str, check: str) -> None:
    """One test case: the families' run on ``shape`` under ``profile``
    (spawned once a process, every family in one run) holds ``arch``'s
    ``check`` to :data:`TOLERANCES`."""
    key = (tuple(shape), profile)
    if key not in _RUNS:
        _run(key)
    if isinstance(_RUNS[key], Exception):
        raise _RUNS[key]
    res = _RUNS[key][f"{arch}/{profile}"]
    assert "error" not in res, res.get("error")
    if "margin" in res:
        assert res["margin"] > MARGIN, f"router top-k margin {res['margin']:.2e}"
    for name, tol in TOLERANCES[check].items():
        assert res[name] <= tol, f"{name}: {res[name]:.3e} > {tol:.0e} ({res})"
    if check == "train":
        assert res["ill_posed"] <= ILL_POSED_SHARE, res
