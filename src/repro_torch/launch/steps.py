"""Step functions driven by ``launch/train.py`` and ``launch/serve.py`` — twin
of ``repro/launch/steps.py``:

    train_step(model, opt, batch)            → (model, opt, metrics)
    prefill_step(model, cache, batch)        → (logits, cache)
    serve_step(model, cache, token, index)   → (next_token, logits, cache)

``input_specs(cfg, shape)`` returns meta-device stand-ins for every *data*
input of the step the shape lowers (tokens/labels, stub frame/patch
embeddings, decode token + cache index). Decoding is greedy (``argmax``; ties
go to the first index in both packages).

A train step attends through ``ops.flash_attention`` (on the card the flash
kernel, one launch a GQA layer for each micro-batch; its backward is
autograd of the plain version, the gradient the reference takes through
``_sdpa``; MLA and Mamba2 layers are plain PyTorch, as in the reference),
and updates the model's parameters and the optimiser state in place.

On a model laid out by ``launch.sharding.distribute_model_`` and run under
``models.sharding_ctx.use_mesh`` the same steps are DTensor SPMD programs:
each gradient is brought to its parameter's placements before AdamW.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as model_lib
from ..models.sharding_ctx import current, grad_like_input, is_dtensor, region, shard
from ..train.optim import AdamWConfig, OptState, abstract_opt_state, adamw_update, leaves

COMPUTE_DTYPE = torch.bfloat16


# ----------------------------------------------------------------- inputs -----


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=COMPUTE_DTYPE) -> dict:
    """Abstract data inputs (``meta`` tensors) for the step this (arch ×
    shape) cell lowers."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.mode == "train":
        specs = {"tokens": spec((b, s)), "labels": spec((b, s))}
    elif shape.mode == "prefill":
        specs = {"tokens": spec((b, s))}
    else:  # decode: one new token against a cache of seq_len
        specs = {"token": spec((b, 1)), "cache_index": spec(())}
    if cfg.is_encdec and shape.mode != "decode":
        specs["frames"] = spec((b, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm" and shape.mode != "decode":
        specs["vision_embeds"] = spec((b, cfg.vision_tokens, cfg.d_model), dtype)
    return specs


# ------------------------------------------------------------------- loss -----


def _next_token_loss(cfg: ModelConfig, logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. logits (b, s, v) fp32, labels (b, s):
    one logit row a label (a qwen2-vl prompt shorter than ``vision_tokens``
    comes out ``vision_tokens`` long, and has none for some)."""
    if logits.shape[:-1] != labels.shape:
        raise ValueError(f"{cfg.name}: logits {tuple(logits.shape)} do not match labels "
                         f"{tuple(labels.shape)}")
    lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    if current() is None:
        lab = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    else:
        lab = _label_logits(shifted, labels)
    return torch.mean(grad_like_input(lse - lab))


def _pick(shifted: torch.Tensor, labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return shifted * (labels[..., None] == ids)


def _label_logits(shifted: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit of each row under a mesh context, where the vocab
    dim may be split: each rank keeps its own vocab ids' entries of the row
    (``ids``, the vocab ids laid out as the logits' last dim), zeros the rest,
    and the sum over vocab adds the one nonzero entry across ranks — exact,
    and its backward stays split (a gather's backward would scatter into a
    zero tensor as large as the whole logits on every rank)."""
    ids = torch.arange(shifted.shape[-1], device=shifted.device)
    rows = ("batch", "seq")
    picked = region(_pick, (rows + ("vocab_act",), rows, ("vocab_act",)),
                    rows + ("vocab_act",), shifted, labels, ids)
    return picked.sum(dim=-1)


# ------------------------------------------------------------------ steps -----


def loss_and_grads(cfg: ModelConfig, model, batch: dict, *, micro_steps: int = 1,
                   backend: str = "auto") -> tuple[torch.Tensor, list]:
    """The train step's loss and its gradients, one per tensor of
    ``train.optim.leaves(model)``. ``batch`` holds ``tokens``, ``labels`` and
    the stub inputs (whisper's ``frames``, qwen2-vl's ``vision_embeds``).
    With ``micro_steps`` > 1 every input is cut into that many equal slices
    along its batch axis, and their losses and
    gradients summed in an fp32 accumulator, then divided by ``micro_steps``,
    as the reference's ``lax.scan`` does. ``backend`` routes the attention
    (``ops.flash_attention``)."""
    params = leaves(model)

    def one(mb):
        logits = model_lib.forward_train(cfg, model, mb, backend=backend)
        loss = _next_token_loss(cfg, logits, mb["labels"])
        return loss.detach(), _laid_out_like(torch.autograd.grad(loss, params), params)

    for p in params:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            if micro_steps == 1:
                loss, grads = one(batch)
                return loss, list(grads)
            b = batch["tokens"].shape[0]
            if b % micro_steps:
                raise ValueError(f"batch {b} does not split into {micro_steps} micro-steps")
            m = b // micro_steps
            acc_dt = [torch.promote_types(p.dtype, torch.float32) for p in params]
            loss_sum = torch.zeros((), dtype=acc_dt[0], device=params[0].device)
            acc = [torch.zeros(p.shape, dtype=dt, device=p.device)
                   for p, dt in zip(params, acc_dt)]
            for i in range(micro_steps):
                l, g = one({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                loss_sum = loss_sum + l
                for a, gi in zip(acc, g):
                    a.add_(gi)
                del g
            return loss_sum / micro_steps, [a / micro_steps for a in acc]
    finally:
        for p in params:
            p.requires_grad_(False)


def _laid_out_like(grads, params) -> list:
    """Each gradient laid out as its parameter is: DTensor leaves a sharded
    parameter's gradient partial over the axes its batch was split on, and
    this is the reduce-scatter (or all-reduce) that the reference's
    ``out_shardings`` force. Plain tensors pass through."""
    return [g.redistribute(p.device_mesh, p.placements) if is_dtensor(p) else g
            for g, p in zip(grads, params)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    micro_steps: int = 1, *, backend: str = "auto"):
    """Fused fwd + bwd + AdamW step. micro_steps > 1 runs gradient
    accumulation over batch slices: activation liveness drops ×micro_steps
    at the cost of holding one fp32 gradient accumulator. The step updates
    ``model`` and ``opt``'s moments in place and returns them with
    ``{"loss", "step"}`` (device tensors)."""
    def train_step(model, opt: OptState, batch: dict):
        with record_function("train_step/forward_backward"):
            loss, grads = loss_and_grads(cfg, model, batch, micro_steps=micro_steps,
                                         backend=backend)
        with record_function("train_step/adamw"):
            model, opt = adamw_update(model, grads, opt, opt_cfg)
        return model, opt, {"loss": loss, "step": opt.step}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, backend: str = "auto"):
    """``batch`` holds ``tokens`` and the stub inputs (``frames``,
    ``vision_embeds``); ``backend`` routes the prompt's attention
    (``ops.flash_attention``)."""

    def prefill_step(model, cache: dict, batch: dict):
        return model_lib.prefill(cfg, model, batch, cache, backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache: dict, token: torch.Tensor, cache_index: int):
        logits, cache = model_lib.decode_step(cfg, model, token, cache, cache_index)
        # under a mesh the last logits gather their vocab first: the argmax is local
        next_token = torch.argmax(shard(logits[:, -1], "batch", None), dim=-1)[:, None]
        return next_token, logits, cache

    return serve_step



# ---------------------------------------------------------------- helpers -----


def abstract_state(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                   dtype=COMPUTE_DTYPE):
    """Abstract (params, opt) trees for the train dry run: the reference's
    stacked trees as meta tensors."""
    params = model_lib.abstract_model_params(cfg, dtype)
    return params, abstract_opt_state(params, opt_cfg)
