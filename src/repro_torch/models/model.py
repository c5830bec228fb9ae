"""Model assembly — twin of ``repro/models/model.py`` for the uniform dense
decoder plan (llama3, deepseek-coder, minitron, OLMo). Three entry points:

    forward_train(cfg, model, inputs)            → logits (b, s, v)
    prefill(cfg, model, inputs, cache)           → (last logits, filled cache)
    decode_step(cfg, model, token, cache, index) → (logits, updated cache)

``model`` is a :class:`Transformer`: the reference's params pytree as an
``nn.Module``, its layer stack an ``nn.ModuleList`` walked by a Python loop
where the reference scans. The cache is a list of per-layer key/value
buffers, written in place.

``param_schema``/``count_params`` cover all ten configs (they allocate
nothing); building a model, or a cache, for MoE, MLA, SSM, hybrid,
encoder-decoder or VLM configs raises: ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .attention import gqa_apply, gqa_make_cache, gqa_params, mla_params
from .layers import embed, embed_params, mlp, mlp_params, rmsnorm, rmsnorm_params, unembed
from .param import P, init_params, param_count, stack_schema, tree_map


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the families whose modules are not ported yet."""
    if (cfg.family != "dense" or cfg.is_moe or cfg.use_mla or cfg.is_encdec
            or cfg.use_mrope):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) is not ported yet: the MoE, MLA, SSM, "
            f"hybrid, encoder-decoder and VLM modules are ROADMAP queue 1 item 14"
        )


# --------------------------------------------------------------- schemas -----


def _moe_params(cfg):
    """``repro/models/moe.py``'s schema, for counting only."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.expert_ff
    out = {
        "router": P((d, e), ("embed", None)),
        "gate": P((e, d, ff), ("experts", "embed", "mlp")),
        "up": P((e, d, ff), ("experts", "embed", "mlp")),
        "down": P((e, ff, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        out["shared"] = mlp_params(cfg, d_ff=cfg.num_shared_experts * cfg.expert_ff)
    return out


def _mamba_params(cfg):
    """``repro/models/ssm.py``'s schema, for counting only."""
    d, din = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    return {
        "in_proj": P((d, 2 * din + 2 * n + h), ("embed", "d_inner")),
        "conv_w": P((cfg.ssm_conv_width, conv_ch), (None, "d_inner")),
        "conv_b": P((conv_ch,), ("d_inner",), init="zeros"),
        "a_log": P((h,), (None,), init="ones"),
        "d_skip": P((h,), (None,), init="ones"),
        "dt_bias": P((h,), (None,), init="zeros"),
        "norm_scale": P((din,), ("d_inner",), init="ones"),
        "out_proj": P((din, d), ("d_inner", "embed")),
    }


def _block_schema(cfg: ModelConfig, mixer: str, mlp_kind: str, cross: bool = False):
    if mixer == "attn":
        mix = mla_params(cfg) if cfg.use_mla else gqa_params(cfg)
    else:
        mix = _mamba_params(cfg)
    s: dict[str, Any] = {"norm1": rmsnorm_params(cfg), "mixer": mix}
    if mlp_kind != "none":
        s["norm2"] = rmsnorm_params(cfg)
        s["mlp"] = _moe_params(cfg) if mlp_kind == "moe" else mlp_params(cfg)
    if cross:
        s["norm_x"] = rmsnorm_params(cfg)
        s["cross"] = gqa_params(cfg)
    return s


def _layer_plan(cfg: ModelConfig) -> dict:
    """How the layer stack decomposes into homogeneous groups."""
    if cfg.family == "ssm":
        return {"kind": "uniform", "mixer": "mamba", "mlp": "none", "n": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"kind": "period", "n": cfg.num_layers // cfg.attn_layer_period,
                "period": cfg.attn_layer_period}
    mlp_kind = "moe" if cfg.is_moe else "dense"
    return {"kind": "uniform", "mixer": "attn", "mlp": mlp_kind, "n": cfg.num_layers}


def _period_schema(cfg: ModelConfig):
    """jamba's 8-layer period: [attn, mamba×7]; MLPs alternate dense/MoE."""
    per = cfg.attn_layer_period
    n_moe = per // cfg.moe_layer_period
    return {
        "attn_block": _block_schema(cfg, "attn", "dense"),
        "mamba_blocks": stack_schema(_block_schema(cfg, "mamba", "none"), per - 1, None),
        "moe_mlps": stack_schema(
            {"norm2": rmsnorm_params(cfg), "mlp": _moe_params(cfg)}, n_moe, None),
        "dense_mlps": stack_schema(
            {"norm2": rmsnorm_params(cfg), "mlp": mlp_params(cfg)}, per - n_moe - 1, None),
    }


def param_schema(cfg: ModelConfig):
    """The reference's params pytree as ``P`` leaves: ``embed``, ``final_norm``
    and the stacked ``layers`` (leading layer dim)."""
    plan = _layer_plan(cfg)
    sch: dict[str, Any] = {"embed": embed_params(cfg), "final_norm": rmsnorm_params(cfg)}
    if plan["kind"] == "uniform":
        sch["layers"] = stack_schema(_block_schema(cfg, plan["mixer"], plan["mlp"]), plan["n"])
    else:
        sch["layers"] = stack_schema(_period_schema(cfg), plan["n"])
    if cfg.is_encdec:
        sch["enc_layers"] = stack_schema(_block_schema(cfg, "attn", "dense"), cfg.encoder_layers)
        sch["enc_norm"] = rmsnorm_params(cfg)
        sch["dec_layers"] = stack_schema(_block_schema(cfg, "attn", "dense", cross=True),
                                         cfg.num_layers)
        del sch["layers"]
    return sch


def count_params(cfg: ModelConfig) -> int:
    return param_count(param_schema(cfg))


# ---------------------------------------------------------------- module -----


def _parameters(tree: dict) -> nn.ParameterDict:
    # serving weights: no autograd (the training slice turns it on)
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False) for k, t in tree.items()})


class Block(nn.Module):
    """One decoder layer: pre-norm GQA mixer, then pre-norm SwiGLU MLP."""

    def __init__(self, tree: dict):
        super().__init__()
        self.norm1 = _parameters(tree["norm1"])
        self.mixer = _parameters(tree["mixer"])
        self.norm2 = _parameters(tree["norm2"])
        self.mlp = _parameters(tree["mlp"])


class Transformer(nn.Module):
    """The dense decoder over a params tree in the reference's layout
    (``param_schema``). Layer ``i``'s parameters are views of slice ``i`` of
    the stacked tensors, so building the module copies nothing."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        check_ported(cfg)
        super().__init__()
        self.cfg = cfg
        self.embed = _parameters(tree["embed"])
        self.final_norm = _parameters(tree["final_norm"])
        self.layers = nn.ModuleList(
            Block(tree_map(lambda t, i=i: t[i], tree["layers"])) for i in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
        return forward_train(self.cfg, self, {"tokens": tokens}, backend=backend)


def lm_leaves(model: Transformer) -> list:
    """The reference's params pytree as ``model`` holds it: ``(path, tensors)``
    for each leaf in ``jax.tree.flatten``'s order (dict keys sorted), ``path``
    its key path (``"embed/tok"``, ``"layers/mlp/up"``) and ``tensors`` the
    leaf's parameters: one, or a stacked leaf's per-layer slices in layer
    order."""
    out = [(f"{group}/{k}", [getattr(model, group)[k]])
           for group in ("embed", "final_norm") for k in sorted(getattr(model, group).keys())]
    first = model.layers[0]
    for name in sorted(n for n, _ in first.named_children()):
        out += [(f"layers/{name}/{k}", [getattr(blk, name)[k] for blk in model.layers])
                for k in sorted(getattr(first, name).keys())]
    return out


def leaf_tree(model: Transformer, flat: list) -> dict:
    """``flat``, tensors in :func:`lm_leaves`' order (one per parameter, e.g.
    a gradient's), as the reference's pytree: nested dicts by path, each
    stacked leaf's slices stacked again along a leading layer axis."""
    tree: dict = {}
    it = iter(flat)
    for path, params in lm_leaves(model):
        parts = [next(it) for _ in params]
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = torch.stack(parts) if path.startswith("layers/") else parts[0]
    return tree


def init_model_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
                      device: DeviceLike = None) -> Transformer:
    """A :class:`Transformer` with weights drawn from ``generator`` (on
    ``device``) at the reference's scales."""
    check_ported(cfg)
    return Transformer(cfg, init_params(param_schema(cfg), generator, dtype, device))


@torch.no_grad()
def cast_model_(model: Transformer, dtype: torch.dtype) -> Transformer:
    """Cast every weight of ``model`` to ``dtype`` in place (the reference's
    params tree cast leaf by leaf). A layer's weights are views of stacked
    tensors, so the casts go stack by stack: each stack's old storage is free
    once its last view is re-pointed, before the next stack is cast, and the
    model is never held whole in both dtypes."""
    stacks: dict = {}
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            stacks.setdefault(p.untyped_storage().data_ptr(), []).append(p)
    for views in stacks.values():
        for p in views:
            p.data = p.data.to(dtype)
        views.clear()
    return model


# --------------------------------------------------------------- caches ------


def zero_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               device: DeviceLike = None) -> dict:
    """``{"attn": [{"k", "v"} per layer]}``, each (batch, max_len, kv, dh)."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"attn": [gqa_make_cache(cfg, batch, max_len, dtype, dev)
                     for _ in range(cfg.num_layers)]}


# --------------------------------------------------------------- forward -----


def _apply_block(p: Block, cfg, h, positions, mode, cache, cache_index, *, backend="auto"):
    mixed, new_cache = gqa_apply(p.mixer, cfg, rmsnorm(p.norm1, h, cfg.norm_eps), positions,
                                 mode, cache, cache_index, backend=backend)
    h = h + mixed
    h = h + mlp(p.mlp, rmsnorm(p.norm2, h, cfg.norm_eps))
    return h, new_cache


def _positions_for(cfg: ModelConfig, batch: int, seq: int, offset: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(batch, seq) positions offset + 0 … seq − 1 (no M-RoPE)."""
    pos = offset + torch.arange(seq, device=device)
    return pos[None].expand(batch, seq)


def _trunk(cfg, model, h, positions, mode, cache, cache_index, backend):
    for i, blk in enumerate(model.layers):
        layer_cache = None if cache is None else cache["attn"][i]
        h, _ = _apply_block(blk, cfg, h, positions, mode, layer_cache, cache_index,
                            backend=backend)
    return h, cache


def forward_train(cfg: ModelConfig, model: Transformer, inputs: dict, *,
                  backend: str = "auto") -> torch.Tensor:
    """Full causal LM forward → logits (b, s, vocab)."""
    h = embed(model.embed, inputs["tokens"])
    b, s, _ = h.shape
    pos = _positions_for(cfg, b, s, 0, h.device)
    h, _ = _trunk(cfg, model, h, pos, "train", None, None, backend)
    return unembed(model.embed, rmsnorm(model.final_norm, h, cfg.norm_eps))


def prefill(cfg: ModelConfig, model: Transformer, inputs: dict, cache: dict, *,
            backend: str = "auto"):
    """Process the prompt, fill the cache, return last-position logits (b, 1, v)."""
    h = embed(model.embed, inputs["tokens"])
    b, s, _ = h.shape
    pos = _positions_for(cfg, b, s, 0, h.device)
    h, cache = _trunk(cfg, model, h, pos, "prefill", cache, None, backend)
    h = rmsnorm(model.final_norm, h[:, -1:], cfg.norm_eps)
    return unembed(model.embed, h), cache


def decode_step(cfg: ModelConfig, model: Transformer, token: torch.Tensor, cache: dict,
                cache_index: int):
    """One token (b, 1) against the cache at position ``cache_index``."""
    h = embed(model.embed, token)
    pos = _positions_for(cfg, token.shape[0], 1, cache_index, h.device)
    h, cache = _trunk(cfg, model, h, pos, "decode", cache, cache_index, "auto")
    return unembed(model.embed, rmsnorm(model.final_norm, h, cfg.norm_eps)), cache
