"""Model assembly — twin of ``repro/models/model.py``: the uniform decoder
stacks (the dense decoders, qwen2-vl with its M-RoPE positions and stub
vision embeddings, the MoE decoders dbrx and deepseek-v2 with its MLA mixer,
the attention-free mamba2), jamba's 8-layer period and whisper's
encoder-decoder over stub frame embeddings. Three entry points:

    forward_train(cfg, model, inputs)            → logits (b, s, v)
    prefill(cfg, model, inputs, cache)           → (last logits, filled cache)
    decode_step(cfg, model, token, cache, index) → (logits, updated cache)

``model`` is a :class:`Transformer`: the reference's params pytree as an
``nn.Module``, each layer stack an ``nn.ModuleList`` of :class:`Block` (or, for
jamba, :class:`Period`) walked by a Python loop where the reference scans;
whisper has two, ``enc_layers`` and ``dec_layers``. The cache has the
reference's keys (``attn``; ``mamba``; MLA's ``ckv`` and ``krope``; whisper's
``self`` and ``memory``), a list a layer (a period's mamba caches a list of
7) where the reference stacks, its buffers written in place.

In training the residual stream between blocks carries the reference's
sequence-parallel ``shard`` (:func:`_seq_shard`), and every branch's output
has its partial sums reduced before it joins the stream
(``sharding_ctx.reduce_partial``): no-ops outside a mesh context.
:func:`abstract_model_params` and :func:`abstract_cache` give the
reference's stacked trees as meta tensors for the dry run.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import moe, ssm
from .attention import (
    gqa_apply, gqa_make_cache, gqa_params, mla_apply, mla_make_cache, mla_params,
)
from .layers import embed, embed_params, mlp, mlp_params, rmsnorm, rmsnorm_params, unembed
from .param import (
    abstract_params, init_params, leaves, logical_axes, param_count, stack_schema, tree_map,
)
from .sharding_ctx import reduce_partial, shard


#: the params tree's stacked layer groups (leading layer dim)
STACKS = ("layers", "enc_layers", "dec_layers")
#: a block's keys, in the order of its forward
BLOCK_KEYS = ("norm1", "mixer", "norm_x", "cross", "norm2", "mlp")


# --------------------------------------------------------------- schemas -----


def _block_schema(cfg: ModelConfig, mixer: str, mlp_kind: str, cross: bool = False):
    if mixer == "attn":
        mix = mla_params(cfg) if cfg.use_mla else gqa_params(cfg)
    else:
        mix = ssm.mamba_params(cfg)
    s: dict[str, Any] = {"norm1": rmsnorm_params(cfg), "mixer": mix}
    if mlp_kind != "none":
        s["norm2"] = rmsnorm_params(cfg)
        s["mlp"] = moe.moe_params(cfg) if mlp_kind == "moe" else mlp_params(cfg)
    if cross:
        s["norm_x"] = rmsnorm_params(cfg)
        s["cross"] = gqa_params(cfg)
    return s


def _layer_plan(cfg: ModelConfig) -> dict:
    """How the layer stack decomposes into homogeneous groups."""
    if cfg.family == "ssm":
        return {"kind": "uniform", "mixer": "mamba", "mlp": "none", "n": cfg.num_layers}
    if cfg.family == "hybrid":
        if cfg.num_layers % cfg.attn_layer_period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole periods of "
                             f"{cfg.attn_layer_period}")
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
            {"norm2": rmsnorm_params(cfg), "mlp": moe.moe_params(cfg)}, n_moe, None),
        "dense_mlps": stack_schema(
            {"norm2": rmsnorm_params(cfg), "mlp": mlp_params(cfg)}, per - n_moe - 1, None),
    }


def param_schema(cfg: ModelConfig):
    """The reference's params pytree as ``P`` leaves: ``embed``, ``final_norm``
    and the stacked ``layers`` (leading layer dim; jamba's period stacks a
    sub-block dim after it), or for whisper ``enc_layers``, ``enc_norm`` and
    ``dec_layers`` (its blocks with ``norm_x`` and ``cross``)."""
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


def abstract_model_params(cfg: ModelConfig, dtype=torch.float32, device: DeviceLike = "meta"):
    """The reference's stacked params tree with no data (meta tensors)."""
    return abstract_params(param_schema(cfg), dtype, device)


def model_logical_axes(cfg: ModelConfig):
    return logical_axes(param_schema(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: routed k of E experts), the
    reference's count: every ``moe_layer_period``-th of the layers is MoE."""
    total = count_params(cfg)
    if not cfg.is_moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.expert_ff
    inactive = ((cfg.num_experts - cfg.experts_per_tok) * per_expert
                * (cfg.num_layers // cfg.moe_layer_period))
    return total - inactive


# ---------------------------------------------------------------- module -----


def _parameters(tree: dict) -> nn.ParameterDict:
    """A params dict as a ``ParameterDict``, a nested dict (MoE's ``shared``)
    as a nested one. Serving weights: no autograd (the train step turns it
    on)."""
    return nn.ParameterDict({
        k: _parameters(t) if isinstance(t, dict) else nn.Parameter(t, requires_grad=False)
        for k, t in tree.items()})


class Block(nn.Module):
    """One layer's params: pre-norm mixer (GQA, MLA or Mamba2: ``norm1``,
    ``mixer``), for a whisper decoder layer pre-norm cross-attention
    (``norm_x``, ``cross``), then, unless it is a mamba block, the pre-norm
    MLP (dense or MoE: ``norm2``, ``mlp``); or one of jamba's stand-alone
    MLPs (``norm2``, ``mlp``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k in sorted(tree, key=BLOCK_KEYS.index):
            setattr(self, k, _parameters(tree[k]))


class Period(nn.Module):
    """One jamba period: ``attn_block`` (GQA, dense MLP), ``mamba_blocks``
    (per − 1 mamba blocks), ``moe_mlps`` and ``dense_mlps`` (the MLPs after
    mamba blocks 1, 3, 5, 7 and 2, 4, 6)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.attn_block = Block(tree["attn_block"])
        for k in ("mamba_blocks", "moe_mlps", "dense_mlps"):
            n = next(t for _, t in leaves(tree[k])).shape[0]
            setattr(self, k, nn.ModuleList(
                Block(tree_map(lambda t, j=j: t[j], tree[k])) for j in range(n)))


def _stack(tree: dict, n: int, layer=Block) -> nn.ModuleList:
    """``n`` layers over the slices of a stacked params tree."""
    return nn.ModuleList(layer(tree_map(lambda t, i=i: t[i], tree)) for i in range(n))


class Transformer(nn.Module):
    """The model over a params tree in the reference's layout
    (``param_schema``). Layer ``i``'s parameters (period ``i``'s, and its
    sub-block ``j``'s) are views of slice ``i`` (``[i, j]``) of the stacked
    tensors, so building the module copies nothing."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _parameters(tree["embed"])
        self.final_norm = _parameters(tree["final_norm"])
        if cfg.is_encdec:
            self.enc_layers = _stack(tree["enc_layers"], cfg.encoder_layers)
            self.enc_norm = _parameters(tree["enc_norm"])
            self.dec_layers = _stack(tree["dec_layers"], cfg.num_layers)
            return
        plan = _layer_plan(cfg)
        self.layers = _stack(tree["layers"], plan["n"],
                             Block if plan["kind"] == "uniform" else Period)

    def forward(self, tokens: torch.Tensor, *, backend: str = "auto", **inputs) -> torch.Tensor:
        """``forward_train`` on ``tokens`` and the stub inputs (``frames``,
        ``vision_embeds``)."""
        return forward_train(self.cfg, self, {"tokens": tokens, **inputs}, backend=backend)


def _slices(node, parts: list) -> list:
    """The parameters at key path ``parts`` below ``node``, every
    ``ModuleList`` on the way walked in order (layers, then sub-blocks)."""
    if isinstance(node, nn.ModuleList):
        return [t for child in node for t in _slices(child, parts)]
    if not parts:
        return [node]
    head, *rest = parts
    return _slices(node[head] if isinstance(node, nn.ParameterDict) else getattr(node, head),
                   rest)


def lm_leaves(model: Transformer) -> list:
    """The reference's params pytree as ``model`` holds it: ``(path, tensors)``
    for each leaf in ``jax.tree.flatten``'s order (dict keys sorted), ``path``
    its key path (``"embed/tok"``, ``"layers/mlp/up"``,
    ``"layers/mamba_blocks/mixer/in_proj"``) and ``tensors`` the leaf's
    parameters: one, or a stacked leaf's slices in order (layer-major, then
    a period's sub-blocks)."""
    return [("/".join(path), _slices(model, list(path)))
            for path, _ in leaves(param_schema(model.cfg))]


def leaf_tree(model: Transformer, flat: list) -> dict:
    """``flat``, tensors in :func:`lm_leaves`' order (one per parameter, e.g.
    a gradient's), as the reference's pytree: nested dicts by path (an empty
    norm's included), each stacked leaf's slices stacked again to the
    reference's shape."""
    it = iter(flat)

    def build(schema, path: tuple):
        if isinstance(schema, dict):
            return {k: build(schema[k], path + (k,)) for k in sorted(schema)}
        parts = [next(it) for _ in _slices(model, list(path))]
        return torch.stack(parts).reshape(schema.shape) if path[0] in STACKS else parts[0]

    return build(param_schema(model.cfg), ())


def init_model_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
                      device: DeviceLike = None) -> Transformer:
    """A :class:`Transformer` with weights drawn from ``generator`` (on
    ``device``) at the reference's scales."""
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
    """The reference's cache keys, a buffer dict a layer: ``{"attn": [...]}``
    (GQA's ``k``, ``v``, each (batch, max_len, kv, dh); MLA's ``ckv``,
    ``krope``), ``{"mamba": [...]}`` (``conv`` in ``dtype``, the ``ssm``
    state fp32), or for jamba both, ``"mamba"`` a list of per − 1 a period;
    for whisper ``{"self": [...], "memory": (batch, encoder_seq, d_model)}``,
    the decoder's self-attention buffers and the encoder's output."""
    dev = resolve_device(device)
    plan = _layer_plan(cfg)

    def attn():
        make = mla_make_cache if cfg.use_mla else gqa_make_cache
        return make(cfg, batch, max_len, dtype, dev)

    def mamba():
        return ssm.mamba_make_cache(cfg, batch, dtype, dev)

    if cfg.is_encdec:
        return {"self": [attn() for _ in range(cfg.num_layers)],
                "memory": torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                      device=dev)}
    if plan["kind"] == "period":
        return {"attn": [attn() for _ in range(plan["n"])],
                "mamba": [[mamba() for _ in range(plan["period"] - 1)]
                          for _ in range(plan["n"])]}
    if plan["mixer"] == "mamba":
        return {"mamba": [mamba() for _ in range(plan["n"])]}
    return {"attn": [attn() for _ in range(plan["n"])]}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = "meta") -> dict:
    """The reference's stacked cache tree with no data (meta tensors): each
    layer group's buffers with the group's layer count (and a period's 7
    mamba blocks) in front, the ``ssm`` state fp32."""
    dev = torch.device(device)
    plan = _layer_plan(cfg)

    def stacked(make, lead: tuple):
        return {k: torch.empty(lead + tuple(t.shape), dtype=t.dtype, device=dev)
                for k, t in make().items()}

    def attn():
        make = mla_make_cache if cfg.use_mla else gqa_make_cache
        return make(cfg, batch, max_len, dtype, "meta")

    def mamba():
        return ssm.mamba_make_cache(cfg, batch, dtype, "meta")

    if cfg.is_encdec:
        return {"self": stacked(attn, (cfg.num_layers,)),
                "memory": torch.empty((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                      device=dev)}
    if plan["kind"] == "period":
        return {"attn": stacked(attn, (plan["n"],)),
                "mamba": stacked(mamba, (plan["n"], plan["period"] - 1))}
    if plan["mixer"] == "mamba":
        return {"mamba": stacked(mamba, (plan["n"],))}
    return {"attn": stacked(attn, (plan["n"],))}


# --------------------------------------------------------------- forward -----


def _seq_shard(h: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel residual stream (Megatron SP): between blocks in
    training, activations (b, s, d) shard their seq dim over the mesh "model"
    axis."""
    if h.ndim == 3 and h.shape[1] > 1:
        return shard(h, "batch", "seq_act", None)
    return h


def _apply_block(p: Block, cfg, h, positions, mode, cache, cache_index, mixer: str,
                 mlp_kind: str, *, cross_mem=None, causal=True, backend="auto"):
    """One block: the mixer (``causal=False``: whisper's encoder), then with
    ``cross_mem`` cross-attention to it, then the MLP."""
    x = rmsnorm(p.norm1, h, cfg.norm_eps)
    if mixer == "mamba":
        mixed, new_cache = ssm.mamba_apply(p.mixer, cfg, x, mode, cache, cache_index)
    elif cfg.use_mla:
        mixed, new_cache = mla_apply(p.mixer, cfg, x, positions, mode, cache, cache_index)
    else:
        mixed, new_cache = gqa_apply(p.mixer, cfg, x, positions, mode, cache, cache_index,
                                     causal=causal, backend=backend)
    h = h + reduce_partial(mixed)
    if cross_mem is not None:
        xattn, _ = gqa_apply(p.cross, cfg, rmsnorm(p.norm_x, h, cfg.norm_eps), positions,
                             mode, cross_kv=(cross_mem,))
        h = h + reduce_partial(xattn)
    return _apply_mlp(p, cfg, h, mlp_kind), new_cache


def _apply_mlp(p: Block, cfg, h, mlp_kind: str):
    if mlp_kind == "dense":
        return h + reduce_partial(mlp(p.mlp, rmsnorm(p.norm2, h, cfg.norm_eps)))
    if mlp_kind == "moe":
        return h + reduce_partial(moe.moe_apply(p.mlp, cfg, rmsnorm(p.norm2, h, cfg.norm_eps)))
    return h


def _apply_period(p: Period, cfg, h, positions, mode, cache, cache_index, backend):
    """One jamba period: the attention block (dense MLP), then each mamba
    block followed by an MoE MLP (odd sub-layers) or a dense one."""
    h, _ = _apply_block(p.attn_block, cfg, h, positions, mode,
                        None if cache is None else cache["attn"], cache_index, "attn", "dense",
                        backend=backend)
    i_moe = i_dense = 0
    for i, blk in enumerate(p.mamba_blocks, start=1):
        h, _ = _apply_block(blk, cfg, h, positions, mode,
                            None if cache is None else cache["mamba"][i - 1], cache_index,
                            "mamba", "none")
        if i % cfg.moe_layer_period == 1:  # global layer 8p + i; odd i → MoE
            h = _apply_mlp(p.moe_mlps[i_moe], cfg, h, "moe")
            i_moe += 1
        else:
            h = _apply_mlp(p.dense_mlps[i_dense], cfg, h, "dense")
            i_dense += 1
    return h


def _positions_for(cfg: ModelConfig, batch: int, seq: int, offset: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(batch, seq) positions offset + 0 … seq − 1; with M-RoPE (3, batch,
    seq): the same positions in the (t, h, w) streams, except that a sequence
    of at least ``vision_tokens`` has the stub vision region's
    side × side grid (side = ⌊√vision_tokens⌋) in the h and w streams of its
    first ``vision_tokens`` positions. Text after the grid is not shifted
    past it (the reference's simplification of Qwen2-VL). Under a mesh
    context the batch dim is split as the activations' is, so that no rank
    builds the whole batch's rotary tables."""
    pos = (offset + torch.arange(seq, device=device))[None].expand(batch, seq)
    if not cfg.use_mrope:
        return shard(pos, "batch", None)
    vt = cfg.vision_tokens
    side = max(int(vt ** 0.5), 1)
    th, tw = pos.clone(), pos.clone()
    if vt and seq >= vt:
        grid = torch.arange(vt, device=device)
        th[:, :vt] = grid // side
        tw[:, :vt] = grid % side
    return shard(torch.stack([pos, th, tw]), None, "batch", None)


def _trunk(cfg, model, h, positions, mode, cache, cache_index, backend):
    plan = _layer_plan(cfg)
    sq = _seq_shard if mode == "train" else (lambda x: x)
    h = sq(h)
    if plan["kind"] == "period":
        for i, per in enumerate(model.layers):
            c = None if cache is None else {"attn": cache["attn"][i],
                                            "mamba": cache["mamba"][i]}
            h = sq(_apply_period(per, cfg, h, positions, mode, c, cache_index, backend))
        return h, cache
    key = "mamba" if plan["mixer"] == "mamba" else "attn"
    for i, blk in enumerate(model.layers):
        h, _ = _apply_block(blk, cfg, h, positions, mode,
                            None if cache is None else cache[key][i], cache_index,
                            plan["mixer"], plan["mlp"], backend=backend)
        h = sq(h)
    return h, cache


def _encode(cfg, model, frames: torch.Tensor, backend: str) -> torch.Tensor:
    """whisper's encoder over stub frame embeddings (b, encoder_seq, d): its
    layers in train mode with full (non-causal) self-attention, then
    ``enc_norm``."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device)[None].expand(b, s)
    h = _seq_shard(frames)
    for blk in model.enc_layers:
        h, _ = _apply_block(blk, cfg, h, pos, "train", None, None, "attn", "dense",
                            causal=False, backend=backend)
        h = _seq_shard(h)
    return rmsnorm(model.enc_norm, h, cfg.norm_eps)


def _decode_trunk(cfg, model, h, positions, mode, cache, cache_index, memory, backend):
    """whisper's decoder stack: cached self-attention, cross-attention to
    ``memory``."""
    sq = _seq_shard if mode == "train" else (lambda x: x)
    h = sq(h)
    for i, blk in enumerate(model.dec_layers):
        h, _ = _apply_block(blk, cfg, h, positions, mode,
                            None if cache is None else cache["self"][i], cache_index,
                            "attn", "dense", cross_mem=memory, backend=backend)
        h = sq(h)
    return h, cache


def _inputs_to_h(cfg, model, inputs: dict, mode: str) -> torch.Tensor:
    """The token embeddings; for qwen2-vl outside decode, the stub vision
    embeddings (b, vision_tokens, d) in place of the first ``vision_tokens``
    positions. A prompt shorter than that comes out ``vision_tokens`` long,
    as in the reference."""
    h = embed(model.embed, inputs["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in inputs and mode != "decode":
        vt = cfg.vision_tokens
        h = torch.cat([inputs["vision_embeds"].to(h.dtype), h[:, vt:]], dim=1)
    return h


def _prompt(cfg, model, inputs: dict, mode: str, cache, backend: str):
    """The trunk over a whole prompt (train or prefill): the stack over the
    embedded inputs; or whisper's encoder, then its decoder, the memory
    stored in the cache in the cache's dtype."""
    if not cfg.is_encdec:
        h = _inputs_to_h(cfg, model, inputs, mode)
        pos = _positions_for(cfg, h.shape[0], h.shape[1], 0, h.device)
        return _trunk(cfg, model, h, pos, mode, cache, None, backend)
    memory = _encode(cfg, model, inputs["frames"], backend)
    h = embed(model.embed, inputs["tokens"])
    pos = _positions_for(cfg, h.shape[0], h.shape[1], 0, h.device)
    h, cache = _decode_trunk(cfg, model, h, pos, mode, cache, None, memory, backend)
    if cache is not None:
        cache["memory"] = memory.to(cache["memory"].dtype)
    return h, cache


def forward_train(cfg: ModelConfig, model: Transformer, inputs: dict, *,
                  backend: str = "auto") -> torch.Tensor:
    """Full causal LM forward → logits (b, s, vocab). ``inputs``: ``tokens``,
    and whisper's ``frames`` or qwen2-vl's ``vision_embeds``."""
    h, _ = _prompt(cfg, model, inputs, "train", None, backend)
    return unembed(model.embed, rmsnorm(model.final_norm, h, cfg.norm_eps))


def prefill(cfg: ModelConfig, model: Transformer, inputs: dict, cache: dict, *,
            backend: str = "auto"):
    """Process the prompt, fill the cache, return last-position logits (b, 1, v)."""
    h, cache = _prompt(cfg, model, inputs, "prefill", cache, backend)
    h = rmsnorm(model.final_norm, h[:, -1:], cfg.norm_eps)
    return unembed(model.embed, h), cache


def decode_step(cfg: ModelConfig, model: Transformer, token: torch.Tensor, cache: dict,
                cache_index: int):
    """One token (b, 1) against the cache at position ``cache_index``;
    whisper's cross-attention recomputes its keys and values from the cached
    memory."""
    h = embed(model.embed, token)
    pos = _positions_for(cfg, token.shape[0], 1, cache_index, h.device)
    if cfg.is_encdec:
        h, cache = _decode_trunk(cfg, model, h, pos, "decode", cache, cache_index,
                                 cache["memory"], "auto")
    else:
        h, cache = _trunk(cfg, model, h, pos, "decode", cache, cache_index, "auto")
    return unembed(model.embed, rmsnorm(model.final_norm, h, cfg.norm_eps)), cache
