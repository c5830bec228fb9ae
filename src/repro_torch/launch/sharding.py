"""Logical-axis → physical-mesh sharding rules — twin of
``repro/launch/sharding.py`` (MaxText-style), with its rules and priority
order.

Parameters are FSDP-sharded: the "embed" (d_model) axis shards over the DP
axes ("pod", "data"), and tensor-parallel axes (heads / kv / mlp / experts /
vocab / d_inner / kv_lora) shard over "model". Activations: batch over
("pod", "data"); per-token feature axes over "model". The "fsdp" profile
retires "model" into the DP axes for both.

A sharding here is ``(mesh, spec)``, a :class:`Sharding`, whose
``placements`` are DTensor's for that spec. The functions take the port's
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(the reference test's ``FakeMesh``), so the rules can be checked at 16 × 16
with no ranks. :func:`distribute_model_` is the port's counterpart of
``jax.jit(in_shardings=...)``: it turns each parameter of a model into a
DTensor laid out by its evenized spec.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models.param import P, leaves, tree_map
from ..models.sharding_ctx import (
    PartitionSpec, axis_names, axis_sizes, evenize_spec, mesh_size, to_placements,
)

__all__ = [
    "PARAM_RULES", "PARAM_RULES_FSDP", "ACT_RULES", "ACT_RULES_FSDP", "PROFILES",
    "Sharding", "activation_rules", "batch_sharding", "cache_shardings", "distribute",
    "distribute_batch", "distribute_cache", "distribute_model_",
    "evenize_spec", "param_shardings", "replicated", "spec_for_axes",
]


# Priority-ordered: earlier rules claim their mesh axis first.
PARAM_RULES: dict[str, Optional[tuple[str, ...]]] = {
    # tensor/expert parallel dims → "model"
    "experts": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "kv_lora": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "d_inner": ("model",),
    # FSDP dim → ("pod","data"): on the multi-pod mesh parameters + optimizer
    # state shard over BOTH DP axes; single-pod meshes drop the absent "pod" axis.
    "embed": ("pod", "data"),
    # layer-stack dim stays replicated
    "layers": None,
}

# Pure-FSDP profile: the "model" axis retires into extra data/FSDP parallelism:
# weights shard d_model over ALL devices, batch shards over all devices.
PARAM_RULES_FSDP: dict[str, Optional[tuple[str, ...]]] = {
    "embed": ("pod", "data", "model"),
    "layers": None,
    "experts": None, "heads": None, "kv": None, "kv_lora": None,
    "mlp": None, "vocab": None, "d_inner": None,
}

ACT_RULES_FSDP: dict[str, Optional[tuple[str, ...]]] = {
    "batch": ("pod", "data", "model"),
    "seq": None, "seq_act": None, "heads_act": None, "kv_act": None,
    "mlp_act": None, "vocab_act": None, "experts_act": None,
}

PROFILES = {"tp": None, "fsdp": (PARAM_RULES_FSDP, ACT_RULES_FSDP)}

ACT_RULES: dict[str, Optional[tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    # Megatron-style sequence parallelism: the residual stream between blocks
    # shards its sequence dim over "model" (training only).
    "seq_act": ("model",),
    "heads_act": ("model",),
    "kv_act": ("model",),  # grouped-attention internals: shard the kv-heads dim
    "mlp_act": ("model",),
    "vocab_act": ("model",),
    "experts_act": ("model",),
}


class Sharding(NamedTuple):
    """A tensor's layout: ``spec`` on ``mesh`` (the reference's
    ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def _filter_rules(rules: dict, mesh) -> dict:
    """Drop mesh axes absent from this mesh (e.g. "pod" on the single-pod mesh)."""
    names = axis_names(mesh)
    out = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
        else:
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
    return out


def activation_rules(mesh, profile: str = "tp") -> dict:
    """Rules installed into ``models.sharding_ctx`` for ``shard``."""
    base = ACT_RULES if PROFILES.get(profile) is None else PROFILES[profile][1]
    r = _filter_rules(base, mesh)
    return {k: (v if v is None else (v if len(v) > 1 else v[0])) for k, v in r.items()}


def spec_for_axes(logical: tuple, mesh, rules: Optional[dict] = None) -> PartitionSpec:
    """Build a PartitionSpec, assigning each mesh axis at most once (priority
    order = the rules' declaration order, then positional order)."""
    rules = _filter_rules(PARAM_RULES if rules is None else rules, mesh)
    order = {name: i for i, name in enumerate(rules)}
    used: set[str] = set()
    spec: list = [None] * len(logical)
    # visit dims by rule priority so e.g. "experts" beats "mlp" for the model axis
    dims = sorted(range(len(logical)), key=lambda i: order.get(logical[i], len(order)))
    for i in dims:
        mesh_axes = rules.get(logical[i])
        if not mesh_axes:
            continue
        kept = tuple(a for a in mesh_axes if a not in used)
        if not kept:
            continue
        used.update(kept)
        spec[i] = kept if len(kept) > 1 else kept[0]
    return PartitionSpec(*spec)


def _mesh_size(mesh, axes) -> int:
    return mesh_size(mesh, axes)


def _param_rules(profile: str) -> dict:
    return PARAM_RULES if PROFILES.get(profile) is None else PROFILES[profile][0]


def param_spec(p: P, mesh, profile: str = "tp") -> PartitionSpec:
    """One schema leaf's evenized spec."""
    return evenize_spec(spec_for_axes(p.axes, mesh, _param_rules(profile)), p.shape, mesh)


def param_shardings(schema: Any, mesh, profile: str = "tp") -> Any:
    """A :class:`Sharding` tree matching a param schema (P-leaf tree)."""
    return tree_map(lambda p: Sharding(mesh, param_spec(p, mesh, profile)), schema)


# ----------------------------------------------------------------- caches -----


def _cache_spec(path: str, shape: tuple, mesh, batch: int) -> PartitionSpec:
    """KV/SSM-cache leaf sharding by leaf name.

    gqa k/v:  (layers.., b, s, kv, dh) → batch over DP axes, kv heads over model.
    mla ckv:  (layers.., b, s, r)      → batch over DP, latent r over model.
    mla krope:(layers.., b, s, rope)   → batch over DP only (tiny).
    mamba conv:(layers.., b, w, c)     → batch over DP, channels over model.
    mamba ssm: (layers.., b, h, n, p)  → batch over DP, heads over model.
    memory:   (b, enc_seq, d)          → batch over DP.

    When batch == 1 (long_500k) the batch dim cannot shard; the cache
    *sequence* dim takes the DP axes instead. The port's caches are per
    layer, with no leading dims; the reference's stacked leaves take the same
    spec after theirs.
    """
    ndim = len(shape)
    names = axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    model_n = axis_sizes(mesh).get("model", 1)
    leaf = path.rsplit("/", 1)[-1]
    trailing = {"k": 4, "v": 4, "ckv": 3, "krope": 3, "conv": 3, "ssm": 4, "memory": 3}
    n_lead = 0 if leaf == "memory" else ndim - trailing[leaf]
    spec: list = [None] * ndim
    seq_shard = batch == 1  # long_500k: batch can't shard → seq takes the DP axes
    has_seq = leaf in ("k", "v", "ckv", "krope", "memory")
    spec[n_lead] = None if seq_shard else dp_spec
    if seq_shard and has_seq:
        spec[n_lead + 1] = dp_spec
    # "model" goes on the first trailing feature dim that divides evenly
    if leaf != "krope" and leaf != "memory":
        for i in range(n_lead + (2 if has_seq else 1), ndim):
            if spec[i] is None and shape[i] % model_n == 0:
                spec[i] = "model"
                break
    return evenize_spec(PartitionSpec(*spec), shape, mesh)


def _cache_paths(cache: Any, prefix: str = ""):
    """(path, tensor) for every buffer of a cache tree; list indices (the
    port's per-layer lists) are left out of the path, as the reference
    stacks them."""
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from _cache_paths(cache[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(cache, (list, tuple)):
        for c in cache:
            yield from _cache_paths(c, prefix)
    else:
        yield prefix, cache


def cache_shardings(cache_tree: Any, mesh, batch: int) -> Any:
    """A :class:`Sharding` for every buffer of a cache tree, in its structure."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix) for v in t)
        return Sharding(mesh, _cache_spec(prefix, tuple(t.shape), mesh, batch))

    return build(cache_tree, "")


# ----------------------------------------------------------------- inputs -----


def batch_sharding(mesh, shape: tuple, batch: int) -> Sharding:
    """Token/label arrays: (b, s, ...) — batch over DP axes (replicated if b == 1)."""
    names = axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    spec: list = [None] * len(shape)
    if batch > 1:
        spec[0] = dp_spec
    return Sharding(mesh, evenize_spec(PartitionSpec(*spec), shape, mesh))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, PartitionSpec())


# ------------------------------------------------------------- placement -----


def distribute(x: torch.Tensor, sharding: Sharding):
    """x (the full value, on every rank) as a DTensor laid out by ``sharding``:
    each rank keeps its own shard (``distribute_tensor``, which copies no
    data between ranks). A meta or fake ``x`` gives a DTensor of its local
    shard's shape."""
    from torch.distributed.tensor import distribute_tensor

    spec = tuple(sharding.spec) + (None,) * (x.ndim - len(sharding.spec))
    return distribute_tensor(x, sharding.mesh, to_placements(spec, sharding.mesh))


def distribute_batch(batch: dict, mesh) -> dict:
    """Each input of ``batch`` (tokens, labels, stub embeddings; a decode
    token) as a DTensor laid out by :func:`batch_sharding` on its own
    leading dim."""
    return {k: distribute(v, batch_sharding(mesh, tuple(v.shape), v.shape[0]))
            for k, v in batch.items()}


def distribute_cache(cache: Any, mesh, batch: int) -> Any:
    """A cache tree (``models.model.zero_cache``'s) with every buffer a
    DTensor laid out by :func:`cache_shardings`."""
    def build(t, sh):
        if isinstance(t, dict):
            return {k: build(v, sh[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, s_) for v, s_ in zip(t, sh))
        return distribute(t, sh)

    return build(cache, cache_shardings(cache, mesh, batch))


def distribute_model_(model, cfg: ModelConfig, mesh, profile: str = "tp"):
    """Turn each parameter of ``model`` (a ``models.model.Transformer``) into
    a DTensor on ``mesh`` laid out by its schema leaf's evenized spec, in
    place, and return the model: the port's counterpart of the reference's
    ``jax.jit(in_shardings=param_shardings(...))``. A layer's parameter is
    its stacked leaf's slice, so it takes the leaf's spec without the
    leading stack dims (which the rules never shard)."""
    from torch import nn

    from ..models.model import _slices, param_schema

    for path, leaf in leaves(param_schema(cfg)):
        spec = param_spec(leaf, mesh, profile)
        for p in _slices(model, list(path)):
            lead = len(leaf.shape) - p.ndim
            if any(e is not None for e in spec[:lead]):
                raise ValueError(f"{'/'.join(path)}: a stacked dim is sharded in {spec}")
            new = distribute(p.data, Sharding(mesh, PartitionSpec(*spec[lead:])))
            _replace_parameter(model, p, nn.Parameter(new, requires_grad=p.requires_grad))
    return model


def _replace_parameter(model, old, new) -> None:
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is old:
                mod._parameters[name] = new
                return
    raise KeyError("parameter not found in the model")
