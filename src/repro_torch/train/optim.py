"""AdamW with memory-tiered state dtypes — twin of ``repro/train/optim.py``.

The first moment is kept in bf16 and the second in fp32 (``AdamWConfig``'s
defaults): 4 + 2 + 4 bytes of state beside each fp32 parameter's 4, so
olmo-1b's 1.18e9 parameters hold 4.7 GB of weights, 2.35 GB of ``mu`` and
4.7 GB of ``nu``.

``params`` is a :class:`~repro_torch.models.model.Transformer` (its leaves in
the reference's pytree order, a stacked leaf as its per-layer slices: see
``models.model.lm_leaves``) or nested dicts, lists and tuples of tensors. The
moments have the same structure: a ``Transformer``'s are ``Transformer``s of
the moment dtype, so ``convert.lm_params_to_numpy`` stacks them as the
reference stores them. A model laid out over a mesh
(``launch.sharding.distribute_model_``) gets moments laid out as its
parameters are, so each rank updates its own shards.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.model import Transformer, lm_leaves, param_schema
from ..models.param import tree_leaves, tree_map
from ..models.sharding_ctx import is_dtensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    mu_dtype: Any = torch.bfloat16
    nu_dtype: Any = torch.float32


class OptState(NamedTuple):
    mu: Any  # a tree like params
    nu: Any
    step: torch.Tensor  # () int32


def leaves(tree: Any) -> list:
    """The tensors of a parameter tree in the reference's leaf order (a
    ``Transformer``'s stacked leaves as their per-layer slices, layer by
    layer)."""
    if isinstance(tree, Transformer):
        return [t for _, ts in lm_leaves(tree) for t in ts]
    return tree_leaves(tree)


def _device(tree: Any) -> torch.device:
    return leaves(tree)[0].device


def _stacked_zeros(first: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """Zeros of a stacked leaf's ``shape``, laid out as its first slice
    ``first`` is: a DTensor slice's placements shift past the stack dims."""
    if not is_dtensor(first):
        return torch.zeros(shape, dtype=dtype, device=first.device)
    from torch.distributed.tensor import Shard, zeros

    lead = len(shape) - first.ndim
    placements = [Shard(p.dim + lead) if p.is_shard() else p for p in first.placements]
    return zeros(shape, dtype=dtype, device_mesh=first.device_mesh, placements=placements)


def _zeros_like(tree: Any, dtype) -> Any:
    if isinstance(tree, Transformer):
        firsts = {path: ts[0] for path, ts in lm_leaves(tree)}
        schema = param_schema(tree.cfg)
        return Transformer(tree.cfg, {
            k: _leafwise(schema[k], (k,), lambda path, p: _stacked_zeros(
                firsts["/".join(path)], p.shape, dtype)) for k in schema})
    if isinstance(tree, dict):
        return {k: _zeros_like(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v, dtype) for v in tree)
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def _leafwise(schema: Any, path: tuple, fn) -> Any:
    if isinstance(schema, dict):
        return {k: _leafwise(v, path + (k,), fn) for k, v in schema.items()}
    return fn(path, schema)


def init_opt_state(params: Any, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    return OptState(
        mu=_zeros_like(params, cfg.mu_dtype),
        nu=_zeros_like(params, cfg.nu_dtype),
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
    )


def abstract_opt_state(params_abstract: Any, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """The dry run's moments: meta tensors like ``params_abstract`` (the
    reference's stacked tree), mu in ``cfg.mu_dtype`` (bf16), nu in
    ``cfg.nu_dtype`` (fp32), and an int32 step."""
    def like(dtype):
        return tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"),
                        params_abstract)

    return OptState(mu=like(cfg.mu_dtype), nu=like(cfg.nu_dtype),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up of the learning rate, in fp32 as the reference's."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: AdamWConfig = AdamWConfig()) -> tuple[Any, OptState]:
    """One AdamW step, the reference's arithmetic in its order: the global
    norm summed leaf by leaf in leaf order, the clip scale, the learning rate
    of the old step, the bias corrections of the new one, and m, v and p in
    fp32, each cast back to its dtype. ``grads`` is a tree like ``params`` or
    the list of :func:`leaves`' order. ``params``, ``mu`` and ``nu`` are
    updated in place (the PyTorch idiom; the reference returns new trees) and
    returned, with the new step."""
    flat_p, flat_g = leaves(params), leaves(grads)
    flat_m, flat_v = leaves(state.mu), leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the moments must have the same leaves")
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g32 = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.float()
        new_p = p32 - lr * (delta + cfg.weight_decay * p32)
        p.copy_(new_p)
        m.copy_(m32)
        v.copy_(v32)
    return params, OptState(mu=state.mu, nu=state.nu, step=step)
