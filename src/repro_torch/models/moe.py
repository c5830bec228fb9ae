"""Mixture-of-Experts layer — twin of ``repro/models/moe.py``: top-k routing
with capacity-grouped dispatch.

Every (token, k) copy takes a slot in its expert's capacity buffer by an
exclusive count of the earlier copies routed to that expert; copies past
capacity are dropped (the gates were renormalised before the drop, so a
dropped copy's weight still counts). The experts compute on E·C rows, C =
ceil(tokens·K/E · capacity_factor) rounded up to 8, never on the dense
all-experts product.

Routing groups are per batch row in train and prefill, and the whole batch in
decode (s = 1), as in the reference, so the two capacities differ.

**The last slot of an overflowing expert.** The reference writes its slot
table with a scatter in which every dropped copy lands on its expert's last
slot, ``cap − 1``, the index of a kept copy too. XLA applies the updates in
order on the CPU, so a dropped copy's write is the last: that slot ends
empty (token 0, not filled), and the kept copy living there gets a zero
output while its gate still counts. The port builds the same table without
a scatter, whose winner CUDA leaves undefined: the kept copies are placed by
a stable sort on the expert id (each expert's copies in order of their slots),
and slot ``cap − 1`` of every expert with more than ``cap`` copies is then
cleared explicitly.

Shared experts (deepseek-v2) are plain always-on MLPs added to the routed
output.

Under a mesh context the dispatch buffers carry the reference's ``shard``
calls (expert-major buffers over "experts_act": expert parallelism), and the
slot table (a stable sort and gathers, which DTensor has no rule for) is
built on each rank's own token groups, and each rank's experts run on its
own groups (``sharding_ctx.region``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import at_least_fp32, matmul, mlp, mlp_params
from .param import P
from .sharding_ctx import merge_dims, region, shard, split_dim


def moe_params(cfg):
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


def _capacity(cfg, tokens_per_group: int) -> int:
    c = math.ceil(tokens_per_group * cfg.experts_per_tok * cfg.capacity_factor
                  / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p, cfg, xg: torch.Tensor):
    """xg: (g, t, d) token groups → ``(gates, flat_e, slot, cap)``: the
    renormalised top-k gates (g, t, k) in fp32, each copy's expert (g, t·k) and
    its slot in that expert's buffer (g, t·k), token-major; a copy is kept
    where ``slot < cap``."""
    g, t, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    logits = at_least_fp32(matmul(xg, p["router"]))  # (g, t, e)
    gates, expert_idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(g, t * k)
    onehot = F.one_hot(flat_e, e)  # (g, tk, e)
    ranks = torch.cumsum(onehot, dim=1) - onehot  # exclusive count per expert
    slot = torch.gather(ranks, 2, flat_e[..., None])[..., 0]
    return gates, flat_e, slot, _capacity(cfg, t)


def _slot_table(flat_e: torch.Tensor, k: int, e: int, cap: int):
    """The reference's dispatch table without a scatter: ``(token, filled)``,
    each (g, e·cap), expert-major. Slot c of expert x holds the copy of rank c
    among x's copies (found at ``start[x] + c`` in a stable sort of the copies
    by expert), and is filled while c < the expert's count; slot ``cap − 1`` of
    an expert with more than ``cap`` copies is cleared, as the reference's last
    write (a dropped copy's) leaves it."""
    g, tk = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    counts = F.one_hot(flat_e, e).sum(dim=1)  # (g, e)
    start = torch.cumsum(counts, dim=1) - counts
    c = torch.arange(cap, device=flat_e.device)
    filled = (c < counts[..., None]) & ((c < cap - 1) | (counts[..., None] <= cap))
    pos = torch.clamp(start[..., None] + c, max=tk - 1).reshape(g, e * cap)
    token = torch.gather(order, 1, pos) // k
    filled = filled.reshape(g, e * cap)
    return torch.where(filled, token, 0), filled


def _experts(xin: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their capacity buffers: xin (g, e, cap, d) →
    (g, e, cap, d). Under a mesh context each rank runs its own experts on
    its own groups (``sharding_ctx.region``)."""
    hidden = (F.silu(torch.einsum("gecd,edf->gecf", xin, gate))
              * torch.einsum("gecd,edf->gecf", xin, up))
    hidden = shard(hidden, "batch", "experts_act", None, "mlp_act")
    return torch.einsum("gecf,efd->gecd", hidden, down)


def _grouped_experts(p, cfg, xg: torch.Tensor) -> torch.Tensor:
    """xg: (g, t, d) token groups → routed output (g, t, d). Grouping stays
    within g."""
    g, t, d = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    gates, flat_e, slot, cap = route(p, cfg, xg)
    keep = slot < cap
    buf_pos = flat_e * cap + torch.where(keep, slot, cap - 1)  # (g, tk) in [0, e·cap)
    rows = ("batch", None)
    token, filled = region(lambda fe: _slot_table(fe, k, e, cap), (rows,), (rows, rows), flat_e)

    xin = torch.gather(xg, 1, token[..., None].expand(g, e * cap, d))
    xin = shard(xin, "batch", "experts_act", None)
    xin = shard(split_dim(xin * filled[..., None], 1, (e, cap)),
                "batch", "experts_act", None, None)
    bufs, weights = ("batch", "experts_act", None, None), ("experts_act", None, None)
    out_buf = region(_experts, (bufs, weights, weights, weights), bufs,
                     xin, p["gate"], p["up"], p["down"])
    out_buf = shard(merge_dims(out_buf, 1), "batch", "experts_act", None)

    copy_out = torch.gather(out_buf, 1, buf_pos[..., None].expand(g, t * k, d))
    copy_out = shard(copy_out, "batch", "seq_act", None)
    copy_out = copy_out * keep[..., None]
    weighted = copy_out * gates.reshape(g, t * k, 1).to(copy_out.dtype)
    return split_dim(weighted, 1, (t, k)).sum(dim=2).to(xg.dtype)


def moe_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (b, s, d) → (b, s, d). Deterministic top-k routing."""
    if x.shape[1] == 1:  # decode: one group over the batch (moved, never reshaped: it may be split)
        y = _grouped_experts(p, cfg, x.transpose(0, 1)).transpose(0, 1)
    else:  # train and prefill: one group a batch row
        y = _grouped_experts(p, cfg, x)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y
