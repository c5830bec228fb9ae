"""Gradient compression with error feedback — twin of ``repro/train/compress.py``.

int8 stochastic-rounding quantisation with **error feedback**: the residual of
each quantisation is carried and added to the next step's gradient, so the
compressed trajectory tracks the exact one. Per-tensor scale keeps the range
adaptive; compress → (int8 payload, fp32 scale), decompress reverses.

The reference draws its rounding coins with ``jax.random.bernoulli(key, p)``,
which is ``uniform(key, p.shape) < p``. Here the uniforms come from an explicit
``torch.Generator`` or are passed in as ``u`` (the parity tests inject the
reference's own ``jax.random.uniform`` draws, and the payloads agree bit for
bit). Trees are nested dicts, lists and tuples of tensors, flattened in the
reference's order (dict keys sorted).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..models.param import tree_leaves, tree_unflatten


class Compressed(NamedTuple):
    q: torch.Tensor  # int8
    scale: torch.Tensor  # ()


def compress(x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             u: Optional[torch.Tensor] = None) -> Compressed:
    """Stochastic-rounding int8 quantisation: each y = x/scale rounds up with
    probability y − ⌊y⌋, where uniform ``u`` (drawn from ``generator`` on
    x's device unless given) is below it."""
    x32 = x.float()
    scale = torch.clamp(torch.amax(torch.abs(x32)), min=1e-12) / 127.0
    y = x32 / scale
    lo = torch.floor(y)
    p = y - lo  # probability of rounding up
    if u is None:
        if generator is None:
            raise ValueError("compress needs a generator or the uniforms u")
        u = torch.rand(x.shape, generator=generator, device=x.device)
    up = u < p
    q = torch.clamp(lo + up.float(), -127, 127).to(torch.int8)
    return Compressed(q=q, scale=scale)


def decompress(c: Compressed, dtype=torch.float32) -> torch.Tensor:
    return (c.q.float() * c.scale).to(dtype)


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor,
                           generator: Optional[torch.Generator] = None, *,
                           u: Optional[torch.Tensor] = None):
    """Returns (compressed, new_error). new_error = (grad+error) − decompress(...)."""
    g = grad.float() + error
    c = compress(g, generator, u=u)
    new_error = g - decompress(c)
    return c, new_error


def tree_compress_with_feedback(grads: Any, errors: Any,
                                generator: Optional[torch.Generator] = None, *,
                                u: Optional[list] = None):
    """Leaf by leaf in the reference's order, each leaf's uniforms drawn from
    ``generator`` in turn, or ``u[i]`` for leaf i."""
    leaves = tree_leaves(grads)
    errs = tree_leaves(errors)
    us = [None] * len(leaves) if u is None else list(u)
    cs, nes = [], []
    for g, e, ui in zip(leaves, errs, us, strict=True):
        c, ne = compress_with_feedback(g, e, generator, u=ui)
        cs.append(c)
        nes.append(ne)
    return tree_unflatten(grads, cs), tree_unflatten(grads, nes)


def tree_decompress(comp: Any, like: Any) -> Any:
    return tree_unflatten(like, [decompress(c, g.dtype) for c, g in
                                 zip(tree_leaves(comp), tree_leaves(like), strict=True)])


def init_error_state(grads_like: Any) -> Any:
    return tree_unflatten(grads_like, [torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device)
                                       for g in tree_leaves(grads_like)])
