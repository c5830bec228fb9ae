"""Param schema system — twin of ``repro/models/param.py``: declare parameters
once as a nested dict of ``P`` leaves carrying shape + logical axes; derive the
parameter count (no allocation) and initialised tensors.

The logical axis names map onto a device mesh through the rules of
``launch/sharding.py``; :func:`abstract_params` gives the dry run's
parameters as meta tensors, which hold no memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional

import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter leaf: shape + logical axis names (len == ndim)."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | zeros | ones | embed

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def scale(self) -> float:
        """The ``fan_in`` std, 1/√fan_in. On a stacked leaf the fan-in counts
        the stacking dims: a (L, d_in, d_out) weight gets 1/√(L·d_in), as the
        reference draws it (``param.py:43-46`` there)."""
        fan_in = self.shape[0] if len(self.shape) == 1 else math.prod(self.shape[:-1])
        return 1.0 / math.sqrt(max(fan_in, 1))


def is_leaf(x: Any) -> bool:
    return isinstance(x, P)


def leaves(schema: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, keys in sorted order (the order in
    which ``jax.tree.flatten`` visits a dict)."""
    if isinstance(schema, dict):
        for k in sorted(schema):
            yield from leaves(schema[k], prefix + (k,))
    else:
        yield prefix, schema


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _is_node(tree: Any) -> bool:
    """A container of the pytrees below: a dict, a list or a plain tuple (a
    named tuple, such as a ``Compressed``, is a leaf)."""
    return isinstance(tree, (dict, list)) or (isinstance(tree, tuple)
                                              and not hasattr(tree, "_fields"))


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, lists and tuples in ``jax.tree.leaves``'
    order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, flat: list) -> Any:
    """:func:`tree_leaves`' inverse: ``flat`` put into the structure of ``like``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_node(t):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def abstract_params(schema: Any, dtype=torch.float32, device: DeviceLike = "meta") -> Any:
    """The schema's tensors with no data: ``meta`` tensors of each leaf's shape
    (or empty ones on ``device``, e.g. under a ``FakeTensorMode``) — the
    reference's ``ShapeDtypeStruct`` tree, the dry run's path (never
    allocates)."""
    dev = torch.device(device)
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device=dev), schema)


def logical_axes(schema: Any) -> Any:
    """Tree of logical-axis tuples, same structure as the params."""
    return tree_map(lambda p: p.axes, schema)


def param_count(schema: Any) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(schema))


def stack_schema(schema: Any, n: int, axis_name: Optional[str] = "layers") -> Any:
    """Prepend a stacking dim (the reference scans over it)."""
    return tree_map(lambda p: P((n,) + p.shape, (axis_name,) + p.axes, p.init), schema)


def init_leaf(leaf: P, generator: torch.Generator, dtype=torch.float32,
              device: DeviceLike = None) -> torch.Tensor:
    """One leaf's tensor: zeros, ones, 0.02·N(0, 1) (embeddings) or
    N(0, 1)/√fan_in. The draw is made in place, so a leaf costs its own size
    and nothing more."""
    dev = resolve_device(device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=dev)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=dev)
    out = torch.empty(leaf.shape, dtype=dtype, device=dev).normal_(generator=generator)
    return out.mul_(0.02 if leaf.init == "embed" else leaf.scale)


def init_params(schema: Any, generator: torch.Generator, dtype=torch.float32,
                device: DeviceLike = None) -> Any:
    """Materialise a schema into tensors, leaves drawn from ``generator`` in
    sorted-key order. The scales are the reference's; its draws are not (the
    parity tests carry its arrays across with ``convert.lm_params_from_numpy``)."""
    if isinstance(schema, dict):
        return {k: init_params(schema[k], generator, dtype, device) for k in sorted(schema)}
    return init_leaf(schema, generator, dtype, device)
