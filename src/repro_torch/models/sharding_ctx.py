"""Activation-sharding context — twin of ``repro/models/sharding_ctx.py``.

Model code calls ``shard(x, *logical_axes)``; the launcher installs a device
mesh and logical → physical rules with :func:`use_mesh`. Outside a context
``shard`` returns ``x`` itself, so every unsharded path keeps its bits.
Inside one it returns a ``DTensor`` on the context's mesh whose placements
are the rules' spec (evenized to x's shape: a dim that its mesh axes do not
divide stays whole, as ``launch.sharding.evenize_spec`` drops it for the
parameters), with the same full value; a plain tensor there is taken as
replicated. The reference's ``with_sharding_constraint`` is a hint to XLA's
partitioner; here the redistribution is the collective itself.

A ``PartitionSpec`` is the reference's: one entry a tensor dim, each None,
a mesh axis name, or a tuple of them (outer axis first).
:func:`to_placements` turns it into DTensor placements, one a mesh dim.

Where a region has no DTensor sharding rule (the hand-written kernels, MoE's
stable sort of its slot table, SSD's chunk loop, the cache's in-place
writes), :func:`region` runs it on each rank's local tensors through
``torch.distributed.tensor.experimental.local_map``, its inputs redistributed
first to the placements the rules give them, so every collective is visible
in the op stream.

``torch.distributed.tensor`` is imported inside the functions that need it:
importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections.abc import Mapping
from typing import Any, Callable, Optional, Sequence

import torch

class _State(threading.local):
    ctx: Optional[tuple] = None  # (mesh, rules) inside use_mesh, per thread


#: a class attribute as the default: reading an unset thread-local attribute
#: raises inside ``getattr`` first, ~10x the cost of a read, on every product
_STATE = _State()


class PartitionSpec(tuple):
    """One entry a tensor dim: None (whole), a mesh axis name, or a tuple of
    names (the dim split over their product, outer axis first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of an object that only describes one (``FakeMesh``)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a ``shape`` mapping as it is, or a ``DeviceMesh``'s
    shape tuple by its dim names."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Sequence[str]):
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def mesh_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(entry))


def rules_to_spec(rules: dict, logical: tuple) -> PartitionSpec:
    """Each mesh axis may appear once; the earliest logical dim wins (e.g. MoE
    activations name both experts_act and mlp_act, which both map to "model")."""
    used: set[str] = set()
    out = []
    for ax in logical:
        phys = rules.get(ax)
        if phys is None:
            out.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        kept = tuple(a for a in axes if a not in used)
        used.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*out)


def evenize_spec(spec: Sequence, shape: tuple, mesh) -> PartitionSpec:
    """Drop mesh axes (innermost first) on dims that they do not divide (e.g.
    vocab 50280 over 16, kv_heads 8 over 16)."""
    out = []
    for i, entry in enumerate(spec):
        axes = list(_axes(entry))
        while axes and shape[i] % mesh_size(mesh, axes) != 0:
            axes.pop()  # drop innermost
        out.append(_entry(axes))
    return PartitionSpec(*out)


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements, one a mesh dim: ``Shard(d)`` on every mesh dim
    that tensor dim d's entry names, ``Replicate()`` elsewhere, and on a
    mesh dim of size 1 (a split one way is the whole tensor, and DTensor's
    views refuse a split dim they cannot see through, such as a sequence
    of 1 split one way). A dim over two mesh axes names them outer first, in
    the mesh's order (DTensor splits a dim over mesh dims in that order);
    another order, an unknown axis or one named twice raises
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        idx = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names {a!r}, not an axis of {names}")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {a!r} twice")
            seen.add(a)
            j = names.index(a)
            idx.append(j)
            if sizes[a] > 1:
                out[j] = Shard(d)
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
    return tuple(out)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict):
    """Install ``(mesh, rules)`` for :func:`shard` and :func:`region`. Plain
    tensors that meet DTensors inside (positions, masks, scalars) are taken
    as replicated (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _STATE.ctx
    _STATE.ctx = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.ctx = prev


def current() -> Optional[tuple]:
    return _STATE.ctx


_DTENSOR: Optional[type] = None


def is_dtensor(x: Any) -> bool:
    global _DTENSOR
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    if _DTENSOR is None:  # imported once, at the first tensor subclass seen
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def replicated(x: torch.Tensor, mesh):
    """x as a DTensor on ``mesh``: itself if it is one, else replicated."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * len(axis_names(mesh)), run_check=False)


def redistribute(x: torch.Tensor, mesh, spec: Sequence):
    """x (a DTensor, or a plain tensor taken as replicated) laid out by
    ``spec`` on ``mesh``."""
    return replicated(x, mesh).redistribute(mesh, to_placements(spec, mesh))


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    ctx = current()
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = evenize_spec(rules_to_spec(rules, logical), tuple(x.shape), mesh)
    return redistribute(x, mesh, spec)


def _region_rules(rules: dict, named: list, mesh) -> dict:
    """The rules a region uses: each logical name's mesh axes, the innermost
    dropped until they divide every dim of that name among the inputs, so
    that all of a region's tensors agree on how a name is split."""
    out = {}
    for name, phys in rules.items():
        axes = list(_axes(phys))
        sizes = [n for nm, n in named if nm == name]
        while axes and any(n % mesh_size(mesh, axes) for n in sizes):
            axes.pop()
        out[name] = _entry(axes)
    return out


def region(fn: Callable, in_axes: Sequence, out_axes, *args):
    """``fn(*args)``, run on each rank's local tensors inside a context.

    ``in_axes`` gives a tuple of logical names for each tensor argument
    (None for a non-tensor one); ``out_axes`` one for each output (a single
    tuple of names for a single tensor output). Inside a context the tensor
    arguments are redistributed to the rules' placements, ``fn`` runs through
    ``local_map`` on their local shards, and its outputs come back as
    DTensors laid out by ``out_axes``. Gradients flow through: an input
    that is whole on a mesh dim that splits another input (a weight beside
    batch-split activations) gets a partial-sum gradient there. Outside a
    context this is ``fn(*args)``."""
    ctx = current()
    if ctx is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = ctx
    named = [(nm, n) for a, ax in zip(args, in_axes) if ax is not None
             for nm, n in zip(ax, a.shape)]
    rr = _region_rules(rules, named, mesh)
    single = bool(out_axes) and all(isinstance(o, str) or o is None for o in out_axes)
    outs = (out_axes,) if single else tuple(out_axes)
    in_pl, local_args = [], []
    for a, ax in zip(args, in_axes):
        if ax is None:
            in_pl.append(None)
            local_args.append(a)
            continue
        spec = rules_to_spec(rr, tuple(ax))
        in_pl.append(to_placements(spec, mesh))
        local_args.append(redistribute(a, mesh, spec))
    out_pl = tuple(to_placements(rules_to_spec(rr, tuple(o)), mesh) for o in outs)

    def local_fn(*a):
        _STATE.ctx = None  # fn sees local tensors: its own shard calls are no-ops
        try:
            return fn(*a)
        finally:
            _STATE.ctx = ctx

    mapped = local_map(local_fn, out_placements=list(out_pl[0]) if single else out_pl,
                       in_placements=tuple(in_pl), in_grad_placements=_grad_placements(in_pl),
                       device_mesh=mesh)
    return mapped(*local_args)


def _grad_placements(in_pl: list) -> tuple:
    """The placements of a region's input gradients: an input's own, except
    that on a mesh dim where it is whole but another input is split, each
    rank's gradient is its shard's contribution, a partial sum."""
    from torch.distributed.tensor import Partial

    split = {j for pl in in_pl if pl is not None for j, p in enumerate(pl) if p.is_shard()}
    return tuple(None if pl is None else
                 tuple(Partial() if (j in split and p.is_replicate()) else p
                       for j, p in enumerate(pl))
                 for pl in in_pl)


def axis_split(logical: str, n: int) -> int:
    """How many ways a dim of size n named ``logical`` is split inside the
    current context (1 outside one): the product of its rule's mesh axes,
    the innermost dropped until they divide n."""
    ctx = current()
    if ctx is None:
        return 1
    mesh, rules = ctx
    axes = list(_axes(rules.get(logical)))
    while axes and n % mesh_size(mesh, axes):
        axes.pop()
    return mesh_size(mesh, axes)


class _GradLaidOutAsInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # a partial sum's gradient is whole on each rank
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_like_input(x: torch.Tensor) -> torch.Tensor:
    """x itself, whose gradient is laid out as x is. A mean's backward
    broadcasts a replicated scalar; without this the ops behind it may take
    that layout and hold a whole batch's worth on every rank."""
    return _GradLaidOutAsInput.apply(x) if is_dtensor(x) else x


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """x with its partial sums summed (a row-parallel product's output, an
    all-reduce), its other placements kept; x itself if it has none. Left
    partial, the sum would reach the next products, which DTensor then runs
    whole on every rank to keep it partial."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def weight_for_compute(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product uses it inside a context: its shards over the
    axes that split the batch ("batch"'s rule: the FSDP dim) gathered, its
    tensor-parallel shards kept, so each rank multiplies its own batch rows
    by its own slice of the weight. (Left to itself DTensor may gather the
    whole weight and repeat the product on every tensor-parallel rank.)"""
    ctx = current()
    if ctx is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    mesh, rules = ctx
    names = axis_names(mesh)
    batch = set(_axes(rules.get("batch")))
    pl = [Replicate() if names[j] in batch else p for j, p in enumerate(w.placements)]
    return w if tuple(pl) == tuple(w.placements) else w.redistribute(mesh, pl)


def local_contiguous(x: torch.Tensor) -> torch.Tensor:
    """x, with a DTensor's local shard made contiguous if it is not (an
    uneven shard can be a narrowed view, which a local ``view`` inside
    DTensor's matmul refuses)."""
    if is_dtensor(x) and not x._local_tensor.is_contiguous():
        # the wrapper itself looks contiguous, so contiguous() would be a no-op
        return x.clone(memory_format=torch.contiguous_format)
    return x


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (a view, as ``reshape`` is). On a DTensor
    whose ``dim`` is split more ways than ``sizes[0]`` divides into (8 kv
    heads over 16 ranks), that dim is gathered first: its shards would cut
    the new leading dim."""
    if is_dtensor(x):
        d = dim % x.ndim
        ways = math.prod(x.device_mesh.size(j) for j, p in enumerate(x.placements)
                         if p.is_shard() and p.dim == d)
        if sizes[0] % ways:
            from torch.distributed.tensor import Replicate

            x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim == d
                                               else p for p in x.placements])
    return x.unflatten(dim, sizes)


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.sizes), None


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim, dim + 1)``. On a DTensor the backward unflattens its
    gradient with :func:`split_dim`: that gradient may come back split more
    ways than the leading dim divides into (56 heads' outputs, their merged
    dim split 16 ways by the next product's weight)."""
    return _Merge.apply(x, dim % x.ndim) if is_dtensor(x) else x.flatten(dim, dim + 1)


def assign(buf: torch.Tensor, val: torch.Tensor) -> None:
    """``buf.copy_(val)`` in place; a DTensor ``buf`` takes ``val`` laid out
    as it is first."""
    if is_dtensor(buf):
        val = replicated(val, buf.device_mesh).redistribute(buf.device_mesh, buf.placements)
    buf.copy_(val)


def write_seq(buf: torch.Tensor, start: int, val: torch.Tensor, seq_dim: int = 1) -> None:
    """``buf[:, start:start + len] = val`` along ``seq_dim``, in place.

    A DTensor buffer is written shard by shard: ``val`` is laid out as
    ``buf`` is, its sequence dim whole, and each rank copies into its own
    local block the rows of ``val`` that fall inside it (a cache whose
    sequence dim is split, long_500k's, holds a decoded token on one rank)."""
    n = val.shape[seq_dim]
    if not is_dtensor(buf):
        buf[(slice(None),) * seq_dim + (slice(start, start + n),)] = val
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    pl = [Replicate() if (p.is_shard() and p.dim == seq_dim) else p for p in buf.placements]
    local_val = replicated(val, mesh).redistribute(mesh, pl).to_local()
    local = buf.to_local()
    names = axis_names(mesh)
    # this rank's offset along seq_dim: its coordinate on each mesh dim that splits it
    coord = mesh.get_coordinate()
    offset, block = 0, buf.shape[seq_dim]
    for j, p in enumerate(buf.placements):
        if p.is_shard() and p.dim == seq_dim:
            block //= mesh.size(j)
            offset += coord[j] * block
    assert local.shape[seq_dim] == block, (names, buf.placements)
    lo, hi = max(start, offset), min(start + n, offset + block)
    if lo < hi:
        local.narrow(seq_dim, lo - offset, hi - lo).copy_(
            local_val.narrow(seq_dim, lo - start, hi - lo))
