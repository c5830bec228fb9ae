"""Collectives over a mesh's data group — the port's counterparts of the
reference's ``jax.lax.all_gather(tiled=True)``, ``psum``, ``ppermute`` and
``axis_index`` inside its ``shard_map`` bodies.

The reference stages its collectives in a jaxpr and counts them there
(``benchmarks/bench_distributed.py:59-63``); here every call adds one to
:data:`COLLECTIVE_COUNTS` under its kind, so a run reads the same schedule
off the counters: ``all_gather`` (:func:`all_gather_rows`), ``psum``
(:func:`psum`) and ``ppermute`` (:func:`ring_shift`, one per tensor moved, as
a ``ppermute`` of a tuple stages one per leaf).

**The route is the group's backend, never a caught failure.** NCCL moves CUDA
tensors on the device. Gloo moves CPU tensors; it has no CUDA ``send``/
``recv`` and does not cover every collective on CUDA tensors, so on a gloo
group a CUDA tensor goes through host memory explicitly: copied to the host,
moved, copied back. The bytes copied each way are counted in
``staged_bytes``. NCCL refuses two ranks on one card, so ranks that share a
card form a gloo group and pay the staging. A CPU tensor on an NCCL group
raises.

``psum`` sums the ranks' partials in rank order after gathering them, so
every rank holds the same bits whatever order the backend reduces in: a
solver's host-side branch on a reduced value (CG's ``live.any()``, a
column's flags) is taken alike by every rank.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

COLLECTIVE_COUNTS = {"all_gather": 0, "psum": 0, "ppermute": 0, "staged_bytes": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVE_COUNTS:
        COLLECTIVE_COUNTS[k] = 0


def collective_counts() -> dict:
    """Collectives by kind since the last reset, and the bytes staged through
    host memory (both directions)."""
    return dict(COLLECTIVE_COUNTS)


def axis_group(mesh, axes) -> dist.ProcessGroup:
    """The process group of ``mesh``'s ``axes`` (one name, or several
    flattened into one group, e.g. ``("pod", "data")``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def axis_index(group) -> int:
    """This rank's index along the group (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def _backend_for(group, device: torch.device) -> str:
    name = str(dist.get_backend(group))
    if ":" in name:  # a per-device table, e.g. "cpu:gloo,cuda:nccl"
        table = dict(part.split(":") for part in name.split(","))
        return table.get(device.type, "")
    return name


def _staged(t: torch.Tensor, group) -> bool:
    """True where ``t`` must go through host memory: a CUDA tensor on gloo."""
    backend = _backend_for(group, t.device)
    if backend == "nccl":
        if not t.is_cuda:
            raise ValueError("an NCCL group moves CUDA tensors only; got a CPU tensor")
        return False
    if backend == "gloo":
        return t.is_cuda
    raise ValueError(f"no route for a {t.device.type} tensor on a {backend!r} group")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    COLLECTIVE_COUNTS["staged_bytes"] += t.numel() * t.element_size()
    return t.to("cpu")


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    COLLECTIVE_COUNTS["staged_bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _gather_parts(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order, on ``t``'s device."""
    staged = _staged(t, group)
    src = _to_host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        return [_to_device(p, t.device) for p in parts]
    return parts


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' row blocks stacked in rank order (``all_gather(tiled=True)``
    over axis 0)."""
    COLLECTIVE_COUNTS["all_gather"] += 1
    return torch.cat(_gather_parts(t, group), dim=0)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``t``, summed in rank order: the same bits on every
    rank."""
    COLLECTIVE_COUNTS["psum"] += 1
    parts = _gather_parts(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _Shift:
    """A ring shift in flight: :meth:`wait` returns the received tensors."""

    def __init__(self, ops, reqs, recvs, devices, staged):
        self._ops = ops  # the send buffers stay alive until the shift lands
        self._reqs, self._recvs, self._devices, self._staged = reqs, recvs, devices, staged

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        return [_to_device(r, dev) if st else r
                for r, dev, st in zip(self._recvs, self._devices, self._staged)]


def ring_shift(tensors: Sequence[torch.Tensor], group) -> _Shift:
    """Start moving each tensor one step around the ring: rank j receives rank
    j+1's (the reference's ``ppermute`` with perm ``[((j+1) % P, j)]``).
    Returns at once; ``wait()`` on the result gives the received tensors.
    One ``ppermute`` counted per tensor."""
    COLLECTIVE_COUNTS["ppermute"] += len(tensors)
    p_size, rank = axis_size(group), axis_index(group)
    dst = dist.get_global_rank(group, (rank - 1) % p_size)
    src = dist.get_global_rank(group, (rank + 1) % p_size)
    ops, recvs, staged = [], [], []
    for t in tensors:
        st = _staged(t, group)
        send = _to_host(t) if st else t.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        recvs.append(recv)
        staged.append(st)
    reqs = dist.batch_isend_irecv(ops)
    return _Shift(ops, reqs, recvs, [t.device for t in tensors], staged)
