"""Device meshes over ``torch.distributed`` — twin of ``repro/launch/mesh.py``.

The reference's axis names stay: one pod is a 16 × 16 mesh over
``("data", "model")``, two pods a 2 × 16 × 16 mesh over ``("pod", "data",
"model")`` (the "pod" axis is pure data parallelism across pods). A mesh here
is a ``DeviceMesh`` over the ranks of the default process group, one rank per
mesh point, so its shape must match the world size.

Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import DeviceLike, resolve_device


def _mesh(device_type: str, shape: tuple, axes: tuple):
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {' × '.join(map(str, shape))} mesh over {axes} needs a world of "
            f"{math.prod(shape)} ranks; this process group has {world}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The reference's pod mesh, (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model"), on a world of 256 or 512 ranks; any
    other world size raises ``ValueError`` naming the size it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(resolve_device(device).type, shape, axes)


def make_host_mesh(device: DeviceLike = "cpu"):
    """A one-rank mesh with the same logical axes — CPU tests of sharded
    code in one process (the default group must be a world of one)."""
    return _mesh(torch.device(device).type, (1, 1), ("data", "model"))


def data_backend(device_type: str, *, local_world: Optional[int] = None) -> str:
    """The backend of a ``("data",)`` group, by rule: gloo on the CPU; on
    cards NCCL where each of this node's ranks has a card of its own
    (``local_world``, else ``torchrun``'s ``LOCAL_WORLD_SIZE``, at most the
    node's card count), else gloo (NCCL refuses two ranks on one card),
    whose collectives stage CUDA tensors through the host
    (core/collectives.py). Where this node's rank count is unknown it raises
    ``ValueError`` rather than guess."""
    if device_type != "cuda":
        return "gloo"
    if local_world is None:
        env = os.environ.get("LOCAL_WORLD_SIZE")
        if env is None:
            raise ValueError(
                "cannot choose the backend: how many ranks share this node's cards "
                "is unknown; pass local_world=, or launch under torchrun, which "
                "sets LOCAL_WORLD_SIZE"
            )
        local_world = int(env)
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def make_data_mesh(device: DeviceLike, world: int, *, rank: Optional[int] = None,
                   init_method: Optional[str] = None, local_world: Optional[int] = None,
                   timeout: datetime.timedelta = datetime.timedelta(seconds=300)):
    """A one-axis ``("data",)`` mesh over ``world`` ranks — what a ``torchrun``
    rank or a spawned rank calls. Joins the default process group first if
    it is not up yet: from ``torchrun``'s environment when ``init_method`` is
    None, else at ``init_method`` (e.g. ``tcp://localhost:29500``) as
    ``rank``. The backend is :func:`data_backend`'s, from the ranks on this
    node (``local_world``, or ``torchrun``'s ``LOCAL_WORLD_SIZE``); the card
    is ``LOCAL_RANK``'s, or ``rank``'s, modulo the node's cards."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = data_backend(dev.type, local_world=local_world)
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
            torch.cuda.set_device(local % torch.cuda.device_count())
        where = {} if init_method is None else dict(init_method=init_method, rank=rank,
                                                    world_size=world)
        dist.init_process_group(backend, timeout=timeout, **where)
    return _mesh(dev.type, (world,), ("data",))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (pure-DP axes)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def num_chips(mesh) -> int:
    return mesh.size()
