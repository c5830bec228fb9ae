"""Spawned ranks on one host, for the distributed path's tests and the card
smoke run: :func:`run_ranks` starts ``world`` processes with
``torch.multiprocessing``, each calling ``fn(rank, world, port, *args)`` with
a free localhost port for its process group (:func:`join_mesh`). It returns
once every rank has ended and raises if one failed or the run outlasted its
timeout, after stopping every process it started: a hung rank fails the run
instead of holding it. :class:`RingOrderGram` is the yardstick of ring CG:
``ShardedGram(comm="ring")``'s arithmetic on one device.
"""
from __future__ import annotations

import dataclasses
import datetime
import socket
import time

import torch
import torch.multiprocessing as mp

from ..core.kernels_fn import KernelParams, gram_diag
from ..core.operators import LinearOperator
from ..device import DeviceLike
from ..kernels.ops import gram_mv
from ..launch.mesh import make_data_mesh


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, *args, timeout: float = 180.0) -> None:
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned processes
    (``fn`` must be importable by its module's name). Raises
    ``TimeoutError`` past ``timeout`` seconds, and a failed rank's exception
    as ``torch.multiprocessing`` reports it."""
    ctx = mp.spawn(fn, args=(world, free_port(), *args), nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def join_mesh(rank: int, world: int, port: int, device: DeviceLike, *,
              timeout: float = 120.0):
    """A spawned rank's ``("data",)`` mesh over ``world`` ranks at
    ``tcp://localhost:port``, every rank on this node; every collective
    times out after ``timeout`` seconds."""
    return make_data_mesh(device, world, rank=rank, init_method=f"tcp://localhost:{port}",
                          local_world=world,
                          timeout=datetime.timedelta(seconds=timeout))


@dataclasses.dataclass(frozen=True)
class RingOrderGram(LinearOperator):
    """(K + σ²I) on one device, each row sum taken as
    ``ShardedGram(comm="ring")`` takes it over ``world`` ranks: row block r
    is σ²v_r, then K(x_r, x_q) @ v_q added for q = r, r + 1, … (mod
    ``world``), the order in which rank r's ring stages receive the blocks,
    one ``gram_mv`` call each at the ring's shapes. Ring CG differs from
    single-device CG on this operator only in how its column reductions add
    the ranks' float64 partials, where single-device CG on ``Gram`` also
    differs in every row sum (one launch over all n columns)."""

    x: torch.Tensor  # (n, d) the whole training inputs
    params: KernelParams
    world: int
    backend: str = "auto"
    row_chunk: int = 2048
    precision: str = "fp32"

    def __post_init__(self):
        if self.x.shape[0] % self.world:
            raise ValueError(f"{self.x.shape[0]} rows do not split into {self.world} blocks")

    @property
    def shape(self) -> tuple:
        return (self.x.shape[0], self.x.shape[0])

    @property
    def noise(self) -> torch.Tensor:
        return self.params.noise

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        n_local = self.x.shape[0] // self.world
        block = [slice(r * n_local, (r + 1) * n_local) for r in range(self.world)]
        out = []
        for r in range(self.world):
            acc = self.noise * v2[block[r]]
            for t in range(self.world):
                q = block[(r + t) % self.world]
                acc = acc + gram_mv(self.params, self.x[block[r]], v2[q].contiguous(),
                                    z=self.x[q], backend=self.backend,
                                    row_chunk=self.row_chunk, precision=self.precision)
            out.append(acc)
        out = torch.cat(out)
        return out[:, 0] if squeeze else out

    def diag_part(self) -> torch.Tensor:
        return gram_diag(self.params, self.x) + self.noise
