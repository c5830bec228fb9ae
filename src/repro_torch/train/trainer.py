"""Training loop: checkpoint/restart and straggler telemetry — twin of
``repro/train/trainer.py``.

Fault-tolerance contract:
  * checkpoints are atomic and step-tagged (``train/checkpoint.py``); the data
    is a pure function of (seed, step), so restore-and-resume is bit-exact;
  * ``Trainer.run`` restores the newest checkpoint automatically: killing the
    process at any point loses at most ``ckpt_every`` steps;
  * per-step host timing feeds a straggler report: steps slower than
    ``straggler_factor`` × the median over a window;
  * the loss history is what ``train/curve_gp.py`` predicts continuations of.

Two things the reference draws from ``jax.random``, which torch cannot
replay, are injected instead: the batches (``batches(step) -> dict``, by
default the port's ``token_batch(seed, step, ...)``) and the initial
parameters (``run(params=...)``, else drawn from a ``torch.Generator`` seeded
with ``seed``). A step's time is host wall-clock ending in a device sync
(reading the loss).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..data.pipeline import token_batch
from ..device import DeviceLike, make_generator, resolve_device
from ..models import model as model_lib
from .checkpoint import prune_checkpoints, restore_checkpoint, save_checkpoint
from .optim import AdamWConfig, init_opt_state


@dataclasses.dataclass
class TrainerConfig:
    batch: int = 8
    seq_len: int = 128
    num_steps: int = 100
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_window: int = 20
    straggler_factor: float = 2.0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


@dataclasses.dataclass
class StragglerReport:
    median_s: float
    slow_steps: list  # [(step, seconds)] steps slower than factor × median


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 step_fn: Optional[Callable] = None, *,
                 batches: Optional[Callable[[int], dict]] = None,
                 device: DeviceLike = None):
        from ..launch.steps import make_train_step

        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.step_fn = step_fn or make_train_step(cfg, tc.opt)
        self.batches = batches or (lambda step: token_batch(
            tc.seed, step, tc.batch, tc.seq_len, cfg.vocab_size, device=self.device))
        self.losses: list[float] = []
        self.step_times: list[float] = []

    # -- state -----------------------------------------------------------------
    def init_state(self, dtype=torch.float32, params=None):
        """``(params, opt)``: the given initial parameters, or a model drawn
        on the trainer's device from a generator seeded with ``tc.seed``."""
        if params is None:
            params = model_lib.init_model_params(
                self.cfg, make_generator(self.tc.seed, self.device), dtype, self.device)
        return params, init_opt_state(params, self.tc.opt)

    def _restore(self, params, opt):
        if not self.tc.ckpt_dir:
            return params, opt, 0
        tree, step, extra = restore_checkpoint(self.tc.ckpt_dir, {"p": params, "o": opt})
        if tree is None:
            return params, opt, 0
        self.losses = list(extra.get("losses", []))
        return tree["p"], tree["o"], step

    # -- loop ------------------------------------------------------------------
    def run(self, dtype=torch.float32, on_step: Optional[Callable] = None, params=None):
        params, opt = self.init_state(dtype, params)
        params, opt, start = self._restore(params, opt)
        tc = self.tc
        for step in range(start, tc.num_steps):
            batch = self.batches(step)
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.losses.append(loss)
            self.step_times.append(dt)
            if on_step is not None:
                on_step(step, loss)
            if tc.log_every and step % tc.log_every == 0:
                print(f"[train] step {step:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms")
            if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
                save_checkpoint(tc.ckpt_dir, step + 1, {"p": params, "o": opt},
                                extra={"losses": self.losses})
                prune_checkpoints(tc.ckpt_dir, tc.keep_ckpts)
        if tc.ckpt_dir:
            save_checkpoint(tc.ckpt_dir, tc.num_steps, {"p": params, "o": opt},
                            extra={"losses": self.losses})
            prune_checkpoints(tc.ckpt_dir, tc.keep_ckpts)
        return params, opt

    # -- telemetry ---------------------------------------------------------------
    def straggler_report(self) -> StragglerReport:
        w = self.step_times[-self.tc.straggler_window:]
        if not w:
            return StragglerReport(0.0, [])
        med = float(np.median(w))
        off = len(self.step_times) - len(w)
        slow = [(off + i, t) for i, t in enumerate(w)
                if t > self.tc.straggler_factor * max(med, 1e-9)]
        return StragglerReport(med, slow)
