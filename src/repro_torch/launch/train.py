"""Training launcher — twin of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch olmo-1b                   # on the card
    python -m repro_torch.launch.train --arch olmo-1b --reduced --device cpu
    python -m repro_torch.launch.train --arch dbrx-132b --reduced       # on the card

Trains in fp32, as the reference's launcher does, on the planted-bigram
token batches, with random initial weights drawn from ``--seed``.
Checkpoint/restart works the same on either device: kill and relaunch with
the same ``--ckpt-dir`` to resume.
"""
from __future__ import annotations

import argparse

import torch

from ..configs.base import get_config, list_configs
from ..train.optim import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> Trainer:
    """Parse ``argv``, train, print the summary; returns the ``Trainer`` (its
    ``losses`` and ``step_times``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainerConfig(
        batch=args.batch, seq_len=args.seq_len, num_steps=args.steps,
        seed=args.seed, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr),
    )
    tr = Trainer(cfg, tc, device=args.device)
    tr.run(dtype=torch.float32)
    rep = tr.straggler_report()
    print(f"[train] done. final loss {tr.losses[-1]:.4f}  "
          f"median step {rep.median_s*1e3:.0f} ms  stragglers: {len(rep.slow_steps)}")
    return tr


if __name__ == "__main__":
    main()
