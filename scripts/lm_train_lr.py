#!/usr/bin/env python3
"""How far the LM training loss falls in a short run, by learning rate.

    python3 scripts/lm_train_lr.py [--arch olmo-1b] [--lrs 3e-3 1e-2 3e-2]
                                   [--steps 20] [--batch 8] [--seq-len 1024]

For each learning rate, trains ``--arch`` at full width and depth through
the ``Trainer`` that ``repro_torch.launch.train`` runs (fp32, the default
AdamW with its 100 warm-up steps) on ``data.pipeline.lm_batch``'s batches of
seed 0: the launcher's planted-bigram tokens, with the stub inputs of a
family that has them (whisper-tiny's frames, qwen2-vl-7b's patch
embeddings), which the launcher does not give. Prints one JSON line: the losses, the means of the first and
the last 5 and their difference, the median step time and the peak memory.
``chip_smoke.py``'s ``lm_train`` and ``lm_families`` phases train at the
rates chosen from these runs, and hold the drop to at least 0.1. Runs on the
card (``--device cpu`` with ``--reduced`` to try it on the CPU), e.g.

    python3 scripts/lm_train_lr.py --arch whisper-tiny --batch 16 --seq-len 448
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-3, 1e-2, 3e-2])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    cuda = args.device is None or args.device.startswith("cuda")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    dev = args.device or "cuda"
    for lr in args.lrs:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, TrainerConfig(
            batch=args.batch, seq_len=args.seq_len, num_steps=args.steps, seed=0,
            log_every=0, opt=AdamWConfig(lr=lr)),
            batches=lambda i: lm_batch(cfg, 0, i, args.batch, args.seq_len, device=dev),
            device=dev)
        tr.run()
        first = statistics.fmean(tr.losses[:5])
        last = statistics.fmean(tr.losses[-5:])
        print(json.dumps(dict(
            arch=args.arch, lr=lr, steps=args.steps, batch=args.batch, seq=args.seq_len,
            losses=tr.losses, first5_mean=first, last5_mean=last,
            drop=first - last, median_step_s=statistics.median(tr.step_times),
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
