#!/usr/bin/env python3
"""How far the LM training loss falls in a short run, by learning rate.

    python3 scripts/lm_train_lr.py [--arch olmo-1b] [--lrs 3e-3 1e-2 3e-2]
                                   [--steps 20] [--batch 8] [--seq-len 1024]

For each learning rate, trains ``--arch`` at full width and depth through
``repro_torch.launch.train.main`` (fp32, the default AdamW with its 100
warm-up steps, the planted-bigram batches of seed 0) and prints one JSON
line: the losses, the means of the first and the last 5 and their
difference, the median step time and the peak memory. ``chip_smoke.py``'s
``lm_train`` phase trains at the rate chosen from these runs, and holds the
drop to at least 0.1. Runs on the card (``--device cpu`` with ``--reduced``
to try it on the CPU).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as launch_train  # noqa: E402


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
    for lr in args.lrs:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(args.batch),
                "--seq-len", str(args.seq_len), "--lr", str(lr), "--seed", "0"]
        argv += ["--reduced"] * args.reduced + (["--device", args.device] if args.device else [])
        tr = launch_train.main(argv)
        first = statistics.fmean(tr.losses[:5])
        last = statistics.fmean(tr.losses[-5:])
        print(json.dumps(dict(
            arch=args.arch, lr=lr, steps=args.steps, batch=args.batch, seq=args.seq_len,
            losses=tr.losses, first5_mean=first, last5_mean=last, drop=first - last,
            median_step_s=statistics.median(tr.step_times),
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
