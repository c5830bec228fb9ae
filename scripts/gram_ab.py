#!/usr/bin/env python3
"""The Gram forward kernel of two checkouts of the port, timed on one card in
turns, with each build's registers and spills.

    python3 scripts/gram_ab.py --src A/src --src B/src [--rounds 2]

Each checkout's ``repro_torch`` package is imported in a process of its own
(its kernels built in its own build directory) and times ``gram_matvec``'s
launch by CUDA events over 20 warm launches, the median of 5, at the main
path's shapes: protein's 45,730², d = 9, Matérn-3/2, at s = 1, 9, 17, 65 (CG's
and training's widths), and SGD's 512 × 45,730 panel at s = 65, on inputs made
from a seed. The runs go A B B A in each round. Prints one JSON line a run
(the ms by shape, and the registers and spill bytes of every
``gram_matvec_kernel`` instance its ptxas reported), then the card's name and
power limit. Run from the root of a checkout, on a machine with a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("square", 45_730, 1), ("square", 45_730, 9), ("square", 45_730, 17),
          ("square", 45_730, 65), ("panel", 512, 65))


def worker(src: str) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gram_matvec import gram_matvec

    info = _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((45_730, 9), generator=gen, device="cuda") * 4.0
    xi = x[torch.randperm(45_730, generator=gen, device="cuda")[:512]].contiguous()
    ms = {}
    for label, rows, s in SHAPES:
        v = torch.randn((45_730, s), generator=gen, device="cuda")
        rows_x = x if label == "square" else xi
        gram_matvec(rows_x, x, v, kind="matern32")
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                gram_matvec(rows_x, x, v, kind="matern32")
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        ms[f"{label}_{rows}_s{s}"] = sorted(runs)[2]
    # gram_matvec_kernel<KIND, NT, BF16>: (registers, spill stores, spill loads)
    ptx = {p["name"].split("gram_matvec_kernel")[-1]: (p["registers"], p["spill_stores"],
                                                      p["spill_loads"])
           for p in info.ptxas if "gram_matvec_kernel<" in p["name"]}
    return dict(src=src, ms=ms, ptxas=ptx)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True,
                    help="a directory holding a repro_torch package (give two)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.src[0])), flush=True)
        return 0
    if len(args.src) != 2:
        ap.error("give --src twice: A and B")
    a, b = args.src
    for _ in range(args.rounds):
        for src in (a, b, b, a):
            proc = subprocess.run([sys.executable, __file__, "--worker", "--src", src],
                                  capture_output=True, text=True, check=True)
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
