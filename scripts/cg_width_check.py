#!/usr/bin/env python3
"""Does a CG column move with its batch's width? Measured on the card, for
any checkout of the port.

    python3 scripts/cg_width_check.py [--src DIR] [--out FILE.jsonl]

Runs the width check of ``chip_smoke.py``'s ``cg_width`` phase and of
``tests/test_torch_gpu.py::test_cg_column_does_not_move_with_its_batch_width_on_card``
against the ``repro_torch`` package under DIR (default: this checkout's
``src``), so that an older tree can be held to it too. Each of the two
problems (the phase's: protein's first 8,192 rows at the main path's θ and
CG(1000, 1e-3); the test's: 4,096 synthetic rows in 5-D, CG(500, 1e-4)) solves
one column at width 8 and beside 63 others at width 64, with random and with
zero companions, and reports, for the 8 columns both widths share, how many
differ in the solver's relative residual, residual norm and solution bits,
in ‖b‖ as float32 ``torch.linalg.norm`` gives it and as a float64 sum of
squares rounded once to float32 gives it (the stop test's denominator
before and after the repair of CG's norms), and in that float64 sum itself;
and the iteration counts. Only the package's public solver surface
is used, so the check reads the same on any tree. Prints one JSON line a
problem and companion set, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package to check")
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cg_width_check: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch
    from repro_torch.core import CG, Gram, make_params, solve
    from repro_torch.data.pipeline import regression_dataset

    out = open(args.out, "a") if args.out else None
    dev = torch.device("cuda")

    def emit(**fields):
        line = json.dumps(dict(package=str(Path(repro_torch.__file__).parent), **fields))
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    def problems():
        data = regression_dataset("protein", seed=0)
        d = data["d"]
        params = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                             d=d, device=dev)
        x = torch.as_tensor(data["x"][:8192], device=dev)
        y = torch.as_tensor(data["y"][:8192], device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        others = torch.randn((x.shape[0], 63), generator=gen, device=dev)
        yield "chip_smoke", x, y, params, others, CG(max_iters=1000, tol=1e-3)
        data = regression_dataset(4096, d=5, seed=2, n_test=8)
        params = make_params("matern32", lengthscale=1.1, noise=0.1, d=5, device=dev)
        others = np.random.default_rng(3).normal(size=(4096, 63)).astype(np.float32)
        yield ("card_test", torch.as_tensor(data["x"], device=dev),
               torch.as_tensor(data["y"], device=dev), params,
               torch.from_numpy(others).to(dev), CG(max_iters=500, tol=1e-4))

    for name, x, y, params, others, spec in problems():
        op = Gram(x=x, params=params)
        for label, companions in (("random", others), ("zero", torch.zeros_like(others))):
            got = []
            for width in (8, 64):
                b = torch.cat([y[:, None], companions[:, :width - 1]], dim=1).contiguous()
                res = solve(op, b, spec)
                got.append(dict(
                    bn_float32=torch.linalg.norm(b, dim=0)[:8],
                    bn_float64=torch.linalg.vector_norm(b, dim=0, dtype=torch.float64)[:8],
                    bn_float64_rounded=torch.linalg.vector_norm(
                        b, dim=0, dtype=torch.float64)[:8].to(b.dtype),
                    rel=res.rel_residual[:8], rn=res.residual_norm[:8],
                    solution=res.solution[:, :8], iterations=res.iterations,
                    converged=res.converged))
            a, b = got
            differ = {k: int((a[k] != b[k]).reshape(-1, 8).any(dim=0).sum())
                      for k in ("bn_float32", "bn_float64_rounded", "bn_float64", "rel", "rn",
                                "solution")}
            emit(problem=name, companions=label, columns_differing=differ,
                 column0_differs={k: bool((a[k] != b[k]).reshape(-1, 8)[:, 0].any())
                                  for k in differ},
                 iterations=[a["iterations"], b["iterations"]],
                 converged=[a["converged"], b["converged"]])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
