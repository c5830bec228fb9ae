#!/usr/bin/env python3
"""How far AP's first 200 steps at ``precision="bf16"`` land from its fp32
steps on the same blocks, on the CPU, through the plain route.

    PYTHONPATH=src python scripts/ap_bf16_drift.py [--n 20000 45730]

AP solves each block exactly in fp32 (``Gram.block_at``) and updates the
residual through ``rows_t_mv``, whose contraction bf16 casts: the block's
residual after its own update is then (K_BB − bf16 K_BB)·Δ, not 0, and the
iterate drifts from the fp32 one, in the reference as in the port (the plain
route, ``backend="chunked"``, is the reference's own bf16 route:
``tests/test_torch_precision.py::test_ap_bf16_drift_is_the_reference_s``
holds the two at a smaller n). For each n, on protein's shape (d = 9,
synthetic), Matérn-3/2 at ℓ = 1.5, σ² = 0.1, blocks of 512 from one
generator seed and 9 right-hand sides (y and 8 normal columns scaled by
0.3), it prints one JSON line: max|bf16 − fp32| over max(1, max|fp32|) for
the plain route and for the kernel route's plain versions
(``backend="cuda"`` on CPU tensors).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import AP, make_params, solve  # noqa: E402
from repro_torch.core.operators import Gram  # noqa: E402
from repro_torch.core.solvers import draw_rows  # noqa: E402
from repro_torch.data.pipeline import regression_dataset  # noqa: E402

STEPS, BLOCK = 200, 512


def drift(n: int) -> dict:
    data = regression_dataset(n, d=9, seed=0)
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    rng = np.random.default_rng(0)
    b = torch.cat([y[:, None], 0.3 * torch.from_numpy(
        rng.normal(size=(n, 8)).astype(np.float32))], dim=1)
    params = make_params("matern32", lengthscale=1.5, signal=1.0, noise=0.1, d=9,
                         device="cpu")
    draws = draw_rows(n, STEPS, BLOCK, generator=torch.Generator().manual_seed(1),
                      device=torch.device("cpu"))
    out = dict(n=n, steps=STEPS, block=BLOCK)
    for backend in ("chunked", "cuda"):
        sol = {p: solve(Gram(x=x, params=params), b,
                        AP(num_steps=STEPS, block_size=BLOCK, backend=backend,
                           precision=p), draws=draws).solution
               for p in ("fp32", "bf16")}
        gap = (sol["bf16"] - sol["fp32"]).abs().max() / max(1.0, float(sol["fp32"].abs().max()))
        out[f"{backend}_gap"] = float(gap)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[20_000, 45_730])
    args = ap.parse_args()
    for n in args.n:
        print(json.dumps(drift(n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
