#!/usr/bin/env python3
"""Is a serving request's payload the same in any batch? Measured on the card.

    python3 scripts/engine_determinism.py [--out FILE.jsonl]

At protein's shape (n = 45,730, d = 9, the main path's θ and CG(1000, 1e-3)):

1. ``width``: CG's column reductions at widths 8–64 against width 8, on the
   first 8 columns — the float32 sum over dim 0, the float64 sum that
   ``core/solvers/cg.py`` runs on the card, and ``torch.linalg.norm``;
2. ``columns``: the Gram kernel (square and 96 query rows) and the RFF kernel
   at widths 4–64 against width 4, on the first 4 columns;
3. ``determinism``: the engine fitted at 1 + 16 columns, one request of a
   64-column batch served again alone and cold, for CG's dots in float32 or
   float64 and the right-hand sides in one feature launch or in
   ``RHS_SLICE``-column launches: the payloads' largest difference and
   whether the solved columns are the same bits;
4. ``ab``: ``IterativeGP.fit → predict`` with the float32 and the float64
   dots in turns (float32, float64, float64, float32), and ms per iteration
   of the one-column ``RFFGram`` solve with the float32 reductions, the
   float64 ones, and float64 dots beside float32 norms, in turns; host clock
   ending in a synchronisation.

Needs the card; prints one JSON line per measurement and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_determinism: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import CG, IterativeGP, make_params, spectral_sample
    from repro_torch.core.solvers import cg as cg_mod
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram_matvec import gram_matvec
    from repro_torch.kernels.rff_matvec import rff_matvec
    from repro_torch.serve import engine as engine_mod

    out = open(args.out, "a") if args.out else None

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = regression_dataset("protein", seed=0)
    d = data["d"]
    ls = math.sqrt(d) * 0.5
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    n = x.shape[0]

    a = torch.randn((n, 64), generator=gen, device=dev)
    b = torch.randn((n, 64), generator=gen, device=dev)
    reductions = {"fp32_sum": lambda a, b: torch.sum(a * b, dim=0),
                  "fp64_sum": cg_mod._col_dot,
                  "linalg_norm": lambda a, b: torch.linalg.norm(a, dim=0),
                  "fp64_norm": lambda a, b: cg_mod._col_norm(a)}
    for name, fn in reductions.items():
        base = fn(a[:, :8].contiguous(), b[:, :8].contiguous())
        emit(measure="width", reduction=name, n=n, differing_of_8={
            s: int((fn(a[:, :s].contiguous(), b[:, :s].contiguous())[:8] != base).sum())
            for s in (16, 32, 64)})

    xs, xts = (x / ls).contiguous(), (xt[:96] / ls).contiguous()
    v = torch.randn((n, 64), generator=gen, device=dev)
    omega = spectral_sample(make_params("matern32", lengthscale=ls, d=d, device=dev), 1024, d,
                            generator=gen)
    w = torch.randn((2048, 64), generator=gen, device=dev)
    kernels = {"gram_square": lambda c: gram_matvec(xs, xs, c, kind="matern32"),
               "gram_cross": lambda c: gram_matvec(xts, xs, c, kind="matern32"),
               "rff": None}
    for name, fn in kernels.items():
        cols = w if name == "rff" else v
        run = fn or (lambda c: rff_matvec(x, omega, c))
        base = run(cols[:, :4].contiguous())
        emit(measure="columns", kernel=name, max_abs_vs_width4={
            s: (run(cols[:, :s].contiguous())[:, :4] - base).abs().max().item()
            for s in (8, 16, 32, 64)})

    fp32 = (lambda a, b: torch.sum(a * b, dim=0), lambda a: torch.linalg.norm(a, dim=0))
    fp64 = (cg_mod._col_dot, cg_mod._col_norm)
    slices = engine_mod.RHS_SLICE

    def gp():
        return IterativeGP("matern32", spec=CG(max_iters=1000, tol=1e-3), lengthscale=ls,
                           signal=1.0, noise=0.1, seed=0)

    try:
        for dots, rhs in (("fp32", 1 << 30), ("fp64", 1 << 30), ("fp64", slices)):
            cg_mod._col_dot, cg_mod._col_norm = fp32 if dots == "fp32" else fp64
            engine_mod.RHS_SLICE = rhs
            eng = gp().fit(x, y).engine(num_samples=16, num_features=2048)
            hs = [eng.sample(xt[16 * i:16 * i + 16], num_samples=4, seed=100 + i)
                  for i in range(16)]
            eng.step()
            key = eng.state.hypers_key
            batched = eng.cache.lookup(key, "sample", 103)
            eng.cache.purge("")
            solo = eng.sample(xt[48:64], num_samples=4, seed=103)
            eng.run_until_idle()
            pa, pb = hs[3].result().value["samples"], solo.result().value["samples"]
            emit(measure="determinism", dots=dots, rhs_launch_columns=min(rhs, 64),
                 batch_columns=hs[3].result().metrics["batch_columns"],
                 batch_iterations=hs[3].result().metrics["iterations"],
                 solo_iterations=solo.result().metrics["iterations"],
                 payload_max_abs=(pa - pb).abs().max().item(), payload_scale=pb.abs().max().item(),
                 solved_columns_bit_identical=bool(
                     (batched == eng.cache.lookup(key, "sample", 103)).all()))
        walls = {"fp32": [], "fp64": []}
        for dots in ("fp32", "fp64", "fp64", "fp32"):
            cg_mod._col_dot, cg_mod._col_norm = fp32 if dots == "fp32" else fp64
            model = gp()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.fit(data["x"], data["y"]).predict(data["x_test"])
            torch.cuda.synchronize()
            walls[dots].append(time.perf_counter() - t0)
            walls[dots + "_iterations"] = model.posterior(64).solve_info.iterations
        emit(measure="ab", path="fit_predict", n=n, walls_s=walls)
        # the one-column RFFGram solve, whose iterations are ~1 ms: the
        # reductions' share shows there
        from repro_torch.core import RFFGram, solve
        from repro_torch.core.rff import make_fourier_features

        params = make_params("matern32", lengthscale=ls, signal=1.0, noise=0.1, d=d,
                             device=dev)
        rop = RFFGram(x=x, ff=make_fourier_features(params, 2048, d, generator=gen),
                      sigma2=params.noise)
        variants = {"fp32": fp32, "fp64": fp64,
                    "fp64_dots_fp32_norms": (fp64[0], fp32[1])}
        walls = {k: [] for k in variants}
        for name in (*variants, *reversed(variants)):
            cg_mod._col_dot, cg_mod._col_norm = variants[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(rop, y, CG(max_iters=1000, tol=1e-3))
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / max(res.iterations, 1) * 1e3)
            walls[name + "_iterations"] = res.iterations
        emit(measure="ab", path="rff_gram", n=n, ms_per_iteration=walls)
    finally:
        cg_mod._col_dot, cg_mod._col_norm = fp64
        engine_mod.RHS_SLICE = slices
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(measure="device", nvidia_smi=smi, torch=torch.__version__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
