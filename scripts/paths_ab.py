#!/usr/bin/env python3
"""The host-bound GP paths of two checkouts of the port, timed on one card in
turns: SGD's and SDD's ms a step, a Thompson acquisition's s, and the
``sgpr_iterative`` and ``inducing_posterior`` wall s.

    python3 scripts/paths_ab.py --src A/src --src B/src [--rounds 2]
    python3 scripts/paths_ab.py --cpu --src A/src --src B/src

Each checkout's ``repro_torch`` package is imported in a process of its own
(its kernels built in its own build directory). The runs go A B B A in each
round. A run drives, through the entry points a user calls and at
``chip_smoke.py``'s cells: ``IterativeGP(spec=SGD | SDD).fit → predict`` on
protein's 45,730 points (the serving θ, 64 samples on 2,048 features, the
bench's specs, STEPS steps; ms a step = wall / steps, fit and predict
included); ``thompson_step`` on SDD from 50,000 observations (bench_thompson's
config, 3,000 SDD steps, 20 ascent steps), two acquisitions; and the sparse
cell's ``sgpr_iterative`` (fit, mean and the 1,024-column variance solve) and
``inducing_posterior`` (fit, mean and sample paths) at m = 512. Each path runs
once short to warm up first. Prints one JSON line a run, then the card's name
and power limit.

``--cpu`` counts the host's share instead, on this machine's CPU with one
thread: the same paths at n = 2,048 (Thompson from 2,000), their solvers
pinned to ``backend="cuda"`` so that every launch resolves its block as on
the card (the wrappers take their plain versions on CPU tensors), and prints
each path's Python calls a step by ``cProfile`` (SGD and SDD: over STEPS_CPU
steps; Thompson: an acquisition; the sparse paths: a whole call). Its times
are never a device's.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import math
import pstats
import subprocess
import sys
import time
from pathlib import Path

#: chip_smoke.py's STOCH_SPECS, THOMPSON, THOMPSON_SDD and SPARSE
STOCH_SPECS = {"sgd": dict(batch_size=512, num_features=100, step_size_times_n=0.5),
               "sdd": dict(batch_size=512, step_size_times_n=2.0)}
THOMPSON = dict(d=8, kind="matern32", lengthscale=0.3, signal=1.0, noise=1e-3, n0=50_000,
                acq_batch=100, num_candidates=512, num_top=4, ascent_steps=20,
                num_features=1024, objective_features=2048)
THOMPSON_SDD = dict(num_steps=3000, batch_size=128, step_size_times_n=2.0)
SPARSE = dict(m=512, num_samples=16, num_features=2048)
STEPS, WARM_STEPS, STEPS_CPU, SEED = 4000, 100, 50, 0


def _paths(torch, dev, cpu: bool):
    """The paths as {name: (run(steps), steps a run)}: each a closure over
    inputs made once."""
    from repro_torch.core import (
        CG, SDD, SGD, IterativeGP, ThompsonState, inducing_posterior, make_params,
        sample_prior, sgpr_iterative, thompson_step,
    )
    from repro_torch.data.pipeline import regression_dataset

    pin = dict(backend="cuda") if cpu else {}
    data = regression_dataset("protein", seed=SEED)
    n = 2_048 if cpu else data["n"]
    x, y = data["x"][:n], data["y"][:n]
    d = data["d"]
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)

    def stochastic(cls, name):
        def run(steps):
            spec = cls(num_steps=steps, **STOCH_SPECS[name], **pin)
            gp = IterativeGP("matern32", spec=spec, device=dev, **hypers)
            mean, _ = gp.fit(x, y).predict(data["x_test"])
            return mean
        return run

    cfg = THOMPSON
    n0 = 2_000 if cpu else cfg["n0"]
    params_t = make_params(cfg["kind"], lengthscale=cfg["lengthscale"], signal=cfg["signal"],
                           noise=cfg["noise"], d=cfg["d"], device=dev)
    target = sample_prior(params_t, 1, cfg["objective_features"], cfg["d"],
                          generator=torch.Generator(device=dev).manual_seed(SEED + 1000))
    kw = {k: cfg[k] for k in ("acq_batch", "num_features", "num_candidates", "num_top",
                              "ascent_steps")}

    def objective(q):
        return target(q)[:, 0]

    def thompson(steps):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            x0 = torch.rand((n0, cfg["d"]), generator=gen, device=dev)
            y0 = objective(x0)
            state = ThompsonState(x=x0, y=y0, best=float(y0.max()))
        spec = SDD(**{**THOMPSON_SDD, "num_steps": steps}, **pin)
        return thompson_step(params_t, state, objective, generator=gen, spec=spec, **kw).x

    xs = torch.as_tensor(x, device=dev)
    ys = torch.as_tensor(y, device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    z = xs[::max(1, n // SPARSE["m"])][:SPARSE["m"]]
    params = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                         d=d, device=dev)

    def sparse(max_iters):
        spec = CG(max_iters=max_iters, tol=1e-6, **pin)
        it = sgpr_iterative(params, xs, ys, z, spec=spec)
        return it.mean(xt), it.var_solve(xt).var

    def inducing(max_iters):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        spec = CG(max_iters=max_iters, tol=1e-5, **pin)
        post = inducing_posterior(params, xs, ys, z, generator=gen, spec=spec,
                                  num_samples=SPARSE["num_samples"],
                                  num_features=SPARSE["num_features"])
        return post.mean(xt), post(xt)

    return {"sgd": (stochastic(SGD, "sgd"), STEPS), "sdd": (stochastic(SDD, "sdd"), STEPS),
            "thompson": (thompson, THOMPSON_SDD["num_steps"]), "sgpr_iterative": (sparse, 400),
            "inducing": (inducing, 200)}


def worker(src: str, cpu: bool) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    out = {"src": src}
    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        from repro_torch.kernels import _build

        _build.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
    paths = _paths(torch, dev, cpu)
    for name, (run, steps) in paths.items():
        if cpu:
            few = STEPS_CPU if name in ("sgd", "sdd") else steps
            run(few)  # warm
            prof = cProfile.Profile()
            prof.runcall(run, few)
            calls = pstats.Stats(prof).total_calls
            out[name] = {"python_calls": calls, "steps": few,
                         "python_calls_per_step": calls / few}
            continue
        run(min(WARM_STEPS, steps))
        torch.cuda.synchronize()
        walls = []
        for _ in range(2 if name == "thompson" else 1):
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        out[name] = ({"ms_per_step": 1e3 * wall / steps, "wall_s": wall}
                     if name in ("sgd", "sdd") else {"wall_s": wall, "walls": walls})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True,
                    help="a directory holding a repro_torch package (give two)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="count Python calls on the CPU")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.src[0], args.cpu)), flush=True)
        return 0
    if len(args.src) != 2:
        ap.error("give --src twice: A and B")
    a, b = args.src
    order = (a, b) if args.cpu else (a, b, b, a) * args.rounds
    for src in order:
        cmd = [sys.executable, __file__, "--worker", "--src", src] + (["--cpu"] if args.cpu
                                                                     else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
