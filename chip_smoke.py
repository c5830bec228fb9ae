#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, runs the main path
``IterativeGP(...).fit(x, y).predict(x_test)`` on the protein-shaped problem at
full n through those kernels, checks its posterior mean against a Cholesky
oracle, and runs one Gram matvec at 3droad's n, where K could not be held.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without its result lines. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero at once. The last two lines are the
kernels' record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores,
#: and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KINDS = ("se", "matern12", "matern32", "matern52")
#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57)
GRAM_TOL, RFF_TOL = 2e-4, 1e-4
SEED = 0
#: The main path's solver: the tolerance of benchmarks/bench_solvers.py:83,
#: with an iteration budget CG can reach it in at the full protein n. The
#: bench's own budget of 150 iterations was set on a quarter of pol, elevators
#: and bike; at n = 45,730 CG stops there well short of the tolerance, and the
#: oracle phase measures what that budget gives.
MAIN_TOL, MAIN_MAX_ITERS, BENCH_MAX_ITERS = 1e-3, 1000, 150


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    smi = env_phase(torch)
    build_phase()
    kernels = kernels_phase(torch)
    main_path_phase(torch, kernels)
    profile_phase(torch)
    large_n_phase(torch)

    print(smi)
    print(json.dumps({"kernels": [kernels[k] for k in ("gram_matvec", "rff_matvec")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def env_phase(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    # the plain versions are the fp32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         capability=list(cap), nvidia_smi=smi)
    print(smi)
    check(cap == (9, 0), f"an sm_90 card (H100), got capability {cap}")
    return smi


def build_phase() -> None:
    from repro_torch.kernels import _build

    info = _build.build(force=True)
    emit("build", seconds=info.seconds, library=str(info.path.relative_to(ROOT)),
         kernels=list(info.ptxas))
    check(len(info.ptxas) > 0, "ptxas reported the compiled kernels")


def _events_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _gram_bound_ms(n, m, d, s):
    flops = n * m * (2 * d + 2 * s)
    nbytes = 4 * (n * d + m * d + m * s + n * s)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def _rff_bound_ms(n, m, d, s):
    flops = n * m * (2 * d + 4 * s)
    nbytes = 4 * (n * d + m * d + 2 * m * s + n * s)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def kernels_phase(torch) -> dict:
    """Each kernel against its plain version, on the card, at the main path's
    shapes. The kernel is compared with the plain version run in float64 on
    the same fp32 inputs: the fp32 plain version rounds d² on the diagonal of
    K(x, x) to a few ulp instead of 0, which Matérn-1/2 turns into ~1e-3, an
    error of the yardstick and not of the kernel (its distance to the fp32 plain
    version is printed too). Times: kernel over 20 warm launches, plain over 3
    calls, both by CUDA events."""
    from repro_torch.core.kernels_fn import make_params, spectral_sample
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels.gram_matvec import gram_matvec
    from repro_torch.kernels.ref import gram_matvec_ref, rff_matvec_ref
    from repro_torch.kernels.rff_matvec import rff_matvec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    ls = math.sqrt(d) * 0.5  # the main path's lengthscale
    x = torch.as_tensor(data["x"], device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    xs, xts = (x / ls).contiguous(), (xt / ls).contiguous()
    rec = {
        "gram_matvec": dict(name="gram_matvec", route="cuda",
                            source="src/repro_torch/kernels/csrc/gram_matvec.cu",
                            replaces="src/repro/kernels/gram_matvec.py:154",
                            max_abs_err=0.0),
        "rff_matvec": dict(name="rff_matvec", route="cuda",
                           source="src/repro_torch/kernels/csrc/rff_matvec.cu",
                           replaces="src/repro/kernels/rff_matvec.py:78",
                           max_abs_err=0.0),
    }

    def gram_case(kind, rows, cols, s, label):
        v = torch.randn((cols.shape[0], s), generator=gen, device=dev)
        out = gram_matvec(rows, cols, v, kind=kind)
        ref64 = gram_matvec_ref(rows.double(), cols.double(), v.double(), kind=kind,
                                row_chunk=2048)
        ref32 = gram_matvec_ref(rows, cols, v, kind=kind)
        torch.cuda.synchronize()
        err = (out.double() - ref64).abs().max().item()
        scale = max(1.0, ref64.abs().max().item())
        n, m = rows.shape[0], cols.shape[0]
        bound, flops, nbytes = _gram_bound_ms(n, m, d, s)
        line = dict(kernel="gram_matvec", case=label, kind=kind, n=n, m=m, d=d, s=s,
                    max_abs_err=err, tol=GRAM_TOL * scale,
                    err_vs_fp32_plain=(out - ref32).abs().max().item(),
                    smem_bytes=gram_matvec.smem_bytes(d, s),
                    ms=_events_ms(torch, lambda: gram_matvec(rows, cols, v, kind=kind), 20),
                    plain_ms=_events_ms(torch, lambda: gram_matvec_ref(rows, cols, v, kind=kind), 3),
                    bound_ms=bound, flops=flops, bytes=nbytes)
        emit("kernels", **line)
        check(err <= GRAM_TOL * scale, f"gram_matvec {label} {kind} s={s}: {err}")
        rec["gram_matvec"]["max_abs_err"] = max(rec["gram_matvec"]["max_abs_err"], err)
        return line

    main_gram = None
    for kind in KINDS:
        for s in (1, 17, 65):
            line = gram_case(kind, xs, xs, s, "square")
            if kind == "matern32" and s == 65:  # CG's call on the main path
                main_gram = line
        for s in (1, 64):  # the posterior mean and the samples at X*
            gram_case(kind, xts, xs, s, "cross")

    params = make_params("matern32", lengthscale=ls, d=d, device=dev)
    omega = spectral_sample(params, 1024, d, generator=gen)  # 2,048 features
    main_rff = None
    for rows, label in ((x, "train"), (xt, "test")):
        for s in (16, 64):
            w = torch.randn((2 * omega.shape[0], s), generator=gen, device=dev)
            out = rff_matvec(rows, omega, w)
            ref64 = rff_matvec_ref(rows.double(), omega.double(), w.double())
            ref32 = rff_matvec_ref(rows, omega, w)
            torch.cuda.synchronize()
            err = (out.double() - ref64).abs().max().item()
            scale = max(1.0, ref64.abs().max().item())
            n, m = rows.shape[0], omega.shape[0]
            bound, flops, nbytes = _rff_bound_ms(n, m, d, s)
            line = dict(kernel="rff_matvec", case=label, n=n, m=m, d=d, s=s,
                        max_abs_err=err, tol=RFF_TOL * scale,
                        err_vs_fp32_plain=(out - ref32).abs().max().item(),
                        smem_bytes=rff_matvec.smem_bytes(d, s),
                        ms=_events_ms(torch, lambda: rff_matvec(rows, omega, w), 20),
                        plain_ms=_events_ms(torch, lambda: rff_matvec_ref(rows, omega, w), 3),
                        bound_ms=bound, flops=flops, bytes=nbytes)
            emit("kernels", **line)
            check(err <= RFF_TOL * scale, f"rff_matvec {label} s={s}: {err}")
            rec["rff_matvec"]["max_abs_err"] = max(rec["rff_matvec"]["max_abs_err"], err)
            if label == "train" and s == 64:  # f_X on the main path
                main_rff = line

    for key, line in (("gram_matvec", main_gram), ("rff_matvec", main_rff)):
        rec[key].update(ms=line["ms"], plain_ms=line["plain_ms"], bound_ms=line["bound_ms"],
                        bound_by="operations", library_ms=None)
    return rec


def main_path_phase(torch, kernels: dict) -> None:
    """``IterativeGP.fit → predict`` at full protein n through the kernels, with
    the launch counts read just around it, then the Cholesky oracle."""
    from repro_torch.core import CG, IterativeGP, exact_posterior
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_matvec import gram_matvec
    from repro_torch.kernels.rff_matvec import rff_matvec

    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)
    gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL), **hypers)
    dev = gp.device
    check(dev.type == "cuda", f"IterativeGP() defaults to the card, got {dev}")
    y_test = torch.as_tensor(data["y_test"], device=dev)

    torch.cuda.synchronize()
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    gram_matvec.launches = 0
    rff_matvec.launches = 0
    t0 = time.perf_counter()
    mean, var = gp.fit(data["x"], data["y"]).predict(data["x_test"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gram_matvec": gram_matvec.launches, "rff_matvec": rff_matvec.launches}
    matvec_counts, feature_counts = dict(ops.MATVEC_TRACE_COUNTS), dict(ops.FEATURE_TRACE_COUNTS)

    info = gp.posterior(64).solve_info  # cached: no further launches
    rmse = torch.sqrt(torch.mean((mean - y_test) ** 2)).item()
    v = torch.clamp(var, min=1e-6)
    nll = torch.mean(0.5 * torch.log(2 * math.pi * v) + 0.5 * (y_test - mean) ** 2 / v).item()
    emit("main_path", n=int(data["n"]), d=d, n_test=int(mean.shape[0]), rhs_columns=65,
         iterations=info.iterations, matvecs=info.matvecs, converged=info.converged,
         max_rel_residual=info.rel_residual.max().item(),
         flags=sorted(set(info.flags.tolist())), rmse=rmse, nll=nll, wall_s=wall,
         launches=launches, matvec_counts=matvec_counts, feature_counts=feature_counts)
    check(info.healthy, "the CG solve carries no nonfinite/breakdown flag")
    check(info.converged, f"CG reached tol {MAIN_TOL} within {MAIN_MAX_ITERS} iterations")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "finite outputs")
    check(mean.shape == var.shape == (1024,), f"outputs of shape (1024,), got {mean.shape}")
    check(launches["gram_matvec"] == info.iterations + 2,
          f"Gram kernel launches {launches['gram_matvec']} == iterations + 2")
    check(launches["rff_matvec"] == 2, f"RFF kernel launches {launches['rff_matvec']} == 2")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    check(feature_counts["features"] == 0, "no materialised feature matrix")
    for k in kernels:
        kernels[k]["launches"] = launches[k]

    t0 = time.perf_counter()
    ep = exact_posterior(gp.params, gp.x, gp.y)
    xt = torch.as_tensor(data["x_test"], device=dev)
    exact_mean, exact_var = ep.mean(xt), ep.var(xt)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    rel = ((mean - exact_mean).norm() / exact_mean.norm()).item()
    # the same fit at the bench's iteration budget, measured, not asserted
    bench = IterativeGP("matern32", spec=CG(max_iters=BENCH_MAX_ITERS, tol=MAIN_TOL), **hypers)
    bench_mean, _ = bench.fit(data["x"], data["y"]).predict(data["x_test"])
    bench_info = bench.posterior(64).solve_info
    emit("oracle", rel_mean_err=rel, tol=1e-2,
         mean_var_ratio=(var / exact_var).mean().item(),
         exact_rmse=torch.sqrt(torch.mean((exact_mean - y_test) ** 2)).item(),
         seconds=oracle_s, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         bench_budget=dict(
             max_iters=BENCH_MAX_ITERS, iterations=bench_info.iterations,
             converged=bench_info.converged,
             max_rel_residual=bench_info.rel_residual.max().item(),
             rel_mean_err=((bench_mean - exact_mean).norm() / exact_mean.norm()).item(),
             rmse=torch.sqrt(torch.mean((bench_mean - y_test) ** 2)).item()))
    check(rel <= 1e-2, f"CG mean within 1e-2 of the Cholesky mean, got {rel}")
    del ep
    torch.cuda.empty_cache()


def profile_phase(torch) -> None:
    """The main path once more under ``torch.profiler``: device time by kernel
    and the card's idle share of the wall time. Run after the counted pass so
    that the profiler's overhead touches no other number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import CG, IterativeGP
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL),
                     lengthscale=math.sqrt(data["d"]) * 0.5, signal=1.0, noise=0.1,
                     seed=SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gp.fit(data["x"], data["y"]).predict(data["x_test"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # device-side events only: a host op's device time repeats its kernels'
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit("profile", wall_ms=wall * 1e3, device_ms=device_ms,
         idle_share=1.0 - device_ms / (wall * 1e3),
         iterations=gp.posterior(64).solve_info.iterations,
         top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
    check(0 < device_ms <= wall * 1e3, f"device time {device_ms} ms within the wall time")


def large_n_phase(torch) -> None:
    """One Gram matvec at 3droad's n = 434,874 (K would take 756 GB), checked on
    4,096 output rows against the plain version in float64."""
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels.gram_matvec import gram_matvec
    from repro_torch.kernels.ref import gram_matvec_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = regression_dataset("3droad", seed=SEED)
    n, d, s = int(data["n"]), data["d"], 17
    xs = (torch.as_tensor(data["x"], device=dev) / (math.sqrt(d) * 0.5)).contiguous()
    v = torch.randn((n, s), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    out = gram_matvec(xs, xs, v, kind="matern32")
    ms = _events_ms(torch, lambda: gram_matvec(xs, xs, v, kind="matern32"), 2)
    peak = torch.cuda.max_memory_allocated()
    rows = 4096
    ref = gram_matvec_ref(xs[:rows].double(), xs.double(), v.double(), kind="matern32",
                          row_chunk=256)
    err = (out[:rows].double() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    bound, flops, nbytes = _gram_bound_ms(n, n, d, s)
    emit("large_n", n=n, d=d, s=s, kind="matern32", ms=ms, bound_ms=bound, flops=flops,
         checked_rows=rows, max_abs_err=err, tol=GRAM_TOL * scale,
         max_memory_allocated_gb=peak / 1e9, finite=bool(torch.isfinite(out).all()))
    check(bool(torch.isfinite(out).all()), "finite 3droad-shaped matvec")
    check(err <= GRAM_TOL * scale, f"3droad-shaped matvec rows: {err}")


if __name__ == "__main__":
    sys.exit(main())
