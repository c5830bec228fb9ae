#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the paths' shapes, and drives both paths
on the protein-shaped problem at full n through those kernels:

* serving, ``IterativeGP(...).fit(x, y).predict(x_test)``, with its posterior
  mean held against a Cholesky oracle;
* training, ``IterativeGP(...).fit(x, y).optimize(...).predict(x_test)``, whose
  MLL gradients run through the Gram backward kernel, with the exact MLL from
  a float64 Cholesky before and after;
* preconditioned CG, ``IterativeGP(spec=CG(precond=P)).fit(x, y).predict``
  for P in Jacobi, Nyström, pivoted Cholesky and random features, against the
  same oracle; an ``RFFGram`` solve through the RFF kernel in both
  orientations; ``optimize`` on Nyström CG;
* the escalation ladder, ``solve_robust``, on the robust bench's happy,
  near-singular and NaN right-hand-side problems;
* the stochastic solvers, ``IterativeGP(spec=SGD | SDD | AP).fit(x, y)
  .predict(x_test)``, through the row-panel pair, the rows matvec and the
  feature pair kernels, each held against the same Cholesky oracle, and each
  run's first steps held against the plain route on the same draws;
* parallel Thompson sampling, ``thompson_step`` on SDD from 50,000 observed
  points in 8-D, whose Adam ascent takes every gradient through the RFF
  backward and the Gram backward kernels, held to the reference's launch
  identities, to the plain Functions' gradient in float64, and to acquiring
  batches better than the median observation;
* LM serving, ``repro_torch.launch.serve.generate`` on llama3-8b at full width
  and depth (random fp32 weights from a seed): prefill's causal attention
  through the flash-attention kernel, greedy decode, held against the plain
  attention route and against ``forward_train`` at one more position.

The training path's θ-gradients are held against the plain autograd Function
in float64 at a reduced n, and one Gram matvec runs at 3droad's n, where K could
not be held.

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
#: and TF32 on the tensor cores (dense), the SFU's 16 operations per clock
#: per SM, at the 1.98 GHz that the fp32 peak implies (132 SMs x 128 lanes x
#: 2 flops); the SFU operations per Gram entry of each kind: exp, sqrt for
#: the Matérn kinds, and the reciprocal of Matérn-5/2's division by 3
PEAK_TF32_FLOPS = 495e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
SFU_OPS = {"se": 1, "matern12": 2, "matern32": 2, "matern52": 3}
#: and per backward pair, k' = dk/d(d2): exp, sqrt for the Matérn kinds, and
#: the reciprocal of Matérn-1/2's division by 2r; per RFF (row, frequency)
#: pair, a sin and a cos (the port's full-range sincosf runs on the FMA
#: pipe: the floor is what one SFU operation each would cost)
SFU_OPS_BWD = {"se": 1, "matern12": 3, "matern32": 2, "matern52": 2}
SFU_OPS_RFF = 2

KINDS = ("se", "matern12", "matern32", "matern52")
#: the reference's own kernel tolerances (tests/test_kernels_pallas.py:23,57)
#: and its fused-VJP tolerance (tests/test_kernels_pallas.py:131-134)
GRAM_TOL, RFF_TOL, GRAD_TOL = 2e-4, 1e-4, 1e-4
SEED = 0
#: rows of a backward-kernel output checked against the float64 plain version
CHECK_ROWS = 4096
#: The training path: benchmarks/bench_mll.py:30-31's initial θ, steps, lr,
#: probes and CG spec, on protein at full n. The gradient check runs at a
#: reduced n, where the float64 plain Function is cheap.
TRAIN_HYPERS = dict(lengthscale=2.0, signal=0.5, noise=0.5)
TRAIN_STEPS, TRAIN_LR, TRAIN_PROBES, TRAIN_MAX_ITERS = 12, 0.08, 8, 600
GRAD_N = 8192
#: outer steps of the profiled training pass: the first, cold solve and two
#: warm ones, to keep the profiler's trace (and its processing) short
PROFILE_TRAIN_STEPS = 3
#: The main path's solver: the tolerance of benchmarks/bench_solvers.py:83,
#: with an iteration budget CG can reach it in at the full protein n. The
#: bench's own budget of 150 iterations was set on a quarter of pol, elevators
#: and bike; at n = 45,730 CG stops there well short of the tolerance, and the
#: oracle phase measures what that budget gives.
MAIN_TOL, MAIN_MAX_ITERS, BENCH_MAX_ITERS = 1e-3, 1000, 150


#: The stochastic solvers (benchmarks/bench_solvers.py's protein problem and
#: θ, the paper's defaults of core/solvers/spec.py, the bench's step budgets).
#: SDD runs at the bench's step 2/n (benchmarks/bench_solvers.py:86): at the
#: paper's 50/n it diverges on this problem within 100 steps, the reference's
#: solve_sdd as much as the port's; that run is kept as SDD_PAPER_STEP, where
#: the check is that every diverged column is flagged
STOCH_STEPS = {"sgd": 8000, "sdd": 8000, "ap": 2000}
STOCH_SPECS = {"sgd": dict(batch_size=512, num_features=100, step_size_times_n=0.5),
               "sdd": dict(batch_size=512, step_size_times_n=2.0),
               "ap": dict(block_size=512)}
SDD_PAPER_STEP = 50.0
#: steps of the route-parity runs, held at the reference's fused-vs-features
#: tolerance (tests/test_features.py:283), and of the profiled solver runs.
#: SGD's kernel route is held to the plain route in float64 on the same
#: draws instead: its excess over rtol at most PARITY_FP64_MARGIN × the plain
#: fp32 route's own (or PARITY_TOL, if larger), each the mean over
#: PARITY_SEEDS draw sequences (on the H100 one run's excess spreads
#: 1.7–4.4e-3 on the plain route alone as the targets' rounding moves: 200
#: clipped steps amplify it)
PARITY_STEPS, PARITY_TOL, PARITY_FP64_MARGIN, PARITY_SEEDS = 200, 2e-3, 1.5, 8
PROFILE_STOCH_STEPS = {"sgd": 500, "sdd": 500, "ap": 200}
#: Parallel Thompson sampling: benchmarks/bench_thompson.py:18-40's full run
#: (d = 8, Matérn-3/2, ℓ = 0.3, σ_f² = 1, σ² = 1e-3, the objective a prior
#: draw on 2,048 features, acquisition batch 100, 512 candidates, top 4, 20
#: ascent steps, 1,024 features, its SDD spec), from n0 = 50,000 uniform
#: points in place of the bench's 2,000, for 3 acquisition steps
THOMPSON = dict(d=8, kind="matern32", lengthscale=0.3, signal=1.0, noise=1e-3,
                n0=50_000, acq_batch=100, num_candidates=512, num_top=4,
                ascent_steps=20, num_features=1024, objective_features=2048, steps=3)
THOMPSON_SDD = dict(num_steps=3000, batch_size=128, step_size_times_n=2.0)
#: LM serving: llama3-8b (src/repro_torch/configs/llama3_8b.py) at full width
#: and depth, batch 4 × prompt 1,024 from the planted-bigram token batch, 16
#: greedy tokens; the flash kernel's cases of the kernels phase (label, b, s,
#: hq, hkv, d, causal): the path's shape, a ragged s causal and not, and the
#: reduced configs' d = 64
LM = dict(arch="llama3-8b", batch=4, prompt=1024, gen=16)
FLASH_CASES = (("lm_serve", 4, 1024, 32, 8, 128, True), ("ragged", 4, 1000, 32, 8, 128, True),
               ("ragged_full", 4, 1000, 32, 8, 128, False), ("d64", 4, 1024, 4, 2, 64, True))
#: the reference's flash tolerance (tests/test_kernels_pallas.py:72); the
#: kernel and plain routes' last-position logits; the reference's
#: prefill/decode-vs-forward tolerances (tests/test_models.py:114,118); a
#: greedy token is held to the plain route's where that route's top-2 margin
#: exceeds LM_MARGIN × the measured logit difference
FLASH_TOL, LM_LOGIT_TOL, CONSIST_RTOL, CONSIST_ATOL, LM_MARGIN = 2e-3, 1e-3, 5e-2, 5e-3, 10.0
#: decode steps of the profiled decode window
PROFILE_DECODE_STEPS = 8
#: The precond phase: the preconditioners' ranks (the specs' defaults), the
#: RFFGram operator's feature count (the serving path's prior)
PRECOND_RANK, RFF_RANK, RFFGRAM_FEATURES = 100, 256, 2048
#: preconditioners measured, not held to convergence: at the serving θ (σ² = 0.01,
#: ℓ = 1.5 in 9-D) the 128-frequency surrogate ΦΦᵀ + σ²I is a worse
#: preconditioner than none, in the reference as in the port
#: (tests/test_torch_precond.py::test_rff_precond_at_small_noise_slows_cg)
UNCONVERGED_PRECONDS = ("rff",)
#: The robust phase: benchmarks/bench_robust.py:31-33's happy-path problem
#: and spec, and the interleaved repetitions of its overhead timing
ROBUST = dict(n=512, d=3, s=16, spec=dict(max_iters=120, tol=1e-4), reps=20)
#: the kernels' records on the last lines, in order
RECORDS = ("gram_matvec", "gram_matvec_bwd", "rff_matvec", "gram_rows_pair",
           "rff_t_matvec", "rff_pair", "rff_bwd", "flash_attention")

_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per result, stamped with the seconds since the start."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram_matvec import (
        gram_matvec, gram_matvec_bwd, gram_rows_matvec, gram_rows_pair,
    )
    from repro_torch.kernels.rff_matvec import rff_bwd, rff_matvec, rff_pair, rff_t_matvec

    return dict(gram_matvec=gram_matvec, gram_matvec_bwd=gram_matvec_bwd,
                rff_matvec=rff_matvec, gram_rows_pair=gram_rows_pair,
                gram_rows_matvec=gram_rows_matvec, rff_t_matvec=rff_t_matvec,
                rff_pair=rff_pair, rff_bwd=rff_bwd, flash_attention=flash_attention)


def _reset_counts(torch) -> None:
    """Every launch and dispatch count to 0, just before a path runs."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_matvec_trace_counts()
    ops.reset_feature_trace_counts()
    ops.reset_attention_trace_counts()
    for w in _wrappers().values():
        w.launches = 0


def _read_counts() -> tuple:
    """(launches by wrapper, Gram dispatches, feature dispatches) since the
    last reset, read just after a path ran."""
    from repro_torch.kernels import ops

    return ({k: w.launches for k, w in _wrappers().items()},
            dict(ops.MATVEC_TRACE_COUNTS), dict(ops.FEATURE_TRACE_COUNTS))


def _path_launches(launches: dict) -> dict:
    """A path's launches by kernel record: the row-panel record counts both
    of its C entries (the pair and the rows matvec), and every feature-pair
    launch runs the RFF kernel's Φ̃ᵀu orientation (phase 1, under
    ``rff_t_matvec``) and its Φ̃W orientation (phase 2, under ``rff_matvec``)."""
    out = {k: launches[k] for k in RECORDS}
    out["gram_rows_pair"] += launches["gram_rows_matvec"]
    out["rff_t_matvec"] += launches["rff_pair"]
    out["rff_matvec"] += launches["rff_pair"]
    return out


def _record_path(kernels: dict, path: str, launches: dict) -> None:
    for k, n in _path_launches(launches).items():
        kernels[k]["by_path"].setdefault(path, {})["launches"] = n
    kernels["gram_rows_pair"]["by_path"][path]["launches_by_entry"] = dict(
        pair=launches["gram_rows_pair"], rows_matvec=launches["gram_rows_matvec"])
    for k in ("rff_t_matvec", "rff_matvec"):
        kernels[k]["by_path"][path]["launches_by_entry"] = dict(
            own=launches[k], inside_rff_pair=launches["rff_pair"])


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
    oracle = main_path_phase(torch, kernels)
    grad_phase(torch)
    trained = train_phase(torch, kernels)
    precond_phase(torch, kernels, oracle, trained)
    robust_phase(torch, kernels)
    stochastic_phase(torch, kernels, oracle)
    route_parity_phase(torch)
    thompson_phase(torch, kernels)
    lm_serve_phase(torch, kernels)
    profile_phase(torch)
    large_n_phase(torch)

    for rec in kernels.values():
        rec["launches"] = sum(line.get("launches", 0) for line in rec["by_path"].values())
        check(rec["launches"] > 0, f"{rec['name']} launched on the paths")
    print(smi)
    print(json.dumps({"kernels": [kernels[k] for k in RECORDS]}))
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
         objects=list(info.objects), kernels=list(info.ptxas))
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


def _bound_by(flops, nbytes) -> str:
    """Which of the two floors sets a kernel's bound."""
    return "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"


def _gram_bound_ms(n, m, d, s):
    flops = n * m * (2 * d + 2 * s)
    nbytes = 4 * (n * d + m * d + m * s + n * s)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def _gram_floors(entries, d, s, kind) -> dict:
    """The Gram kernel's own floors for ``entries`` kernel entries (n·m, or
    p·n per row-panel contraction): ``sfu_floor_ms``, the SFU operations of
    the covariance map at 16 per clock per SM, and ``tc_split_bound_ms``, the
    larger of stage 1's 2d flops per entry on the FMA pipe and the three-way
    TF32 split's 3 × 2·s_pad flops per entry on the tensor cores, s_pad the
    v width the launch pads to (gram_plan's slices × width). ``bound_ms``
    stays the all-fp32 bound (_gram_bound_ms), comparable across versions."""
    from repro_torch.kernels.gram_matvec import gram_plan

    plan = gram_plan(1, 1, d, s)
    s_pad = plan.slices * plan.width
    return dict(sfu_floor_ms=1e3 * entries * SFU_OPS[kind] / SFU_OPS_PER_S,
                tc_split_bound_ms=1e3 * max(entries * 2 * d / PEAK_FP32_FLOPS,
                                            entries * 6 * s_pad / PEAK_TF32_FLOPS),
                s_pad=s_pad)


def _bwd_floors(entries, d, s, kind, stage2="tc") -> dict:
    """The backward kernel's own floors for ``entries`` pairs (n·m):
    ``sfu_floor_ms``, k''s SFU operations at 16 per clock per SM, and
    ``tc_split_bound_ms``, the larger of the FMA pipe's share (2d flops an
    entry for the distance, and 2s for G where the slice is 16 columns or
    fewer, and 2(d + 1) for stage 2 on the FMA pipe) and the tensor cores'
    (the three-way split's 3 × 2 flops an entry per padded G column above
    that and per [z | 1] column of stage 2 there), as the plan runs it."""
    from repro_torch.kernels.gram_matvec import NARROW_G, gram_bwd_plan

    plan = gram_bwd_plan(1, 1, d, s, stage2)
    fma = entries * 2 * d
    tc = 0
    if plan.width > NARROW_G:
        tc += entries * 6 * plan.slices * plan.width
    else:
        fma += entries * 2 * s
    if stage2 == "tc":
        n2 = (d + 1 + 7) // 8
        tc += entries * 6 * 8 * (2 if n2 <= 2 else 5 if n2 <= 5 else 17)
    else:
        fma += entries * 2 * (d + 1)
    return dict(sfu_floor_ms=1e3 * entries * SFU_OPS_BWD[kind] / SFU_OPS_PER_S,
                tc_split_bound_ms=1e3 * max(fma / PEAK_FP32_FLOPS, tc / PEAK_TF32_FLOPS))


def _rff_floors(n, m, d, s, passes=1) -> dict:
    """The RFF kernel's own floors over ``passes`` orientations (2 for the
    pair): ``sfu_floor_ms``, a sin and a cos per (row, frequency) pair at 16
    SFU operations per clock per SM, and ``tc_split_bound_ms``, the larger of
    the projections' 2d flops a pair on the FMA pipe and the three-way
    split's 3 × 2 × 2·s_pad flops a pair on the tensor cores, over the
    frequencies and width rff_plan runs (m in groups of 8, s in slices)."""
    from repro_torch.kernels.rff_matvec import rff_plan

    plan = rff_plan(n, m, d, s)
    pairs = passes * n * plan.padded_freqs
    return dict(sfu_floor_ms=1e3 * passes * n * m * SFU_OPS_RFF / SFU_OPS_PER_S,
                tc_split_bound_ms=1e3 * max(pairs * 2 * d / PEAK_FP32_FLOPS,
                                            pairs * 12 * plan.slices * plan.width
                                            / PEAK_TF32_FLOPS))


def _gram_bwd_bound_ms(n, m, d, s):
    """2d flops for the distance, 2s for rowv·colv and 2d for W z per pair;
    x, z, rowv and colv read once, dx written once."""
    flops = n * m * (4 * d + 2 * s)
    nbytes = 4 * (n * d + m * d + n * s + m * s + n * d)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def _rff_bound_ms(n, m, d, s):
    flops = n * m * (2 * d + 4 * s)
    nbytes = 4 * (n * d + m * d + 2 * m * s + n * s)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def kernels_phase(torch) -> dict:
    """Each kernel against its plain version, on the card, at the shapes both
    paths give it, the instances they run among them. The kernel is compared with the plain version run in float64 on
    the same fp32 inputs: the fp32 plain version rounds d² on the diagonal of
    K(x, x) to a few ulp instead of 0, which Matérn-1/2 turns into ~1e-3, an
    error of the yardstick and not of the kernel (its distance to the fp32 plain
    version is printed too). Times: kernel over 20 warm launches, plain over 3
    calls, both by CUDA events. The record of each kernel carries its line at
    the training path's shape (the path whose launches it counts), and its
    line on each path under ``by_path``."""
    from repro_torch.core.kernels_fn import make_params, spectral_sample
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_bwd, gram_plan
    from repro_torch.kernels.ref import gram_matvec_ref, rff_matvec_ref
    from repro_torch.kernels.rff_matvec import rff_matvec, rff_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    ls = math.sqrt(d) * 0.5  # the main path's lengthscale
    x = torch.as_tensor(data["x"], device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    xs, xts = (x / ls).contiguous(), (xt / ls).contiguous()
    # the training path's inputs at θ₀'s lengthscale
    tls = TRAIN_HYPERS["lengthscale"]
    xtr, xttr = (x / tls).contiguous(), (xt / tls).contiguous()
    rec = {
        "gram_matvec": dict(name="gram_matvec", route="cuda",
                            source="src/repro_torch/kernels/csrc/gram_matvec.cu",
                            replaces="src/repro/kernels/gram_matvec.py:154",
                            max_abs_err=0.0),
        "gram_matvec_bwd": dict(name="gram_matvec_bwd", route="cuda",
                                source="src/repro_torch/kernels/csrc/gram_matvec_bwd.cu",
                                replaces="src/repro/kernels/gram_matvec.py:250",
                                max_abs_err=0.0),
        "rff_matvec": dict(name="rff_matvec", route="cuda",
                           source="src/repro_torch/kernels/csrc/rff_matvec.cu",
                           replaces="src/repro/kernels/rff_matvec.py:78",
                           max_abs_err=0.0),
        # the pair (SGD) and its phases 0-1 alone, the rows matvec (SDD): the
        # row-panel source's entry and the Gram entry on the same plan
        "gram_rows_pair": dict(name="gram_rows_pair", route="cuda",
                               source="src/repro_torch/kernels/csrc/gram_rows_pair.cu",
                               replaces="src/repro/kernels/gram_matvec.py:390",
                               entries=["repro_gram_rows_pair_f32",
                                        "repro_gram_matvec_f32"],
                               max_abs_err=0.0),
        "rff_t_matvec": dict(name="rff_t_matvec", route="cuda",
                             source="src/repro_torch/kernels/csrc/rff_matvec.cu",
                             replaces="src/repro/kernels/rff_matvec.py:154",
                             max_abs_err=0.0),
        "rff_pair": dict(name="rff_pair", route="cuda",
                         source="src/repro_torch/kernels/csrc/rff_matvec.cu",
                         replaces="src/repro/kernels/rff_matvec.py:447",
                         max_abs_err=0.0),
        "rff_bwd": dict(name="rff_bwd", route="cuda",
                        source="src/repro_torch/kernels/csrc/rff_bwd.cu",
                        replaces="src/repro/kernels/rff_matvec.py:252",
                        max_abs_err=0.0),
        "flash_attention": dict(name="flash_attention", route="cuda",
                                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                                replaces="src/repro/kernels/flash_attention.py:72",
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
        plan = gram_plan(n, m, d, s)
        line = dict(kernel="gram_matvec", case=label, kind=kind, n=n, m=m, d=d, s=s,
                    ctas=plan.ctas, chunks=plan.chunks, rows_per_cta=plan.rows_per_cta,
                    max_abs_err=err, tol=GRAM_TOL * scale,
                    err_vs_fp32_plain=(out - ref32).abs().max().item(),
                    smem_bytes=gram_matvec.smem_bytes(d, s, plan.rows_per_cta),
                    ms=_events_ms(torch, lambda: gram_matvec(rows, cols, v, kind=kind), 20),
                    plain_ms=_events_ms(torch, lambda: gram_matvec_ref(rows, cols, v, kind=kind), 3),
                    bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops,
                    bytes=nbytes, **_gram_floors(n * m, d, s, kind))
        emit("kernels", **line)
        check(err <= GRAM_TOL * scale, f"gram_matvec {label} {kind} s={s}: {err}")
        rec["gram_matvec"]["max_abs_err"] = max(rec["gram_matvec"]["max_abs_err"], err)
        return line

    paths = {"fit_predict": {}, "train": {}}  # each path's line of each kernel
    for kind in KINDS:
        for s in (1, 17, 65):
            line = gram_case(kind, xs, xs, s, "square")
            if kind == "matern32" and s == 65:  # CG's call on the serving path
                paths["fit_predict"]["gram_matvec"] = line
        for s in (1, 64):  # the posterior mean and the samples at X*
            gram_case(kind, xts, xs, s, "cross")
        # CG's call on the training path: y and the probes, 9 columns
        line = gram_case(kind, xtr, xtr, 1 + TRAIN_PROBES, "square_train")
        if kind == "matern32":
            paths["train"]["gram_matvec"] = line

    def bwd_case(kind, rows, cols, s, label, variants=False):
        # the first CHECK_ROWS rows against the plain version in float64; in
        # the square case they hold their own diagonal entries, where the
        # plain version's d² (from differences) is exactly 0 like the kernel's
        rowv = torch.randn((rows.shape[0], s), generator=gen, device=dev)
        colv = torch.randn((cols.shape[0], s), generator=gen, device=dev)
        line = _bwd_line(torch, rec, rows, cols, rowv, colv, kind, label, variants)
        line.update(smem_bytes=gram_matvec_bwd.smem_bytes(d, s))
        return line

    for kind in KINDS:  # the training path's shapes (the Thompson path's below)
        for s in (1, 8):  # the fit and the trace terms of the MLL gradient
            line = bwd_case(kind, xtr, xtr, s, "square",
                            variants=kind == "matern32" and s == 8)
            if kind == "matern32" and s == 8:  # the trace term on the training path
                paths["train"]["gram_matvec_bwd"] = line
            bwd_case(kind, xttr, xtr, s, "cross")  # ∂x* at the test points

    def rff_omega(lengthscale, m):
        params = make_params("matern32", lengthscale=lengthscale, d=d, device=dev)
        return spectral_sample(params, m, d, generator=gen)

    serve_omega = rff_omega(ls, 1024)  # 2,048 features
    # the training path's prior f_X: mll_grad's 1,024 features at θ₀, 8 probes
    train_omega = rff_omega(tls, 512)
    for rows, omega, label, widths in ((x, serve_omega, "train", (16, 64)),
                                       (xt, serve_omega, "test", (16, 64)),
                                       (x, train_omega, "mll_prior", (TRAIN_PROBES,))):
        for s in widths:
            w = torch.randn((2 * omega.shape[0], s), generator=gen, device=dev)
            out = rff_matvec(rows, omega, w)
            ref64 = rff_matvec_ref(rows.double(), omega.double(), w.double())
            ref32 = rff_matvec_ref(rows, omega, w)
            torch.cuda.synchronize()
            err = (out.double() - ref64).abs().max().item()
            scale = max(1.0, ref64.abs().max().item())
            n, m = rows.shape[0], omega.shape[0]
            bound, flops, nbytes = _rff_bound_ms(n, m, d, s)
            plan = rff_plan(n, m, d, s)
            line = dict(kernel="rff_matvec", case=label, n=n, m=m, d=d, s=s,
                        ctas=plan.mv_ctas, chunks=plan.freq_chunks,
                        **_rff_floors(n, m, d, s), max_abs_err=err, tol=RFF_TOL * scale,
                        err_vs_fp32_plain=(out - ref32).abs().max().item(),
                        smem_bytes=rff_matvec.smem_bytes(d, s),
                        ms=_events_ms(torch, lambda: rff_matvec(rows, omega, w), 20),
                        plain_ms=_events_ms(torch, lambda: rff_matvec_ref(rows, omega, w), 3),
                        bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops,
                        bytes=nbytes)
            emit("kernels", **line)
            check(err <= RFF_TOL * scale, f"rff_matvec {label} s={s}: {err}")
            rec["rff_matvec"]["max_abs_err"] = max(rec["rff_matvec"]["max_abs_err"], err)
            if label == "train" and s == 64:  # f_X on the serving path
                paths["fit_predict"]["rff_matvec"] = line
            if label == "mll_prior":  # f_X on the training path
                paths["train"]["rff_matvec"] = line

    paths.update(sgd={}, sdd={}, ap={}, thompson={}, lm_serve={})
    new_kernels_cases(torch, x, xs, rff_omega, gen, rec, paths)
    rff_bwd_cases(torch, x, rff_omega, gen, rec)
    thompson_kernel_cases(torch, gen, rec, paths)
    flash_cases(torch, gen, rec, paths)

    keep = ("s", "m", "p", "rows", "cols", "ctas", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "sfu_floor_ms", "tc_split_bound_ms")
    # each record's own numbers: the training path's shape for the kernels of
    # the first slices, SGD's for the row-panel and feature-pair kernels, the
    # Thompson ascent's for the RFF backward, LM serving's for flash attention.
    # Only attention has one PyTorch call for the same function (SDPA); the
    # GP kernels' fused functions have none.
    home = dict(gram_matvec="train", gram_matvec_bwd="train", rff_matvec="train",
                gram_rows_pair="sgd", rff_t_matvec="sgd", rff_pair="sgd",
                rff_bwd="thompson", flash_attention="lm_serve")
    for key in rec:
        line = paths[home[key]][key]
        rec[key].update({k: line[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        library_ms=line.get("library_ms"),
                        **{k: line[k] for k in ("sfu_floor_ms", "tc_split_bound_ms") if k in line},
                        by_path={p: {k: lines[key][k] for k in keep if k in lines[key]}
                                 for p, lines in paths.items() if key in lines})
    # the rows matvec (SDD's entry of the row-panel source) under its record
    for path in ("sdd", "thompson"):
        rec["gram_rows_pair"]["by_path"][path] = {
            k: paths[path]["gram_rows_matvec"][k] for k in keep
            if k in paths[path]["gram_rows_matvec"]}
    return rec


def _bwd_line(torch, rec, rows, cols, rowv, colv, kind, label, variants) -> dict:
    """One Gram backward launch against its plain version in float64 on the
    first CHECK_ROWS output rows, timed (CUDA events, 20 launches) beside the
    fp32 plain version; with ``variants``, both stage-2 variants are checked
    and timed (``stage2_ms``), the plan's own giving ``ms``."""
    from repro_torch.kernels.gram_matvec import BWD_STAGE2, gram_bwd_plan, gram_matvec_bwd
    from repro_torch.kernels.ref import gram_matvec_bwd_ref

    (n, d), m, s = rows.shape, cols.shape[0], rowv.shape[1]
    k = min(n, CHECK_ROWS)
    ref64 = gram_matvec_bwd_ref(rows[:k].double(), cols.double(), rowv[:k].double(),
                                colv.double(), kind=kind, row_chunk=256)
    scale = max(1.0, ref64.abs().max().item())
    plan = gram_bwd_plan(n, m, d, s)
    errs, stage2_ms = {}, {}
    for stage2 in (BWD_STAGE2 if variants else (plan.stage2,)):
        out = gram_matvec_bwd._launch(rows, cols, rowv, colv, kind, stage2)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"gram_matvec_bwd {label} {kind} s={s}: finite")
        errs[stage2] = (out[:k].double() - ref64).abs().max().item()
        stage2_ms[stage2] = _events_ms(torch, lambda: gram_matvec_bwd._launch(
            rows, cols, rowv, colv, kind, stage2), 20)
    err = max(errs.values())
    bound, flops, nbytes = _gram_bwd_bound_ms(n, m, d, s)
    line = dict(kernel="gram_matvec_bwd", case=label, kind=kind, n=n, m=m, d=d, s=s,
                ctas=plan.ctas, chunks=plan.chunks, stage2=plan.stage2, checked_rows=k,
                max_abs_err=err, tol=GRAD_TOL * scale, ms=stage2_ms[plan.stage2],
                plain_ms=_events_ms(torch, lambda: gram_matvec_bwd_ref(
                    rows, cols, rowv, colv, kind=kind), 3),
                bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops,
                bytes=nbytes, **_bwd_floors(n * m, d, s, kind, plan.stage2))
    if variants:
        line.update(stage2_ms=stage2_ms, stage2_err=errs,
                    stage2_tc_split_bound_ms={v: _bwd_floors(n * m, d, s, kind, v)[
                        "tc_split_bound_ms"] for v in BWD_STAGE2})
    emit("kernels", **line)
    check(err <= GRAD_TOL * scale, f"gram_matvec_bwd {label} {kind} s={s}: {errs}")
    rec["gram_matvec_bwd"]["max_abs_err"] = max(rec["gram_matvec_bwd"]["max_abs_err"], err)
    return line


def _rows_bound_ms(p, n, d, s, chunks, pair: bool):
    """The row panel: p·n·(2d + 2s) flops per contraction, two for the pair;
    bytes of xi, x, look (and b) read once, the (chunks, p, s) workspace
    written and read, err written (and, for the pair, x, xi and err read
    again by phase 2 and g written)."""
    flops = (2 if pair else 1) * p * n * (2 * d + 2 * s)
    floats = p * d + n * d + n * s + 2 * chunks * p * s + p * s
    if pair:
        floats += p * s + n * d + p * d + p * s + n * s
    return 1e3 * max(flops / PEAK_FP32_FLOPS, 4 * floats / PEAK_BYTES), flops, 4 * floats


def _rff_t_bound_ms(n, m, d, s, chunks, pair: bool):
    """Φᵀu: n·m·(2d + 4s) flops, twice for the pair; x, ω and u read once,
    the (chunks, 2m, s) workspace written and read, t (2m, s) written (the
    pair also reads x, ω and t again and writes its (n, s) output)."""
    flops = (2 if pair else 1) * n * m * (2 * d + 4 * s)
    floats = n * d + m * d + n * s + 2 * chunks * 2 * m * s + 2 * m * s
    if pair:
        floats += n * d + m * d + 2 * m * s + n * s
    return 1e3 * max(flops / PEAK_FP32_FLOPS, 4 * floats / PEAK_BYTES), flops, 4 * floats


def new_kernels_cases(torch, x, xs, rff_omega, gen, rec, paths) -> None:
    """The kernels of the stochastic solvers against their plain versions in
    float64 on the card, at the solvers' shapes: the row panel at p = 256 and
    512 with p_true = p − 7 for every kind (SGD's pair, SDD's rows matvec),
    Φᵀu at m = 100 and 1,024, and the feature pair at m = 100 and at a
    padded m = 128 with m_true = 100, all at s = 65; each RFF case twice, its
    two results equal bit for bit."""
    from repro_torch.kernels.gram_matvec import gram_plan, gram_rows_matvec, gram_rows_pair
    from repro_torch.kernels.ref import (
        gram_rows_matvec_ref, gram_rows_pair_ref, rff_pair_ref, rff_t_matvec_ref,
    )
    from repro_torch.kernels.rff_matvec import rff_matvec, rff_pair, rff_plan, rff_t_matvec

    dev = x.device
    n, d = xs.shape
    s = 65

    def err_of(out, ref64):
        return ((out.double() - ref64).abs().max().item(),
                max(1.0, ref64.abs().max().item()))

    for kind in KINDS:
        for p in (256, 512):
            idx = torch.randint(0, n, (p,), generator=gen, device=dev)
            xi = xs[idx].contiguous()
            look = torch.randn((n, s), generator=gen, device=dev)
            b = torch.randn((p, s), generator=gen, device=dev)
            p_true = p - 7
            panel = gram_plan(p, n, d, s)
            chunks = panel.chunks
            err, g = gram_rows_pair(xi, xs, look, b, kind=kind, p_true=p_true)
            mv = gram_rows_matvec(xi, xs, look, kind=kind)
            re, rg = gram_rows_pair_ref(xi.double(), xs.double(), look.double(), b.double(),
                                        kind=kind, p_true=p_true)
            rmv = gram_rows_matvec_ref(xi.double(), xs.double(), look.double(), kind=kind)
            torch.cuda.synchronize()
            masked = bool((err[p_true:] == 0).all())
            cases = (
                ("gram_rows_pair", True, (err_of(err, re), err_of(g, rg)),
                 lambda: gram_rows_pair(xi, xs, look, b, kind=kind, p_true=p_true),
                 lambda: gram_rows_pair_ref(xi, xs, look, b, kind=kind, p_true=p_true)),
                ("gram_rows_matvec", False, (err_of(mv, rmv),),
                 lambda: gram_rows_matvec(xi, xs, look, kind=kind),
                 lambda: gram_rows_matvec_ref(xi, xs, look, kind=kind)),
            )
            for name, pair, errs, fn, plain in cases:
                # each output against its own scale: err and g for the pair
                e = max(a for a, _ in errs)
                ok = all(a <= GRAM_TOL * scale for a, scale in errs)
                bound, flops, nbytes = _rows_bound_ms(p, n, d, s, chunks, pair)
                line = dict(kernel=name, kind=kind, n=n, p=p, p_true=p_true, d=d, s=s,
                            chunks=chunks, ctas_phase0=panel.ctas,
                            ctas_phase2=gram_plan(n, p, d, s).ctas if pair else None,
                            **_gram_floors((2 if pair else 1) * p * n, d, s, kind),
                            max_abs_err=e, tol=[GRAM_TOL * scale for _, scale in errs],
                            err_masked_rows_zero=masked,
                            ms=_events_ms(torch, fn, 20), plain_ms=_events_ms(torch, plain, 3),
                            bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops,
                            bytes=nbytes)
                emit("kernels", **line)
                check(ok, f"{name} {kind} p={p}: {e}")
                check(masked, f"{name} {kind} p={p}: rows >= p_true zeroed")
                rec["gram_rows_pair"]["max_abs_err"] = max(rec["gram_rows_pair"]["max_abs_err"], e)
                if kind == "matern32" and p == 512:
                    paths["sgd" if pair else "sdd"][
                        "gram_rows_pair" if pair else "gram_rows_matvec"] = line
            if p == 512:
                check(-(-p // 64) * chunks >= 132,
                      f"the row panel at p = 512 fills the card: {-(-p // 64) * chunks} CTAs")

    u = torch.randn((n, s), generator=gen, device=dev)
    for m, m_true, what in ((100, 100, "t"), (1024, 1024, "t"), (100, 100, "pair"),
                            (128, 100, "pair")):
        omega = rff_omega(math.sqrt(d) * 0.5, m)
        omega[m_true:] = 0.0  # padded frequencies, masked by m_true
        plan = rff_plan(n, m, d, s)
        chunks = plan.row_chunks
        pair = what == "pair"
        kernel, ref = (rff_pair, rff_pair_ref) if pair else (rff_t_matvec, rff_t_matvec_ref)
        out = kernel(x, omega, u, m_true=m_true)
        ref64 = ref(x.double(), omega.double(), u.double(), m_true=m_true)
        torch.cuda.synchronize()
        check(torch.equal(out, kernel(x, omega, u, m_true=m_true)),
              f"{what} m={m}: the same bits on two runs")
        e, sc = err_of(out, ref64)
        bound, flops, nbytes = _rff_t_bound_ms(n, m, d, s, chunks, pair)
        name = "rff_pair" if pair else "rff_t_matvec"
        line = dict(kernel=name, n=n, m=m, m_true=m_true, d=d, s=s, chunks=chunks,
                    ctas=plan.t_ctas, ctas_phase2=plan.mv_ctas if pair else None,
                    padded_freqs=plan.padded_freqs, **_rff_floors(n, m, d, s, 2 if pair else 1),
                    max_abs_err=e, tol=RFF_TOL * sc,
                    smem_bytes=rff_matvec.smem_bytes(d, s),
                    ms=_events_ms(torch, lambda: kernel(x, omega, u, m_true=m_true), 20),
                    plain_ms=_events_ms(torch, lambda: ref(x, omega, u, m_true=m_true), 3),
                    bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops,
                    bytes=nbytes)
        emit("kernels", **line)
        check(e <= RFF_TOL * sc, f"{name} m={m} m_true={m_true}: {e}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], e)
        if m == 100:  # SGD's fresh features: its pair and the pair's phase 1
            paths["sgd"][name] = line


def _rff_bwd_bound_ms(rows, cols, d, s, ws_floats, operands):
    """rows·cols·(4d + 4s) flops (2d for the projection, 2s for each factor
    product, 2d for W C; the sincos uncounted, as in the other RFF bounds);
    each distinct operand read once, dR written once, the workspace written
    and read."""
    flops = rows * cols * (4 * d + 4 * s)
    floats = sum(t.numel() for t in {id(t): t for t in operands}.values())
    floats += rows * d + 2 * ws_floats
    return 1e3 * max(flops / PEAK_FP32_FLOPS, 4 * floats / PEAK_BYTES), flops, 4 * floats


def _rff_bwd_floors(plan, cols, d) -> dict:
    """The RFF backward's own floors over the pairs its plan computes (row
    blocks of 64 × column tiles of 64, once per slice): ``sfu_floor_ms``, a
    sin and a cos a pair at 16 SFU operations per clock per SM, and
    ``tc_split_bound_ms``, the larger of the FMA pipe's share (2d flops a pair
    for the projection, and 4·width for the factor products where those run
    there) and the tensor cores' (the three-way split's 3 × 2 flops a product
    per padded factor column of the two products where those run there, and
    per C column of W C's n-tiles)."""
    pairs = 64 * plan.row_blocks * 64 * -(-cols // 64) * plan.slices
    kp = plan.width  # a multiple of 8: the padded k-steps of a slice
    fma, tc = pairs * 2 * d, 0
    if plan.products == "tc":
        tc += pairs * 3 * 2 * 2 * kp
    else:
        fma += pairs * 2 * 2 * kp
    tc += pairs * 3 * 2 * 8 * (2 if d <= 16 else 16)
    return dict(sfu_floor_ms=1e3 * pairs * SFU_OPS_RFF / SFU_OPS_PER_S,
                tc_split_bound_ms=1e3 * max(fma / PEAK_FP32_FLOPS, tc / PEAK_TF32_FLOPS))


def _rff_bwd_case(torch, rec, label, r, c, p1, p2, q1, q2, scale, check_rows=CHECK_ROWS):
    """One RFF backward call against its plain version in float64 (on the
    first ``check_rows`` output rows), timed beside the fp32 plain version;
    both variants of its factor products (``variant_ms``, the plan's own
    giving ``ms``) checked and timed, by CUDA events over 20 calls."""
    from repro_torch.kernels.ref import rff_bwd_ref
    from repro_torch.kernels.rff_matvec import rff_bwd, rff_bwd_plan

    (rows, d), cols, s = r.shape, c.shape[0], p1.shape[1]
    plan = rff_bwd_plan(rows, cols, d, s)
    k = min(rows, check_rows)
    ref64 = rff_bwd_ref(r[:k].double(), c.double(), p1[:k].double(), p2[:k].double(),
                        q1.double(), q2.double(), scale=scale)
    tol = GRAD_TOL * max(1.0, ref64.abs().max().item())
    before = rff_bwd.launches
    out = rff_bwd(r, c, p1, p2, q1, q2, scale=scale)
    launches = rff_bwd.launches - before
    torch.cuda.synchronize()
    err = (out[:k].double() - ref64).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    variants, errs = {}, {}
    for prod in ("tc", "fma"):
        vout = rff_bwd._launch(r, c, p1, p2, q1, q2, scale, prod)
        torch.cuda.synchronize()
        errs[prod] = (vout[:k].double() - ref64).abs().max().item()
        finite = finite and bool(torch.isfinite(vout).all())
        variants[prod] = _events_ms(torch, lambda: rff_bwd._launch(
            r, c, p1, p2, q1, q2, scale, prod), 20)
    del ref64
    ws = plan.workspace_floats(rows, d)
    bound, flops, nbytes = _rff_bwd_bound_ms(rows, cols, d, s, ws, (r, c, p1, p2, q1, q2))
    line = dict(kernel="rff_bwd", case=label, rows=rows, cols=cols, d=d, s=s,
                launches_per_call=launches, chunks=plan.chunks, slices=plan.slices,
                width=plan.width, ctas=plan.ctas, products=plan.products,
                checked_rows=k, max_abs_err=err, tol=tol, variant_err=errs, finite=finite,
                smem_bytes=rff_bwd.smem_bytes(d, s),
                ms=_events_ms(torch, lambda: rff_bwd(r, c, p1, p2, q1, q2, scale=scale), 20),
                variant_ms=variants,
                plain_ms=_events_ms(torch, lambda: rff_bwd_ref(r, c, p1, p2, q1, q2,
                                                               scale=scale), 3),
                bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops, bytes=nbytes,
                **_rff_bwd_floors(plan, cols, d))
    emit("kernels", **line)
    check(finite, f"rff_bwd {label}: finite")
    check(launches == 1, f"rff_bwd {label}: one launch a call, got {launches}")
    check(max(err, *errs.values()) <= tol, f"rff_bwd {label}: {err}, {errs} > {tol}")
    rec["rff_bwd"]["max_abs_err"] = max(rec["rff_bwd"]["max_abs_err"], err, *errs.values())
    return line


def rff_bwd_cases(torch, x, rff_omega, gen, rec) -> None:
    """The RFF backward kernel against its plain version in float64 on the
    card, in both orientations, at protein's forward-VJP shape (n = 45,730
    points, m = 1,024 frequencies, s = 65) and at the SGD pair VJP's (m = 100,
    2s = 130, in two slices); then the three RFF autograd Functions' ∂x, ∂ω
    and ∂w/∂u through the kernels against the plain Functions in float64, at
    SGD's m = 100 and s = 65 with a padded Ω (m_true = 93) for the transpose
    and the pair."""
    from repro_torch.kernels.rff_matvec import (
        plain_rff_matvec, plain_rff_pair, plain_rff_t_matvec, rff_matvec, rff_pair,
        rff_t_matvec,
    )

    dev = x.device
    n, d = x.shape
    ls = math.sqrt(d) * 0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    omega = rff_omega(ls, 1024)
    g, w_sin, w_cos = randn(n, 65), randn(1024, 65), randn(1024, 65)
    sc = math.sqrt(1.0 / 1024)
    _rff_bwd_case(torch, rec, "dx_forward_vjp", x, omega, g, g, w_sin, w_cos, sc)
    _rff_bwd_case(torch, rec, "domega_forward_vjp", omega, x, w_sin, w_cos, g, g, sc)
    omega = rff_omega(ls, 100)
    pp, q1, q2 = randn(n, 130), randn(100, 130), randn(100, 130)
    sc = math.sqrt(1.0 / 100)
    _rff_bwd_case(torch, rec, "dx_pair_vjp", x, omega, pp, pp, q1, q2, sc)
    _rff_bwd_case(torch, rec, "domega_pair_vjp", omega, x, q1, q2, pp, pp, sc)

    omega[93:] = 0.0  # padded frequencies for the transpose and the pair
    w, u = randn(200, 65), randn(n, 65)
    cases = (("rff_matvec", rff_matvec, plain_rff_matvec, w, (n, 65), {}),
             ("rff_t_matvec", rff_t_matvec, plain_rff_t_matvec, u, (200, 65), {"m_true": 93}),
             ("rff_pair", rff_pair, plain_rff_pair, u, (n, 65), {"m_true": 93}))
    for name, kernel, plain, operand, gshape, kw in cases:
        gbar = randn(*gshape)
        grads = []
        for fn, dt in ((kernel, torch.float32), (plain, torch.float64)):
            ins = [t.to(dt).detach().requires_grad_() for t in (x, omega, operand)]
            out = torch.sum(gbar.to(dt) * fn(*ins, **kw))
            grads.append(torch.autograd.grad(out, ins))
        errs = {}
        for key, a, b in zip(("dx", "domega", "doperand"), *grads):
            errs[key] = ((a.double() - b).abs().max().item(),
                         GRAD_TOL * max(1.0, b.abs().max().item()))
        emit("rff_grads", function=name, n=n, m=100, m_true=kw.get("m_true", 100), d=d, s=65,
             errors={k: dict(max_abs_err=e, tol=t) for k, (e, t) in errs.items()})
        for key, (e, t) in errs.items():
            check(e <= t, f"{name} {key} through the kernels: {e} > {t}")


def thompson_kernel_cases(torch, gen, rec, paths) -> None:
    """The kernels of the Thompson path at its shapes, against their plain
    versions in float64: the ascent's Gram forward and backward at the
    num_top·acq_batch = 400 query rows against n0 = 50,000 observations
    (s = 100; the forward on gram_plan's column chunks, the backward on
    gram_bwd_plan's, both of its stage-2 variants timed), the prior's RFF
    matvec (rff_plan's frequency chunks) and backward at 400 rows and
    m = 512, and SDD's rows matvec at p = 128, s = 101."""
    from repro_torch.core.kernels_fn import make_params, spectral_sample
    from repro_torch.kernels.gram_matvec import gram_matvec, gram_plan, gram_rows_matvec
    from repro_torch.kernels.ref import gram_matvec_ref, gram_rows_matvec_ref, rff_matvec_ref
    from repro_torch.kernels.rff_matvec import rff_matvec, rff_plan

    cfg, dev = THOMPSON, torch.device("cuda")
    d, kind, ls, s = cfg["d"], cfg["kind"], cfg["lengthscale"], cfg["acq_batch"]
    rows, n, m = cfg["num_top"] * s, cfg["n0"], cfg["num_features"] // 2
    xs = (torch.rand((n, d), generator=gen, device=dev) / ls).contiguous()
    xq = torch.rand((rows, d), generator=gen, device=dev)
    xqs = (xq / ls).contiguous()
    v = torch.randn((n, s), generator=gen, device=dev)
    g = torch.randn((rows, s), generator=gen, device=dev)

    def case(name, out, ref64, fn, plain, bound, ctas, **fields):
        torch.cuda.synchronize()
        err = (out.double() - ref64).abs().max().item()
        tol = (GRAD_TOL if "bwd" in name else GRAM_TOL) * max(1.0, ref64.abs().max().item())
        b, flops, nbytes = bound
        line = dict(kernel=name, case="thompson", ctas=ctas, max_abs_err=err, tol=tol,
                    ms=_events_ms(torch, fn, 20), plain_ms=_events_ms(torch, plain, 3),
                    bound_ms=b, bound_by=_bound_by(flops, nbytes), flops=flops,
                    bytes=nbytes, **fields)
        emit("kernels", **line)
        check(err <= tol, f"{name} at the Thompson shape: {err} > {tol}")
        key = "gram_rows_pair" if name == "gram_rows_matvec" else name
        rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], err)
        paths["thompson"][name] = line

    case("gram_matvec", gram_matvec(xqs, xs, v, kind=kind),
         gram_matvec_ref(xqs.double(), xs.double(), v.double(), kind=kind),
         lambda: gram_matvec(xqs, xs, v, kind=kind),
         lambda: gram_matvec_ref(xqs, xs, v, kind=kind), _gram_bound_ms(rows, n, d, s),
         gram_plan(rows, n, d, s).ctas, n=rows, m=n, d=d, s=s,
         chunks=gram_plan(rows, n, d, s).chunks, **_gram_floors(rows * n, d, s, kind))
    line = _bwd_line(torch, rec, xqs, xs, g, v, kind, "thompson", variants=True)
    check(line["ctas"] >= 264, f"the backward at 400 rows fills the card: {line['ctas']} CTAs")
    paths["thompson"]["gram_matvec_bwd"] = line
    params = make_params(kind, lengthscale=ls, d=d, device=dev)
    omega = spectral_sample(params, m, d, generator=gen)
    w = torch.randn((2 * m, s), generator=gen, device=dev)
    rplan = rff_plan(rows, m, d, s)
    case("rff_matvec", rff_matvec(xq, omega, w),
         rff_matvec_ref(xq.double(), omega.double(), w.double()),
         lambda: rff_matvec(xq, omega, w), lambda: rff_matvec_ref(xq, omega, w),
         _rff_bound_ms(rows, m, d, s), rplan.mv_ctas, n=rows, m=m, d=d, s=s,
         chunks=rplan.freq_chunks, **_rff_floors(rows, m, d, s))
    p, sr = THOMPSON_SDD["batch_size"], s + 1
    xi = xs[torch.randint(0, n, (p,), generator=gen, device=dev)].contiguous()
    u = torch.randn((n, sr), generator=gen, device=dev)
    panel = gram_plan(p, n, d, sr)
    chunks = panel.chunks
    case("gram_rows_matvec", gram_rows_matvec(xi, xs, u, kind=kind),
         gram_rows_matvec_ref(xi.double(), xs.double(), u.double(), kind=kind),
         lambda: gram_rows_matvec(xi, xs, u, kind=kind),
         lambda: gram_rows_matvec_ref(xi, xs, u, kind=kind),
         _rows_bound_ms(p, n, d, sr, chunks, False), panel.ctas,
         p=p, n=n, d=d, s=sr, chunks=chunks, **_gram_floors(p * n, d, sr, kind))
    paths["thompson"]["rff_bwd"] = _rff_bwd_case(
        torch, rec, "thompson_dx", xq, omega, g, g, w[:m].contiguous(), w[m:].contiguous(),
        math.sqrt(1.0 / m))


def _flash_bound_ms(b, s, hq, hkv, d, causal):
    """2d flops for q·k and 2d for p·v per visible (query, key) pair, of which
    there are b·hq·s(s + 1)/2 when causal and b·hq·s² otherwise; q and the
    output at hq heads, k and v at hkv heads, each read or written once."""
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    flops = 4 * d * pairs
    nbytes = 4 * 2 * b * s * d * (hq + hkv)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def _flash_floors(b, s, hq, d, causal) -> dict:
    """The flash kernel's own floors over the (row, key) pairs it computes:
    64 × 64 a visited key tile (causal: tiles 0 to the CTA's own), an exp a
    pair on the SFU (``sfu_floor_ms``), and 2 × 2d flops a pair in the
    three-way TF32 split, 3 × that, at 495 TFLOP/s (``tc_split_bound_ms``),
    where a diagonal tile's warp skips the n-tiles past its rows (2,560 of
    its 4,096 pairs computed)."""
    from repro_torch.kernels.flash_attention import BLOCK

    nq = -(-s // BLOCK)
    tiles = nq * (nq + 1) // 2 if causal else nq * nq
    pairs = b * hq * tiles * BLOCK ** 2
    mma_pairs = pairs - (b * hq * nq * (BLOCK ** 2 - 2560) if causal else 0)
    return dict(sfu_floor_ms=1e3 * pairs / SFU_OPS_PER_S,
                tc_split_bound_ms=1e3 * mma_pairs * 3 * 4 * d / PEAK_TF32_FLOPS)


def flash_cases(torch, gen, rec, paths) -> None:
    """The flash-attention kernel against its plain version in float64 on the
    card (FLASH_CASES): the serving path's shape, s = 1,000 causal and not
    (the ragged last block masked by bounds) and d = 64. Times: the kernel
    over 20 warm launches, the fp32 plain version over 3 calls, and SDPA
    (``scaled_dot_product_attention`` with ``enable_gqa``, on (b, h, s, d)
    copies made beforehand) over 20, by CUDA events. Both calls of the
    kernel give the same bits."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import BLOCK, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    dev = torch.device("cuda")
    for label, b, s, hq, hkv, d, causal in FLASH_CASES:
        q = torch.randn((b, s, hq, d), generator=gen, device=dev)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
        out = flash_attention(q, k, v, causal=causal)
        again = flash_attention(q, k, v, causal=causal)
        ref64 = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
        torch.cuda.synchronize()
        err = (out.double() - ref64).abs().max().item()
        scale = max(1.0, ref64.abs().max().item())
        del ref64
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        bound, flops, nbytes = _flash_bound_ms(b, s, hq, hkv, d, causal)
        line = dict(
            kernel="flash_attention", case=label, b=b, s=s, hq=hq, hkv=hkv, d=d,
            causal=causal, ctas=b * hq * -(-s // BLOCK), max_abs_err=err, rel_err=err / scale,
            same_bits=bool(torch.equal(out, again)),
            tol=FLASH_TOL * scale, smem_bytes=flash_attention.smem_bytes(d),
            ms=_events_ms(torch, lambda: flash_attention(q, k, v, causal=causal), 20),
            plain_ms=_events_ms(torch, lambda: flash_attention_ref(q, k, v, causal=causal), 3),
            library_ms=_events_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20),
            bound_ms=bound, bound_by=_bound_by(flops, nbytes), flops=flops, bytes=nbytes,
            **_flash_floors(b, s, hq, d, causal))
        emit("kernels", **line)
        check(err <= FLASH_TOL * scale, f"flash_attention {label}: {err} > {FLASH_TOL * scale}")
        check(line["same_bits"], f"flash_attention {label}: the same bits on two launches")
        rec["flash_attention"]["max_abs_err"] = max(rec["flash_attention"]["max_abs_err"], err)
        if label == "lm_serve":
            paths["lm_serve"]["flash_attention"] = line


def main_path_phase(torch, kernels: dict) -> dict:
    """``IterativeGP.fit → predict`` at full protein n through the kernels, with
    the launch counts read just around it, then the Cholesky oracle. Returns
    the oracle's mean at the test points and CG's test metrics, which the
    stochastic solvers are held against."""
    from repro_torch.core import CG, IterativeGP, exact_posterior
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)
    gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL), **hypers)
    dev = gp.device
    check(dev.type == "cuda", f"IterativeGP() defaults to the card, got {dev}")
    y_test = torch.as_tensor(data["y_test"], device=dev)

    _reset_counts(torch)
    t0 = time.perf_counter()
    mean, var = gp.fit(data["x"], data["y"]).predict(data["x_test"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, matvec_counts, feature_counts = _read_counts()

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
    check(launches["gram_matvec_bwd"] == 0, "serving takes no gradient")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    check(feature_counts["features"] == 0, "no materialised feature matrix")
    _record_path(kernels, "fit_predict", launches)

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
    cg_rmse, cg_nll = _test_metrics(torch, mean, var, y_test)
    return dict(exact_mean=exact_mean, cg=dict(rmse=cg_rmse, nll=cg_nll, rel_mean_err=rel,
                                               iterations=info.iterations, wall_s=wall))


def _test_metrics(torch, mean, var, y_test) -> tuple:
    """Test RMSE and Gaussian NLL of a predictive mean and variance."""
    rmse = torch.sqrt(torch.mean((mean - y_test) ** 2)).item()
    v = torch.clamp(var, min=1e-6)
    nll = torch.mean(0.5 * torch.log(2 * math.pi * v) + 0.5 * (y_test - mean) ** 2 / v).item()
    return rmse, nll


def grad_phase(torch) -> None:
    """∇θ of the MLL estimator's quadratic forms (``mll._quad``: the fit term
    at s = 1, the trace term at s = 8) through the kernels, against the same
    forms through the plain autograd Function in float64 on the card, at
    GRAD_N protein rows and θ₀ of the training path. u and w are held fixed:
    the solutions v_y and α of one ``mll_grad`` there. The trace term's w
    also requires grad, so dv runs the forward kernel on swapped operands."""
    from repro_torch.core import CG, mll_grad
    from repro_torch.core.kernels_fn import make_params, map_params
    from repro_torch.core.mll import _quad
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_bwd, plain_gram_matvec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = regression_dataset("protein", seed=SEED)
    x = torch.as_tensor(data["x"][:GRAD_N], device=dev)
    y = torch.as_tensor(data["y"][:GRAD_N], device=dev)
    n, d = x.shape

    def plain_quad(p, x, u, w):  # mll._quad with the plain Function as the core
        xs = x / p.lengthscale
        kw = p.signal * plain_gram_matvec(xs, xs, w, kind=p.kind)
        return torch.sum(u * kw, dim=0) + p.noise * torch.sum(u * w, dim=0)

    for kind in KINDS:
        params = make_params(kind, d=d, device=dev, **TRAIN_HYPERS)
        est = mll_grad(params, x, y, generator=gen, num_probes=TRAIN_PROBES,
                       spec=CG(max_iters=TRAIN_MAX_ITERS, tol=MAIN_TOL))
        grads = {}
        for route, dt in (("kernels", torch.float32), ("plain", torch.float64)):
            p = map_params(lambda t: t.detach().to(dt).requires_grad_(), params)
            xx, a, b = x.to(dt), est.v_y[:, None].to(dt), est.alpha.to(dt)
            w = b.clone().requires_grad_()
            before = (gram_matvec.launches, gram_matvec_bwd.launches)
            if route == "kernels":
                neg = (0.5 * _quad(p, xx, a, a, "cuda")[0]
                       - 0.5 * torch.mean(_quad(p, xx, b, w, "cuda")))
                g = torch.autograd.grad(neg, [p.log_lengthscale, p.log_signal, p.log_noise, w])
                launched = (gram_matvec.launches - before[0],
                            gram_matvec_bwd.launches - before[1])
            else:
                neg = 0.5 * plain_quad(p, xx, a, a)[0] - 0.5 * torch.mean(plain_quad(p, xx, b, w))
                g = torch.autograd.grad(neg, [p.log_lengthscale, p.log_signal, p.log_noise, w])
            grads[route] = dict(zip(("log_lengthscale", "log_signal", "log_noise", "dv"), g))
        rel = {k: ((grads["kernels"][k].double() - grads["plain"][k]).norm()
                   / grads["plain"][k].norm()).item() for k in grads["plain"]}
        # the log_noise leaf runs through no kernel: it is ∝ ½ aᵀa − ½ mean bᵀb,
        # and its fp32 error is that of the two sums times this ratio
        fit_n = 0.5 * (a * a).sum()
        tr_n = 0.5 * (b * b).sum(dim=0).mean()
        cancel = ((fit_n.abs() + tr_n.abs()) / (fit_n - tr_n).abs()).item()
        emit("grad", kind=kind, n=n, d=d, solve_iterations=est.solver_iterations,
             rel_err=rel, tol=GRAD_TOL, log_noise_cancellation=cancel,
             launches=dict(gram_matvec=launched[0], gram_matvec_bwd=launched[1]))
        check(launched == (3, 4), f"2 forward + 1 dv Gram launches and 4 backward, got {launched}")
        for k, e in rel.items():
            check(e <= GRAD_TOL, f"grad {kind} {k}: relative error {e}")


def train_phase(torch, kernels: dict) -> None:
    """The slice's path at full protein n: ``fit → optimize → predict`` through
    the kernels, with every launch count read just around it; θ₀'s own
    fit → predict before it as the baseline, and the exact MLL at θ₀ and at
    the optimised θ from a float64 Cholesky after it."""
    from repro_torch.core import CG, IterativeGP, exact_mll, map_params
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    spec = CG(max_iters=TRAIN_MAX_ITERS, tol=MAIN_TOL)
    dev = torch.device("cuda")
    y_test = torch.as_tensor(data["y_test"], device=dev)

    base = IterativeGP("matern32", spec=spec, seed=SEED, **TRAIN_HYPERS)
    t0 = time.perf_counter()
    mean0, var0 = base.fit(data["x"], data["y"]).predict(data["x_test"])
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    rmse0, nll0 = _test_metrics(torch, mean0, var0, y_test)
    base_info = base.posterior(64).solve_info
    theta0 = base.params

    gp = IterativeGP("matern32", spec=spec, seed=SEED, **TRAIN_HYPERS)
    steps = []

    def record(t, st):
        info = st.last_solve
        steps.append(dict(step=t, iterations=info.iterations, matvecs=info.matvecs,
                          converged=info.converged, healthy=info.healthy,
                          max_rel_residual=info.rel_residual.max().item()))

    _reset_counts(torch)
    t0 = time.perf_counter()
    gp.fit(data["x"], data["y"]).optimize(num_steps=TRAIN_STEPS, lr=TRAIN_LR,
                                          num_probes=TRAIN_PROBES, callback=record)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mean, var = gp.predict(data["x_test"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, matvec_counts, feature_counts = _read_counts()

    info = gp.posterior(64).solve_info  # cached: no further launches
    rmse, nll = _test_metrics(torch, mean, var, y_test)
    n = int(data["n"])
    x64 = torch.as_tensor(data["x"], device=dev, dtype=torch.float64)
    y64 = torch.as_tensor(data["y"], device=dev, dtype=torch.float64)
    t3 = time.perf_counter()
    mll0 = exact_mll(map_params(torch.Tensor.double, theta0), x64, y64).item() / n
    mll1 = exact_mll(map_params(torch.Tensor.double, gp.params), x64, y64).item() / n
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del x64, y64
    torch.cuda.empty_cache()

    def theta(p):
        return dict(lengthscale=p.lengthscale.tolist(), signal=p.signal.item(),
                    noise=p.noise.item())

    step_matvecs = sum(st["matvecs"] for st in steps)
    emit("train", n=n, d=int(data["d"]), n_test=int(mean.shape[0]), steps=steps,
         total_solver_iters=gp.last_optim.total_solver_iters, optimize_s=t1 - t0,
         predict_s=t2 - t1, predict_iterations=info.iterations,
         predict_matvecs=info.matvecs, predict_converged=info.converged,
         launches=launches, matvec_counts=matvec_counts, feature_counts=feature_counts,
         theta_before=theta(theta0), theta_after=theta(gp.params),
         exact_mll_per_n=dict(before=mll0, after=mll1), oracle_s=oracle_s,
         max_memory_gb=peak_gb, rmse=rmse, nll=nll,
         baseline=dict(rmse=rmse0, nll=nll0, fit_predict_s=base_s,
                       iterations=base_info.iterations, converged=base_info.converged))
    check(len(steps) == TRAIN_STEPS, f"{TRAIN_STEPS} outer steps, got {len(steps)}")
    check(all(st["healthy"] for st in steps) and info.healthy and base_info.healthy,
          "every solve is free of nonfinite/breakdown flags")
    check(launches["gram_matvec_bwd"] == 4 * TRAIN_STEPS,
          f"backward launches {launches['gram_matvec_bwd']} == 4 × {TRAIN_STEPS}")
    want = step_matvecs + 2 * TRAIN_STEPS + info.matvecs + 2
    check(launches["gram_matvec"] == want,
          f"Gram launches {launches['gram_matvec']} == Σ step matvecs + 2 × steps + "
          f"predict's matvecs + 2 = {want}")
    check(launches["rff_matvec"] == TRAIN_STEPS + 2,
          f"RFF launches {launches['rff_matvec']} == {TRAIN_STEPS} + 2")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    check(feature_counts["features"] == 0, "no materialised feature matrix")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "finite outputs")
    check(mean.shape == var.shape == (1024,), f"outputs of shape (1024,), got {mean.shape}")
    check(math.isfinite(mll1) and mll1 > mll0,
          f"the exact MLL per n rises: {mll0} -> {mll1}")
    _record_path(kernels, "train", launches)
    return dict(total_solver_iters=gp.last_optim.total_solver_iters, optimize_s=t1 - t0,
                exact_mll_before=mll0)


def _precond_specs():
    """The preconditioners of the precond phase, by name."""
    from repro_torch.core import RFF, Jacobi, Nystrom, PivotedCholesky

    return dict(jacobi=Jacobi(), nystrom=Nystrom(rank=PRECOND_RANK),
                pivoted_cholesky=PivotedCholesky(rank=PRECOND_RANK), rff=RFF(rank=RFF_RANK))


def precond_phase(torch, kernels: dict, oracle: dict, trained: dict) -> None:
    """Preconditioned CG on the main path: ``IterativeGP(spec=CG(precond=P))
    .fit → predict`` at full protein n and the serving path's θ for each
    preconditioner, each held against the Cholesky oracle and to the
    serving path's launch identities, the factor build timed apart; one
    ``RFFGram`` solve with its own feature matrix as the preconditioner; and
    ``fit → optimize`` as the training path runs it, with Nyström CG."""
    from repro_torch.core import (
        CG, RFF, Gram, IterativeGP, Nystrom, RFFGram, exact_mll, make_fourier_features,
        make_params, map_params, solve,
    )
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    d, dev = data["d"], torch.device("cuda")
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)
    exact_mean = oracle["exact_mean"]
    for name, pc in _precond_specs().items():
        gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL, precond=pc),
                         **hypers)
        gp.fit(data["x"], data["y"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc.build(Gram(x=gp.x, params=gp.params), generator=torch.Generator(device=dev))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _reset_counts(torch)
        t0 = time.perf_counter()
        mean, var = gp.predict(data["x_test"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, matvec_counts, feature_counts = _read_counts()
        info = gp.posterior(64).solve_info  # cached: no further launches
        rel = ((mean - exact_mean).norm() / exact_mean.norm()).item()
        emit("precond", precond=name, n=int(data["n"]), rank=getattr(pc, "rank", None),
             build_s=build_s, iterations=info.iterations, matvecs=info.matvecs,
             unpreconditioned_iterations=oracle["cg"]["iterations"], wall_s=wall,
             unpreconditioned_wall_s=oracle["cg"]["wall_s"], converged=info.converged,
             max_rel_residual=info.rel_residual.max().item(),
             flags=sorted(set(info.flags.tolist())), rel_mean_err=rel, tol=1e-2,
             launches=launches, matvec_counts=matvec_counts, feature_counts=feature_counts)
        check(info.healthy, f"{name}: the solve carries no nonfinite/breakdown flag")
        if name not in UNCONVERGED_PRECONDS:
            check(info.converged, f"{name}: CG converged to {MAIN_TOL}")
            check(rel <= 1e-2, f"{name}: mean within 1e-2 of the Cholesky mean, got {rel}")
        check(launches["gram_matvec"] == info.iterations + 2,
              f"{name}: Gram launches {launches['gram_matvec']} == iterations + 2")
        check(launches["rff_matvec"] == 2, f"{name}: RFF launches {launches['rff_matvec']} == 2")
        check(matvec_counts["chunked"] == matvec_counts["dense"] == 0,
              f"{name}: no plain Gram matvec")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "finite outputs")
        _record_path(kernels, f"precond_{name}", launches)
        del gp, mean, var
        torch.cuda.empty_cache()

    # RFFGram: Φ(Φᵀv) + σ²v on 2,048 features, through the RFF kernel in both
    # orientations; RFF() there is the operator's own Φ, an exact inverse
    params = make_params("matern32", d=d, device=dev,
                         **{k: v for k, v in hypers.items() if k != "seed"})
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    ff = make_fourier_features(params, RFFGRAM_FEATURES, d, generator=gen)
    op = RFFGram(x=x, ff=ff, sigma2=params.noise)
    runs = {}
    for label, spec in (("plain", CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL)),
                        ("rff", CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL, precond=RFF()))):
        _reset_counts(torch)
        t0 = time.perf_counter()
        res = solve(op, y, spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, matvec_counts, feature_counts = _read_counts()
        runs[label] = res
        emit("rff_gram", precond=label, n=int(data["n"]), num_features=RFFGRAM_FEATURES,
             iterations=res.iterations, matvecs=res.matvecs, converged=res.converged,
             rel_residual=res.rel_residual.max().item(), wall_s=wall, launches=launches,
             feature_counts=feature_counts)
        check(res.converged and res.healthy, f"RFFGram {label}: converged, healthy")
        check(launches["rff_t_matvec"] == launches["rff_matvec"] == res.matvecs,
              f"RFFGram {label}: Φ̃ᵀu and Φ̃W launches {launches['rff_t_matvec']}, "
              f"{launches['rff_matvec']} == matvecs {res.matvecs}")
        check(launches["gram_matvec"] == 0 and matvec_counts["chunked"] == 0,
              f"RFFGram {label}: no Gram matvec")
        _record_path(kernels, f"rff_gram_{label}", launches)
    pre, plain = runs["rff"], runs["plain"]
    diff = ((pre.solution - plain.solution).norm() / plain.solution.norm()).item()
    emit("rff_gram_check", rel_solution_diff=diff, tol=1e-2)
    check(pre.iterations <= 3 < plain.iterations,
          f"RFF() inverts RFFGram exactly: {pre.iterations} iterations, plain {plain.iterations}")
    check(diff <= 1e-2, f"the preconditioned RFFGram solution within 1e-2 of plain CG's: {diff}")
    del op, ff, runs, pre, plain
    torch.cuda.empty_cache()

    # fit → optimize as the training path runs it, on Nyström CG
    spec = CG(max_iters=TRAIN_MAX_ITERS, tol=MAIN_TOL, precond=Nystrom(rank=PRECOND_RANK))
    gp = IterativeGP("matern32", spec=spec, seed=SEED, **TRAIN_HYPERS)
    steps = []
    gp.fit(data["x"], data["y"])
    _reset_counts(torch)
    t0 = time.perf_counter()
    gp.optimize(num_steps=TRAIN_STEPS, lr=TRAIN_LR, num_probes=TRAIN_PROBES,
                callback=lambda t, st: steps.append(st.last_solve))
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    launches, matvec_counts, _ = _read_counts()
    x64 = torch.as_tensor(data["x"], device=dev, dtype=torch.float64)
    y64 = torch.as_tensor(data["y"], device=dev, dtype=torch.float64)
    mll1 = exact_mll(map_params(torch.Tensor.double, gp.params), x64, y64).item() / int(data["n"])
    mll0 = trained["exact_mll_before"]
    del x64, y64
    torch.cuda.empty_cache()
    step_matvecs = sum(st.matvecs for st in steps)
    emit("precond_train", precond="nystrom", rank=PRECOND_RANK, steps=len(steps),
         iterations=[st.iterations for st in steps],
         total_solver_iters=gp.last_optim.total_solver_iters,
         unpreconditioned_total_solver_iters=trained["total_solver_iters"],
         optimize_s=optimize_s, unpreconditioned_optimize_s=trained["optimize_s"],
         exact_mll_per_n=dict(before=mll0, after=mll1), launches=launches,
         matvec_counts=matvec_counts)
    check(len(steps) == TRAIN_STEPS and all(st.healthy for st in steps),
          "every preconditioned step's solve is healthy")
    check(launches["gram_matvec"] == step_matvecs + 2 * TRAIN_STEPS,
          f"Gram launches {launches['gram_matvec']} == Σ step matvecs + 2 × steps")
    check(launches["gram_matvec_bwd"] == 4 * TRAIN_STEPS, "4 backward launches a step")
    check(launches["rff_matvec"] == TRAIN_STEPS, "one prior RFF launch a step")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    check(math.isfinite(mll1) and mll1 > mll0, f"the exact MLL per n rises: {mll0} -> {mll1}")
    _record_path(kernels, "precond_train", launches)


def robust_phase(torch, kernels: dict) -> None:
    """``solve_robust`` on benchmarks/bench_robust.py's three problems, built
    from the port's generator on the card: the happy path (matvecs equal to a
    plain solve), the near-singular problem (recovered by the ladder, beside
    results/BENCH_bench_robust.json's rows), and a NaN right-hand side (one
    failed column, the healthy columns bit-identical)."""
    from repro_torch.core import Gram, make_params, solve, solve_robust
    from repro_torch.testing import nan_columns, near_singular_problem

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((ROBUST["n"], ROBUST["d"]), generator=gen, device=dev)
    b = torch.randn((ROBUST["n"], ROBUST["s"]), generator=gen, device=dev)
    op = Gram(x=x, params=make_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1,
                                      d=ROBUST["d"], device=dev))
    kw = ROBUST["spec"]
    _reset_counts(torch)
    plain = solve(op, b, "cg", **kw)
    robust = solve_robust(op, b, "cg", **kw)
    launches, _, _ = _read_counts()
    walls = {"plain": [], "robust": []}
    for r in range(ROBUST["reps"]):
        order = ("plain", "robust") if r % 2 == 0 else ("robust", "plain")
        for label in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "plain":
                solve(op, b, "cg", **kw).solution.sum().item()
            else:
                solve_robust(op, b, "cg", **kw).result.solution.sum().item()
            walls[label].append(time.perf_counter() - t0)
    best = {k: min(v) for k, v in walls.items()}
    emit("robust_overhead", n=ROBUST["n"], s=ROBUST["s"], matvecs=plain.matvecs,
         robust_matvecs=robust.result.matvecs, escalated=robust.escalated,
         wall_s=best, overhead_pct=100.0 * (best["robust"] - best["plain"]) / best["plain"],
         launches=launches)
    check(not robust.escalated and robust.result.matvecs == plain.matvecs,
          "the happy path takes no rung and spends the plain solve's matvecs")
    check(launches["gram_matvec"] == 2 * plain.matvecs, "one Gram launch a matvec")
    _record_path(kernels, "robust_overhead", launches)

    ns_op, ns_b, _, _ = near_singular_problem(96, 3, generator=gen, device=dev)
    _reset_counts(torch)
    rep = solve_robust(ns_op, ns_b, "cg", max_iters=200, tol=1e-6, stall_window=30)
    launches, matvec_counts, _ = _read_counts()
    emit("robust_recovery", recovered=rep.recovered, rungs=len(rep.rungs),
         ladder=" > ".join(rep.ladder), matvecs=rep.result.matvecs,
         committed=dict(ladder="jitter:1e-06 > jitter:0.001", rungs=2, matvecs=559),
         failed_columns=list(rep.failed_columns), launches=launches)
    check(rep.escalated and rep.recovered, "the near-singular problem is recovered")
    check(torch.isfinite(rep.result.solution).all().item(), "finite rescued solutions")
    check(launches["gram_matvec"] == rep.result.matvecs,
          f"Gram launches {launches['gram_matvec']} == the ladder's matvecs")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    _record_path(kernels, "robust_recovery", launches)

    bad = solve_robust(op, nan_columns(b, (1,)), "cg", **kw)
    intact = all(torch.equal(bad.result.solution[:, c], plain.solution[:, c])
                 for c in range(ROBUST["s"]) if c != 1)
    emit("robust_failure", escalated=bad.escalated, failed_columns=list(bad.failed_columns),
         ladder=" > ".join(bad.ladder), healthy_columns_intact=intact)
    check(bad.escalated and bad.failed_columns == (1,), "the NaN column fails, alone")
    check(intact, "the healthy columns keep the plain solve's payload bit for bit")


def _stochastic_spec(name: str, num_steps: int, **kw):
    from repro_torch.core import AP, SDD, SGD

    cls = dict(sgd=SGD, sdd=SDD, ap=AP)[name]
    return cls(num_steps=num_steps, **{**STOCH_SPECS[name], **kw})


def stochastic_phase(torch, kernels: dict, oracle: dict) -> None:
    """The slice's paths at full protein n: ``IterativeGP(spec=SGD | SDD |
    AP).fit → predict`` through the kernels, at the serving path's θ, 2,048
    prior features and 64 samples (65 RHS columns), each solver at the
    paper's defaults and the bench's step budget. Every launch count is read
    just around each run and checked against the solver's identity; the
    posterior mean is held against the Cholesky mean of the main path
    (measured, not asserted: the quality of a fixed step budget is a
    finding), beside CG's test metrics."""
    from repro_torch.core import IterativeGP
    from repro_torch.core.solvers import FLAG_NONFINITE
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)
    dev = torch.device("cuda")
    y_test = torch.as_tensor(data["y_test"], device=dev)
    exact_mean = oracle["exact_mean"]
    runs = [(name, steps, _stochastic_spec(name, steps)) for name, steps in STOCH_STEPS.items()]
    runs.append(("sdd_paper_step", STOCH_STEPS["sdd"],
                 _stochastic_spec("sdd", STOCH_STEPS["sdd"], step_size_times_n=SDD_PAPER_STEP)))
    for run, steps, spec in runs:
        name = spec.name
        gp = IterativeGP("matern32", spec=spec, **hypers)
        _reset_counts(torch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        mean, var = gp.fit(data["x"], data["y"]).predict(data["x_test"])
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, matvec_counts, feature_counts = _read_counts()
        info = gp.posterior(64).solve_info  # cached: no further launches
        rmse, nll = _test_metrics(torch, mean, var, y_test)
        rel = ((mean - exact_mean).norm() / exact_mean.norm()).item()
        flags = sorted(set(info.flags.tolist()))
        emit("stochastic", run=run, solver=name, n=int(data["n"]), d=d, rhs_columns=65,
             steps=steps, step_size_times_n=getattr(spec, "step_size_times_n", None),
             batch=getattr(spec, "batch_size", getattr(spec, "block_size", None)),
             wall_s=wall,
             event_span_ms=start.elapsed_time(end), ms_per_step=1e3 * wall / steps,
             matvecs=info.matvecs, rel_residual_mean=info.rel_residual[0].item(),
             max_rel_residual=info.rel_residual.max().item(), flags=flags,
             columns_flagged=int(((info.flags & 1) != 0).sum()),
             rel_mean_err_vs_cholesky=rel, rmse=rmse, nll=nll, cg=oracle["cg"],
             launches=launches, matvec_counts=matvec_counts, feature_counts=feature_counts)
        check(mean.shape == var.shape == (1024,), f"{run}: outputs of shape (1024,)")
        if run == "sdd_paper_step":
            # diverged or not, no column is non-finite without its NONFINITE
            # flag (a flagged column keeps its last finite iterate)
            post = gp.posterior(64)
            finite = torch.cat([torch.isfinite(post.v_mean).all()[None],
                                torch.isfinite(post.alpha).all(dim=0)])
            flagged = (info.flags & FLAG_NONFINITE) != 0
            check(bool((flagged | finite).all()), f"{run}: every non-finite column flagged")
        else:
            check(info.healthy, f"{run}: no nonfinite column")
            check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                  f"{run}: finite outputs")
        check(info.iterations == steps, f"{name}: {steps} steps, got {info.iterations}")
        # the launch identities: finalize's matvecs (one, or none for AP's
        # maintained residual) and predict's two Gram matvecs, f_X and the
        # prior at X* on the RFF kernel, one row-panel or feature-pair launch
        # per step where the solver has one
        want = dict(gram_matvec=info.matvecs + 2, gram_matvec_bwd=0, rff_matvec=2,
                    gram_rows_pair=0, gram_rows_matvec=0, rff_t_matvec=0, rff_pair=0,
                    rff_bwd=0, flash_attention=0)
        if name == "sgd":
            want.update(gram_rows_pair=steps, rff_pair=steps)
        elif name == "sdd":
            want.update(gram_rows_matvec=steps)
        else:
            want.update(gram_matvec=steps + 2)
        check(info.matvecs == (0 if name == "ap" else 1),
              f"{name}: finalize's full matvecs {info.matvecs}")
        check(launches == want, f"{name}: launches {launches} == {want}")
        check(matvec_counts["chunked"] == matvec_counts["dense"] == 0,
              f"{name}: no plain Gram matvec")
        check(feature_counts["features"] == 0, f"{name}: no materialised feature matrix")
        if run in STOCH_STEPS:
            _record_path(kernels, run, launches)
        del gp, mean, var
        torch.cuda.empty_cache()


def route_parity_phase(torch) -> None:
    """Each solver's first PARITY_STEPS steps twice on the card from one
    generator seed, through the kernels (``backend="cuda"``) and through the
    plain route (``backend="chunked"``: materialised panels and features), on
    the main path's pathwise targets: the iterates agree within the
    reference's fused-vs-features tolerance. This holds the kernels inside
    the loop. SGD also runs 50 and 100 steps, unchecked, to show how fast
    the two routes' rounding drifts apart. SGD's PARITY_STEPS runs are held
    against the plain route in float64 on the same draws (``vs_fp64``), on
    PARITY_SEEDS draw sequences: the kernel route's mean excess over rtol at
    most PARITY_FP64_MARGIN × the plain fp32 route's (or PARITY_TOL); SDD
    and AP keep the fp32 check."""
    from repro_torch.core import make_params
    from repro_torch.core.operators import Gram
    from repro_torch.core.pathwise import pathwise_targets
    from repro_torch.core.rff import sample_prior
    from repro_torch.core.solvers import solve
    from repro_torch.core.solvers.sgd import SGDDraws, draw_sgd
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    dev = torch.device("cuda")
    params = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                         d=d, device=dev)
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prior = sample_prior(params, 64, 2048, d, generator=gen)
    b, delta = pathwise_targets(Gram(x=x, params=params), y, prior, generator=gen)
    for name, steps in [("sgd", 50), ("sgd", 100)] + [(k, PARITY_STEPS) for k in STOCH_STEPS]:
        sols, launched = {}, {}
        for backend in ("cuda", "chunked"):
            _reset_counts(torch)
            spec = _stochastic_spec(name, steps, backend=backend)
            t0 = time.perf_counter()
            res = solve(Gram(x=x, params=params), b, spec, delta=delta,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
            torch.cuda.synchronize()
            launched[backend] = dict(seconds=time.perf_counter() - t0,
                                     **_path_launches(_read_counts()[0]))
            sols[backend] = res.solution
        a, ref = sols["cuda"], sols["chunked"]
        excess = ((a - ref).abs() - PARITY_TOL * ref.abs()).max().item()
        vs_fp64 = None
        if name == "sgd" and steps == PARITY_STEPS:
            params64 = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0,
                                   noise=0.1, d=d, dtype=torch.float64, device=dev)
            per_seed = []
            for i in range(PARITY_SEEDS):  # the first seed's runs are the ones above
                seed = SEED + 1 + i
                spec = _stochastic_spec(name, steps, backend="chunked")
                runs = sols if i == 0 else {
                    backend: solve(Gram(x=x, params=params), b,
                                   _stochastic_spec(name, steps, backend=backend), delta=delta,
                                   generator=torch.Generator(device=dev).manual_seed(seed)
                                   ).solution
                    for backend in ("cuda", "chunked")}
                draws = draw_sgd(Gram(x=x, params=params), steps, spec.batch_size,
                                 spec.num_features,
                                 generator=torch.Generator(device=dev).manual_seed(seed))
                ref64 = solve(Gram(x=x.double(), params=params64), b.double(), spec,
                              delta=delta.double(),
                              draws=SGDDraws(idx=draws.idx, omega=draws.omega.double())).solution
                per_seed.append({k: dict(
                    max_abs_diff=(v.double() - ref64).abs().max().item(),
                    max_excess_over_rtol=((v.double() - ref64).abs()
                                          - PARITY_TOL * ref64.abs()).max().item())
                    for k, v in runs.items()})
            vs_fp64 = dict(per_seed[0], seeds=per_seed, mean_excess_over_rtol={
                k: sum(r[k]["max_excess_over_rtol"] for r in per_seed) / PARITY_SEEDS
                for k in ("cuda", "chunked")})
        emit("route_parity", solver=name, steps=steps, rtol=PARITY_TOL,
             atol=PARITY_TOL, max_abs_diff=(a - ref).abs().max().item(),
             max_rel_diff=((a - ref).norm() / ref.norm()).item(),
             max_excess_over_rtol=excess, vs_fp64=vs_fp64, runs=launched)
        if steps != PARITY_STEPS:
            continue  # SGD's shorter runs measure how the routes drift apart
        check(bool(torch.isfinite(a).all()), f"{name}: finite iterates")
        if name == "sgd":
            # held to the float64 route: the kernel route no further from it
            # than PARITY_FP64_MARGIN × the plain fp32 route, over
            # PARITY_SEEDS draw sequences (the clipped iterates amplify any
            # rounding; the fp32 routes' distance to each other is printed
            # above)
            mean = vs_fp64["mean_excess_over_rtol"]
            limit = max(PARITY_TOL, PARITY_FP64_MARGIN * mean["chunked"])
            check(mean["cuda"] <= limit, f"sgd: kernel route's mean excess over rtol "
                  f"{PARITY_TOL} against the float64 route {mean['cuda']} <= {limit} after "
                  f"{PARITY_STEPS} steps, {PARITY_SEEDS} draw sequences")
        else:
            check(excess <= PARITY_TOL, f"{name}: kernel and plain routes within "
                  f"rtol = atol = {PARITY_TOL} after {PARITY_STEPS} steps ({excess})")
        own = launched["cuda"]
        used = dict(sgd=own["gram_rows_pair"] + own["rff_pair"], sdd=own["gram_rows_pair"],
                    ap=own["gram_matvec"])[name]
        check(used > 0, f"{name}: the kernel route launched its kernels")
        check(all(v == 0 for k, v in launched["chunked"].items() if k != "seconds"),
              f"{name}: the plain route launched no kernel")


def _plain_ascent_value64(torch, post, xs):
    """``thompson.ascent_value`` in float64 through the plain autograd
    Functions, with σ_f², 1/ℓ and the weights applied as ``kernels/ops.py``
    applies them around the kernels."""
    from repro_torch.kernels.gram_matvec import plain_gram_matvec
    from repro_torch.kernels.rff_matvec import plain_rff_matvec

    top, s, d = xs.shape
    q = xs.reshape(top * s, d)
    p = post.params
    ls, sig = p.lengthscale.double(), p.signal.double()
    prior = torch.sqrt(sig) * plain_rff_matvec(q, post.prior.ff.omega.double(),
                                               post.prior.w.double())
    w = (post.v_mean[:, None] - post.alpha).double()
    cross = sig * plain_gram_matvec(q / ls, post.x.double() / ls, w, kind=p.kind)
    return torch.diagonal((prior + cross).reshape(top, s, s), dim1=1, dim2=2).sum()


def thompson_phase(torch, kernels: dict) -> None:
    """Parallel Thompson sampling: THOMPSON["steps"] calls of
    ``thompson_step`` on SDD from n0 = 50,000 observations, with every launch
    count read just around each step and held to its identity (per step:
    the RFF and Gram backward kernels once per ascent step and no ∂ω, ∂z, ∂v
    or ∂w launch; the Gram forward ascent steps + 3: SDD's finalize, the
    candidates, the final values; the RFF forward ascent steps + 4: f_X, the
    candidates, the final values, the objective; SDD's rows matvec once per
    solver step), the wall time of each step split into the solve and the
    ascent, and each acquired batch's mean objective held above the median
    of the initial observations. The first step's ascent gradient at its
    starts through the kernels is then held against the plain Functions in
    float64."""
    import repro_torch.core.thompson as th
    from repro_torch.core import SDD, ThompsonState, make_params, sample_prior, thompson_step

    cfg, dev = THOMPSON, torch.device("cuda")
    d, acq, steps_t = cfg["d"], cfg["acq_batch"], cfg["ascent_steps"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = make_params(cfg["kind"], lengthscale=cfg["lengthscale"], signal=cfg["signal"],
                         noise=cfg["noise"], d=d, device=dev)
    target = sample_prior(params, 1, cfg["objective_features"], d,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 1000))

    def objective(x):
        return target(x)[:, 0]

    with torch.no_grad():
        x0 = torch.rand((cfg["n0"], d), generator=gen, device=dev)
        y0 = objective(x0)
    state = ThompsonState(x=x0, y=y0, best=float(y0.max()))
    best0, median0 = state.best, float(y0.median())
    spec = SDD(**THOMPSON_SDD)
    kw = {k: cfg[k] for k in ("acq_batch", "num_features", "num_candidates", "num_top",
                              "ascent_steps")}

    # each step's solve (posterior_functions) and ascent (ascend_samples)
    # timed between synchronisations; the calls' arguments kept
    split, calls = {}, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = (args, out)
            return out
        return run

    originals = (th.posterior_functions, th._maximise_samples, th.ascend_samples)
    th.posterior_functions = timed("solve", originals[0])
    th._maximise_samples = timed("maximise", originals[1])
    th.ascend_samples = timed("ascent", originals[2])
    total, first = {}, None
    try:
        for step in range(cfg["steps"]):
            split.clear()
            _reset_counts(torch)
            t0 = time.perf_counter()
            state = thompson_step(params, state, objective, generator=gen, spec=spec, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, matvec_counts, feature_counts = _read_counts()
            first = first or dict(calls)
            info = calls["solve"][1].solve_info
            with torch.no_grad():
                f_new = objective(state.x[-acq:])
            mean_new = f_new.mean().item()
            emit("thompson", step=step, n=int(state.x.shape[0]) - acq, d=d, acq_batch=acq,
                 wall_s=wall, solve_s=split["solve"], ascent_s=split["ascent"],
                 candidates_and_final_s=split["maximise"] - split["ascent"],
                 rest_s=wall - split["solve"] - split["maximise"],
                 ms_per_ascent_step=1e3 * split["ascent"] / steps_t,
                 sdd_steps=info.iterations, rel_residual_mean=info.rel_residual[0].item(),
                 max_rel_residual=info.rel_residual.max().item(),
                 flags=sorted(set(info.flags.tolist())), batch_mean_objective=mean_new,
                 batch_max_objective=f_new.max().item(), median_y0=median0,
                 best=state.best, best_gain=state.best - best0, launches=launches,
                 matvec_counts=matvec_counts, feature_counts=feature_counts)
            want = dict(gram_matvec=steps_t + 3, gram_matvec_bwd=steps_t,
                        rff_matvec=steps_t + 4, gram_rows_pair=0,
                        gram_rows_matvec=THOMPSON_SDD["num_steps"], rff_t_matvec=0,
                        rff_pair=0, rff_bwd=steps_t, flash_attention=0)
            check(launches == want, f"thompson step {step}: launches {launches} == {want}")
            check(matvec_counts["chunked"] == matvec_counts["dense"] == 0,
                  f"thompson step {step}: no plain Gram matvec")
            check(feature_counts["features"] == 0,
                  f"thompson step {step}: no materialised feature matrix")
            check(info.healthy, f"thompson step {step}: no nonfinite SDD column")
            check(bool(torch.isfinite(state.x).all() and torch.isfinite(state.y).all()),
                  f"thompson step {step}: finite state")
            check(mean_new > median0, f"thompson step {step}: the batch's mean objective "
                  f"{mean_new} lies above the initial median {median0}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    finally:
        th.posterior_functions, th._maximise_samples, th.ascend_samples = originals
    _record_path(kernels, "thompson", total)

    # the first step's ascent gradient at its starts, through the kernels and
    # through the plain Functions in float64
    post, x_start = first["ascent"][0][:2]
    xk = x_start.detach().clone().requires_grad_()
    (gk,) = torch.autograd.grad(th.ascent_value(post, xk), [xk])
    x64 = x_start.detach().double().requires_grad_()
    (g64,) = torch.autograd.grad(_plain_ascent_value64(torch, post, x64), [x64])
    err = (gk.double() - g64).abs().max().item()
    tol = GRAD_TOL * max(1.0, g64.abs().max().item())
    # random search at the same budget, printed beside the ascent's gain
    with torch.no_grad():
        xr = torch.rand((cfg["steps"] * acq, d), generator=gen, device=dev)
        best_rand = max(best0, objective(xr).max().item())
    emit("thompson_check", ascent_grad_max_abs_err=err, tol=tol, starts=list(x_start.shape),
         best0=best0, best=state.best, gain=state.best - best0,
         random_search_best=best_rand, random_search_gain=best_rand - best0,
         acquired=int(state.x.shape[0]) - cfg["n0"])
    check(err <= tol, f"the ascent gradient through the kernels: {err} > {tol}")
    check(state.x.shape == (cfg["n0"] + cfg["steps"] * acq, d), "the state grew by the batches")


def _greedy_plain(torch, cfg, model, tokens, gen_n):
    """Greedy decoding with prefill on the plain attention route: the tokens
    (b, gen_n), the last-position prefill logits and each step's top-2 margin
    (b, gen_n). Decode steps are the same on both routes (the plain product)."""
    from repro_torch.models import model as model_lib

    b, prompt = tokens.shape
    cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
    logits, cache = model_lib.prefill(cfg, model, {"tokens": tokens}, cache, backend="plain")
    first, toks, margins = logits[:, -1], [], []
    for i in range(gen_n):
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        if i < gen_n - 1:
            logits, cache = model_lib.decode_step(cfg, model, toks[-1], cache, prompt + i)
    return torch.cat(toks, dim=1), first, torch.stack(margins, dim=1)


def lm_serve_phase(torch, kernels: dict) -> None:
    """LM serving at full width and depth: llama3-8b with random fp32 weights
    drawn on the card from a seeded generator, ``generate`` on a batch of 4
    prompts of 1,024 tokens for 16 greedy tokens, with the launch counts read
    just around it (one flash launch a layer, no plain attention dispatch).
    Then, on the same weights and tokens: prefill on the plain attention
    route (its last-position logits within LM_LOGIT_TOL of the kernel
    route's, scaled by max(1, max|logits|)); the plain route's greedy tokens,
    each held equal where its top-2 margin exceeds LM_MARGIN × the measured
    logit difference, row by row until the first position that is not; and
    ``forward_train`` on prompt + first token against prefill + decode_step at
    the reference's tolerances. Last, one prefill and PROFILE_DECODE_STEPS
    decode steps under the profiler: device time by kernel, idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib

    cfg = get_config(LM["arch"])
    b, prompt, gen_n = LM["batch"], LM["prompt"], LM["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    tokens = token_batch(SEED, 0, b, prompt, cfg.vocab_size)["tokens"]
    check(tokens.is_cuda and all(p.is_cuda for p in model.parameters()),
          "the model and tokens default to the card")

    _reset_counts(torch)
    toks, timings = generate(cfg, model, tokens, prompt + gen_n, gen_n)
    launches = _read_counts()[0]
    attention = dict(ops.ATTENTION_TRACE_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decoded = b * (gen_n - 1)  # the first token comes from prefill's logits
    emit("lm_serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=model_lib.count_params(cfg),
         weights_gb=weights_gb, batch=b, prompt=prompt, gen=gen_n, init_s=init_s,
         prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
         prefill_tok_per_s=b * prompt / timings["prefill_s"], decode_tokens=decoded,
         decode_tok_per_s=decoded / timings["decode_s"],
         ms_per_decode_step=1e3 * timings["decode_s"] / (gen_n - 1),
         max_memory_allocated_gb=peak_gb, launches=launches, attention_dispatches=attention,
         tokens_row0=toks[0].tolist())
    check(toks.shape == (b, gen_n), f"generated tokens of shape {(b, gen_n)}: {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "tokens inside the vocabulary")
    check(launches["flash_attention"] == cfg.num_layers,
          f"flash launches {launches['flash_attention']} == {cfg.num_layers} layers")
    check(attention == {"cuda": cfg.num_layers, "plain": 0},
          f"prefill's attention on the kernel route only: {attention}")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          "no GP kernel on the LM path")
    _record_path(kernels, "lm_serve", launches)

    with torch.no_grad():
        cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
        logits_k, cache = model_lib.prefill(cfg, model, {"tokens": tokens}, cache)
        logits_k = logits_k[:, -1]
        check(torch.equal(torch.argmax(logits_k, dim=-1), toks[:, 0]),
              "a second prefill gives generate's first tokens")
        plain_toks, logits_p, margins = _greedy_plain(torch, cfg, model, tokens, gen_n)
        diff = (logits_k - logits_p).abs().max().item()
        scale = max(1.0, logits_p.abs().max().item())
        checked = mismatched = 0
        for row in range(b):
            for i in range(gen_n):
                if margins[row, i].item() <= LM_MARGIN * diff:
                    break  # below the margin, and past it the two contexts may differ
                checked += 1
                mismatched += int(toks[row, i].item() != plain_toks[row, i].item())
        # the reference's prefill/decode consistency at one more position
        ext = torch.cat([tokens, toks[:, :1]], dim=1)
        full = model_lib.forward_train(cfg, model, {"tokens": ext})
        logits_d, _ = model_lib.decode_step(cfg, model, toks[:, :1], cache, prompt)
        consist = {}
        for name, got, want in (("prefill", logits_k, full[:, -2]),
                                ("decode", logits_d[:, -1], full[:, -1])):
            consist[name] = dict(
                max_abs_diff=(got - want).abs().max().item(),
                excess=((got - want).abs() - CONSIST_RTOL * want.abs()).max().item())
        del full
    emit("lm_route_parity", logit_max_abs_diff=diff, logit_scale=scale,
         tol=LM_LOGIT_TOL * scale, margin_factor=LM_MARGIN, positions=b * gen_n,
         positions_checked=checked, positions_mismatched=mismatched,
         tokens_equal_everywhere=bool(torch.equal(toks, plain_toks)),
         min_margin=margins.min().item(), consistency=consist, rtol=CONSIST_RTOL,
         atol=CONSIST_ATOL)
    check(diff <= LM_LOGIT_TOL * scale, f"plain-route logits within {LM_LOGIT_TOL}: {diff}")
    check(mismatched == 0, f"{mismatched} greedy tokens differ above the margin")
    for name, line in consist.items():
        check(line["excess"] <= CONSIST_ATOL,
              f"{name} logits against forward_train: {line['excess']} > {CONSIST_ATOL}")

    with torch.no_grad():
        for window in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if window == "prefill":
                    model_lib.prefill(cfg, model, {"tokens": tokens}, cache)
                else:
                    tok = toks[:, :1]
                    for i in range(PROFILE_DECODE_STEPS):
                        logits, cache = model_lib.decode_step(cfg, model, tok, cache, prompt + i)
                        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            by_name = _device_ms_by_kernel(prof)
            device_ms = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            emit("lm_profile", window=window,
                 decode_steps=PROFILE_DECODE_STEPS if window == "decode" else 0,
                 wall_ms=wall * 1e3, device_ms=device_ms,
                 idle_share=1.0 - device_ms / (wall * 1e3),
                 flash_ms=sum(v for k, v in by_name.items() if "flash_attention" in k),
                 top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
            check(0 < device_ms <= wall * 1e3, f"{window}: device time within the wall time")
    del model, cache
    torch.cuda.empty_cache()


def _device_ms_by_kernel(prof) -> dict:
    """Device time by kernel name from a profile, device-side events only: a
    host op's device time repeats its kernels'."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return by_name


def profile_phase(torch) -> None:
    """The serving and training paths, each stochastic solver's
    fit → predict at PROFILE_STOCH_STEPS steps, one Thompson acquisition
    step, and the serving path on Nyström CG, once more under
    ``torch.profiler``: device time by kernel and the
    card's idle share of the wall time. Run after the counted passes so
    that the profiler's overhead touches no other number."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import CG, SDD, IterativeGP, ThompsonState, make_params, sample_prior
    from repro_torch.core import thompson_step
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)

    def fit_predict():
        gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL),
                         lengthscale=math.sqrt(data["d"]) * 0.5, signal=1.0, noise=0.1,
                         seed=SEED)
        gp.fit(data["x"], data["y"]).predict(data["x_test"])
        return gp.posterior(64).solve_info.iterations  # cached: no launch

    def train():
        gp = IterativeGP("matern32", spec=CG(max_iters=TRAIN_MAX_ITERS, tol=MAIN_TOL),
                         seed=SEED, **TRAIN_HYPERS)
        gp.fit(data["x"], data["y"]).optimize(num_steps=PROFILE_TRAIN_STEPS, lr=TRAIN_LR,
                                              num_probes=TRAIN_PROBES)
        return gp.last_optim.total_solver_iters

    def stochastic(name):
        def run():
            gp = IterativeGP("matern32", spec=_stochastic_spec(name, PROFILE_STOCH_STEPS[name]),
                             lengthscale=math.sqrt(data["d"]) * 0.5, signal=1.0, noise=0.1,
                             seed=SEED)
            gp.fit(data["x"], data["y"]).predict(data["x_test"])
            return gp.posterior(64).solve_info.iterations  # cached: no launch
        return run

    cfg, dev = THOMPSON, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tparams = make_params(cfg["kind"], lengthscale=cfg["lengthscale"], signal=cfg["signal"],
                          noise=cfg["noise"], d=cfg["d"], device=dev)
    target = sample_prior(tparams, 1, cfg["objective_features"], cfg["d"], generator=gen)
    with torch.no_grad():
        tx = torch.rand((cfg["n0"], cfg["d"]), generator=gen, device=dev)
        tstate = ThompsonState(x=tx, y=target(tx)[:, 0], best=0.0)

    def thompson():
        thompson_step(tparams, tstate, lambda x: target(x)[:, 0], generator=gen,
                      spec=SDD(**THOMPSON_SDD),
                      **{k: cfg[k] for k in ("acq_batch", "num_features", "num_candidates",
                                             "num_top", "ascent_steps")})
        return cfg["ascent_steps"]

    def precond(pc):
        def run():
            gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL,
                                                 precond=pc),
                             lengthscale=math.sqrt(data["d"]) * 0.5, signal=1.0, noise=0.1,
                             seed=SEED)
            gp.fit(data["x"], data["y"]).predict(data["x_test"])
            return gp.posterior(64).solve_info.iterations  # cached: no launch
        return run

    for path, run in (("fit_predict", fit_predict), ("train", train),
                      *((name, stochastic(name)) for name in PROFILE_STOCH_STEPS),
                      ("thompson", thompson),
                      ("precond_nystrom", precond(_precond_specs()["nystrom"]))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            iterations = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_name = _device_ms_by_kernel(prof)
        processing_s = time.perf_counter() - t0
        device_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        # the Gram forward's device code: its kernel and its chunk sums (the
        # row-panel launches' included), not the backward
        gram_ms = sum(v for k, v in by_name.items()
                      if "gram_matvec_kernel" in k or "chunk_sum_kernel" in k)
        # the Gram backward and the RFF kernel (both orientations: the
        # feature pair, Φ̃ᵀu, Φ̃W), each with its fixed-order sum
        bwd_ms = sum(v for k, v in by_name.items()
                     if "gram_bwd_kernel" in k or "bwd_sum_kernel" in k)
        rff_ms = sum(v for k, v in by_name.items()
                     if "rff_kernel<" in k or "rff_sum_kernel" in k)
        emit("profile", path=path, wall_ms=wall * 1e3, device_ms=device_ms,
             idle_share=1.0 - device_ms / (wall * 1e3), iterations=iterations,
             processing_s=processing_s, gram_ms=gram_ms, gram_share=gram_ms / device_ms,
             gram_bwd_ms=bwd_ms, gram_bwd_share=bwd_ms / device_ms, rff_ms=rff_ms,
             rff_share=rff_ms / device_ms,
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
         **_gram_floors(n * n, d, s, "matern32"),
         checked_rows=rows, max_abs_err=err, tol=GRAM_TOL * scale,
         max_memory_allocated_gb=peak / 1e9, finite=bool(torch.isfinite(out).all()))
    check(bool(torch.isfinite(out).all()), "finite 3droad-shaped matvec")
    check(err <= GRAM_TOL * scale, f"3droad-shaped matvec rows: {err}")


if __name__ == "__main__":
    sys.exit(main())
