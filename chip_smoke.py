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
  run's first steps held against the plain route on the same draws; and the
  same three at ``precision="bf16"``, through the kernels' bf16 tiles (the
  Gram kernel, the row panel and its pair, the feature pair), their first
  steps held against the fp32 run on the same draws;
* parallel Thompson sampling, ``thompson_step`` on SDD from 50,000 observed
  points in 8-D, whose Adam ascent takes every gradient through the RFF
  backward and the Gram backward kernels, held to the reference's launch
  identities, to the plain Functions' gradient in float64, and to acquiring
  batches better than the median observation;
* the sparse paths, bench_solvers' SVGP(SGPR) row at protein's n with 512
  inducing points: ``sgpr``, ``sgpr_iterative`` (its normal-equations
  operator through the Gram kernel on the cross shapes, a 1,024-column
  variance solve), ``inducing_posterior`` (its prior through the RFF kernel)
  and SVGP natural-gradient steps, each against the float64 dense SGPR;
* the latent Kronecker GP, bench_kronecker's full 512 × 50 learning-curve
  grid: ``lkgp_posterior`` against the float64 dense posterior, the bench's
  standard iterative GP on the same cells through the kernels, and
  ``fit_curve_gp``;
* LM serving, ``repro_torch.launch.serve.generate`` on llama3-8b at full width
  and depth (random fp32 weights from a seed): prefill's causal attention
  through the flash-attention kernel, greedy decode, held against the plain
  attention route and against ``forward_train`` at one more position; then
  the same model cast to bf16 in place and served again, its prefill
  through the bf16 flash kernel, held against the fp32 run;
* LM training, ``repro_torch.launch.train.main`` on olmo-1b at full width
  and depth in fp32 (random weights from a seed, 20 AdamW steps on batches
  of 8 × 1,024 tokens): every layer's forward attention through the flash
  kernel, the loss falling; at full width with 2 layers, one step's loss
  and gradients against the plain attention route in fp32 and in float64,
  gradient accumulation over micro-batches, a bit-exact kill-and-resume
  from a checkpoint, and int8 gradient compression with error feedback;
* the LM families, served by ``generate`` and trained, in fp32: mamba2-130m
  at full width and depth (its chunked SSD held against the sequential
  scan, 20 training steps with the loss falling), dbrx-132b and
  deepseek-v2-236b at full width with 2 layers (dbrx's prefill through the
  flash kernel against the plain attention route, deepseek's absorbed MLA
  decode against the baseline, the MoE layers' dropped copies counted;
  one reduced training step each), jamba's hybrid period, reduced
  (held to the training yardstick), whisper-tiny's encoder-decoder at full
  size over stub frames (its encoder's non-causal attention and its
  decoder's causal self-attention through the flash kernel, its
  cross-attention the plain product; 20 training steps with the loss
  falling, the training yardstick at full size) and qwen2-vl-7b at full
  width and depth on prompts whose first 1,024 positions are stub patch
  embeddings under M-RoPE's vision grid (one training step at full width
  with 2 layers, the yardstick reduced); every prefill against
  ``forward_train``.

* the distributed solve, ``distributed_solve`` over ``torch.distributed``
  with its ranks spawned on the card: one rank on NCCL and two sharing the
  card on gloo (staging through host memory) on the CG cell's problem,
  under gather, gather_once, ring and auto, against the Cholesky oracle and
  single-device CG, SGD, SDD and AP against their single-device runs on the
  same draws, and four ranks' primitives under ring against gather.

The training path's θ-gradients are held against the plain autograd Function
in float64 at a reduced n, and the gradients at ``precision="bf16"`` through
the reference's differentiable kernel entry points (the pins ``ops.
gram_matvec``, ``rff_matvec``, ``rff_t_matvec``, and ``gram_mv``,
``gram_rows_pair``, ``rff_pair_mv``) at protein's full n, on bf16 backward
launches alone, against the plain bf16 route and the fp32 kernels; one CG
column's bits are held at widths 8 and 64, and one Gram matvec runs at
3droad's n, where K could not be held.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without its result lines. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero at once. The last two lines are the
kernels' record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
#: the profiled windows' depth: a profiled step costs the host its events'
#: processing, so the stochastic runs and the Thompson acquisition's ascent
#: are profiled short (the counted runs above keep their full depth)
PROFILE_STOCH_STEPS = {"sgd": 250, "sdd": 250, "ap": 100}
PROFILE_THOMPSON_ASCENT = 5
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
#: hq, hkv, d, causal): the path's shape, a ragged s causal and not, the
#: reduced configs' d = 64, olmo-1b's training shape, dbrx-132b's 48 → 8
#: heads, whisper-tiny's encoder (non-causal, 1,500 frames) and decoder
#: self-attention (its 432-token prompts), qwen2-vl-7b's 28 → 4 heads
LM = dict(arch="llama3-8b", batch=4, prompt=1024, gen=16)
FLASH_CASES = (("lm_serve", 4, 1024, 32, 8, 128, True), ("ragged", 4, 1000, 32, 8, 128, True),
               ("ragged_full", 4, 1000, 32, 8, 128, False), ("d64", 4, 1024, 4, 2, 64, True),
               ("lm_train", 8, 1024, 16, 16, 128, True), ("lm_dbrx", 4, 1024, 48, 8, 128, True),
               ("whisper_encoder", 4, 1500, 6, 6, 64, False),
               ("whisper_decoder", 4, 432, 6, 6, 64, True),
               ("lm_qwen2vl", 4, 2048, 28, 4, 128, True))
#: the flash cases that are a path's shape: the path each one's line goes to
#: (d64 is the reduced jamba's attention layer at the families' batch); a
#: path with two shapes (whisper's) takes its first as its line and lists both
FLASH_PATHS = {"lm_serve": "lm_serve", "lm_train": "lm_train", "lm_dbrx": "lm_dbrx",
               "d64": "lm_jamba", "whisper_encoder": "lm_whisper",
               "whisper_decoder": "lm_whisper", "lm_qwen2vl": "lm_qwen2vl"}
#: LM training: olmo-1b (src/repro_torch/configs/olmo_1b.py: 16 layers,
#: d_model 2,048, 16 heads of 128, d_ff 8,192, vocab 50,304, tied embeddings,
#: 1.18e9 parameters) at full width and depth in fp32, batch 8 × 1,024
#: planted-bigram tokens, 20 steps of the default AdamW (100 warm-up steps)
#: at lr LM_TRAIN["lr"], then LM_TRAIN["profile_steps"] profiled; the loss
#: must fall by LM_TRAIN_DROP between the means of the first and the last 5
#: steps (tests/test_train.py:28's margin). At full width with 2 layers
#: (LM_TRAIN_SMALL): the kernel route's loss and gradients within
#: TRAIN_YARD_RATIO × the fp32 plain route's distance from the float64 plain
#: route, or TRAIN_LOSS_FLOOR / TRAIN_GRAD_FLOOR if larger; micro_steps=2
#: against 1 within MICRO_LOSS_RTOL (loss) and MICRO_GRAD_TOL (of each
#: gradient leaf's scale); the bit-exact restart, a checkpoint every
#: ``ckpt_every`` steps
LM_TRAIN = dict(arch="olmo-1b", batch=8, seq=1024, steps=20, lr=2e-3, profile_steps=2)
LM_TRAIN_DROP = 0.1
LM_TRAIN_SMALL = dict(layers=2, batch=4, seq=512, steps=4, ckpt_every=2)
TRAIN_YARD_RATIO, TRAIN_LOSS_FLOOR, TRAIN_GRAD_FLOOR = 1.5, 1e-5, 1e-4
MICRO_LOSS_RTOL, MICRO_GRAD_TOL = 1e-6, 1e-5
#: the reference's flash tolerance (tests/test_kernels_pallas.py:72); the
#: kernel and plain routes' last-position logits; the reference's
#: prefill/decode-vs-forward tolerances (tests/test_models.py:114,118); a
#: greedy token is held to the plain route's where that route's top-2 margin
#: exceeds LM_MARGIN × the measured logit difference
FLASH_TOL, LM_LOGIT_TOL, CONSIST_RTOL, CONSIST_ATOL, LM_MARGIN = 2e-3, 1e-3, 5e-2, 5e-3, 10.0
#: decode steps of the profiled decode window
PROFILE_DECODE_STEPS = 8
#: The LM families (the lm_families phase), fp32: each served by ``generate``
#: on LM_FAMILY_SERVE's batch of planted-bigram prompts, then freed before the
#: next is built. mamba2-130m at full width and depth, dbrx-132b and
#: deepseek-v2-236b at full width with 2 of their 40 and 60 layers (the
#: reference's own consistency test runs them at num_layers=2,
#: tests/test_models.py:96; the MoE configs are trained only reduced, one
#: step: a full-width dbrx layer's weights, gradients and moments alone
#: would fill the card), jamba-1.5-large-398b reduced (one period at full
#: width is 4.51e10 parameters, 180 GB in fp32), whisper-tiny at full size
#: on its published 448-position decoder context (n_text_ctx: 432-token
#: prompts, 16 generated) over 1,500 stub frames, and qwen2-vl-7b at full
#: width and depth on 2,048-token prompts whose first 1,024 positions are
#: stub patch embeddings (``data.pipeline.stub_inputs``). Path names (``path``) key the
#: kernels' records; ``trained`` says how each is trained
#: (``_lm_family_train``; ``train`` overrides LM_FAMILY_TRAIN's size and
#: rate, ``yardstick`` adds the yardstick step at full size); ``prompt``
#: overrides LM_FAMILY_SERVE's; ``prefix``
#: is the length of the prefix prefill held, with the next decode, against
#: forward_train (not for the MoE configs: a shorter group routes
#: differently); a prefill's flash launches are ``_flash_layers``
LM_FAMILY_SERVE = dict(batch=4, prompt=1024, gen=16)
LM_FAMILIES = (
    dict(arch="mamba2-130m", path="lm_mamba2", layers=None, reduced=False, trained="full",
         prefix=768),
    dict(arch="dbrx-132b", path="lm_dbrx", layers=2, reduced=False, trained="reduced"),
    dict(arch="deepseek-v2-236b", path="lm_deepseek", layers=2, reduced=False,
         trained="reduced"),
    dict(arch="jamba-1.5-large-398b", path="lm_jamba", layers=None, reduced=True,
         trained="yardstick"),
    dict(arch="whisper-tiny", path="lm_whisper", layers=None, reduced=False, trained="full",
         train=dict(batch=16, seq=448, lr=5e-3), yardstick=True, prompt=432,
         prefix=416),
    dict(arch="qwen2-vl-7b", path="lm_qwen2vl", layers=None, reduced=False, trained="width",
         prompt=2048, prefix=1536),
)
#: mamba2-130m's full-size run: batch 8 × 1,024 planted-bigram tokens, 20
#: steps of the default AdamW at ``lr`` (scripts/lm_train_lr.py --arch
#: mamba2-130m: drops of 0.259 at 3e-3 and 0.217 at 1e-2, divergence at
#: 3e-2), the loss falling by LM_TRAIN_DROP, then ``profile_steps``
#: profiled; the reduced MoE configs' one step and jamba's yardstick step on
#: ``small``'s batch. whisper-tiny's full-size run (``full`` with its
#: ``train``): the yardstick step at full size, then 20 steps on 16 × 448
#: tokens (its published 448-position decoder context), each with its
#: frames, of the default AdamW at 5e-3. scripts/lm_train_lr.py --arch
#: whisper-tiny --seq-len 448: on 8 × 448 the drop stays below 0.1 at the
#: default warm-up (0.064 at 3e-3, 0.057 at 1e-2, divergence at 3e-2); on
#: 16 × 448, 0.124, 0.113, 0.026 and −0.061 at 5e-3, 1e-2, 2e-2, 3e-2. qwen2-vl-7b
#: (``width``): one counted step at full width with ``qwen2vl["layers"]`` of
#: its 28 layers on ``qwen2vl``'s batch, and the yardstick on the reduced
#: config with as many layers at ``small``'s batch
LM_FAMILY_TRAIN = dict(batch=8, seq=1024, steps=20, lr=3e-3, profile_steps=1,
                       small=dict(batch=4, seq=512),
                       qwen2vl=dict(layers=2, batch=4, seq=2048))
#: one layer's chunked SSD against the sequential scan within the
#: reference's SSD_TOL (tests/test_models.py:29); absorbed MLA decode
#: against the baseline at the reference's MLA_RTOL, MLA_ATOL (:184)
SSD_TOL, MLA_RTOL, MLA_ATOL = 2e-3, 2e-2, 2e-3
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
#: The serving engine (the engine phase): IterativeGP(...).fit(x, y).engine()
#: on the main path's cell (its θ and CG spec) with num_samples 16 and 2,048
#: features, the scheduler's caps at launch/serve_gp.py's defaults; the traffic
#: is serve_gp's defaults (40 requests at depth 8, mix predict 2 : sample 2 :
#: thompson_step 1, 16 query rows from the test points, 4 sample columns, a
#: quarter replayed, Thompson's 128 candidates and 5 ascent steps), driven
#: closed-loop by its drive(), with one write of WRITE_ROWS rows held out of
#: the training set after WRITE_AFTER completions (policy auto); the predict
#: means are held to the Cholesky oracle, a payload served in a full batch
#: and alone to ENGINE_DET_TOL of its scale; the fault path runs at the
#: robust phase's n = 512
ENGINE = dict(num_samples=16, num_features=2048, max_rhs_columns=64, max_batch_requests=16,
              requests=40, depth=8, mix=dict(predict=2, sample=2, thompson_step=1),
              num_rows=16, req_samples=4, repeat=0.25, ascent_steps=5)
WRITE_ROWS, WRITE_AFTER = 4, 20
ENGINE_MEAN_TOL, ENGINE_DET_TOL = 1e-2, 1e-3
#: the Gram kernel's widths in the engine's solve batches (bucketed RHS
#: columns; the fit's 1 + 16 is among the kernels phase's square cases), and
#: the Thompson ascent's query rows: num_top 2 × the 8-column bucket
ENGINE_WIDTHS, ENGINE_ASCENT_ROWS = (8, 16, 32, 64), 16
#: The sparse phase: benchmarks/bench_solvers.py's SVGP(SGPR) row on the
#: main path's cell (its θ, :79-80) at full n, with the bench's inducing
#: inputs Z = x[::n // 512][:512] (:115); sgpr_iterative on its default
#: CG(400, 1e-6), inducing_posterior on 16 samples of 2,048 features and its
#: default CG(200, 1e-5), and the SVGP natural-gradient schedule of
#: tests/test_svgp_inducing.py:64-78 (25 full-batch steps at lr 0.5, then 3
#: on 256-row batches at lr 0.05). Held against the float64 dense SGPR on
#: the same Z: sgpr within SGPR_TOL of its scale, the iterative means and
#: variance within the reference's SPARSE_TOL (tests/test_svgp_inducing.py:
#: 50-51,88) or, where the float64 plain route misses it too, within
#: SPARSE_PLAIN_RATIO × that route's gap; the SVGP mean within the
#: reference's SVGP_TOL (:78)
SPARSE = dict(m=512, num_samples=16, num_features=2048, full_steps=25, full_lr=0.5,
              batch=256, batch_steps=3, batch_lr=0.05)
SGPR_TOL, SPARSE_TOL, SVGP_TOL, SPARSE_PLAIN_RATIO = 1e-2, 5e-2, 0.25, 1.5
#: The LKGP phase: benchmarks/bench_kronecker.py:34-62 at its full size (a
#: 512 × 50 learning-curve grid, 70% density; Matérn-5/2 factors, σ² = 1e-2,
#: 8 samples, 200 iterations) and its standard iterative GP on the same
#: observations (d = 5, Matérn-5/2, noise 0.1, 8 samples on 1,024 features,
#: CG(200)); the LKGP mean at tol 1e-4 held within the reference's LKGP_TOL
#: (tests/test_kronecker.py:70) of the float64 dense posterior mean, and
#: fit_curve_gp's error on the observed cells under CURVE_TOL
#: (tests/test_train.py:131)
LKGP = dict(n_configs=512, n_steps=50, density=0.7, noise=1e-2, num_samples=8,
            max_iters=200, std_noise=0.1, std_features=1024)
LKGP_TOL, CURVE_TOL = 2e-2, 0.1
#: the budget of the LKGP's accuracy check at the reference's tol 1e-4: the
#: bench's 200 iterations leave CG far from converged at this size, in fp32
#: and float64 alike (both residuals are printed), and the fp32 solve
#: reaches 1e-4 in ~1,000
LKGP_CHECK_ITERS = 2000
#: the timed run at the bench's 200 iterations: its fp32 mean's gap from the
#: float64 dense posterior mean is the budget's, so it is held within
#: LKGP_BUDGET_RATIO of the reference's own fp32 gap at that budget on this
#: grid, LKGP_REF_GAP (measured on the CPU by tests/test_torch_kronecker.py::
#: test_lkgp_at_the_bench_budget_misses_where_the_reference_does)
LKGP_REF_GAP, LKGP_BUDGET_RATIO = 0.3276, 1.5
#: CG's column check: one column at width 8 and beside 63 others at width
#: 64, on the first CG_WIDTH_N protein rows at the main path's θ and tol
CG_WIDTH_N = 8192
#: The distributed phase: the CG cell's problem (2,048 prior features, 64
#: samples) split over spawned ranks, the 18-iteration budget of the
#: reference's ring tests (tests/test_distributed_ring.py:124), 200 steps of
#: each stochastic solver, every primitive at P = 4 on the cg_width problem
#: (45,730 rows do not split into 4). Held: CG's iterations within
#: ``iters_rtol`` of single-device CG's, the budget's columns within
#: ``budget_tol`` of scale of single-device CG's. Ring sums each row over P
#: launches, which fp32 CG carries far: its columns are held within
#: ``budget_tol`` of single-device CG on ``RingOrderGram`` (the ring's row
#: sums on one device) and to the float64 route within PARITY_FP64_MARGIN ×
#: the single device's distance from it, and its distance from single-device
#: CG on ``Gram`` at each of ``ring_budgets`` is printed. The stochastic
#: solvers within the stochastic phase's
#: route bound (PARITY_TOL); ring's ``mv`` (P = 2, 4) and primitives (P = 4)
#: within the reference's ring-vs-gather bound (tests/test_distributed_ring.py:49);
#: each rank's Gram and RFF launches against the plain route in float64 on
#: the same inputs at the kernels phase's GRAM_TOL and RFF_TOL.
#: ``auto_budget_bytes`` is under protein's 1.6 MB (n, d) panel, so auto
#: resolves to ring. Timeouts in seconds: a spawned run, a collective.
DIST = dict(features=2048, samples=64, budget=18, steps=200, p4_n=CG_WIDTH_N,
            iters_rtol=0.15, budget_tol=1e-4,
            ring_budgets=(2, 4, 6, 8, 10, 12, 14, 16, 18), stoch_tol=PARITY_TOL,
            prim_tol=1e-5, auto_budget_bytes=1 << 20, mv_reps=5, kernel_reps=5, plain_reps=3,
            run_timeout=600, group_timeout=300)
#: the kernels' records on the last lines, in order: the fp32 kernels, then
#: the bf16 tiles of the GP kernels and flash attention's bf16 inputs
#: (``[bf16]``), each its own record
BF16_RECORDS = ("gram_matvec[bf16]", "gram_rows_pair[bf16]", "rff_matvec[bf16]",
                "rff_t_matvec[bf16]", "rff_pair[bf16]", "gram_matvec_bwd[bf16]",
                "rff_bwd[bf16]", "flash_attention[bf16]")
FP32_RECORDS = ("gram_matvec", "gram_matvec_bwd", "rff_matvec", "gram_rows_pair",
                "rff_t_matvec", "rff_pair", "rff_bwd", "flash_attention")
RECORDS = FP32_RECORDS + BF16_RECORDS
#: a bf16 kernel against its bf16 plain version (the same cast points, fp32
#: sums: one bf16 ulp of a panel entry now and then flips with the summation
#: order) and against the fp32 kernel (tests/test_pair_and_precision.py:164,
#: 174), and a bf16 solve's first PARITY_STEPS steps against the fp32 solve's
#: on the same draws (:209-221), each of max(1, scale)
BF16_TOL, BF16_FP32_TOL, BF16_SOLVE_TOL = 2e-3, 5e-2, 8e-2
#: AP solves each block exactly in fp32 and updates the residual through the
#: bf16 contraction, so its bf16 iterate drifts from its fp32 one past
#: BF16_SOLVE_TOL in the reference's own bf16 route: AP_REF_GAP is the JAX
#: package's bf16-vs-fp32 gap of max(1, scale) after PARITY_STEPS steps at
#: this phase's problem (protein's n, θ and 64 prior draws on 2,048
#: features, blocks of 512), measured on the CPU by tests/
#: test_torch_precision.py::test_ap_bf16_reference_gap_at_protein_n; the
#: kernel route's AP is held within AP_REF_RATIO of it, SGD and SDD within
#: BF16_SOLVE_TOL
AP_REF_GAP, AP_REF_RATIO = 0.2343, 1.5
#: bf16 on the tensor cores, dense (H100 SXM, 700 W)
PEAK_BF16_FLOPS = 989e12
#: flash attention on bf16 inputs against its bf16 plain version (both round
#: their outputs to bf16, and p is rounded against the running max in the
#: kernel, the final one in the plain version: a bf16 ulp of an output is
#: 2^-8 of it) and against the fp32 kernel on the same bf16-valued inputs
#: (the reference's own bf16 tolerance, tests/test_kernels_pallas.py:84),
#: each of max(1, scale)
FLASH_BF16_TOL, FLASH_BF16_FP32_TOL = 1e-2, 3e-2
#: a bf16 backward kernel or gradient against its bf16 plain version run in
#: float64 (the cast points exactly, the sums exact): within BF16_GRAD_TOL,
#: or BF16_PLAIN_RATIO × the plain version's own error run in fp32, if larger
#: (d² from the identity on rounded points loses ~1e-7 of |x|² to fp32
#: rounding, which κ' amplifies at small distances: 2e-3 of the Gram
#: gradient's scale on the CPU at n = 3,000); against the fp32 kernels'
#: gradient within BF16_GRAD_RATIO × the plain bf16 route's own gap from
#: fp32 or BF16_FP32_TOL, if larger (bf16's error is the reference's design:
#: dx = 2(x ΣW − W z) rounds W z, not x ΣW). Gradients by relative norm
#: errors, kernels by max(1, scale)
BF16_GRAD_TOL, BF16_PLAIN_RATIO, BF16_GRAD_RATIO = 2e-3, 2.0, 1.5
#: LM serving in bf16: the bf16 prefill's last-position logits against the
#: fp32 run's, of max(1, max|fp32 logits|); a greedy token is held to the
#: fp32 run's where the fp32 top-2 margin exceeds LM_BF16_MARGIN × the
#: measured logit difference (no larger difference can reorder the two)
LM_BF16_LOGIT_TOL, LM_BF16_MARGIN = 1e-1, 2.0

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
        if hasattr(w, "bf16_launches"):
            w.bf16_launches = 0


def _read_counts() -> tuple:
    """(launches by wrapper, Gram dispatches, feature dispatches) since the
    last reset, read just after a path ran."""
    from repro_torch.kernels import ops

    return ({k: w.launches for k, w in _wrappers().items()},
            dict(ops.MATVEC_TRACE_COUNTS), dict(ops.FEATURE_TRACE_COUNTS))


def _read_bf16_counts() -> dict:
    """The bf16 kernels' launches by wrapper since the last reset."""
    return {k: w.bf16_launches for k, w in _wrappers().items() if hasattr(w, "bf16_launches")}


def _bf16_path_launches(bf16: dict) -> dict:
    """A path's bf16 launches by bf16 record, counted as ``_path_launches``
    counts the fp32 ones."""
    return {"gram_matvec[bf16]": bf16["gram_matvec"],
            "gram_rows_pair[bf16]": bf16["gram_rows_pair"] + bf16["gram_rows_matvec"],
            "rff_matvec[bf16]": bf16["rff_matvec"] + bf16["rff_pair"],
            "rff_t_matvec[bf16]": bf16["rff_t_matvec"] + bf16["rff_pair"],
            "rff_pair[bf16]": bf16["rff_pair"],
            "gram_matvec_bwd[bf16]": bf16["gram_matvec_bwd"], "rff_bwd[bf16]": bf16["rff_bwd"],
            "flash_attention[bf16]": bf16["flash_attention"]}


def _path_launches(launches: dict) -> dict:
    """A path's launches by kernel record: the row-panel record counts both
    of its C entries (the pair and the rows matvec), and every feature-pair
    launch runs the RFF kernel's Φ̃ᵀu orientation (phase 1, under
    ``rff_t_matvec``) and its Φ̃W orientation (phase 2, under ``rff_matvec``)."""
    out = {k: launches[k] for k in FP32_RECORDS}
    out["gram_rows_pair"] += launches["gram_rows_matvec"]
    out["rff_t_matvec"] += launches["rff_pair"]
    out["rff_matvec"] += launches["rff_pair"]
    return out


def _record_path(kernels: dict, path: str, launches: dict, bf16: dict = None) -> None:
    """A path's launches under each record, from the counts its run read just
    after it ran: the fp32 kernels' ``launches`` and the bf16 kernels'
    ``bf16`` (``_read_bf16_counts``). An fp32 path may pass no ``bf16``: it
    records none, and none is checked here (the counts only grow between
    resets, so none now means none in its run)."""
    if bf16 is None:
        bf16 = _read_bf16_counts()
        check(not any(bf16.values()), f"{path}: no bf16 kernel launched: {bf16}")
    for k, n in {**_path_launches(launches), **_bf16_path_launches(bf16)}.items():
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
    grad_phase(torch, kernels)
    trained = train_phase(torch, kernels)
    precond_phase(torch, kernels, oracle, trained)
    robust_phase(torch, kernels)
    stochastic_phase(torch, kernels, oracle)
    route_parity_phase(torch)
    thompson_phase(torch, kernels)
    engine = engine_phase(torch, kernels, oracle)
    cg_width_phase(torch)
    distributed_phase(torch, kernels, oracle)
    sparse = sparse_phase(torch, kernels)
    lkgp = lkgp_phase(torch, kernels)
    lm_serve_phase(torch, kernels)
    lm_train_phase(torch, kernels)
    lm_families_phase(torch, kernels)
    profile_phase(torch, engine, sparse, lkgp)
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
    from repro_torch.serve.engine import RHS_SLICE

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
        (n, d), m = rows.shape, cols.shape[0]
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

    # the serving engine's solve batches at each bucketed width, the widest
    # its line
    paths["engine"] = {}
    for s in ENGINE_WIDTHS:
        paths["engine"]["gram_matvec"] = gram_case("matern32", xs, xs, s, "square_engine")

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

    def rff_case(rows, omega, s, label):
        w = torch.randn((2 * omega.shape[0], s), generator=gen, device=dev)
        out = rff_matvec(rows, omega, w)
        ref64 = rff_matvec_ref(rows.double(), omega.double(), w.double())
        ref32 = rff_matvec_ref(rows, omega, w)
        torch.cuda.synchronize()
        err = (out.double() - ref64).abs().max().item()
        scale = max(1.0, ref64.abs().max().item())
        (n, d), m = rows.shape, omega.shape[0]
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
        return line

    for rows, omega, label, widths in ((x, serve_omega, "train", (RHS_SLICE, 16, 64)),
                                       (xt, serve_omega, "test", (16, 64)),
                                       (x, train_omega, "mll_prior", (TRAIN_PROBES,))):
        for s in widths:
            line = rff_case(rows, omega, s, label)
            if label == "train" and s == 64:  # f_X on the serving path
                paths["fit_predict"]["rff_matvec"] = line
            if label == "train" and s == RHS_SLICE:  # the engine's RHS launches
                paths["engine"]["rff_matvec"] = line
            if label == "mll_prior":  # f_X on the training path
                paths["train"]["rff_matvec"] = line

    # the sparse phase's three NormalEq products, K_XZ·u (n × m),
    # K_ZX·(K_XZ·u) (m × n) and K_ZZ·u (m × m), at the SGPR fit's 1 column
    # (and its right-hand side K_ZX y), the inducing solve's 17 (and its
    # right-hand side) and the SGPR variance solve's 1,024; the inducing
    # prior's f_X on 16 samples of 2,048 features. Every shape a path runs
    # is listed under its ``shapes``.
    paths.update(sgpr_iterative={}, inducing={}, lkgp_standard={})
    zs = xs[::max(1, xs.shape[0] // SPARSE["m"])][:SPARSE["m"]].contiguous()
    for s in (1, SPARSE["num_samples"] + 1, xt.shape[0]):
        on = ("sgpr_iterative",) if s != SPARSE["num_samples"] + 1 else ("inducing",)
        for rows, cols, label in ((xs, zs, "sparse_nm"), (zs, xs, "sparse_mn"),
                                  (zs, zs, "sparse_mm")):
            line = gram_case("matern32", rows, cols, s, label)
            for path in on:
                _path_shape(paths, path, "gram_matvec", line)
            if label == "sparse_nm" and s == xt.shape[0]:
                paths["sgpr_iterative"]["gram_matvec"] = line
            if label == "sparse_nm" and s == SPARSE["num_samples"] + 1:
                paths["inducing"]["gram_matvec"] = line
    paths["inducing"]["rff_matvec"] = rff_case(x, serve_omega, SPARSE["num_samples"],
                                               "inducing_prior")
    lkgp_kernel_cases(torch, gram_case, rff_case, gen, paths)

    paths.update(sgd={}, sdd={}, ap={}, thompson={}, lm_serve={}, lm_train={}, lm_dbrx={},
                 lm_jamba={}, lm_whisper={}, lm_qwen2vl={})
    new_kernels_cases(torch, x, xs, rff_omega, gen, rec, paths)
    rff_bwd_cases(torch, x, rff_omega, gen, rec)
    thompson_kernel_cases(torch, gen, rec, paths)
    engine_kernel_cases(torch, x, xs, serve_omega, gen, rec, paths)
    flash_cases(torch, gen, rec, paths)
    paths.update(sgd_bf16={}, sdd_bf16={}, ap_bf16={})
    bf16_kernel_cases(torch, x, xs, rff_omega, gen, rec, paths)
    paths.update(grad_bf16={}, lm_serve_bf16={})
    bf16_backward_cases(torch, x, xtr, rff_omega, gen, rec, paths)
    flash_bf16_cases(torch, gen, rec, paths)

    keep = ("s", "m", "p", "rows", "cols", "ctas", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "sfu_floor_ms", "tc_split_bound_ms", "tile_bound_ms")
    # each record's own numbers: the training path's shape for the kernels of
    # the first slices, SGD's for the row-panel and feature-pair kernels, the
    # Thompson ascent's for the RFF backward, LM serving's for flash attention.
    # Only attention has one PyTorch call for the same function (SDPA); the
    # GP kernels' fused functions have none.
    home = dict(gram_matvec="train", gram_matvec_bwd="train", rff_matvec="train",
                gram_rows_pair="sgd", rff_t_matvec="sgd", rff_pair="sgd",
                rff_bwd="thompson", flash_attention="lm_serve",
                **{"gram_matvec[bf16]": "ap_bf16", "gram_rows_pair[bf16]": "sgd_bf16",
                   "rff_matvec[bf16]": "sgd_bf16", "rff_t_matvec[bf16]": "sgd_bf16",
                   "rff_pair[bf16]": "sgd_bf16", "gram_matvec_bwd[bf16]": "grad_bf16",
                   "rff_bwd[bf16]": "grad_bf16", "flash_attention[bf16]": "lm_serve_bf16"})
    for key in rec:
        line = paths[home[key]][key]
        rec[key].update({k: line[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        library_ms=line.get("library_ms"),
                        **{k: line[k] for k in ("sfu_floor_ms", "tc_split_bound_ms",
                                                "tile_bound_ms") if k in line},
                        by_path={p: _path_line(lines, key, keep)
                                 for p, lines in paths.items() if key in lines})
    # the rows matvec (SDD's entry of the row-panel source) under its record
    for path, key, rows in (("sdd", "gram_rows_pair", "gram_rows_matvec"),
                            ("thompson", "gram_rows_pair", "gram_rows_matvec"),
                            ("sdd_bf16", "gram_rows_pair[bf16]", "gram_rows_matvec[bf16]")):
        rec[key]["by_path"][path] = {k: paths[path][rows][k] for k in keep
                                     if k in paths[path][rows]}
    return rec


def _path_shape(paths: dict, path: str, key: str, line: dict) -> None:
    """List ``line`` (a kernel case) among the shapes ``path`` runs ``key`` at."""
    paths[path].setdefault("shapes", {}).setdefault(key, []).append(line)


def _path_line(lines: dict, key: str, keep) -> dict:
    """A path's entry in a kernel record: its line's numbers, and each shape
    it runs the kernel at with its own."""
    out = {k: lines[key][k] for k in keep if k in lines[key]}
    shapes = lines.get("shapes", {}).get(key)
    if shapes:
        out["shapes"] = [{k: line[k] for k in ("case", "kind", "n", "m", "d", "s", "ms",
                                                "plain_ms", "bound_ms", "max_abs_err", "tol")
                          if k in line}
                         for line in shapes]
    return out


def _lkgp_inputs(torch):
    """The LKGP phase's grid (grid_curves at bench_kronecker's full size), its
    observed flat indices, and the standard GP's 5-D inputs: each grid cell's
    config features beside its log-step, all cells and the observed ones."""
    from repro_torch.data.pipeline import grid_curves

    cfg, dev = LKGP, torch.device("cuda")
    data = grid_curves(cfg["n_configs"], cfg["n_steps"], cfg["density"], seed=SEED)
    idx = torch.as_tensor(data["mask"].reshape(-1).nonzero()[0], device=dev)
    g1 = torch.as_tensor(data["grid1"], device=dev)
    g2 = torch.as_tensor(data["grid2"], device=dev)
    x_all = torch.cat([g1.repeat_interleave(cfg["n_steps"], dim=0),
                       g2.repeat(cfg["n_configs"], 1)], dim=1)
    return data, idx, x_all, x_all[idx].contiguous()


def lkgp_kernel_cases(torch, gram_case, rff_case, gen, paths) -> None:
    """The LKGP phase's standard GP: its CG matvec on the 17,742 observed
    cells (d = 5, Matérn-5/2 at ℓ = 1, 1 + 8 columns) and its prior f_X on
    8 samples of 1,024 features."""
    from repro_torch.core.kernels_fn import make_params, spectral_sample

    _, _, x_all, x_obs = _lkgp_inputs(torch)
    d = x_obs.shape[1]
    line = gram_case("matern52", x_obs, x_obs, 1 + LKGP["num_samples"], "lkgp_standard")
    paths["lkgp_standard"]["gram_matvec"] = line
    _path_shape(paths, "lkgp_standard", "gram_matvec", line)
    # its predict on the whole grid: the mean (1 column) and the samples' update
    for s in (1, LKGP["num_samples"]):
        _path_shape(paths, "lkgp_standard", "gram_matvec",
                    gram_case("matern52", x_all, x_obs, s, "lkgp_predict"))
    params = make_params("matern52", lengthscale=1.0, d=d, device=x_obs.device)
    omega = spectral_sample(params, LKGP["std_features"] // 2, d, generator=gen)
    paths["lkgp_standard"]["rff_matvec"] = rff_case(x_obs, omega, LKGP["num_samples"],
                                                    "lkgp_standard")


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


def _bf16_bound(entries, per_entry, nbytes) -> dict:
    """The bound of a bf16 kernel over ``entries`` kernel entries (row,
    column or row, frequency pairs), each ``per_entry`` flops of products of
    bf16 operands: the distance or the projection (2d, on the rounded
    operands, which the kernels run on the FMA pipes) and the contractions
    (2s each), all at the bf16 tensor-core rate, the rate the card has for
    that type; ``bound_ms`` the larger of that and ``nbytes`` over the
    memory rate. The SFU floor of the exp, sqrt or sincos is its own column
    (``sfu_floor_ms``)."""
    flops = entries * per_entry
    ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                flops_bf16=flops, bytes=nbytes)


def _bf16_line(torch, rec, key, case, got, plain, fp32, fn, plain_fn, *, tol=BF16_TOL,
               tol_fp32=BF16_FP32_TOL, library_fn=None, **fields) -> dict:
    """One bf16 kernel case: its largest error against its bf16 plain version
    and against the fp32 kernel, over its outputs, absolute (``max_abs_err``,
    ``err_vs_fp32_kernel``) and of max(1, scale) (``rel_err``,
    ``rel_err_vs_fp32_kernel``, checked against ``tol`` and ``tol_fp32``),
    and its CUDA-event time over 20 warm launches beside the plain version's
    over 3 (and ``library_fn``'s over 20, where one PyTorch call computes the
    same function)."""
    def errs(outs, refs):
        pairs = [((a.double() - b.double()).abs().max().item(),
                  max(1.0, b.abs().max().item())) for a, b in zip(outs, refs)]
        return max(e for e, _ in pairs), max(e / sc for e, sc in pairs)

    (e_plain, r_plain), (e_fp32, r_fp32) = errs(got, plain), errs(got, fp32)
    line = dict(kernel=key, case=case, precision="bf16", **fields, max_abs_err=e_plain,
                rel_err=r_plain, tol=tol, err_vs_fp32_kernel=e_fp32,
                rel_err_vs_fp32_kernel=r_fp32, tol_vs_fp32=tol_fp32,
                ms=_events_ms(torch, fn, 20), plain_ms=_events_ms(torch, plain_fn, 3),
                library_ms=None if library_fn is None else _events_ms(torch, library_fn, 20))
    emit("kernels", **line)
    check(r_plain <= tol, f"{key} {case}: {r_plain} from its bf16 plain version")
    check(r_fp32 <= tol_fp32, f"{key} {case}: {r_fp32} from the fp32 kernel")
    rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], e_plain)
    return line


def bf16_kernel_cases(torch, x, xs, rff_omega, gen, rec, paths) -> None:
    """The bf16 tiles at the bf16 paths' shapes, each against its bf16 plain
    version (``precision="bf16"``: the same cast points, products of rounded
    operands summed in fp32, TF32 off) and against its fp32 launch: the Gram
    kernel at 45,730² (finalize's matvec of SGD and SDD) and at AP's 45,730 ×
    512 (``rows_t_mv``), every kind there; the row pair and SDD's rows matvec
    at p = 512 of 45,730; the feature pair and its Φ̃ᵀu at m = 100, Φ̃W at the
    pair's m = 100 and at m = 512, s = 8; s = 65 but where said."""
    from repro_torch.kernels.gram_matvec import (
        gram_matvec, gram_plan, gram_rows_matvec, gram_rows_pair,
    )
    from repro_torch.kernels.ref import (
        gram_matvec_ref, gram_rows_matvec_ref, gram_rows_pair_ref, rff_matvec_ref,
        rff_pair_ref, rff_t_matvec_ref,
    )
    from repro_torch.kernels.rff_matvec import rff_matvec, rff_pair, rff_plan, rff_t_matvec

    bf = dict(precision="bf16")
    for key, src, replaces in (
            ("gram_matvec[bf16]", "gram_matvec_bf16.cu", "src/repro/kernels/gram_matvec.py:154"),
            ("gram_rows_pair[bf16]", "gram_rows_pair.cu", "src/repro/kernels/gram_matvec.py:390"),
            ("rff_matvec[bf16]", "rff_matvec_bf16.cu", "src/repro/kernels/rff_matvec.py:78"),
            ("rff_t_matvec[bf16]", "rff_matvec_bf16.cu", "src/repro/kernels/rff_matvec.py:154"),
            ("rff_pair[bf16]", "rff_matvec_bf16.cu", "src/repro/kernels/rff_matvec.py:447")):
        rec[key] = dict(name=key, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                        replaces=replaces, max_abs_err=0.0)
    rec["gram_rows_pair[bf16]"]["entries"] = ["repro_gram_rows_pair_bf16",
                                             "repro_gram_matvec_bf16"]
    dev = x.device
    n, d = xs.shape
    s, p = 65, 512

    def gram(kind, rows, cols, label):
        v = torch.randn((cols.shape[0], s), generator=gen, device=dev)
        (nr, _), m = rows.shape, cols.shape[0]
        plan = gram_plan(nr, m, d, s)
        line = _bf16_line(
            torch, rec, "gram_matvec[bf16]", label,
            [gram_matvec(rows, cols, v, kind=kind, **bf)],
            [gram_matvec_ref(rows, cols, v, kind=kind, **bf)],
            [gram_matvec(rows, cols, v, kind=kind)],
            lambda: gram_matvec(rows, cols, v, kind=kind, **bf),
            lambda: gram_matvec_ref(rows, cols, v, kind=kind, **bf),
            kind=kind, n=nr, m=m, d=d, s=s, ctas=plan.ctas, chunks=plan.chunks,
            smem_bytes=gram_matvec.smem_bytes(d, s, plan.rows_per_cta, "bf16"),
            sfu_floor_ms=1e3 * nr * m * SFU_OPS[kind] / SFU_OPS_PER_S,
            **_bf16_bound(nr * m, 2 * (d + s), 4 * (nr * d + m * d + m * s + nr * s)))
        return line

    idx = torch.randint(0, n, (p,), generator=gen, device=dev)
    xi = xs[idx].contiguous()
    line = gram("matern32", xs, xs, "square")
    for path in ("sgd_bf16", "sdd_bf16"):  # finalize's matvec
        _path_shape(paths, path, "gram_matvec[bf16]", line)
        paths[path]["gram_matvec[bf16]"] = line
    for kind in KINDS:
        line = gram(kind, xs, xi, "ap_rows_t")
        if kind == "matern32":  # AP's rows_t_mv: K(x, x[idx]) u
            paths["ap_bf16"]["gram_matvec[bf16]"] = line

    look = torch.randn((n, s), generator=gen, device=dev)
    b = torch.randn((p, s), generator=gen, device=dev)
    p_true = p - 7
    panel, back = gram_plan(p, n, d, s), gram_plan(n, p, d, s)
    pair_ref = gram_rows_pair_ref(xi, xs, look, b, kind="matern32", p_true=p_true, **bf)
    got = gram_rows_pair(xi, xs, look, b, kind="matern32", p_true=p_true, **bf)
    check(bool((got[0][p_true:] == 0).all()), "gram_rows_pair[bf16]: rows >= p_true zeroed")
    _, _, nbytes = _rows_bound_ms(p, n, d, s, panel.chunks, True)
    paths["sgd_bf16"]["gram_rows_pair[bf16]"] = _bf16_line(
        torch, rec, "gram_rows_pair[bf16]", "pair", got, pair_ref,
        gram_rows_pair(xi, xs, look, b, kind="matern32", p_true=p_true),
        lambda: gram_rows_pair(xi, xs, look, b, kind="matern32", p_true=p_true, **bf),
        lambda: gram_rows_pair_ref(xi, xs, look, b, kind="matern32", p_true=p_true, **bf),
        kind="matern32", n=n, p=p, p_true=p_true, d=d, s=s, chunks=panel.chunks,
        ctas_phase0=panel.ctas, ctas_phase2=back.ctas,
        sfu_floor_ms=1e3 * 2 * p * n * SFU_OPS["matern32"] / SFU_OPS_PER_S,
        **_bf16_bound(2 * p * n, 2 * (d + s), nbytes))
    _, _, nbytes = _rows_bound_ms(p, n, d, s, panel.chunks, False)
    paths["sdd_bf16"]["gram_rows_matvec[bf16]"] = _bf16_line(
        torch, rec, "gram_rows_pair[bf16]", "rows_matvec",
        [gram_rows_matvec(xi, xs, look, kind="matern32", **bf)],
        [gram_rows_matvec_ref(xi, xs, look, kind="matern32", **bf)],
        [gram_rows_matvec(xi, xs, look, kind="matern32")],
        lambda: gram_rows_matvec(xi, xs, look, kind="matern32", **bf),
        lambda: gram_rows_matvec_ref(xi, xs, look, kind="matern32", **bf),
        kind="matern32", n=n, p=p, d=d, s=s, chunks=panel.chunks, ctas=panel.ctas,
        sfu_floor_ms=1e3 * p * n * SFU_OPS["matern32"] / SFU_OPS_PER_S,
        **_bf16_bound(p * n, 2 * (d + s), nbytes))

    # SGD's fresh features: m = 100 frequencies at the serving θ's ℓ
    omega = rff_omega(math.sqrt(d) * 0.5, 100)
    u = torch.randn((n, s), generator=gen, device=dev)
    m = omega.shape[0]
    plan = rff_plan(n, m, d, s)

    def sfu(passes):
        return 1e3 * passes * n * m * SFU_OPS_RFF / SFU_OPS_PER_S

    _, _, nbytes = _rff_t_bound_ms(n, m, d, s, plan.row_chunks, False)
    paths["sgd_bf16"]["rff_t_matvec[bf16]"] = _bf16_line(
        torch, rec, "rff_t_matvec[bf16]", "sgd", [rff_t_matvec(x, omega, u, **bf)],
        [rff_t_matvec_ref(x, omega, u, **bf)], [rff_t_matvec(x, omega, u)],
        lambda: rff_t_matvec(x, omega, u, **bf), lambda: rff_t_matvec_ref(x, omega, u, **bf),
        n=n, m=m, d=d, s=s, chunks=plan.row_chunks, ctas=plan.t_ctas,
        sfu_floor_ms=sfu(1), **_bf16_bound(n * m, 2 * d + 4 * s, nbytes))
    _, _, nbytes = _rff_t_bound_ms(n, m, d, s, plan.row_chunks, True)
    paths["sgd_bf16"]["rff_pair[bf16]"] = _bf16_line(
        torch, rec, "rff_pair[bf16]", "sgd", [rff_pair(x, omega, u, **bf)],
        [rff_pair_ref(x, omega, u, **bf)], [rff_pair(x, omega, u)],
        lambda: rff_pair(x, omega, u, **bf), lambda: rff_pair_ref(x, omega, u, **bf),
        n=n, m=m, d=d, s=s, chunks=plan.row_chunks, ctas=plan.t_ctas,
        ctas_phase2=plan.mv_ctas, sfu_floor_ms=sfu(2),
        **_bf16_bound(2 * n * m, 2 * d + 4 * s, nbytes))
    for label, om, width in (("sgd_phase2", omega, s),
                             ("train", rff_omega(TRAIN_HYPERS["lengthscale"], 512), 8)):
        w = torch.randn((2 * om.shape[0], width), generator=gen, device=dev)
        mm, wplan = om.shape[0], rff_plan(n, om.shape[0], d, width)
        _, _, nbytes = _rff_bound_ms(n, mm, d, width)
        line = _bf16_line(
            torch, rec, "rff_matvec[bf16]", label, [rff_matvec(x, om, w, **bf)],
            [rff_matvec_ref(x, om, w, **bf)], [rff_matvec(x, om, w)],
            lambda: rff_matvec(x, om, w, **bf), lambda: rff_matvec_ref(x, om, w, **bf),
            n=n, m=mm, d=d, s=width, chunks=wplan.freq_chunks, ctas=wplan.mv_ctas,
            smem_bytes=rff_matvec.smem_bytes(d, width, "bf16"),
            sfu_floor_ms=1e3 * n * mm * SFU_OPS_RFF / SFU_OPS_PER_S,
            **_bf16_bound(n * mm, 2 * d + 4 * width, nbytes))
        _path_shape(paths, "sgd_bf16", "rff_matvec[bf16]", line)
        if label == "sgd_phase2":
            paths["sgd_bf16"]["rff_matvec[bf16]"] = line


def _bf16_record(rec, key, src, replaces) -> None:
    rec[key] = dict(name=key, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=replaces, max_abs_err=0.0)


def bf16_backward_cases(torch, x, xtr, rff_omega, gen, rec, paths) -> None:
    """The backward kernels' bf16 tiles, each against its bf16 plain version
    run in float64 on the first CHECK_ROWS output rows (the bf16 cast points
    exactly, the sums exact) and against the fp32 launch: the Gram backward at
    training's 45,730², d = 9, Matérn-3/2, s = 8 (the grad phase's shape) and
    at the Thompson ascent's 400 × 50,000, s = 100; the RFF backward at 400
    rows × 512 frequencies, d = 8, s = 100, at the engine's 16 rows × 1,024,
    d = 9, s = 8, and at the grad phase's 45,730 × 512, d = 9, s = 8; against
    the fp32 launch within BF16_GRAD_RATIO × the bf16 plain version's own gap
    from it (or BF16_FP32_TOL): the bf16 projection of the Thompson shape's
    large frequencies is ~10% of scale from fp32 by the reference's design
    (x and ω rounded before sin and cos). Each
    line gives the kernel's ms beside the bf16 bound (``bound_ms``: its
    products at the bf16 tensor-core rate, or its bytes), the fp32 record's
    bound on the same shape (``bound_fp32_ms``), the bytes' time
    (``bytes_ms``), the SFU floor and the CTAs."""
    from repro_torch.core.kernels_fn import make_params, spectral_sample
    from repro_torch.kernels.gram_matvec import gram_bwd_plan, gram_matvec_bwd
    from repro_torch.kernels.ref import gram_matvec_bwd_ref, rff_bwd_ref
    from repro_torch.kernels.rff_matvec import rff_bwd, rff_bwd_plan

    _bf16_record(rec, "gram_matvec_bwd[bf16]", "gram_matvec_bwd_bf16.cu",
                 "src/repro/kernels/gram_matvec.py:250")
    _bf16_record(rec, "rff_bwd[bf16]", "rff_bwd_bf16.cu", "src/repro/kernels/rff_matvec.py:252")
    dev, bf = xtr.device, dict(precision="bf16")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def gram(rows, cols, s, kind, label):
        (n, d), m = rows.shape, cols.shape[0]
        rowv, colv = randn(n, s), randn(m, s)
        k = min(n, CHECK_ROWS)
        plan = gram_bwd_plan(n, m, d, s, precision="bf16")
        ref64 = gram_matvec_bwd_ref(rows[:k].double(), cols.double(), rowv[:k].double(),
                                    colv.double(), kind=kind, row_chunk=256, **bf)
        plain32 = _scaled_err(gram_matvec_bwd_ref(rows[:k], cols, rowv[:k], colv, kind=kind,
                                                  **bf), ref64)
        fp32 = gram_matvec_bwd(rows, cols, rowv, colv, kind=kind)[:k]
        gap = _scaled_err(ref64, fp32)
        fp32_bound, flops, nbytes = _gram_bwd_bound_ms(n, m, d, s)
        return _bf16_line(
            torch, rec, "gram_matvec_bwd[bf16]", label,
            [gram_matvec_bwd(rows, cols, rowv, colv, kind=kind, **bf)[:k]], [ref64], [fp32],
            lambda: gram_matvec_bwd(rows, cols, rowv, colv, kind=kind, **bf),
            lambda: gram_matvec_bwd_ref(rows, cols, rowv, colv, kind=kind, **bf),
            tol=max(BF16_GRAD_TOL, BF16_PLAIN_RATIO * plain32), plain_fp32_rel_err=plain32,
            tol_fp32=max(BF16_FP32_TOL, BF16_GRAD_RATIO * gap), plain_bf16_vs_fp32=gap,
            kind=kind, n=n, m=m, d=d, s=s, checked_rows=k, ctas=plan.ctas,
            chunks=plan.chunks, width=plan.width,
            smem_bytes=gram_matvec_bwd.smem_bytes(d, s, precision="bf16"),
            sfu_floor_ms=1e3 * n * m * SFU_OPS_BWD[kind] / SFU_OPS_PER_S,
            bound_fp32_ms=fp32_bound, bytes_ms=1e3 * nbytes / PEAK_BYTES,
            **_bf16_bound(n * m, 4 * d + 2 * s, nbytes))

    paths["grad_bf16"]["gram_matvec_bwd[bf16]"] = gram(xtr, xtr, 8, "matern32", "train")
    t = THOMPSON
    xq = (torch.rand((t["num_top"] * t["acq_batch"], t["d"]), generator=gen, device=dev)
          / t["lengthscale"]).contiguous()
    xo = (torch.rand((t["n0"], t["d"]), generator=gen, device=dev)
          / t["lengthscale"]).contiguous()
    gram(xq, xo, t["acq_batch"], t["kind"], "thompson")
    del xo

    def rff(r, c, s, label):
        (rows, d), cols = r.shape, c.shape[0]
        p, q1, q2 = randn(rows, s), randn(cols, s), randn(cols, s)
        scale = math.sqrt(1.0 / cols)
        k = min(rows, CHECK_ROWS)
        plan = rff_bwd_plan(rows, cols, d, s, precision="bf16")
        ref64 = rff_bwd_ref(r[:k].double(), c.double(), p[:k].double(), p[:k].double(),
                            q1.double(), q2.double(), scale=scale, **bf)
        plain32 = _scaled_err(rff_bwd_ref(r[:k], c, p[:k], p[:k], q1, q2, scale=scale, **bf),
                              ref64)
        fp32 = rff_bwd(r, c, p, p, q1, q2, scale=scale)[:k]
        gap = _scaled_err(ref64, fp32)
        fp32_bound, flops, nbytes = _rff_bwd_bound_ms(
            rows, cols, d, s, plan.workspace_floats(rows, d), (r, c, p, q1, q2))
        return _bf16_line(
            torch, rec, "rff_bwd[bf16]", label,
            [rff_bwd(r, c, p, p, q1, q2, scale=scale, **bf)[:k]], [ref64], [fp32],
            lambda: rff_bwd(r, c, p, p, q1, q2, scale=scale, **bf),
            lambda: rff_bwd_ref(r, c, p, p, q1, q2, scale=scale, **bf),
            tol=max(BF16_GRAD_TOL, BF16_PLAIN_RATIO * plain32), plain_fp32_rel_err=plain32,
            tol_fp32=max(BF16_FP32_TOL, BF16_GRAD_RATIO * gap), plain_bf16_vs_fp32=gap,
            rows=rows, cols=cols, d=d, s=s, checked_rows=k, ctas=plan.ctas,
            chunks=plan.chunks, slices=plan.slices, width=plan.width,
            smem_bytes=rff_bwd.smem_bytes(d, s, precision="bf16"),
            sfu_floor_ms=1e3 * rows * cols * SFU_OPS_RFF / SFU_OPS_PER_S,
            bound_fp32_ms=fp32_bound, bytes_ms=1e3 * nbytes / PEAK_BYTES,
            **_bf16_bound(rows * cols, 4 * d + 4 * s, nbytes))

    t_omega = spectral_sample(make_params(t["kind"], lengthscale=t["lengthscale"], d=t["d"],
                                          device=dev), 512, t["d"], generator=gen)
    rff(torch.rand((400, t["d"]), generator=gen, device=dev), t_omega, t["acq_batch"],
        "thompson")
    d = x.shape[1]
    rff(torch.rand((ENGINE_ASCENT_ROWS, d), generator=gen, device=dev),
        rff_omega(math.sqrt(d) * 0.5, 1024), 8, "engine_ascent")
    paths["grad_bf16"]["rff_bwd[bf16]"] = rff(
        x, rff_omega(TRAIN_HYPERS["lengthscale"], 512), 8, "grad_dx")


def flash_bf16_cases(torch, gen, rec, paths) -> None:
    """Flash attention on bf16 q, k and v (``csrc/flash_attention_bf16.cu``)
    at FLASH_CASES' lm_serve, ragged, ragged_full (non-causal) and d64
    shapes, against its bf16 plain version (FLASH_BF16_TOL) and against the
    fp32 kernel on the same bf16-valued inputs (FLASH_BF16_FP32_TOL), the
    same bits on two launches, beside SDPA on the same bf16 tensors
    (``enable_gqa``, (b, h, s, d) copies made beforehand) as the library's
    time. The bound counts the products at the bf16 tensor-core rate and
    bf16 bytes; the floors count the 128 × 128 tiles the kernel visits
    (``_flash_floors``); ``items`` is its work items (128 query rows of a
    batch × query head), ``ctas`` its persistent CTAs. The kernel's
    registers, spills and shared memory from the build's ptxas log come on
    a line of their own first."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, query_blocks
    from repro_torch.kernels.ref import flash_attention_ref

    _bf16_record(rec, "flash_attention[bf16]", "flash_attention_bf16.cu",
                 "src/repro/kernels/flash_attention.py:72")
    info = _build._INFO or _build.build()
    emit("kernel_build", kernel="flash_attention[bf16]",
         ptxas=[k for k in info.ptxas if "flash_attention_bf16_kernel" in k["name"]],
         smem_bytes={d: flash_attention.smem_bytes(d, "bf16") for d in (64, 128)})
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, s, hq, hkv, d, causal in FLASH_CASES[:4]:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
                   for h in (hq, hkv, hkv))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        fp32_bound, flops, nbytes = _flash_bound_ms(b, s, hq, hkv, d, causal)
        items = b * hq * query_blocks(s, "bf16")
        out = flash_attention(q, k, v, causal=causal)
        same_bits = bool(torch.equal(out, flash_attention(q, k, v, causal=causal)))
        line = _bf16_line(
            torch, rec, "flash_attention[bf16]", label, [out],
            [flash_attention_ref(q, k, v, causal=causal)],
            [flash_attention(q.float(), k.float(), v.float(), causal=causal)],
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: flash_attention_ref(q, k, v, causal=causal),
            tol=FLASH_BF16_TOL, tol_fp32=FLASH_BF16_FP32_TOL,
            library_fn=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal, items=items, ctas=min(items, sms),
            same_bits=same_bits, smem_bytes=flash_attention.smem_bytes(d, "bf16"),
            **_flash_floors(b, s, hq, d, causal, "bf16"),
            bound_fp32_ms=fp32_bound, bytes_ms=1e3 * (nbytes / 2) / PEAK_BYTES,
            **_bf16_bound(flops, 1, nbytes // 2))
        check(same_bits, f"flash_attention[bf16] {label}: the same bits on two launches")
        if label == "lm_serve":
            paths["lm_serve_bf16"]["flash_attention[bf16]"] = line


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


def engine_kernel_cases(torch, x, xs, omega, gen, rec, paths) -> None:
    """The backward kernels at the serving engine's Thompson ascent, against
    their plain versions in float64: ENGINE_ASCENT_ROWS query rows against
    protein's n = 45,730 points at the engine's 8-column bucket, the Gram
    backward's ∂x and the RFF backward's ∂x on the 2,048-feature prior."""
    dev, (n, d) = x.device, x.shape
    ls, rows, s, m = math.sqrt(d) * 0.5, ENGINE_ASCENT_ROWS, 8, omega.shape[0]
    xq = torch.rand((rows, d), generator=gen, device=dev)
    g = torch.randn((rows, s), generator=gen, device=dev)
    v = torch.randn((n, s), generator=gen, device=dev)
    paths["engine"]["gram_matvec_bwd"] = _bwd_line(
        torch, rec, (xq / ls).contiguous(), xs, g, v, "matern32", "engine_ascent", False)
    w = torch.randn((2 * m, s), generator=gen, device=dev)
    paths["engine"]["rff_bwd"] = _rff_bwd_case(
        torch, rec, "engine_ascent_dx", xq, omega, g, g, w[:m].contiguous(),
        w[m:].contiguous(), math.sqrt(1.0 / m))


def _flash_bound_ms(b, s, hq, hkv, d, causal):
    """2d flops for q·k and 2d for p·v per visible (query, key) pair, of which
    there are b·hq·s(s + 1)/2 when causal and b·hq·s² otherwise; q and the
    output at hq heads, k and v at hkv heads, each read or written once."""
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    flops = 4 * d * pairs
    nbytes = 4 * 2 * b * s * d * (hq + hkv)
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES), flops, nbytes


def _flash_floors(b, s, hq, d, causal, precision="fp32") -> dict:
    """A flash kernel's own floors over the (row, key) pairs it computes:
    BLOCKS[precision]² a visited key tile (causal: tiles 0 to the block's
    own), an exp a pair on the SFU (``sfu_floor_ms``); for the fp32 kernel
    2 × 2d flops a pair in the three-way TF32 split, 3 × that, at 495 TFLOP/s
    (``tc_split_bound_ms``), where a diagonal tile's warp skips the n-tiles
    past its rows (2,560 of its 4,096 pairs computed); for the bf16 kernel
    2 × 2d flops a pair of every visited tile, whole, at the bf16
    tensor-core rate (``tile_bound_ms``)."""
    from repro_torch.kernels.flash_attention import BLOCKS

    block = BLOCKS[precision]
    nq = -(-s // block)
    tiles = nq * (nq + 1) // 2 if causal else nq * nq
    pairs = b * hq * tiles * block ** 2
    out = dict(sfu_floor_ms=1e3 * pairs / SFU_OPS_PER_S)
    if precision == "bf16":
        out.update(tile_bound_ms=1e3 * pairs * 4 * d / PEAK_BF16_FLOPS)
    else:
        mma_pairs = pairs - (b * hq * nq * (block ** 2 - 2560) if causal else 0)
        out.update(tc_split_bound_ms=1e3 * mma_pairs * 3 * 4 * d / PEAK_TF32_FLOPS)
    return out


def flash_cases(torch, gen, rec, paths) -> None:
    """The flash-attention kernel against its plain version in float64 on the
    card (FLASH_CASES): the serving path's shape, s = 1,000 causal and not
    (the ragged last block masked by bounds), d = 64 and the training path's
    shape (olmo-1b's 16 heads of 128, batch 8 × 1,024). Times: the kernel
    over 20 warm launches, the fp32 plain version over 3 calls, and SDPA
    (``scaled_dot_product_attention`` with ``enable_gqa``, on (b, h, s, d)
    copies made beforehand) over 20, by CUDA events. Both calls of the
    kernel give the same bits. whisper-tiny's encoder and decoder shapes and
    qwen2-vl-7b's are the families' paths."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, query_blocks
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
            causal=causal, ctas=b * hq * query_blocks(s, "fp32"), max_abs_err=err,
            rel_err=err / scale,
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
        if label in FLASH_PATHS:
            path = FLASH_PATHS[label]
            paths[path].setdefault("flash_attention", line)
            if list(FLASH_PATHS.values()).count(path) > 1:
                _path_shape(paths, path, "flash_attention", line)


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


def grad_phase(torch, kernels: dict) -> None:
    """∇θ of the MLL estimator's quadratic forms (``mll._quad``: the fit term
    at s = 1, the trace term at s = 8) through the kernels, against the same
    forms through the plain autograd Function in float64 on the card, at
    GRAD_N protein rows and θ₀ of the training path. u and w are held fixed:
    the solutions v_y and α of one ``mll_grad`` there. The trace term's w
    also requires grad, so dv runs the forward kernel on swapped operands.
    Then the bf16 gradients at protein's full n (``grad_bf16_phase``)."""
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
    grad_bf16_phase(torch, kernels)


#: the kernel ops that the plain route replaces, by the plain Function of each
_PLAIN_ROUTE = {"_gram_kernel": "plain_gram_matvec", "_pair_kernel": "plain_gram_rows_pair",
                "_rff_kernel": "plain_rff_matvec", "_rff_t_kernel": "plain_rff_t_matvec",
                "_rff_pair_kernel": "plain_rff_pair"}


@contextlib.contextmanager
def _plain_route():
    """``kernels.ops`` with the plain autograd Functions in place of the
    kernel wrappers, on the same card tensors: the reference's VJPs on the
    plain versions, at the same tile precision."""
    from repro_torch.kernels import gram_matvec as gm, ops, rff_matvec as rm

    saved = {name: getattr(ops, name) for name in _PLAIN_ROUTE}
    for name, plain in _PLAIN_ROUTE.items():
        setattr(ops, name, getattr(gm, plain, None) or getattr(rm, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def _plain_calls():
    """Counts, by name, the calls of the plain versions (``kernels/ref.py``)
    that the kernel wrappers and their autograd Functions can reach: their
    module-level names and the plain ops tables. Yields the counts."""
    from repro_torch.kernels import gram_matvec as gm, rff_matvec as rm

    calls, saved = {}, []

    def spy(name, fn):
        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return counted

    for mod in (gm, rm):
        for name in [n for n in vars(mod) if n.endswith("_ref")]:
            saved.append((vars(mod), name, getattr(mod, name)))
            setattr(mod, name, spy(name, getattr(mod, name)))
    for table in (gm._PLAIN_PAIR_OPS, rm._PLAIN_OPS):
        for name, fn in list(table.items()):
            saved.append((table, name, fn))
            table[name] = spy(f"plain_{name}", fn)
    try:
        yield calls
    finally:
        for table, name, fn in saved:
            table[name] = fn


def _rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def grad_bf16_phase(torch, kernels: dict) -> None:
    """Gradients at ``precision="bf16"`` at protein's n = 45,730 through the
    reference's differentiable kernel entry points: the pins
    ``ops.gram_matvec`` (K(x, x) v), ``ops.rff_matvec`` and
    ``ops.rff_t_matvec`` (512 frequencies at θ₀'s ℓ), ``ops.gram_mv`` on the
    cross operator K(x*, x), ``ops.gram_rows_pair`` (p = 512 rows) and
    ``ops.rff_pair_mv``, 8 columns, Matérn-3/2 at θ₀, each leaf's gradient
    of a random linear functional. Three routes on the same inputs: the
    kernels at bf16 (every launch counted, every backward launch a bf16
    launch, no fp32 launch and no call to a plain version), the plain
    Functions at bf16 on the card (``_plain_route``) on the fp32 inputs and
    on the same inputs in float64, and the kernels at fp32. Each leaf's bf16
    kernel gradient is held within BF16_GRAD_TOL (or BF16_PLAIN_RATIO × the
    fp32 plain route's own error) of the float64 plain bf16 route's, and
    within BF16_GRAD_RATIO × the plain bf16 route's own gap from fp32 (or
    BF16_FP32_TOL) of the fp32 kernels'."""
    from repro_torch.core.kernels_fn import make_params, map_params, spectral_sample
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    data = regression_dataset("protein", seed=SEED)
    x0 = torch.as_tensor(data["x"], device=dev)
    xt0 = torch.as_tensor(data["x_test"], device=dev)
    (n, d), nt, s, p, m = x0.shape, xt0.shape[0], 8, 512, 512
    params0 = make_params("matern32", d=d, device=dev, **TRAIN_HYPERS)
    omega0 = spectral_sample(params0, m, d, generator=gen)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    idx = torch.randint(0, n, (p,), generator=gen, device=dev)
    operands = dict(v=randn(n, s), vt=randn(nt, s), look=randn(n, s), b=randn(p, s),
                    w=randn(2 * m, s), u=randn(n, s))
    cot = dict(gram_matvec=randn(n, s), gram_mv=randn(n, s), err=randn(p, s), g=randn(n, s),
               rff_matvec=randn(n, s), rff_t_matvec=randn(2 * m, s), rff_pair_mv=randn(n, s))

    def leaves(dt):
        prm = map_params(lambda t: t.detach().to(dt).requires_grad_(), params0)
        ins = {k: t.detach().to(dt).requires_grad_()
               for k, t in dict(operands, x=x0, xt=xt0, omega=omega0).items()}
        sig = params0.signal.detach().to(dt).requires_grad_()
        return prm, ins, sig

    def dot(key, out):
        return torch.sum(cot[key].to(out.dtype) * out)

    def fns(prec):
        bf = dict(precision=prec)

        def gram_pin(prm, i, sig):
            out = ops.gram_matvec(prm, i["x"], i["v"], **bf)
            return dot("gram_matvec", out), [prm.log_lengthscale, prm.log_signal, i["x"], i["v"]]

        def gram_cross(prm, i, sig):
            out = ops.gram_mv(prm, i["x"], i["vt"], z=i["xt"], backend="cuda", **bf)
            return dot("gram_mv", out), [prm.log_lengthscale, prm.log_signal, i["x"], i["xt"],
                                         i["vt"]]

        def rows_pair(prm, i, sig):
            err, g = ops.gram_rows_pair(prm, i["x"], idx, i["look"], i["b"], backend="cuda", **bf)
            return (dot("err", err) + dot("g", g),
                    [prm.log_lengthscale, prm.log_signal, i["x"], i["look"], i["b"]])

        def rff_pin(prm, i, sig):
            out = ops.rff_matvec(i["x"], i["omega"], i["w"], signal=sig, **bf)
            return dot("rff_matvec", out), [i["x"], i["omega"], i["w"], sig]

        def rff_t_pin(prm, i, sig):
            out = ops.rff_t_matvec(i["x"], i["omega"], i["u"], signal=sig, **bf)
            return dot("rff_t_matvec", out), [i["x"], i["omega"], i["u"], sig]

        def rff_pair(prm, i, sig):
            out = ops.rff_pair_mv(i["x"], i["omega"], i["u"], signal=sig, backend="cuda", **bf)
            return dot("rff_pair_mv", out), [i["x"], i["omega"], i["u"], sig]

        return dict(gram_matvec=gram_pin, gram_mv=gram_cross, gram_rows_pair=rows_pair,
                    rff_matvec=rff_pin, rff_t_matvec=rff_t_pin, rff_pair_mv=rff_pair)

    def run(name, prec, dt=torch.float32):
        prm, ins, sig = leaves(dt)
        loss, wrt = fns(prec)[name](prm, ins, sig)
        grads = torch.autograd.grad(loss, wrt)
        torch.cuda.synchronize()
        return grads

    leaf_names = dict(gram_matvec=("log_lengthscale", "log_signal", "x", "v"),
                      gram_mv=("log_lengthscale", "log_signal", "x", "x_test", "v"),
                      gram_rows_pair=("log_lengthscale", "log_signal", "x", "look", "b"),
                      rff_matvec=("x", "omega", "w", "signal"),
                      rff_t_matvec=("x", "omega", "u", "signal"),
                      rff_pair_mv=("x", "omega", "u", "signal"))
    total, total_bf16 = {}, {}
    for name in leaf_names:
        _reset_counts(torch)
        t0 = time.perf_counter()
        with _plain_calls() as plain_calls:
            g_bf16 = run(name, "bf16")
        seconds = time.perf_counter() - t0
        launches, bf16 = _read_counts()[0], _read_bf16_counts()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k, v in bf16.items():
            total_bf16[k] = total_bf16.get(k, 0) + v
        with _plain_route():
            g_plain = run(name, "bf16")
            g_plain64 = run(name, "bf16", torch.float64)
        g_fp32 = run(name, "fp32")
        errs = {}
        for leaf, a, b, b64, c in zip(leaf_names[name], g_bf16, g_plain, g_plain64, g_fp32):
            gap_plain, plain32 = _rel(b, c), _rel(b, b64)
            errs[leaf] = dict(vs_plain_bf16=_rel(a, b64), vs_fp32=_rel(a, c),
                              plain_fp32_vs_plain64=plain32, plain_bf16_vs_fp32=gap_plain,
                              tol_vs_plain_bf16=max(BF16_GRAD_TOL, BF16_PLAIN_RATIO * plain32),
                              tol_vs_fp32=max(BF16_FP32_TOL, BF16_GRAD_RATIO * gap_plain),
                              finite=bool(torch.isfinite(a).all()))
        bwd = dict(gram_matvec_bwd=bf16["gram_matvec_bwd"], rff_bwd=bf16["rff_bwd"])
        emit("grad_bf16", function=name, n=n, n_test=nt, p=p, m=m, d=d, s=s,
             kind="matern32", seconds=seconds, fp32_launches=launches,
             bf16_launches=bf16, plain_calls=dict(plain_calls), errors=errs)
        check(not any(launches.values()), f"grad_bf16 {name}: no fp32 launch: {launches}")
        check(not plain_calls, f"grad_bf16 {name}: no plain version called: {plain_calls}")
        check(sum(bwd.values()) > 0, f"grad_bf16 {name}: bf16 backward launches {bwd}")
        for leaf, e in errs.items():
            check(e["finite"], f"grad_bf16 {name} {leaf}: finite")
            check(e["vs_plain_bf16"] <= e["tol_vs_plain_bf16"],
                  f"grad_bf16 {name} {leaf}: {e['vs_plain_bf16']} from the plain bf16 route")
            check(e["vs_fp32"] <= e["tol_vs_fp32"],
                  f"grad_bf16 {name} {leaf}: {e['vs_fp32']} from fp32 > {e['tol_vs_fp32']}")
    _record_path(kernels, "grad_bf16", total, total_bf16)


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
    finding), beside CG's test metrics. Each solver runs again at
    ``precision="bf16"``: its steps' launches, and finalize's, on the bf16
    kernels, the prior and predict's on the fp32 ones."""
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
    # the same solves on the bf16 tiles: solve() pins the precision onto the
    # operator, so the steps, their feature pairs and finalize's matvec run
    # bf16 kernels, and the prior f_X and predict stay fp32
    runs += [(f"{name}_bf16", steps, _stochastic_spec(name, steps, precision="bf16"))
             for name, steps in STOCH_STEPS.items()]
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
        bf16 = _read_bf16_counts()
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
             precision=spec.precision or "fp32", launches=launches, bf16_launches=bf16,
             matvec_counts=matvec_counts, feature_counts=feature_counts)
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
        want_bf16 = {k: 0 for k in bf16}
        if spec.precision == "bf16":  # the solve's launches move to the bf16 kernels
            for k in want_bf16:
                want_bf16[k] = want[k] - (2 if k in ("gram_matvec", "rff_matvec") else 0)
                want[k] -= want_bf16[k]
        check(info.matvecs == (0 if name == "ap" else 1),
              f"{name}: finalize's full matvecs {info.matvecs}")
        check(launches == want, f"{run}: launches {launches} == {want}")
        check(bf16 == want_bf16, f"{run}: bf16 launches {bf16} == {want_bf16}")
        check(matvec_counts["chunked"] == matvec_counts["dense"] == 0,
              f"{name}: no plain Gram matvec")
        check(feature_counts["features"] == 0, f"{name}: no materialised feature matrix")
        if run != "sdd_paper_step":
            _record_path(kernels, run, launches, bf16)
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
    and AP keep the fp32 check. Then each solver's PARITY_STEPS steps on the
    bf16 tiles are held against its fp32 kernel route on the same draws,
    within the reference's bf16-vs-fp32 bound (BF16_SOLVE_TOL; AP within
    AP_REF_RATIO × the reference's own AP gap here, AP_REF_GAP)."""
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

    # each solver's first PARITY_STEPS steps on the bf16 tiles against the
    # fp32 kernels, on the same draws and targets, within the reference's
    # bf16-vs-fp32 bound of a solve (SGD, SDD), or within AP_REF_RATIO × the
    # reference's own AP gap at this problem; the plain route's own gap is
    # printed beside it
    for name in STOCH_STEPS:
        sols, launched = {}, {}
        for backend, precision in (("cuda", "fp32"), ("cuda", "bf16"), ("chunked", "fp32"),
                                   ("chunked", "bf16")):
            _reset_counts(torch)
            spec = _stochastic_spec(name, PARITY_STEPS, backend=backend,
                                    precision=None if precision == "fp32" else precision)
            t0 = time.perf_counter()
            res = solve(Gram(x=x, params=params), b, spec, delta=delta,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
            torch.cuda.synchronize()
            launched[f"{backend}_{precision}"] = dict(
                seconds=time.perf_counter() - t0, fp32=_path_launches(_read_counts()[0]),
                bf16=_bf16_path_launches(_read_bf16_counts()))
            sols[backend, precision] = res.solution

        def gap(backend):
            a, ref = sols[backend, "bf16"], sols[backend, "fp32"]
            return (a - ref).abs().max().item() / max(1.0, ref.abs().max().item())

        kernel_gap, plain_gap = gap("cuda"), gap("chunked")
        limit = AP_REF_RATIO * AP_REF_GAP if name == "ap" else BF16_SOLVE_TOL
        emit("route_parity_bf16", solver=name, steps=PARITY_STEPS, gap=kernel_gap,
             plain_route_gap=plain_gap, reference_gap=AP_REF_GAP if name == "ap" else None,
             limit=limit, rel_diff=(
                 (sols["cuda", "bf16"] - sols["cuda", "fp32"]).norm()
                 / sols["cuda", "fp32"].norm()).item(), runs=launched)
        check(bool(torch.isfinite(sols["cuda", "bf16"]).all()), f"{name} bf16: finite iterates")
        check(kernel_gap <= limit, f"{name}: bf16 within {limit} of max(1, scale) of fp32 after "
              f"{PARITY_STEPS} steps on the same draws ({kernel_gap}; the plain route's "
              f"{plain_gap})")
        check(sum(launched["cuda_bf16"]["bf16"].values()) > 0
              and not any(launched["cuda_fp32"]["bf16"].values()),
              f"{name}: bf16 kernels on the bf16 run alone")
        check(all(v == 0 for run in ("chunked_fp32", "chunked_bf16")
                  for launches in (launched[run]["fp32"], launched[run]["bf16"])
                  for v in launches.values()), f"{name}: the plain route launched no kernel")


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


def _engine_stream(torch, xt):
    """launch/serve_gp.py's default traffic (its request_stream, a quarter
    replayed), each query block ENGINE["num_rows"] consecutive test points
    (request i's from row num_rows·i)."""
    from repro_torch.launch.serve_gp import request_stream

    cfg = ENGINE
    stream = []
    for i, (kind, kw) in enumerate(request_stream(
            cfg["requests"], cfg["mix"], xt.shape[1], SEED + 1, cfg["num_rows"],
            cfg["req_samples"], device=xt.device)):
        if "xs" in kw:
            lo = (cfg["num_rows"] * i) % xt.shape[0]
            kw = dict(kw, xs=xt[lo:lo + cfg["num_rows"]])
        if kind == "thompson_step":
            kw = dict(kw, ascent_steps=cfg["ascent_steps"])
        stream.append((kind, kw))
    return stream + stream[:int(len(stream) * cfg["repeat"])]


def _step_identity(comps) -> dict:
    """The launches one engine step must make, from what it served: a predict
    batch, 2 Gram launches (the mean and the samples) and 1 RFF launch; a
    solve batch, an RFF launch for each RHS_SLICE columns of its right-hand
    sides and its solve's matvecs in Gram launches, 1 more of each for the
    sample requests' evaluation, and for each Thompson request of T ascent
    steps T + 3 of each forward kernel (the candidates, T ascent steps, the
    final values, the per-sample values) and T of each backward."""
    from repro_torch.serve.engine import RHS_SLICE

    zero = dict(gram_matvec=0, gram_matvec_bwd=0, rff_matvec=0, rff_bwd=0, gram_rows_pair=0,
                gram_rows_matvec=0, rff_t_matvec=0, rff_pair=0, flash_attention=0)
    if not comps:
        return zero
    if comps[0].metrics["group"] == "predict":
        return dict(zero, gram_matvec=2, rff_matvec=1)
    sample = int(any(c.kind == "sample" for c in comps))
    ascent = [ENGINE["ascent_steps"] for c in comps if c.kind == "thompson_step"]
    fwd = sum(t + 3 for t in ascent)
    slices = -(-comps[0].metrics["bucket_columns"] // RHS_SLICE)
    return dict(zero, gram_matvec=comps[0].metrics["matvecs"] + sample + fwd,
                rff_matvec=slices + sample + fwd, gram_matvec_bwd=sum(ascent),
                rff_bwd=sum(ascent))


def engine_phase(torch, kernels: dict, oracle: dict):
    """The serving engine at protein's full n: ``IterativeGP(...).fit(x, y)
    .engine(...)`` on the main path's cell, WRITE_ROWS rows held out for the
    write, then serve_gp's default traffic through its ``drive`` with one
    ``add_observations`` after WRITE_AFTER completions, the launch counts read
    just around the fit and the drive. Held: every request served; every
    predict mean within ENGINE_MEAN_TOL of the Cholesky oracle at its rows
    (relative), every variance finite and ≥ 0; each step's launches to
    ``_step_identity`` and the write's to its solve's bill, no plain dispatch;
    the write certified within the auto budget or compacted. Then the last
    cold solve batch replayed warm (its iterations below a quarter of the
    cold batch's), one sample request of a full batch served alone and cold
    (its payload within ENGINE_DET_TOL of its scale), and the fault path at
    n = 512. Returns the engine: profile_phase profiles one of its solve
    batches last (the idle share is on that phase's ``engine_solve_batch``
    line), since a profiler session slows later host loops."""
    from repro_torch.core import CG, IterativeGP
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.launch.serve_gp import drive

    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    cfg, dev = ENGINE, torch.device("cuda")
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    x_fit, y_fit = x[:-WRITE_ROWS], y[:-WRITE_ROWS]
    gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL),
                     lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, seed=SEED)

    _reset_counts(torch)
    t0 = time.perf_counter()
    eng = gp.fit(x_fit, y_fit).engine(
        num_samples=cfg["num_samples"], num_features=cfg["num_features"],
        max_rhs_columns=cfg["max_rhs_columns"], max_batch_requests=cfg["max_batch_requests"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches, _, _ = _read_counts()
    fit = eng.state.fit_result
    check(eng.device.type == "cuda", f"the engine runs on the card, got {eng.device}")
    check(fit.converged and fit.healthy, "the engine's fit converged, no flag")
    check(fit_launches["gram_matvec"] == fit.matvecs and fit_launches["rff_matvec"] == 1,
          f"the fit: Gram = its {fit.matvecs} matvecs, RFF = 1: {fit_launches}")

    # every step's and the write's launches, read around them; the warm
    # cache's host copies timed one by one
    steps, writes, stores = [], [], []
    step, add_obs, store = eng.step, eng.add_observations, eng.cache.store

    def delta(before):
        after = _read_counts()
        return tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before))

    def counted_step():
        before = _read_counts()
        nstores = len(stores)
        comps = step()
        steps.append((comps, *delta(before), sum(stores[nstores:])))
        return comps

    def counted_add_observations(x_new, y_new, **kw):
        eng.run_until_idle()  # the drain's steps counted as steps
        before = _read_counts()
        snap = eng.stats()
        t0 = time.perf_counter()
        add_obs(x_new, y_new, **kw)
        torch.cuda.synchronize()
        writes.append((eng.stats(), snap, time.perf_counter() - t0, *delta(before), len(steps)))

    def timed_store(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store(*args)
        stores.append(time.perf_counter() - t0)

    eng.step, eng.add_observations, eng.cache.store = (counted_step, counted_add_observations,
                                                       timed_store)
    stream = _engine_stream(torch, xt)
    held_out = [(x[-WRITE_ROWS:], y[-WRITE_ROWS:])]
    handles, wall = drive(eng, stream, cfg["depth"], writes=held_out,
                          write_every=WRITE_AFTER, update="auto")
    torch.cuda.synchronize()
    launches, matvec_counts, feature_counts = _read_counts()  # the fit's among them
    _record_path(kernels, "engine", launches)
    snap = eng.stats()

    check(len(handles) == len(stream) and all(h.done and h.result().ok for h in handles),
          "every request of the stream served")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0, "no plain Gram matvec")
    check(feature_counts["features"] == 0, "no materialised feature matrix")
    # the predict means against the Cholesky oracle at their rows; the oracle
    # conditions on all n rows, the requests served before the write on
    # n − WRITE_ROWS of them (at protein's n a change far below the tolerance)
    errs = []
    for h, (kind, kw) in zip(handles, stream):
        if kind != "predict":
            continue
        lo = (cfg["num_rows"] * h.request.seed) % xt.shape[0]
        want = oracle["exact_mean"][lo:lo + cfg["num_rows"]]
        val = h.result().value
        errs.append(((val["mean"] - want).norm() / want.norm()).item())
        check(bool(torch.isfinite(val["var"]).all() and (val["var"] >= 0).all()),
              f"predict {h.request.id}: finite, non-negative variances")
    check(max(errs) <= ENGINE_MEAN_TOL, f"predict means within {ENGINE_MEAN_TOL} of the "
          f"Cholesky mean at their rows: worst {max(errs)}")
    # each step's launches
    check(len(writes) == 1, f"one write, got {len(writes)}")
    after_w, before_w, write_s, wl, wmv, wfc, write_step = writes[0]
    cold, warm_in_stream, copy_ms, cold_after_write = [], [], [], []
    for i, (comps, got, mv, fc, store_s) in enumerate(steps):
        want = _step_identity(comps)
        check(got == want, f"step launches {got} == {want}")
        check(mv["chunked"] == mv["dense"] == 0 and fc["features"] == 0,
              "a step took no plain dispatch")
        if comps and comps[0].metrics["group"] != "predict":
            (warm_in_stream if comps[0].metrics["group"] == "solve_warm" else cold).append(
                comps)
            if comps[0].metrics["group"] == "solve_cold" and i >= write_step:
                cold_after_write.append(comps)
            copy_ms.append(1e3 * store_s)
    compacted = after_w["compactions"] > before_w["compactions"]
    w_mv = after_w["lowrank_matvecs"] - before_w["lowrank_matvecs"]
    w_iters = after_w["lowrank_iterations"] - before_w["lowrank_iterations"]
    if compacted:
        w_iters = after_w["refit_iterations"] - before_w["refit_iterations"]
    budget = eng.compaction_tol_factor * MAIN_TOL
    check(compacted or after_w["last_refit_rel_residual"] <= budget,
          f"the write certified within {budget} or compacted: {after_w}")
    if not compacted:
        check(wl["gram_matvec"] == w_mv and wl["rff_matvec"] == 1,
              f"the rank-{WRITE_ROWS} write: Gram = its {w_mv} matvecs (the Z solve's and "
              f"the certification's), RFF = 1: {wl}")
    check(wmv["chunked"] == wmv["dense"] == 0, "the write took no plain Gram matvec")
    check(eng.state.n == int(data["n"]), "the write restored the full training set")

    # the last cold solve batch replayed: one warm batch of the same requests
    check(len(cold_after_write) > 0, "cold solve batches after the write")
    last = cold_after_write[-1]
    replay = [eng.submit(c.kind, handles[c.request_id].request.xs,
                         num_samples=handles[c.request_id].request.num_samples,
                         seed=handles[c.request_id].request.seed,
                         **handles[c.request_id].request.options) for c in last]
    nsteps = len(steps)
    eng.run_until_idle()
    check(len(steps) == nsteps + 1 and all(h.request.warm for h in replay),
          "the replay ran as one warm batch")
    warm_comps = steps[-1][0]
    cold_iters, warm_iters = last[0].metrics["iterations"], warm_comps[0].metrics["iterations"]
    check(warm_iters < cold_iters / 4, f"the warm batch: {warm_iters} iterations < a quarter "
          f"of its cold batch's {cold_iters}")
    check(steps[-1][1] == _step_identity(warm_comps), "the warm batch's launches")

    # one sample request of the widest cold batch since the write, served
    # again alone and cold, on the same posterior
    full = max((c for c in cold_after_write if any(r.kind == "sample" for r in c)),
               key=lambda comps: comps[0].metrics["batch_columns"])
    pick = next(c for c in full if c.kind == "sample")
    req = handles[pick.request_id].request
    key = eng.state.hypers_key
    batched = eng.cache.lookup(key, "sample", req.seed)
    eng.cache.purge("")
    solo = eng.sample(req.xs, num_samples=req.num_samples, seed=req.seed)
    eng.run_until_idle()
    same_columns = bool((batched == eng.cache.lookup(key, "sample", req.seed)).all())
    a, b = pick.value["samples"], solo.result().value["samples"]
    det_err = (a - b).abs().max().item()
    det_tol = ENGINE_DET_TOL * max(1.0, b.abs().max().item())
    check(not solo.request.warm and solo.result().metrics["batch_columns"] == req.num_samples,
          "the solo request ran alone and cold")
    check(det_err <= det_tol, f"a payload in a full batch and alone: {det_err} > {det_tol}")
    eng.step, eng.add_observations, eng.cache.store = step, add_obs, store

    # the Gram kernel at each width the engine's solve batches used
    from repro_torch.kernels.gram_matvec import gram_matvec

    xs = (eng.state.x / eng.state.params.lengthscale).contiguous()
    widths = sorted({c[0].metrics["bucket_columns"] for c in cold + warm_in_stream}
                    | {1 + cfg["num_samples"]})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gram_ms = {}
    for s in widths:
        v = torch.randn((xs.shape[0], s), generator=gen, device=dev)
        gram_ms[s] = _events_ms(torch, lambda: gram_matvec(xs, xs, v, kind="matern32"), 10)
    fault = _engine_fault_path(torch)
    lat = [h.result().metrics["total_s"] for h in handles]
    emit("engine", n=int(data["n"]) - WRITE_ROWS, d=d, fit_s=fit_s, fit_iterations=fit.iterations,
         fit_columns=1 + cfg["num_samples"], requests=len(handles), wall_s=wall,
         requests_per_s=len(handles) / wall, p50_total_s=snap["total_latency_p50_s"],
         p99_total_s=snap["total_latency_p99_s"], p50_queue_s=snap["queue_latency_p50_s"],
         max_total_s=max(lat), steps=snap["steps"], batches=snap["batches"],
         solve_batches=snap["solves"], rhs_columns=snap["rhs_columns"],
         padded_columns=snap["padded_columns"],
         cold_batches=[dict(columns=c[0].metrics["batch_columns"],
                            bucket=c[0].metrics["bucket_columns"],
                            iterations=c[0].metrics["iterations"],
                            requests=len(c), exec_s=c[0].metrics["exec_s"]) for c in cold],
         warm_batches_in_stream=len(warm_in_stream), warm_hits=snap["warm_hits"],
         iterations_per_cold_batch=sum(c[0].metrics["iterations"] for c in cold) / len(cold),
         replay=dict(cold_iterations=cold_iters, warm_iterations=warm_iters,
                     requests=len(replay), exec_s=warm_comps[0].metrics["exec_s"]),
         gram_ms_by_width=gram_ms,
         write=dict(path="compaction" if compacted else "lowrank", iterations=w_iters,
                    matvecs=w_mv if not compacted else None, wall_s=write_s,
                    rel_residual=after_w["last_refit_rel_residual"], budget=budget,
                    launches=wl),
         cache_copy_ms_per_batch=sum(copy_ms) / len(copy_ms), cache_copy_ms=copy_ms,
         predict_max_rel_err=max(errs), tol=ENGINE_MEAN_TOL,
         determinism=dict(max_abs_err=det_err, tol=det_tol,
                          batch_columns=pick.metrics["batch_columns"],
                          solved_columns_bit_identical=same_columns),
         fault=fault, launches=launches, fit_launches=fit_launches,
         matvec_counts=matvec_counts, feature_counts=feature_counts)
    return eng


def _engine_fault_path(torch) -> dict:
    """The engine's fault isolation at the robust phase's problem (n = 512,
    d = 3, CG(120, 1e-4)): a FaultyOperator poisons one request's columns in
    a batch of three (width-gated, so it vanishes on the solo rescue); that
    request is rescued through the ladder and its batch-mates' payloads are
    bit-identical to a fault-free engine's; then a persistently poisoned
    prior (FaultyFeatureOperator) fails one seed twice, and its third submit
    is quarantined."""
    import dataclasses

    from repro_torch.core import CG, make_params
    from repro_torch.serve import GPEngine
    from repro_torch.testing import FaultyFeatureOperator, FaultyOperator

    dev, n, d = torch.device("cuda"), ROBUST["n"], ROBUST["d"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((n, d), generator=gen, device=dev)
    y = torch.sin(4.0 * x[:, 0]) + 0.5 * torch.cos(3.0 * x[:, 1])
    params = make_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=d, device=dev)

    def engine(**kw):
        return GPEngine(params, x, y, spec=CG(**ROBUST["spec"]), num_samples=8,
                        num_features=256, seed=SEED, **kw)

    # request 1's second column (batch column 5) poisoned at the batch's width
    faulty = engine(operator_transform=lambda op: FaultyOperator(op, columns=(5,),
                                                                 min_width=9))
    clean = engine()
    xq = torch.rand((3, 16, d), generator=gen, device=dev)
    hf = [faulty.sample(xq[i], num_samples=4, seed=50 + i) for i in range(3)]
    hc = [clean.sample(xq[i], num_samples=4, seed=50 + i) for i in range(3)]
    faulty.run_until_idle()
    clean.run_until_idle()
    st = faulty.stats()
    check(all(h.result().ok for h in hf) and st["escalations"] == 1 and st["failed"] == 0,
          f"the poisoned request rescued solo: {st['escalations']} escalations")
    intact = all(torch.equal(hf[i].result().value["samples"], hc[i].result().value["samples"])
                 for i in (0, 2))
    check(intact, "the batch-mates' payloads are bit-identical to a fault-free run")
    rescued_err = (hf[1].result().value["samples"] - hc[1].result().value["samples"]).abs().max()

    poisoned = engine(quarantine_after=2)
    poisoned.state.post = dataclasses.replace(
        poisoned.state.post, prior=FaultyFeatureOperator(poisoned.state.prior, columns=(0,)))
    codes = []
    for _ in range(3):
        h = poisoned.sample(xq[0], num_samples=4, seed=77)
        poisoned.run_until_idle()
        codes.append(h.result().error["code"])
    check(codes == ["solver_failure", "solver_failure", "quarantined"],
          f"a twice-failing seed is quarantined: {codes}")
    return dict(escalations=st["escalations"], batch_mates_bit_identical=intact,
                rescued_vs_clean_max_abs=rescued_err.item(), quarantine=codes,
                quarantined=poisoned.stats()["quarantined"])


def _scaled_err(a, ref) -> float:
    """max|a − ref| over the scale max(1, max|ref|), the kernels' convention."""
    return (a.double() - ref.double()).abs().max().item() / max(1.0, ref.abs().max().item())


def cg_width_phase(torch) -> None:
    """CG's stop test and reported residual at two widths: one column (the
    protein targets' first CG_WIDTH_N rows at the main path's θ) solved at
    width 8 and beside 63 others at width 64, with random companions and
    with zero ones (which converge at once, so the batch's iteration count is
    the column's own). Held: the 8 columns both widths share (the column and
    its first 7 companions) have the same ‖b‖, relative residual, residual
    norm and solved bits at both widths, and so the same iteration count."""
    from repro_torch.core import CG, Gram, make_params, solve
    from repro_torch.core.solvers.base import _col_norm
    from repro_torch.data.pipeline import regression_dataset

    data = regression_dataset("protein", seed=SEED)
    d, dev = data["d"], torch.device("cuda")
    x = torch.as_tensor(data["x"][:CG_WIDTH_N], device=dev)
    y = torch.as_tensor(data["y"][:CG_WIDTH_N], device=dev)
    params = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                         d=d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    others = torch.randn((x.shape[0], 63), generator=gen, device=dev)
    op, spec = Gram(x=x, params=params), CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL)
    out = {}
    for name, companions in (("random", others), ("zero", torch.zeros_like(others))):
        got = []
        for width in (8, 64):
            b = torch.cat([y[:, None], companions[:, :width - 1]], dim=1).contiguous()
            res = solve(op, b, spec)
            got.append(dict(bn=_col_norm(b)[:8], rel=res.rel_residual[:8],
                            rn=res.residual_norm[:8], solution=res.solution[:, :8],
                            iterations=res.iterations, converged=res.converged))
        a, b = got
        # the columns of the 8 shared that differ between the widths, by quantity
        differ = {k: int((a[k] != b[k]).reshape(-1, 8).any(dim=0).sum())
                  for k in ("bn", "rel", "rn", "solution")}
        same = {k: v == 0 for k, v in differ.items()}
        out[name] = dict(same=same, columns_differing=differ,
                         iterations=[a["iterations"], b["iterations"]],
                         rel_residual=a["rel"][0].item(),
                         converged=[a["converged"], b["converged"]])
        check(all(same.values()), f"CG column at widths 8 and 64 ({name} companions): {same}")
        check(a["converged"] and b["converged"], f"CG converged at both widths ({name})")
    check(out["zero"]["iterations"][0] == out["zero"]["iterations"][1],
          f"the column's own iteration count at widths 8 and 64: {out['zero']['iterations']}")
    emit("cg_width", n=int(x.shape[0]), d=d, **out)


def _dist_inputs(torch, data, params_cpu) -> dict:
    """The distributed phase's draws, made once on the host from SEED and
    given to every rank and to the single-device runs alike: the prior's
    2,048 features and 64 weight columns, ε, the stochastic solvers' SGD and
    row draws, and the P = 4 primitives' operands."""
    from repro_torch.core import spectral_sample

    n, d = int(data["n"]), data["d"]
    gen = torch.Generator().manual_seed(SEED)
    m, s, steps = DIST["features"] // 2, DIST["samples"], DIST["steps"]
    batch, q = STOCH_SPECS["sgd"]["batch_size"], STOCH_SPECS["sgd"]["num_features"]
    p4 = DIST["p4_n"]
    return dict(
        x=torch.as_tensor(data["x"]), y=torch.as_tensor(data["y"]),
        omega=spectral_sample(params_cpu, m, d, generator=gen),
        w=torch.randn((2 * m, s), generator=gen),
        eps=params_cpu.noise.sqrt() * torch.randn((n, s), generator=gen),
        sgd_idx=torch.randint(0, n, (steps, batch), generator=gen),
        sgd_omega=spectral_sample(params_cpu, steps * q, d, generator=gen).reshape(steps, q, d),
        rows_idx=torch.randint(0, n, (steps, STOCH_SPECS["sdd"]["batch_size"]), generator=gen),
        v4=torch.randn((p4, s + 1), generator=gen), u4=torch.randn((512, s + 1), generator=gen),
        idx4=torch.randint(0, p4, (512,), generator=gen),
        hypers=dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, d=d))


def _dist_specs():
    """The distributed phase's solver specs: CG to the main path's tol, CG at
    the fixed budget, and the stochastic solvers' DIST["steps"] steps."""
    from repro_torch.core import CG

    return dict(full=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL),
                budget=CG(max_iters=DIST["budget"], tol=1e-12),
                **{name: _stochastic_spec(name, DIST["steps"]) for name in ("sgd", "sdd", "ap")})


def _dist_rank(rank: int, world: int, port: int, inputs: str, out_dir: str, part: str) -> None:
    """One spawned rank of the distributed phase: joins the ``("data",)``
    mesh of ``world`` ranks on the card (NCCL for one rank, gloo for ranks
    that share the card), runs its ``part`` and saves what it measured."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.testing.ranks import join_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = join_mesh(rank, world, port, "cuda", timeout=DIST["group_timeout"])
    inp = torch.load(inputs, map_location="cuda")
    out = (_dist_primitives if part == "p4" else _dist_solves)(torch, rank, world, mesh, inp)
    torch.save(out, Path(out_dir) / f"{part}_rank{rank}.pt")
    dist.destroy_process_group()


def _dist_window(torch, fn):
    """Run ``fn`` with every count at 0 just before and read just after:
    (its result, wall seconds, the counts)."""
    from repro_torch.core import collectives as coll

    _reset_counts(torch)
    coll.reset_collective_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, matvec_counts, feature_counts = _read_counts()
    return res, wall, dict(launches=launches, bf16=_read_bf16_counts(),
                           matvec_counts=matvec_counts, feature_counts=feature_counts,
                           collectives=coll.collective_counts())


def _dist_held(torch, fn, plain_fn, ref64_fn, tol: float, bound: tuple) -> dict:
    """A rank's launch at its distributed shape held as the kernels phase
    holds each kernel: its result against the plain route run in float64 on
    the same inputs within ``tol`` × max(1, scale), the kernel and the fp32
    plain route timed by CUDA events, ``bound`` = (ms, flops, bytes)."""
    out, ref = fn(), ref64_fn()
    err = (out.double() - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    return dict(max_abs_err=err, tol=tol * scale,
                err_vs_fp32_plain=(out - plain_fn()).abs().max().item(),
                ms=_events_ms(torch, fn, DIST["kernel_reps"]),
                plain_ms=_events_ms(torch, plain_fn, DIST["plain_reps"]),
                bound_ms=bound[0], bound_by=_bound_by(bound[1], bound[2]))


def _dist_rff_held(torch, p, p64, x, omega, w, sgd_omega, u) -> dict:
    """The RFF launches of a rank's shard held by :func:`_dist_held` against
    the materialised features: f_X's ``phi_mv`` (2,048 features, w's 64
    columns), and on SGD's first step's frequencies its pullback
    ``phi_t_mv`` of u (the rank's (n/P, 65) rows) and push-forward."""
    from repro_torch.core.rff import FourierFeatures

    (n, d) = x.shape

    def held(om, call, operand):
        zero = torch.zeros_like(om[:, 0])
        ff = FourierFeatures(omega=om, phase=zero, signal=p.signal)
        ff64 = FourierFeatures(omega=om.double(), phase=zero.double(), signal=p64.signal)
        line = _dist_held(
            torch, lambda: getattr(ff, call)(x, operand),
            lambda: getattr(ff, call)(x, operand, backend="features"),
            lambda: getattr(ff64, call)(x.double(), operand.double(), backend="features"),
            RFF_TOL, _rff_bound_ms(n, om.shape[0], d, operand.shape[1]))
        line.update(n=n, m=om.shape[0], d=d, s=operand.shape[1])
        return line, getattr(ff, call)(x, operand)

    f_x, _ = held(omega, "phi_mv", w)
    pull, t = held(sgd_omega, "phi_t_mv", u)
    push, _ = held(sgd_omega, "phi_mv", t)
    return dict(f_x=f_x, sgd_pull=pull, sgd_push=push)


def _dist_solves(torch, rank, world, mesh, inp) -> dict:
    """A rank's solves on the protein problem: the right-hand side's f_X
    block through ``ShardedFourierFeatures.phi_mv``, then ``distributed_solve``
    with CG to tol and at the 18-iteration budget under each comm (under
    ring at P > 1 also at each of DIST["ring_budgets"]), one ``mv``, a
    matvec's wall time, and the Gram launch at the comm's shard shape
    against its plain route; the RFF launches at the shard's shapes against
    theirs; at P = 2, 200 steps of SGD and SDD under ring and AP under
    gather_once on the injected draws."""
    import torch.distributed as dist

    from repro_torch.core import CG, ShardedGram, distributed_solve, make_params
    from repro_torch.core import shard_training_rows
    from repro_torch.core import collectives as coll
    from repro_torch.core.rff import FourierFeatures
    from repro_torch.core.solvers import RowDraws, SGDDraws
    from repro_torch.kernels.ops import gram_mv

    p = make_params("matern32", device="cuda", **inp["hypers"])
    p64 = make_params("matern32", device="cuda", dtype=torch.float64, **inp["hypers"])
    x = shard_training_rows(mesh, inp["x"])
    group = coll.axis_group(mesh, ("data",))
    rows = slice(rank * x.shape[0], (rank + 1) * x.shape[0])
    ff = ShardedGram(x=x, params=p, mesh=mesh).wrap_features(
        FourierFeatures(omega=inp["omega"], phase=torch.zeros_like(inp["omega"][:, 0]),
                        signal=p.signal))
    f_x, _, rhs = _dist_window(torch, lambda: ff.phi_mv(x, inp["w"]))
    b_local = torch.cat([inp["y"][rows, None], f_x + inp["eps"][rows]], dim=1).contiguous()
    b_whole = coll.all_gather_rows(b_local, group)
    out = dict(backend=str(dist.get_backend()), rhs=rhs, runs={}, stochastic={},
               rff=_dist_rff_held(torch, p, p64, x, inp["omega"], inp["w"],
                                  inp["sgd_omega"][0], b_local))
    comms = [("gather", dict(comm="gather")), ("gather_once", dict(comm="gather", gather_once=True)),
             ("ring", dict(comm="ring")),
             ("auto", dict(comm="auto", comm_budget_bytes=DIST["auto_budget_bytes"]))]
    if world == 1:
        comms = [comms[0], comms[2]]
    specs = _dist_specs()
    for tag, kw in comms:
        op = ShardedGram(x=x, params=p, mesh=mesh, **kw)
        ring = op._resolve_comm() == "ring"
        b = b_local if ring else b_whole
        mine = (lambda t: t) if ring else (lambda t: t[rows])  # this rank's rows
        rec = dict(resolved=op._resolve_comm())
        for run in ("full", "budget"):
            res, wall, counts = _dist_window(
                torch, lambda: distributed_solve(p, x, b, mesh, specs[run], **kw))
            rec[run] = dict(iterations=res.iterations, matvecs=res.matvecs,
                            converged=res.converged, wall_s=wall,
                            max_rel_residual=res.rel_residual.max().item(),
                            solution_shape=list(res.solution.shape), **counts)
            rec[run + "_rows"] = mine(res.solution).cpu()
        if ring and world > 1:
            rec["curve_rows"] = {k: mine(distributed_solve(
                p, x, b, mesh, CG(max_iters=k, tol=1e-12), **kw).solution).cpu()
                for k in DIST["ring_budgets"]}
        prepared = op.prepare_for_solve()
        rec["mv_rows"] = mine(prepared.mv(b)).cpu()
        _, wall, counts = _dist_window(
            torch, lambda: [prepared.mv(b) for _ in range(DIST["mv_reps"])])
        rec["ms_per_mv"] = 1e3 * wall / DIST["mv_reps"]
        rec["mv_counts"] = counts
        z, vz = (x, b_local) if ring else (coll.all_gather_rows(x, group), b_whole)
        rec["kernel_shape"] = [x.shape[0], z.shape[0], vz.shape[1]]
        rec["kernel"] = _dist_held(
            torch, lambda: prepared._local_mv(x, z, vz),
            lambda: gram_mv(p, x, vz, z=z, backend="chunked"),
            lambda: gram_mv(p64, x.double(), vz.double(), z=z.double(), backend="chunked"),
            GRAM_TOL, _gram_bound_ms(x.shape[0], z.shape[0], x.shape[1], vz.shape[1]))
        out["runs"][tag] = rec
    if world == 2:
        draws = dict(sgd=SGDDraws(idx=inp["sgd_idx"], omega=inp["sgd_omega"]),
                     sdd=RowDraws(idx=inp["rows_idx"]), ap=RowDraws(idx=inp["rows_idx"]))
        for name, kw in (("sgd", dict(comm="ring")), ("sdd", dict(comm="ring")),
                         ("ap", dict(comm="gather", gather_once=True))):
            res, wall, counts = _dist_window(torch, lambda: distributed_solve(
                p, x, b_whole, mesh, specs[name], draws=draws[name], **kw))
            ring = kw["comm"] == "ring"
            out["stochastic"][name] = dict(
                comm=kw, iterations=res.iterations, matvecs=res.matvecs, wall_s=wall,
                ms_per_step=1e3 * wall / DIST["steps"],
                rows=(res.solution if ring else res.solution[rows]).cpu(), **counts)
    return out


def _dist_primitives(torch, rank, world, mesh, inp) -> dict:
    """A rank's primitives on the first DIST["p4_n"] protein rows under
    gather and ring: one ``mv`` counted alone, then the row primitives and
    ``block_at``; ring's row blocks are gathered whole outside the counts."""
    from repro_torch.core import ShardedGram, make_params, shard_training_rows
    from repro_torch.core import collectives as coll

    p = make_params("matern32", device="cuda", **inp["hypers"])
    x = shard_training_rows(mesh, inp["x"][:DIST["p4_n"]])
    group = coll.axis_group(mesh, ("data",))
    v, u, idx = inp["v4"], inp["u4"], inp["idx4"]
    out = {}
    for comm in ("gather", "ring"):
        op = ShardedGram(x=x, params=p, mesh=mesh, comm=comm)
        v_in = op.layout.iterate(v)
        mv, _, mv_counts = _dist_window(torch, lambda: op.mv(v_in))
        prims, _, counts = _dist_window(torch, lambda: dict(
            rows_mv=op.rows_mv(idx, v_in), rows_t_mv=op.rows_t_mv(idx, u),
            pair=op.rows_pair_mv(idx, v_in, u), block_at=op.block_at(idx)))
        whole = (lambda t: coll.all_gather_rows(t, group)) if comm == "ring" else (lambda t: t)
        out[comm] = dict(mv_counts=mv_counts, counts=counts, mv=whole(mv).cpu(),
                         rows_mv=prims["rows_mv"].cpu(), rows_t_mv=whole(prims["rows_t_mv"]).cpu(),
                         pair_err=prims["pair"][0].cpu(), pair_g=whole(prims["pair"][1]).cpu(),
                         block_at=prims["block_at"].cpu())
    return out


def _sum_counts(recs: list, key: str) -> dict:
    """A counts dict (``launches`` or ``bf16``) summed over ranks and windows."""
    out = {}
    for rec in recs:
        for k, v in rec[key].items():
            out[k] = out.get(k, 0) + v
    return out


def _dist_no_plain(what: str, rec: dict) -> None:
    check(rec["matvec_counts"]["chunked"] == rec["matvec_counts"]["dense"] == 0,
          f"{what}: no plain Gram matvec")
    check(rec["feature_counts"]["features"] == 0, f"{what}: no materialised feature matrix")
    check(not any(rec["bf16"].values()), f"{what}: no bf16 launch")


def _dist_launches(what: str, rec: dict, want: dict) -> None:
    """A window's launches: ``want`` by wrapper, every other wrapper none."""
    full = {k: want.get(k, 0) for k in rec["launches"]}
    check(rec["launches"] == full, f"{what}: launches {rec['launches']} == {full}")


def _dist_path_line(kernels, name: str, path: str, what: str, lines: list) -> None:
    """The ranks' held launches of kernel ``name`` on a distributed path
    (:func:`_dist_held`): each within its tolerance; under ``by_path`` the
    path's line, beside its launches, gets the shape, the slowest rank's
    times and the largest error, which the record's ``max_abs_err`` takes
    too."""
    for rk, line in enumerate(lines):
        check(line["max_abs_err"] <= line["tol"],
              f"{what} rank {rk}: {name} within {line['tol']} of the plain route in "
              f"float64 ({line['max_abs_err']})")
    worst = max(lines, key=lambda line: line["ms"])
    err = max(line["max_abs_err"] for line in lines)
    kernels[name]["by_path"][path].update(
        worst, max_abs_err=err, ms_by_rank=[line["ms"] for line in lines],
        plain_ms_by_rank=[line["plain_ms"] for line in lines])
    kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)


def _dist_cg_checks(torch, part, ranks, single, oracle, kernels, p, x, xt) -> None:
    """CG under each comm of one world: counts, launches, the mean column
    against the Cholesky oracle, the fixed budget against single-device CG,
    ring's row blocks; one line and one launch record a comm."""
    from repro_torch.kernels.ops import gram_mv

    world = len(ranks)
    for rk, r in enumerate(ranks):
        rhs = r["rhs"]
        _dist_launches(f"{part} rank {rk}: f_X", rhs, dict(rff_matvec=1))
        _dist_no_plain(f"{part} rank {rk}: f_X", rhs)
    _record_path(kernels, f"dist_{part}_rhs", _sum_counts([r["rhs"] for r in ranks], "launches"),
                 _sum_counts([r["rhs"] for r in ranks], "bf16"))
    _dist_path_line(kernels, "rff_matvec", f"dist_{part}_rhs", f"{part} f_X",
                    [r["rff"]["f_x"] for r in ranks])
    emit("distributed_kernels", part=part, ranks=world, rff=[r["rff"] for r in ranks],
         gram={tag: dict(shape=ranks[0]["runs"][tag]["kernel_shape"],
                         by_rank=[r["runs"][tag]["kernel"] for r in ranks])
               for tag in ranks[0]["runs"]})
    gather_mv = [r["runs"]["gather"]["mv_rows"] for r in ranks]
    for tag in ranks[0]["runs"]:
        recs = [r["runs"][tag] for r in ranks]
        ring = recs[0]["resolved"] == "ring"
        for run in ("full", "budget"):
            its = {(rec[run]["iterations"], rec[run]["matvecs"]) for rec in recs}
            check(len(its) == 1, f"{part} {tag} {run}: every rank the same counts {its}")
            for rk, rec in enumerate(recs):
                it, what = rec[run], f"{part} {tag} {run} rank {rk}"
                check(it["matvecs"] == it["iterations"], f"{what}: matvecs == iterations")
                _dist_launches(what, it, dict(gram_matvec=(world if ring else 1) * it["iterations"]))
                _dist_no_plain(what, it)
                staged = it["collectives"]["staged_bytes"]
                check(staged > 0 if world > 1 else staged == 0,
                      f"{what}: {staged} bytes staged through the host ({ranks[0]['backend']})")
                if ring:
                    check(it["solution_shape"] == [x.shape[0] // world, DIST["samples"] + 1],
                          f"{what}: ring's solution stays this rank's block "
                          f"{it['solution_shape']}")
        full = recs[0]["full"]
        want_its = single["full"].iterations
        check(abs(full["iterations"] - want_its) <= DIST["iters_rtol"] * want_its,
              f"{part} {tag}: {full['iterations']} iterations within 15% of single-device "
              f"CG's {want_its}")
        check(all(rec["full"]["converged"] for rec in recs), f"{part} {tag}: CG converged")
        v = torch.cat([rec["full_rows"] for rec in recs]).to(x.device)
        mean = gram_mv(p, xt, v[:, 0].contiguous(), z=x)
        exact = oracle["exact_mean"]
        rel = ((mean - exact).norm() / exact.norm()).item()
        check(rel <= 1e-2, f"{part} {tag}: mean within 1e-2 of the Cholesky mean ({rel})")
        mv_vs_gather = max(_scaled_err(rec["mv_rows"], g) for rec, g in zip(recs, gather_mv))
        check(mv_vs_gather <= DIST["prim_tol"],
              f"{part} {tag}: mv within {DIST['prim_tol']} of gather's ({mv_vs_gather})")
        budget = torch.cat([rec["budget_rows"] for rec in recs]).to(x.device)
        budget_err = _scaled_err(budget, single["budget"].solution)
        curve = ring_order_err = None
        vs_fp64 = dict(distributed=_scaled_err(budget, single["fp64"]["budget"]),
                       single_device=_scaled_err(single["budget"].solution,
                                                 single["fp64"]["budget"]))
        check(recs[0]["budget"]["iterations"] == single["budget"].iterations == DIST["budget"],
              f"{part} {tag}: {DIST['budget']} iterations at the budget")
        if ring and world > 1:
            # ring sums a row over P launches where the single device sums it
            # in one, and fp32 CG carries that rounding far (its distance from
            # single-device CG at each budget is printed): held within
            # budget_tol of single-device CG with the ring's row sums, and, as
            # route parity holds SGD, to the float64 route no further than
            # PARITY_FP64_MARGIN × the single device's own distance
            curve = {k: _scaled_err(torch.cat([rec["curve_rows"][k] for rec in recs]).to(x.device),
                                    single["curve"][k]) for k in DIST["ring_budgets"]}
            ring_order_err = _scaled_err(budget, single["ring_order"][world])
            check(ring_order_err <= DIST["budget_tol"],
                  f"{part} {tag}: {DIST['budget']} iterations within {DIST['budget_tol']} of "
                  f"scale of single-device CG on the ring's row sums ({ring_order_err})")
            limit = PARITY_FP64_MARGIN * vs_fp64["single_device"]
            check(vs_fp64["distributed"] <= limit,
                  f"{part} {tag}: {DIST['budget']} iterations {vs_fp64['distributed']} of scale "
                  f"from the float64 route, within {limit}")
        else:
            # gather contracts each row in one launch of the single device's
            # shape, and its vectors are whole: the single device's bits
            check(budget_err <= DIST["budget_tol"],
                  f"{part} {tag}: {DIST['budget']} iterations within {DIST['budget_tol']} of "
                  f"scale of single-device CG ({budget_err})")
        emit("distributed", part=part, ranks=world, backend=ranks[0]["backend"], comm=tag,
             resolved=recs[0]["resolved"], n=int(x.shape[0]), rhs_columns=DIST["samples"] + 1,
             iterations=full["iterations"], single_device_iterations=want_its,
             matvecs=full["matvecs"], max_rel_residual=full["max_rel_residual"],
             rel_mean_err_vs_cholesky=rel, budget_err=budget_err, budget_vs_fp64=vs_fp64,
             ring_curve=curve, budget_vs_ring_order=ring_order_err, mv_vs_gather=mv_vs_gather,
             solve_wall_s=[rec["full"]["wall_s"] for rec in recs],
             single_device_wall_s=single["full_wall_s"],
             ms_per_mv=[rec["ms_per_mv"] for rec in recs],
             kernel_ms=[rec["kernel"]["ms"] for rec in recs],
             kernel_plain_ms=[rec["kernel"]["plain_ms"] for rec in recs],
             kernel_err=[rec["kernel"]["max_abs_err"] for rec in recs],
             kernel_shape=recs[0]["kernel_shape"], kernel_bound_ms=recs[0]["kernel"]["bound_ms"],
             collectives_per_solve=full["collectives"],
             collectives_per_mv={k: v / DIST["mv_reps"]
                                 for k, v in recs[0]["mv_counts"]["collectives"].items()},
             launches_per_rank=full["launches"]["gram_matvec"],
             solution_shape=full["solution_shape"])
        windows = [rec[run] for rec in recs for run in ("full", "budget")]
        _record_path(kernels, f"dist_{part}_{tag}", _sum_counts(windows, "launches"),
                     _sum_counts(windows, "bf16"))
        _dist_path_line(kernels, "gram_matvec", f"dist_{part}_{tag}", f"{part} {tag}",
                        [rec["kernel"] for rec in recs])


def _dist_stochastic_checks(torch, ranks, single, kernels) -> None:
    """SGD, SDD and AP at P = 2 against the single-device runs on the same
    draws, with their counts and launch identities."""
    world, steps = len(ranks), DIST["steps"]
    for name, ref in single["stochastic"].items():
        recs = [r["stochastic"][name] for r in ranks]
        ring = recs[0]["comm"]["comm"] == "ring"
        fin = world if ring else 1  # finalize's matvec: P launches under ring
        want = dict(sgd=dict(gram_matvec=2 * steps + fin, rff_t_matvec=steps, rff_matvec=steps),
                    sdd=dict(gram_matvec=steps + fin), ap=dict(gram_matvec=steps))[name]
        for rk, rec in enumerate(recs):
            what = f"p2 {name} rank {rk}"
            check(rec["iterations"] == steps, f"{what}: {steps} steps")
            check(rec["matvecs"] == (0 if name == "ap" else 1), f"{what}: matvecs {rec['matvecs']}")
            _dist_launches(what, rec, want)
            _dist_no_plain(what, rec)
        sol = torch.cat([rec["rows"] for rec in recs]).to(ref.solution.device)
        err = _scaled_err(sol, ref.solution)
        vs_fp64 = None if name != "sgd" else dict(
            distributed=_scaled_err(sol, single["fp64"]["sgd"]),
            single_device=_scaled_err(ref.solution, single["fp64"]["sgd"]))
        emit("distributed_stochastic", solver=name, ranks=world, comm=recs[0]["comm"],
             steps=steps, err_vs_single_device=err, tol=DIST["stoch_tol"], vs_fp64=vs_fp64,
             matvecs=recs[0]["matvecs"], wall_s=[rec["wall_s"] for rec in recs],
             ms_per_step=[rec["ms_per_step"] for rec in recs],
             single_device_ms_per_step=single["stochastic_ms"][name],
             collectives=recs[0]["collectives"], launches_per_rank=recs[0]["launches"],
             feature_counts=recs[0]["feature_counts"])
        check(bool(torch.isfinite(sol).all()), f"p2 {name}: finite iterates")
        check(err <= DIST["stoch_tol"], f"p2 {name}: within {DIST['stoch_tol']} of scale of "
              f"the single-device run on the same draws ({err})")
        _record_path(kernels, f"dist_p2_{name}", _sum_counts(recs, "launches"),
                     _sum_counts(recs, "bf16"))
    for name, key in (("rff_t_matvec", "sgd_pull"), ("rff_matvec", "sgd_push")):
        _dist_path_line(kernels, name, "dist_p2_sgd", f"p2 sgd {key}",
                        [r["rff"][key] for r in ranks])


def _dist_primitive_checks(ranks, kernels) -> None:
    """P = 4: every primitive under ring within 1e-5 of gather, and a
    matvec's collectives and launches."""
    world = len(ranks)
    errs = {}
    for rk, r in enumerate(ranks):
        for k in ("mv", "rows_mv", "rows_t_mv", "pair_err", "pair_g", "block_at"):
            errs[k] = max(errs.get(k, 0.0), _scaled_err(r["ring"][k], r["gather"][k]))
        for comm, want in (("gather", dict(all_gather=2, ppermute=0, psum=0)),
                           ("ring", dict(all_gather=0, ppermute=2 * (world - 1), psum=0))):
            got = {k: r[comm]["mv_counts"]["collectives"][k] for k in want}
            check(got == want, f"p4 {comm} rank {rk}: collectives a matvec {got} == {want}")
            per_mv = world if comm == "ring" else 1
            _dist_launches(f"p4 {comm} rank {rk}: mv", r[comm]["mv_counts"],
                           dict(gram_matvec=per_mv))
            for rec in (r[comm]["mv_counts"], r[comm]["counts"]):
                _dist_no_plain(f"p4 {comm} rank {rk}", rec)
    emit("distributed_primitives", ranks=world, n=DIST["p4_n"], ring_vs_gather=errs,
         tol=DIST["prim_tol"], collectives_per_mv={
             comm: ranks[0][comm]["mv_counts"]["collectives"] for comm in ("gather", "ring")},
         launches={comm: ranks[0][comm]["counts"]["launches"] for comm in ("gather", "ring")})
    for k, e in errs.items():
        check(e <= DIST["prim_tol"], f"p4 {k}: ring within {DIST['prim_tol']} of gather ({e})")
    windows = [r[comm][w] for r in ranks for comm in ("gather", "ring")
               for w in ("mv_counts", "counts")]
    _record_path(kernels, "dist_p4", _sum_counts(windows, "launches"),
                 _sum_counts(windows, "bf16"))


def distributed_phase(torch, kernels: dict, oracle: dict) -> None:
    """``distributed_solve`` on the card, its ranks spawned on a free
    localhost port: at P = 1 on NCCL and at P = 2 on gloo (both ranks on
    the one card: NCCL refuses two ranks on one card, so gloo stages every
    collective through host memory, and the ranks' kernels time-slice the
    card: these times measure neither NVLink nor overlap), the CG cell's
    problem at protein's full n with 65 columns [y | f_X + ε], f_X on 2,048
    features through ``ShardedFourierFeatures.phi_mv``; CG to tol under
    gather and ring (and at P = 2 gather_once and auto, whose budget resolves
    to ring) against the Cholesky oracle and single-device CG, and at an
    18-iteration budget against single-device CG (ring: with the ring's row
    sums, ``RingOrderGram``); at P = 2, 200 steps of SGD,
    SDD and AP against the single-device runs on the same draws; at P = 4
    on the first DIST["p4_n"] rows, every primitive under ring against
    gather. Each rank's counts are set to 0 just before each window and read
    just after; a failed rank fails the phase."""
    import tempfile

    from repro_torch.core import CG, Gram, make_params, solve
    from repro_torch.core.rff import FourierFeatures
    from repro_torch.core.solvers import RowDraws, SGDDraws
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.testing.ranks import RingOrderGram, run_ranks

    t_phase = time.perf_counter()
    data = regression_dataset("protein", seed=SEED)
    d, dev = data["d"], torch.device("cuda")
    hypers = dict(lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1, d=d)
    inp = _dist_inputs(torch, data, make_params("matern32", device="cpu", **hypers))
    p = make_params("matern32", device=dev, **hypers)
    x, xt = inp["x"].to(dev), torch.as_tensor(data["x_test"], device=dev)
    ff = FourierFeatures(omega=inp["omega"].to(dev), phase=torch.zeros(inp["omega"].shape[0],
                                                                       device=dev),
                         signal=p.signal)
    b = torch.cat([inp["y"].to(dev)[:, None],
                   ff.phi_mv(x, inp["w"].to(dev)) + inp["eps"].to(dev)], dim=1)
    op, specs = Gram(x=x, params=p), _dist_specs()
    single = dict(stochastic={}, stochastic_ms={})
    for run in ("full", "budget"):
        t0 = time.perf_counter()
        single[run] = solve(op, b, specs[run])
        torch.cuda.synchronize()
        single[run + "_wall_s"] = time.perf_counter() - t0
    single["curve"] = {k: solve(op, b, CG(max_iters=k, tol=1e-12)).solution
                       for k in DIST["ring_budgets"]}
    single["ring_order"] = {2: solve(RingOrderGram(x=x, params=p, world=2), b,
                                     specs["budget"]).solution}
    draws = dict(sgd=SGDDraws(idx=inp["sgd_idx"].to(dev), omega=inp["sgd_omega"].to(dev)),
                 sdd=RowDraws(idx=inp["rows_idx"].to(dev)), ap=RowDraws(idx=inp["rows_idx"].to(dev)))
    for name in ("sgd", "sdd", "ap"):
        t0 = time.perf_counter()
        single["stochastic"][name] = solve(op, b, specs[name], draws=draws[name])
        torch.cuda.synchronize()
        single["stochastic_ms"][name] = 1e3 * (time.perf_counter() - t0) / DIST["steps"]
    # the float64 plain route on the same inputs and draws: how far each fp32
    # route's rounding carries the budget's CG and SGD's clipped steps
    op64 = Gram(x=x.double(), params=make_params("matern32", dtype=torch.float64, device=dev,
                                                 **hypers), backend="chunked")
    single["fp64"] = dict(budget=solve(op64, b.double(), specs["budget"]).solution, sgd=solve(
        op64, b.double(), specs["sgd"],
        draws=SGDDraws(idx=draws["sgd"].idx, omega=draws["sgd"].omega.double())).solution)
    ranks, spawn_s = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(inp, path)
        torch.cuda.empty_cache()
        for part, world in (("p1", 1), ("p2", 2), ("p4", 4)):
            t0 = time.perf_counter()
            run_ranks(_dist_rank, world, path, tmp, part, timeout=DIST["run_timeout"])
            spawn_s[part] = time.perf_counter() - t0
            ranks[part] = [torch.load(Path(tmp) / f"{part}_rank{r}.pt") for r in range(world)]
    check(ranks["p1"][0]["backend"] == "nccl", f"P = 1 on NCCL, got {ranks['p1'][0]['backend']}")
    check(all(r["backend"] == "gloo" for r in ranks["p2"]), "P = 2 on one card on gloo")
    for part in ("p1", "p2"):
        _dist_cg_checks(torch, part, ranks[part], single, oracle, kernels, p, x, xt)
    _dist_stochastic_checks(torch, ranks["p2"], single, kernels)
    _dist_primitive_checks(ranks["p4"], kernels)
    emit("distributed_phase", seconds=time.perf_counter() - t_phase, ranks_seconds=spawn_s,
         single_device_iterations=single["full"].iterations)


def sparse_phase(torch, kernels: dict) -> dict:
    """bench_solvers' SVGP(SGPR) row at protein's full n through the entry
    points a user calls: ``sgpr`` and ``sgpr_elbo``; ``sgpr_iterative``
    and its mean and variance at the 1,024 test points (the variance a
    1,024-column NormalEq solve); ``inducing_posterior`` and its mean and
    sample paths there; the SVGP natural-gradient schedule and
    ``svgp_mean_var``. Each held against the float64 dense SGPR on the same
    Z (SPARSE's tolerances), and the iterative paths' launches read around
    them: 3 Gram launches a NormalEq matvec, 1 for each right-hand side, 1
    RFF launch for the inducing prior's f_X and 1 an evaluation of its sample
    paths, no plain dispatch. Where an iterative check misses, the same spec
    on the float64 plain route (backend "chunked") gives the yardstick.
    Returns the problem (θ, x, y, Z, the test points) for the profile."""
    from repro_torch.core import (
        CG, inducing_posterior, make_params, sgpr, sgpr_elbo, sgpr_iterative,
    )
    from repro_torch.core.svgp import SVGPState, svgp_mean_var, svgp_natgrad_step
    from repro_torch.data.pipeline import regression_dataset

    cfg, dev = SPARSE, torch.device("cuda")
    data = regression_dataset("protein", seed=SEED)
    d = data["d"]
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    xt = torch.as_tensor(data["x_test"], device=dev)
    y_test = torch.as_tensor(data["y_test"], device=dev)
    n = x.shape[0]
    z = x[::max(1, n // cfg["m"])][:cfg["m"]]
    params = make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                         d=d, device=dev)
    p64 = map_params_double(params)
    x64, y64, z64, xt64 = x.double(), y.double(), z.double(), xt.double()

    t0 = time.perf_counter()
    oracle = sgpr(p64, x64, y64, z64)
    o_mean, o_var = oracle.mean(xt64), oracle.var(xt64)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0

    # the dense baseline, as the bench's row times it
    _reset_counts(torch)
    t0 = time.perf_counter()
    post = sgpr(params, x, y, z)
    mean, var = post.mean(xt), post.var(xt)
    torch.cuda.synchronize()
    sgpr_s = time.perf_counter() - t0
    elbo = sgpr_elbo(params, x, y, z).item()
    elbo64 = sgpr_elbo(p64, x64, y64, z64).item()
    dense_launches, dense_mv, _ = _read_counts()
    rmse, nll = _test_metrics(torch, mean, var, y_test)
    sgpr_err = dict(mean=_scaled_err(mean, o_mean), var=_scaled_err(var, o_var))
    check(all(math.isfinite(v) and v <= SGPR_TOL for v in sgpr_err.values()),
          f"sgpr in fp32 within {SGPR_TOL} of the float64 oracle's scale: {sgpr_err}")
    check(sum(dense_launches.values()) == 0 and sum(dense_mv.values()) == 0,
          "the dense SGPR dispatches no Gram matvec")

    def held(errs, plain_errs):
        """Each error within SPARSE_TOL, or, where the float64 plain route
        misses it too, within SPARSE_PLAIN_RATIO × that route's."""
        out = {}
        for k, e in errs.items():
            if e <= SPARSE_TOL:
                out[k] = "tol"
            else:
                p = plain_errs()[k]
                check(p > SPARSE_TOL, f"{k}: the kernel route misses {SPARSE_TOL} ({e}) where "
                      f"the float64 plain route meets it ({p}): a port fault")
                check(e <= SPARSE_PLAIN_RATIO * p, f"{k}: the kernel route's gap {e} within "
                      f"{SPARSE_PLAIN_RATIO} × the float64 plain route's {p}")
                out[k] = "plain_ratio"
        return out

    # sgpr_iterative: the fit's NormalEq solve, then the mean and the
    # 1,024-column variance solve at the test points
    _reset_counts(torch)
    t0 = time.perf_counter()
    it = sgpr_iterative(params, x, y, z)
    torch.cuda.synchronize()
    it_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it_mean = it.mean(xt)
    solved = it.var_solve(xt)
    it_var, var_info = solved.var, solved.solve_info
    torch.cuda.synchronize()
    it_pred_s = time.perf_counter() - t0
    launches, matvec_counts, feature_counts = _read_counts()
    fit_info = it.solve_info
    want = 3 * fit_info.matvecs + 1 + 3 * var_info.matvecs
    check(launches["gram_matvec"] == want, f"sgpr_iterative: Gram launches "
          f"{launches['gram_matvec']} == 3·{fit_info.matvecs} + 1 + 3·{var_info.matvecs}")
    check(launches["rff_matvec"] == 0 and launches["gram_matvec_bwd"] == 0,
          f"sgpr_iterative: no feature or backward launch: {launches}")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0 and matvec_counts["cuda"]
          == want, f"sgpr_iterative: every Gram dispatch on cuda: {matvec_counts}")
    check(feature_counts["features"] == 0, "sgpr_iterative: no materialised feature matrix")
    check(fit_info.healthy and var_info.healthy, "sgpr_iterative's solves carry no flag")
    _record_path(kernels, "sgpr_iterative", launches)
    it_err = dict(mean=_scaled_err(it_mean, o_mean), var=_scaled_err(it_var, o_var))
    plain = {}

    def it_plain():
        if "sgpr_iterative" not in plain:
            spec = CG(max_iters=400, tol=1e-6, backend="chunked")
            t0 = time.perf_counter()
            ref = sgpr_iterative(p64, x64, y64, z64, spec=spec)
            pm, pvar = ref.mean(xt64), ref.var_solve(xt64)
            pv, pinfo = pvar.var, pvar.solve_info
            torch.cuda.synchronize()
            plain["sgpr_iterative"] = dict(
                mean=_scaled_err(pm, o_mean), var=_scaled_err(pv, o_var),
                fit_iterations=ref.solve_info.iterations, var_iterations=pinfo.iterations,
                seconds=time.perf_counter() - t0)
        return plain["sgpr_iterative"]

    it_held = held(it_err, it_plain)

    # the inducing-point pathwise posterior on the same Z
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _reset_counts(torch)
    t0 = time.perf_counter()
    ind = inducing_posterior(params, x, y, z, generator=gen, num_samples=cfg["num_samples"],
                             num_features=cfg["num_features"])
    torch.cuda.synchronize()
    ind_fit_s = time.perf_counter() - t0
    fit_launches, _, _ = _read_counts()
    t0 = time.perf_counter()
    ind_mean = ind.mean(xt)
    paths = ind(xt)
    torch.cuda.synchronize()
    ind_pred_s = time.perf_counter() - t0
    launches, matvec_counts, feature_counts = _read_counts()
    info = ind.solve_info
    check(fit_launches["gram_matvec"] == 1 + 3 * info.matvecs and fit_launches["rff_matvec"] == 1,
          f"inducing_posterior: Gram = 1 + 3·{info.matvecs}, RFF = 1: {fit_launches}")
    check(launches["gram_matvec"] == fit_launches["gram_matvec"]
          and launches["rff_matvec"] == 2, f"the sample paths: 1 RFF launch: {launches}")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0
          and feature_counts["features"] == 0 and feature_counts["cuda"] == 2,
          f"inducing: no plain dispatch: {matvec_counts}, {feature_counts}")
    check(info.healthy, "inducing_posterior's solve carries no flag")
    check(paths.shape == (xt.shape[0], cfg["num_samples"]) and bool(torch.isfinite(paths).all()),
          "finite sample paths of the expected shape")
    _record_path(kernels, "inducing", launches)
    ind_err = dict(mean=_scaled_err(ind_mean, o_mean))

    def ind_plain():
        if "inducing" not in plain:
            t0 = time.perf_counter()
            ref = inducing_posterior(p64, x64, y64, z64,
                                     generator=torch.Generator(device=dev).manual_seed(SEED),
                                     num_samples=cfg["num_samples"],
                                     num_features=cfg["num_features"],
                                     spec=CG(max_iters=200, tol=1e-5, backend="chunked"))
            pm = ref.mean(xt64)
            torch.cuda.synchronize()
            plain["inducing"] = dict(mean=_scaled_err(pm, o_mean),
                                     iterations=ref.solve_info.iterations,
                                     seconds=time.perf_counter() - t0)
        return plain["inducing"]

    ind_held = held(ind_err, ind_plain)

    # SVGP: natural-gradient steps from the prior, full batch then minibatches
    m = z.shape[0]
    state = SVGPState(theta1=torch.zeros(m, device=dev), theta2=-0.5 * torch.eye(m, device=dev))
    t0 = time.perf_counter()
    for _ in range(cfg["full_steps"]):
        state = svgp_natgrad_step(params, x, y, z, state, n_total=n, lr=cfg["full_lr"])
    for _ in range(cfg["batch_steps"]):
        idx = torch.randint(0, n, (cfg["batch"],), generator=gen, device=dev)
        state = svgp_natgrad_step(params, x[idx], y[idx], z, state, n_total=n,
                                  lr=cfg["batch_lr"])
    sv_mean, sv_var = svgp_mean_var(params, z, state, xt)
    torch.cuda.synchronize()
    svgp_s = time.perf_counter() - t0
    svgp_err = (sv_mean.double() - o_mean).abs().max().item()
    check(math.isfinite(svgp_err) and svgp_err <= SVGP_TOL,
          f"the SVGP mean within {SVGP_TOL} of the oracle's: {svgp_err}")
    o_rmse, o_nll = _test_metrics(torch, o_mean.float(), o_var.float(), y_test)
    emit("sparse", n=n, d=d, m=m, n_test=int(xt.shape[0]),
         oracle=dict(seconds=oracle_s, rmse=o_rmse, nll=o_nll, elbo=elbo64),
         sgpr=dict(wall_s=sgpr_s, rmse=rmse, nll=nll, elbo=elbo, err=sgpr_err, tol=SGPR_TOL),
         sgpr_iterative=dict(
             fit_s=it_fit_s, predict_s=it_pred_s, wall_s=it_fit_s + it_pred_s,
             fit_iterations=fit_info.iterations, fit_matvecs=fit_info.matvecs,
             fit_rel_residual=fit_info.rel_residual.max().item(),
             var_columns=int(xt.shape[0]), var_iterations=var_info.iterations,
             var_matvecs=var_info.matvecs, var_rel_residual=var_info.rel_residual.max().item(),
             ridge=float(it.op.ridge), err=it_err, held=it_held, tol=SPARSE_TOL,
             rmse_nll=_test_metrics(torch, it_mean, it_var, y_test)),
         inducing=dict(
             fit_s=ind_fit_s, predict_s=ind_pred_s, iterations=info.iterations,
             matvecs=info.matvecs, rel_residual=info.rel_residual.max().item(),
             columns=1 + cfg["num_samples"], err=ind_err, held=ind_held, tol=SPARSE_TOL,
             paths_var_vs_oracle=_scaled_err(torch.var(paths, dim=1, correction=0), o_var)),
         svgp=dict(wall_s=svgp_s, steps=cfg["full_steps"] + cfg["batch_steps"],
                   max_abs_err=svgp_err, tol=SVGP_TOL,
                   rmse_nll=_test_metrics(torch, sv_mean, sv_var, y_test)),
         plain_route=plain, launches=launches)
    return dict(params=params, x=x, y=y, z=z, xt=xt)


def lkgp_phase(torch, kernels: dict) -> dict:
    """bench_kronecker's LKGP-vs-standard row at its full size: the latent
    Kronecker posterior over the 512 × 50 learning-curve grid from its
    17,742 observed cells (``make_lkgp`` → ``lkgp_posterior``; two dense
    products an iteration, no kernel) at the bench's 200 iterations, timed;
    the bench's standard iterative GP on the same observations through the
    Gram and RFF kernels (``posterior_functions``, then its mean and samples
    on the whole grid), held to the main path's launch identities (Gram =
    iterations + 2, RFF = 2, no plain dispatch); and ``fit_curve_gp`` on the
    same grid, its error on the observed cells under CURVE_TOL. The LKGP
    mean is held within LKGP_TOL of the float64 dense posterior mean (built
    from K_obs) where CG reaches the reference's tol 1e-4, at LKGP_CHECK_ITERS
    iterations at most; 200 leave it far from converged at this size, in
    float64 as in fp32 (both gaps and residuals are printed), so the timed
    run's gap is held within LKGP_BUDGET_RATIO of the reference's own fp32
    gap at that budget, LKGP_REF_GAP. Returns the model and its centred
    observations for the profile."""
    from repro_torch.core import CG, make_params, posterior_functions
    from repro_torch.core.kernels_fn import gram
    from repro_torch.core.kronecker import (
        break_even_density, lkgp_matvec_flops, lkgp_posterior, make_lkgp,
    )
    from repro_torch.train.curve_gp import fit_curve_gp

    cfg, dev = LKGP, torch.device("cuda")
    data, idx, x_all, x_obs = _lkgp_inputs(torch)
    n1, n2 = cfg["n_configs"], cfg["n_steps"]
    n_obs = int(idx.shape[0])
    p1 = make_params("matern52", lengthscale=1.0, signal=1.0, d=data["grid1"].shape[1],
                     device=dev)
    p2 = make_params("matern52", lengthscale=1.0, signal=1.0, d=1, device=dev)
    gp = make_lkgp(p1, p2, data["grid1"], data["grid2"], data["mask"], cfg["noise"])
    check(gp.grid1.device.type == "cuda", f"make_lkgp defaults to the card: {gp.grid1.device}")
    y_obs = torch.as_tensor(data["curves"], device=dev).reshape(-1)[idx]
    y_c = y_obs - y_obs.mean()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    _reset_counts(torch)
    t0 = time.perf_counter()
    lk = lkgp_posterior(gp, y_c, generator=gen, num_samples=cfg["num_samples"],
                        max_iters=cfg["max_iters"])
    (mean, samples), info = lk, lk.solve_info
    torch.cuda.synchronize()
    lk_s = time.perf_counter() - t0
    lk_launches, lk_mv, lk_fc = _read_counts()
    check(sum(lk_launches.values()) == 0 and sum(lk_mv.values()) == sum(lk_fc.values()) == 0,
          "the LKGP's matvecs are its two dense products: no kernel, no Gram dispatch")
    check(info.healthy and mean.shape == (n1, n2)
          and samples.shape == (n1, n2, cfg["num_samples"])
          and bool(torch.isfinite(samples).all()), "a healthy LKGP solve, finite outputs")

    # the float64 dense posterior mean: K_obs = K₁[i₁, i₁] ⊙ K₂[i₂, i₂] + σ²I
    t0 = time.perf_counter()
    p64 = (map_params_double(p1), map_params_double(p2))
    k1, k2 = gram(p64[0], gp.grid1.double()), gram(p64[1], gp.grid2.double())
    i1, i2 = idx // n2, idx % n2
    k_obs = k1[i1][:, i1] * k2[i2][:, i2]
    k_obs.diagonal().add_(cfg["noise"])
    w = torch.cholesky_solve(y_c.double()[:, None], torch.linalg.cholesky(k_obs))[:, 0]
    del k_obs
    rows = 64  # grid rows a block of K(grid, obs): 64 · 50 × n_obs float64
    mean_ref = torch.cat([((k1[a:a + rows, i1][:, None, :] * k2[:, i2][None]) @ w)
                          for a in range(0, n1, rows)])
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    def gap(m):
        return (m.double() - mean_ref).abs().max().item()

    # the bench's budget in float64 (the same model and spec), and CG to the
    # reference's tol, for the check
    gp64 = make_lkgp(*p64, gp.grid1.double(), gp.grid2.double(), data["mask"], cfg["noise"])
    lk64 = lkgp_posterior(gp64, y_c.double(), generator=gen, num_samples=1,
                          max_iters=cfg["max_iters"])
    t0 = time.perf_counter()
    lk_conv = lkgp_posterior(gp, y_c, generator=gen, num_samples=cfg["num_samples"],
                             spec=CG(max_iters=LKGP_CHECK_ITERS, tol=1e-4))
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    conv = lk_conv.solve_info
    lk_err, lk64_err, conv_err = gap(mean), gap(lk64[0]), gap(lk_conv[0])
    check(lk_err <= LKGP_BUDGET_RATIO * LKGP_REF_GAP, f"the LKGP mean at the bench's "
          f"{cfg['max_iters']} iterations: its gap {lk_err} within {LKGP_BUDGET_RATIO} × "
          f"the reference's fp32 gap {LKGP_REF_GAP} (float64's here {lk64_err})")
    check(conv.converged and conv_err <= LKGP_TOL, f"the LKGP mean at tol 1e-4 "
          f"({conv.iterations} iterations, converged {conv.converged}) within {LKGP_TOL} of "
          f"the float64 dense posterior mean: {conv_err}")

    # the bench's standard iterative GP on the same observations
    p_flat = make_params("matern52", lengthscale=1.0, signal=1.0, noise=cfg["std_noise"],
                         d=x_obs.shape[1], device=dev)
    _reset_counts(torch)
    t0 = time.perf_counter()
    pf = posterior_functions(p_flat, x_obs, y_c, generator=gen, num_samples=cfg["num_samples"],
                             num_features=cfg["std_features"],
                             spec=CG(max_iters=cfg["max_iters"]))
    torch.cuda.synchronize()
    std_s = time.perf_counter() - t0
    fit_launches, _, _ = _read_counts()
    t0 = time.perf_counter()
    std_mean, std_var = pf.sample_mean_and_var(x_all)
    torch.cuda.synchronize()
    std_pred_s = time.perf_counter() - t0
    launches, matvec_counts, feature_counts = _read_counts()
    sinfo = pf.solve_info
    check(fit_launches["gram_matvec"] == sinfo.iterations and fit_launches["rff_matvec"] == 1,
          f"the standard GP's fit: Gram = {sinfo.iterations} iterations, RFF = 1: "
          f"{fit_launches}")
    check(launches["gram_matvec"] == sinfo.iterations + 2 and launches["rff_matvec"] == 2,
          f"the standard GP: Gram = iterations + 2, RFF = 2: {launches}")
    check(matvec_counts["chunked"] == matvec_counts["dense"] == 0
          and feature_counts["features"] == 0, "the standard GP: no plain dispatch")
    check(sinfo.healthy and bool(torch.isfinite(std_mean).all() and torch.isfinite(std_var).all()),
          "the standard GP: a healthy solve, finite outputs")
    _record_path(kernels, "lkgp_standard", launches)

    # learning-curve prediction through the trainer-side entry point
    t0 = time.perf_counter()
    pred = fit_curve_gp(data["curves"], data["mask"], data["grid1"])
    torch.cuda.synchronize()
    curve_s = time.perf_counter() - t0
    check(pred.mean.device.type == "cuda", f"fit_curve_gp runs on the card: {pred.mean.device}")
    mask = torch.as_tensor(data["mask"], device=dev)
    curve_err = (pred.mean - torch.as_tensor(data["curves"], device=dev))[mask].abs().mean().item()
    check(curve_err < CURVE_TOL, f"fit_curve_gp's mean error on the observed cells "
          f"{curve_err} < {CURVE_TOL}")
    lk_flops, direct_flops = lkgp_matvec_flops(n1, n2, n_obs / (n1 * n2))
    emit("lkgp", grid=[n1, n2], n_obs=n_obs, density=n_obs / (n1 * n2),
         rho_star=break_even_density(n1, n2), matvec_flops=dict(lkgp=lk_flops,
                                                                direct=direct_flops),
         lkgp=dict(wall_s=lk_s, iterations=info.iterations, matvecs=info.matvecs,
                   rel_residual=info.rel_residual.max().item(),
                   rel_residual_mean=info.rel_residual[0].item(), converged=info.converged,
                   max_abs_err=lk_err, ref_fp32_gap=LKGP_REF_GAP, ratio=LKGP_BUDGET_RATIO,
                   oracle_s=oracle_s),
         lkgp_float64=dict(iterations=lk64.solve_info.iterations,
                           rel_residual=lk64.solve_info.rel_residual.max().item(),
                           rel_residual_mean=lk64.solve_info.rel_residual[0].item(),
                           max_abs_err=lk64_err),
         lkgp_converged=dict(wall_s=conv_s, iterations=conv.iterations,
                             rel_residual=conv.rel_residual.max().item(),
                             max_abs_err=conv_err, tol=LKGP_TOL),
         standard=dict(wall_s=std_s, predict_s=std_pred_s, iterations=sinfo.iterations,
                       matvecs=sinfo.matvecs, rel_residual=sinfo.rel_residual.max().item(),
                       converged=sinfo.converged, launches=launches),
         lkgp_speedup=std_s / lk_s,
         curve_gp=dict(wall_s=curve_s, observed_mean_abs_err=curve_err, tol=CURVE_TOL))
    return dict(gp=gp, y=y_c)


def map_params_double(params):
    """θ in float64, for the oracles."""
    from repro_torch.core import map_params

    return map_params(lambda a: a.double(), params)


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
    the reference's tolerances. Then the same model is cast to bf16 in place
    (``cast_model_``, stack by stack: the fp32 and bf16 weights are never
    both held) and served again by ``generate`` on the same tokens
    (``lm_serve_bf16``): every prefill layer one bf16 flash launch, no fp32
    flash launch and no plain attention; its last-position prefill logits
    within LM_BF16_LOGIT_TOL of the fp32 run's, of max(1, max|fp32 logits|);
    its greedy tokens equal to the fp32 run's where the fp32 plain route's
    top-2 margin exceeds LM_BF16_MARGIN × the measured logit difference, row
    by row until the first position that does not. Last, one prefill and PROFILE_DECODE_STEPS decode steps under
    the profiler, on the bf16 weights and then on the same weights cast back
    to fp32 (the fp32 run's shapes and kernels; its times do not depend on
    the values): device time by kernel, idle share."""
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
        logits_d = model_lib.decode_step(cfg, model, toks[:, :1], cache, prompt)[0]
        consist = {name: dict(max_abs_diff=(got - want).abs().max().item(),
                              excess=((got - want).abs() - CONSIST_RTOL * want.abs()).max().item())
                   for name, got, want in (("prefill", logits_k, full[:, -2]),
                                           ("decode", logits_d[:, -1], full[:, -1]))}
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

    fp32_run = dict(prefill_s=timings["prefill_s"],
                    ms_per_decode_step=1e3 * timings["decode_s"] / (gen_n - 1),
                    max_memory_allocated_gb=peak_gb, weights_gb=weights_gb)
    del cache
    _lm_serve_bf16(torch, kernels, cfg, model, tokens, toks, logits_k, margins, fp32_run)
    with torch.no_grad():
        cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
        _lm_profile(torch, cfg, model, {"tokens": tokens}, toks, cache, "_bf16")
        model_lib.cast_model_(model, torch.float32)
        torch.cuda.empty_cache()
        _lm_profile(torch, cfg, model, {"tokens": tokens}, toks, cache, "")
    del model, cache
    torch.cuda.empty_cache()


def _lm_serve_bf16(torch, kernels, cfg, model, tokens, toks, logits_fp32, margins,
                   fp32_run) -> None:
    """``lm_serve_phase``'s bf16 run: ``model`` cast to bf16 in place, then
    ``generate`` and one more prefill on the same tokens, held to the fp32
    run's logits and greedy tokens (``toks``, with the fp32 plain route's
    top-2 ``margins``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib

    b, gen_n = toks.shape
    prompt = tokens.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_lib.cast_model_(model, torch.bfloat16)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    cast_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()), "every weight is bf16")

    _reset_counts(torch)
    toks16, timings = generate(cfg, model, tokens, prompt + gen_n, gen_n)
    launches, bf16 = _read_counts()[0], _read_bf16_counts()
    attention = dict(ops.ATTENTION_TRACE_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decoded = b * (gen_n - 1)
    _record_path(kernels, "lm_serve_bf16", launches, bf16)
    with torch.no_grad():
        cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
        logits16 = model_lib.prefill(cfg, model, {"tokens": tokens}, cache)[0][:, -1]
    diff = (logits16.double() - logits_fp32.double()).abs().max().item()
    scale = max(1.0, logits_fp32.abs().max().item())
    tol = LM_BF16_LOGIT_TOL * scale
    checked = mismatched = 0
    for row in range(b):
        for i in range(gen_n):
            if margins[row, i].item() <= LM_BF16_MARGIN * diff:
                break  # below the margin, and past it the two contexts may differ
            checked += 1
            mismatched += int(toks16[row, i].item() != toks[row, i].item())
    emit("lm_serve_bf16", arch=cfg.name, layers=cfg.num_layers, batch=b, prompt=prompt,
         gen=gen_n, cast_s=cast_s, cast_peak_gb=cast_peak_gb, weights_gb=weights_gb,
         prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
         prefill_tok_per_s=b * prompt / timings["prefill_s"],
         decode_tok_per_s=decoded / timings["decode_s"],
         ms_per_decode_step=1e3 * timings["decode_s"] / (gen_n - 1),
         max_memory_allocated_gb=peak_gb, fp32=fp32_run, fp32_launches=launches,
         bf16_launches=bf16, attention_dispatches=attention,
         logit_max_abs_diff_vs_fp32=diff, logit_scale=scale, tol=tol,
         margin_factor=LM_BF16_MARGIN, positions=b * gen_n, positions_checked=checked, positions_mismatched=mismatched,
         tokens_equal_everywhere=bool(torch.equal(toks16, toks)), tokens_row0=toks16[0].tolist())
    check(toks16.shape == (b, gen_n), f"bf16 tokens of shape {(b, gen_n)}: {toks16.shape}")
    check(bf16["flash_attention"] == cfg.num_layers,
          f"bf16 flash launches {bf16['flash_attention']} == {cfg.num_layers} layers")
    check(not any(launches.values()), f"no fp32 kernel on the bf16 LM path: {launches}")
    check(all(n == 0 for k, n in bf16.items() if k != "flash_attention"),
          f"no GP kernel on the bf16 LM path: {bf16}")
    check(attention == {"cuda": cfg.num_layers, "plain": 0},
          f"bf16 prefill's attention on the kernel route only: {attention}")
    check(bool(torch.isfinite(logits16).all()), "bf16 prefill logits finite")
    check(torch.equal(torch.argmax(logits16, dim=-1), toks16[:, 0]),
          "a second bf16 prefill gives generate's first tokens")
    check(diff <= tol, f"bf16 prefill logits within {LM_BF16_LOGIT_TOL} of fp32: {diff}")
    check(mismatched == 0, f"{mismatched} bf16 greedy tokens differ above the margin")


def _lm_profile(torch, cfg, model, inputs, toks, cache, suffix: str) -> None:
    """One prefill of ``inputs`` (the tokens and any stub inputs) and
    PROFILE_DECODE_STEPS decode steps of ``model`` under the profiler
    (windows ``prefill`` and ``decode``, with ``suffix``): device time by
    kernel, idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as model_lib

    prompt = inputs["tokens"].shape[1]
    for window in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if window == "prefill":
                model_lib.prefill(cfg, model, inputs, cache)
            else:
                tok = toks[:, :1]
                for i in range(PROFILE_DECODE_STEPS):
                    logits, cache = model_lib.decode_step(cfg, model, tok, cache, prompt + i)
                    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = _device_ms_by_kernel(prof)
        device_ms = sum(by_name.values())
        flash_ms = sum(v for k, v in by_name.items() if "flash_attention" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        emit("lm_profile", window=window + suffix,
             decode_steps=PROFILE_DECODE_STEPS if window == "decode" else 0,
             wall_ms=wall * 1e3, device_ms=device_ms,
             idle_share=1.0 - device_ms / (wall * 1e3),
             flash_ms=flash_ms, flash_share=flash_ms / max(device_ms, 1e-9),
             top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
        check(0 < device_ms <= wall * 1e3, f"{window}{suffix}: device time within the wall time")


def _device_ms_by_kernel(prof) -> dict:
    """Device time by kernel name from a profile, device-side events only: a
    host op's device time repeats its kernels', and so does the device-side
    twin of a ``record_function`` range (a user annotation, or a name the
    host side has too)."""
    from torch.autograd import DeviceType

    events = prof.events()
    host = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    by_name = {}
    for ev in events:
        if (ev.device_type == DeviceType.CUDA and ev.name not in host
                and not getattr(ev, "is_user_annotation", False) and ev.device_time_total > 0):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total / 1e3
    return by_name


def _rel_dist(model, got: list, want: list) -> tuple:
    """Gradients ``got`` against ``want`` (both in ``train.optim.leaves``'
    order of ``model``), in float64: (‖got − want‖/‖want‖ over all leaves
    together, the largest of the same over one leaf of the reference's
    pytree, a stacked leaf's layers together)."""
    from repro_torch.models.model import lm_leaves

    pairs = iter(zip(got, want, strict=True))
    num = den = worst = 0.0
    for _, params in lm_leaves(model):
        d2 = w2 = 0.0
        for _ in params:
            a, b = next(pairs)
            d2 += (a.double() - b.double()).pow(2).sum().item()
            w2 += b.double().pow(2).sum().item()
        num, den = num + d2, den + w2
        worst = max(worst, math.sqrt(d2 / max(w2, 1e-300)))
    return math.sqrt(num / max(den, 1e-300)), worst


def _range_ms(prof, pattern: str) -> float:
    """Device ms of the profiled host ranges whose name holds ``pattern``
    (a ``record_function`` range, or an autograd node's evaluation),
    outermost ranges only, each with its children's kernels."""
    from torch.autograd import DeviceType

    total = 0.0
    for ev in prof.events():
        parent = ev.cpu_parent
        if (ev.device_type == DeviceType.CPU and pattern in ev.name
                and not (parent is not None and pattern in parent.name)):
            total += ev.device_time_total / 1e3
    return total


def _train_counts(launches, attention, bf16, layers, micro, what) -> None:
    check(launches["flash_attention"] == layers * micro,
          f"{what}: flash launches {launches['flash_attention']} == {layers} layers × {micro}")
    check(attention == {"cuda": layers * micro, "plain": 0},
          f"{what}: attention on the kernel route only: {attention}")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"{what}: no GP kernel on the LM training path: {launches}")
    check(not any(bf16.values()), f"{what}: no bf16 launch: {bf16}")


def lm_train_phase(torch, kernels: dict) -> None:
    """LM training at full width and depth: ``launch/train.main`` on olmo-1b
    in fp32 (LM_TRAIN: batch 8 × 1,024 planted-bigram tokens, 20 steps of the
    default AdamW, mu bf16 and nu fp32, at LM_TRAIN["lr"]), with the launch
    counts read just around it: every step one fp32 flash launch a layer, no
    plain attention, no bf16 and no GP launch. Every loss finite, and the
    mean of the last 5 at least LM_TRAIN_DROP below the first 5's
    (tests/test_train.py:28). Then, on a fresh model, one counted step and
    LM_TRAIN["profile_steps"] steps under the profiler (device ms by kernel
    and by range, idle share). Then at full width with 2 layers
    (``_lm_train_checks``): the yardstick, the micro-steps, the restart and
    the compression."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.train import AdamWConfig, init_opt_state

    cfg = get_config(LM_TRAIN["arch"])
    b, s, steps, lr = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"], LM_TRAIN["lr"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", cfg.name, "--steps", str(steps), "--batch", str(b), "--seq-len", str(s),
            "--lr", str(lr), "--seed", str(SEED)]
    _reset_counts(torch)
    t0 = time.perf_counter()
    tr = launch_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bf16 = _read_counts()[0], _read_bf16_counts()
    attention = dict(ops.ATTENTION_TRACE_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep = tr.straggler_report()
    losses, times = tr.losses, tr.step_times
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    med = sorted(times)[len(times) // 2]
    emit("lm_train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         params=model_lib.count_params(cfg), batch=b, seq=s, steps=steps, lr=lr,
         opt=dict(AdamWConfig(lr=lr)._asdict(), mu_dtype="bfloat16", nu_dtype="float32"),
         wall_s=wall, step_s=times, median_step_s=med, first_step_s=times[0],
         tok_per_s=b * s / med, max_memory_allocated_gb=peak_gb, losses=losses,
         first5_mean=first, last5_mean=last, drop=first - last, min_drop=LM_TRAIN_DROP,
         straggler=dict(median_s=rep.median_s, slow_steps=rep.slow_steps),
         launches=launches, attention_dispatches=attention)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), "every loss finite")
    check(first - last >= LM_TRAIN_DROP,
          f"the loss falls by {LM_TRAIN_DROP}: first 5 {first}, last 5 {last}")
    _train_counts(launches, attention, bf16, cfg.num_layers, steps, "lm_train")
    _record_path(kernels, "lm_train", launches)
    del tr

    opt_cfg = AdamWConfig(lr=lr)
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    opt = init_opt_state(model, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    batch = token_batch(SEED, steps, b, s, cfg.vocab_size)
    _reset_counts(torch)
    model, opt, metrics = step_fn(model, opt, batch)
    loss = float(metrics["loss"])
    launches, bf16 = _read_counts()[0], _read_bf16_counts()
    _train_counts(launches, attention=dict(ops.ATTENTION_TRACE_COUNTS), bf16=bf16,
                  layers=cfg.num_layers, micro=1, what="one lm_train step")
    check(math.isfinite(loss) and int(metrics["step"]) == 1, "the counted step's loss and step")
    _lm_train_profile(torch, cfg, step_fn, model, opt, b, s, steps + 1)
    del model, opt
    torch.cuda.empty_cache()
    _lm_train_checks(torch, cfg, kernels)


def _lm_train_profile(torch, cfg, step_fn, model, opt, b, s, step0,
                      window="lm_train", n=LM_TRAIN["profile_steps"]) -> None:
    """``n`` train steps under the profiler (profile ``window``): device ms
    by kernel (the GEMMs by name: cuBLAS's
    ``nvjet``/``gemm`` kernels; the flash forward), by range (the flash
    Function's backward, the plain attention recomputed under autograd;
    ``train_step/adamw``), and the idle share."""
    import re

    from torch.profiler import ProfilerActivity, profile

    batches = [_lm_batch(torch, cfg, step0 + i, b, s) for i in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            model, opt, metrics = step_fn(model, opt, batch)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = _device_ms_by_kernel(prof)
    device_ms = sum(by_name.values())
    gemm_ms = sum(v for k, v in by_name.items() if re.search(r"gemm|nvjet|cutlass|xmma", k, re.I))
    flash_ms = sum(v for k, v in by_name.items() if "flash_attention" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    line = dict(window=window, steps=n, wall_ms=wall * 1e3, device_ms=device_ms,
                idle_share=1.0 - device_ms / (wall * 1e3), gemm_ms=gemm_ms,
                gemm_share=gemm_ms / max(device_ms, 1e-9), flash_fwd_ms=flash_ms,
                attention_bwd_ms=_range_ms(prof, "FlashAttentionFnBackward"),
                adamw_ms=_range_ms(prof, "train_step/adamw"),
                top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
    emit("lm_profile", **line)
    check(0 < device_ms <= wall * 1e3, f"{window}: device time within the wall time")
    check(line["adamw_ms"] > 0, f"{window}: the profile saw AdamW")
    check((flash_ms > 0) == (_flash_layers(cfg) > 0),
          f"{window}: the profile saw flash where the model has GQA layers")


def _lm_train_checks(torch, cfg, kernels) -> None:
    """At full width with 2 layers (LM_TRAIN_SMALL), on one seed's weights
    and batch: the kernel route's loss and gradients against the plain
    attention route in fp32 and in float64 (the model cast to float64),
    each within TRAIN_YARD_RATIO × the fp32 plain route's distance from
    float64, or the floors TRAIN_LOSS_FLOOR (loss, relative) and
    TRAIN_GRAD_FLOOR (gradients, relative norm over all leaves and over the
    worst leaf), whichever is larger; ``micro_steps=2`` against 1 (the loss
    within MICRO_LOSS_RTOL, each gradient leaf within MICRO_GRAD_TOL of its
    scale), one flash launch a layer for each micro-batch; then the restart
    and the compression."""
    import dataclasses

    from repro_torch.data.pipeline import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.train import AdamWConfig, init_opt_state

    small = LM_TRAIN_SMALL
    cfg2 = dataclasses.replace(cfg, num_layers=small["layers"])
    b, s = small["batch"], small["seq"]
    model = model_lib.init_model_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED))
    batch = token_batch(SEED, 0, b, s, cfg2.vocab_size)
    loss_k, grads_k, yard = _yardstick(torch, cfg2, model, batch, "2-layer kernel route")

    _reset_counts(torch)
    loss_m, grads_m = loss_and_grads(cfg2, model, batch, micro_steps=2)
    torch.cuda.synchronize()
    micro_launches = _read_counts()[0]
    _train_counts(micro_launches, dict(ops.ATTENTION_TRACE_COUNTS),
                  _read_bf16_counts(), cfg2.num_layers, 2, "micro_steps=2")
    micro = dict(loss_rel=abs(loss_m.item() - loss_k.item()) / abs(loss_k.item()),
                 grad_worst_of_scale=max(((a - b_).abs().max() / b_.abs().max()).item()
                                         for a, b_ in zip(grads_m, grads_k)))
    del grads_m
    # one whole step at micro_steps=2: the same launches
    step2 = make_train_step(cfg2, AdamWConfig(lr=LM_TRAIN["lr"]), micro_steps=2)
    opt = init_opt_state(model, AdamWConfig(lr=LM_TRAIN["lr"]))
    _reset_counts(torch)
    step2(model, opt, batch)
    torch.cuda.synchronize()
    _train_counts(_read_counts()[0], dict(ops.ATTENTION_TRACE_COUNTS),
                  _read_bf16_counts(), cfg2.num_layers, 2, "a micro_steps=2 step")
    del opt
    emit("lm_train_parity", layers=cfg2.num_layers, batch=b, seq=s, **yard,
         ratio=TRAIN_YARD_RATIO, micro_steps_2=micro,
         micro_tols=dict(loss_rel=MICRO_LOSS_RTOL, grad_of_scale=MICRO_GRAD_TOL))
    _check_yardstick(yard, "2-layer")
    check(micro["loss_rel"] <= MICRO_LOSS_RTOL, f"micro-steps loss: {micro['loss_rel']}")
    check(micro["grad_worst_of_scale"] <= MICRO_GRAD_TOL,
          f"micro-steps gradients: {micro['grad_worst_of_scale']}")
    _lm_train_compress(torch, model, grads_k)
    del model, grads_k
    torch.cuda.empty_cache()
    _lm_train_restart(torch, cfg2)


def _yardstick(torch, cfg, model, batch, what: str) -> tuple:
    """One step's loss and gradients on the kernel route (its launches
    counted: one flash launch a GQA layer, nothing else), on the plain
    attention route in fp32 and in float64 (``model`` cast to float64):
    ``(loss, grads, yard)`` of the kernel route, ``yard`` the float64 loss,
    each fp32 route's distance from float64 (the loss relative; the
    gradients' relative norm over all leaves and over the worst leaf) and
    the bounds, TRAIN_YARD_RATIO × the plain fp32 route's distance or the
    floors TRAIN_LOSS_FLOOR, TRAIN_GRAD_FLOOR, whichever is larger."""
    import copy

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as model_lib

    model64 = model_lib.cast_model_(copy.deepcopy(model), torch.float64)
    _reset_counts(torch)
    loss_k, grads_k = loss_and_grads(cfg, model, batch)
    torch.cuda.synchronize()
    _train_counts(_read_counts()[0], dict(ops.ATTENTION_TRACE_COUNTS),
                  _read_bf16_counts(), _flash_layers(cfg), 1, what)
    loss_p, grads_p = loss_and_grads(cfg, model, batch, backend="plain")
    loss_64, grads_64 = loss_and_grads(cfg, model64, batch, backend="plain")
    del model64
    l64 = loss_64.item()
    dist = {name: dict(loss=abs(l.item() - l64) / abs(l64),
                       **dict(zip(("grad_rel_norm", "grad_worst_leaf"),
                                  _rel_dist(model, g, grads_64))))
            for name, l, g in (("kernel", loss_k, grads_k), ("plain_fp32", loss_p, grads_p))}
    bounds = dict(loss=max(TRAIN_YARD_RATIO * dist["plain_fp32"]["loss"], TRAIN_LOSS_FLOOR),
                  **{k: max(TRAIN_YARD_RATIO * dist["plain_fp32"][k], TRAIN_GRAD_FLOOR)
                     for k in ("grad_rel_norm", "grad_worst_leaf")})
    return loss_k, grads_k, dict(loss_float64=l64, distance_from_float64=dist, bounds=bounds)


def _check_yardstick(yard: dict, what: str) -> None:
    dist = yard["distance_from_float64"]["kernel"]
    for k, bound in yard["bounds"].items():
        check(dist[k] <= bound, f"{what}: kernel route's {k} from float64 {dist[k]} <= {bound}")


def _lm_train_compress(torch, model, grads) -> None:
    """``tree_compress_with_feedback`` on one full-width gradient (the 2-layer
    kernel route's, as the reference's pytree, layers stacked) from zero
    error, its coins drawn on the card: every payload int8, |decompress − g|
    within its leaf's scale (and an fp32 ulp of it), and the new error
    exactly g − decompress."""
    from repro_torch.models.model import leaf_tree
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import init_error_state, tree_compress_with_feedback, tree_decompress

    tree = leaf_tree(model, grads)
    errors = init_error_state(tree)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp, new_err = tree_compress_with_feedback(tree, errors, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dec = tree_decompress(comp, tree)
    worst = 0.0
    exact = int8 = True
    for c, g, d, e in zip(tree_leaves(comp), tree_leaves(tree), tree_leaves(dec),
                          tree_leaves(new_err), strict=True):
        int8 &= c.q.dtype == torch.int8
        worst = max(worst, ((d - g).abs().max() / c.scale).item())
        exact &= bool(torch.equal(e, g.float() - d))
    payload = sum(c.q.numel() for c in tree_leaves(comp))
    emit("lm_train_compress", leaves=len(tree_leaves(tree)), entries=payload,
         payload_bytes=payload, fp32_bytes=4 * payload, ms=ms,
         max_err_over_scale=worst, error_exact=exact)
    check(int8, "every payload is int8")
    check(worst <= 1.0 + 1e-6, f"|decompress - g| within the scale: {worst}")
    check(exact, "the new error is g - decompress exactly")


def _lm_train_restart(torch, cfg2) -> None:
    """Kill and resume at full width with 2 layers (LM_TRAIN_SMALL, batch
    4 × 512): LM_TRAIN_SMALL["steps"] steps in one ``Trainer`` with a
    checkpoint every ``ckpt_every``, and separately ``ckpt_every`` steps, then
    a fresh ``Trainer`` resumed from that checkpoint to the same step: the
    losses, the final parameters and the optimiser state bit-equal. The
    checkpoints go to a temporary directory, removed afterwards; one
    checkpoint's bytes, save and restore times are printed."""
    import shutil
    import tempfile

    from repro_torch.train import (
        AdamWConfig, Trainer, TrainerConfig, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.train.optim import leaves

    small = LM_TRAIN_SMALL
    tmp = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    try:
        def trainer(steps, name):
            return Trainer(cfg2, TrainerConfig(
                batch=small["batch"], seq_len=small["seq"], num_steps=steps, seed=SEED,
                ckpt_dir=os.path.join(tmp, name), ckpt_every=small["ckpt_every"],
                keep_ckpts=1, log_every=0, opt=AdamWConfig(lr=LM_TRAIN["lr"])))

        full = trainer(small["steps"], "full")
        p_full, o_full = full.run()
        shutil.rmtree(os.path.join(tmp, "full"))
        trainer(small["ckpt_every"], "resume").run()
        resumed = trainer(small["steps"], "resume")
        p_res, o_res = resumed.run()
        same = dict(
            losses=resumed.losses == full.losses,
            params=all(torch.equal(a, b) for a, b in zip(leaves(p_full), leaves(p_res))),
            mu=all(torch.equal(a, b) for a, b in zip(leaves(o_full.mu), leaves(o_res.mu))),
            nu=all(torch.equal(a, b) for a, b in zip(leaves(o_full.nu), leaves(o_res.nu))),
            step=torch.equal(o_full.step, o_res.step))
        del p_res, o_res
        free_gb = shutil.disk_usage(tmp).free / 1e9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "timed"), small["steps"],
                               {"p": p_full, "o": o_full}, extra={"losses": full.losses})
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        back, step, _ = restore_checkpoint(os.path.join(tmp, "timed"),
                                           {"p": p_full, "o": o_full})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same["restored"] = step == small["steps"] and all(
            torch.equal(a, b) for a, b in zip(leaves(back["p"]) + leaves(back["o"].mu),
                                              leaves(p_full) + leaves(o_full.mu)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("lm_train_restart", layers=cfg2.num_layers, batch=small["batch"], seq=small["seq"],
         steps=small["steps"], ckpt_every=small["ckpt_every"], losses=full.losses,
         bit_equal=same, ckpt_bytes=nbytes, save_s=save_s, restore_s=restore_s,
         disk_free_gb=free_gb)
    for k, ok in same.items():
        check(ok, f"restart: {k} bit-equal")


def _flash_layers(cfg) -> int:
    """The flash launches a forward of ``cfg`` makes: one a GQA attention
    layer (none for MLA or Mamba2; one a jamba period; one a whisper encoder
    layer and one a decoder layer, none for cross-attention)."""
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_layer_period
    return cfg.num_layers + cfg.encoder_layers


def _lm_batch(torch, cfg, step: int, b: int, s: int) -> dict:
    """Train batch ``step`` on the card: ``data.pipeline.lm_batch``'s
    planted-bigram tokens and labels (b, s) and the family's stub inputs,
    drawn from (SEED, step)."""
    from repro_torch.data.pipeline import lm_batch

    return lm_batch(cfg, SEED, step, b, s, device="cuda")


@contextlib.contextmanager
def _spy(module, name: str, on_call):
    """``module.name`` wrapped for the block: each call's arguments and result
    passed to ``on_call(args, kwargs, result)``."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        on_call(args, kwargs, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _excess(got, want, rtol: float) -> dict:
    """``assert_allclose``'s measure: max|got − want| and max(|got − want| −
    rtol·|want|), which must stay within the atol."""
    d = (got.double() - want.double()).abs()
    return dict(max_abs_diff=d.max().item(), excess=(d - rtol * want.double().abs()).max().item())


def lm_families_phase(torch, kernels: dict) -> None:
    """The LM families of LM_FAMILIES, one at a time, each freed before the
    next is built (``_lm_family``)."""
    import gc

    for fam in LM_FAMILIES:
        _lm_family(torch, kernels, fam)
        gc.collect()
        torch.cuda.empty_cache()


def _family_cfg(fam: dict):
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = get_config(fam["arch"])
    if fam["reduced"]:
        return cfg.reduced()
    return dataclasses.replace(cfg, num_layers=fam["layers"]) if fam["layers"] else cfg


def _lm_family(torch, kernels: dict, fam: dict) -> None:
    """One family served and trained on the card, in fp32. ``generate`` on
    LM_FAMILY_SERVE's prompts (``fam["prompt"]`` tokens long where given,
    with the family's stub inputs, ``data.pipeline.stub_inputs``), with the launch counts
    read just around it: one flash launch a GQA layer per prefill (whisper:
    its encoder's and its decoder's, none for cross-attention), no plain
    attention, no GP kernel. Then, untimed: ``forward_train`` on the
    prompts, whose last position holds prefill's logits at the reference's
    CONSIST_RTOL and CONSIST_ATOL (the same routing groups: MoE capacities
    depend on the group's length), each MoE layer's dropped copies counted
    (``moe.route`` watched), the first Mamba2 layer's chunked SSD held
    against the sequential scan on the same inputs (SSD_TOL); where the
    family has a ``prefix``, a prefill of the first ``prefix`` tokens and a
    decode of the next against ``forward_train``; where it has flash layers,
    its prefill on the plain attention route within LM_LOGIT_TOL of the
    kernel route's; deepseek-v2's absorbed MLA decode against the baseline
    (MLA_RTOL, MLA_ATOL). Then the prefill and decode profiles and the
    training (``_lm_family_train``)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe, ssm

    cfg = _family_cfg(fam)
    path = fam["path"]
    b, gen_n = LM_FAMILY_SERVE["batch"], LM_FAMILY_SERVE["gen"]
    prompt = fam.get("prompt", LM_FAMILY_SERVE["prompt"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    inputs = _lm_batch(torch, cfg, 0, b, prompt)
    del inputs["labels"]
    tokens = inputs["tokens"]
    extra = {k: v for k, v in inputs.items() if k != "tokens"}

    causal = {"causal": 0, "non_causal": 0}

    def count_causal(args, kwargs, out):
        causal["causal" if kwargs["causal"] else "non_causal"] += 1

    _reset_counts(torch)
    with _spy(ops, "_flash_kernel", count_causal):
        toks, timings = generate(cfg, model, tokens, prompt + gen_n, gen_n, extra)
    launches = _read_counts()[0]
    attention = dict(ops.ATTENTION_TRACE_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decoded = b * (gen_n - 1)
    flash = _flash_layers(cfg)
    want_causal = {"causal": flash - cfg.encoder_layers, "non_causal": cfg.encoder_layers}
    emit("lm_family", arch=cfg.name, path=path, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, reduced=fam["reduced"], d_model=cfg.d_model,
         params=model_lib.count_params(cfg), active_params=model_lib.active_param_count(cfg),
         weights_gb=weights_gb, batch=b, prompt=prompt, gen=gen_n,
         stub_inputs={k: list(v.shape) for k, v in extra.items()}, init_s=init_s,
         prefill_s=timings["prefill_s"], decode_s=timings["decode_s"],
         prefill_tok_per_s=b * prompt / timings["prefill_s"],
         decode_tok_per_s=decoded / timings["decode_s"],
         ms_per_decode_step=1e3 * timings["decode_s"] / (gen_n - 1),
         max_memory_allocated_gb=peak_gb, launches=launches, attention_dispatches=attention,
         flash_launches_by_mask=causal, tokens_row0=toks[0].tolist())
    check(toks.shape == (b, gen_n), f"{path}: tokens of shape {(b, gen_n)}: {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{path}: tokens in vocabulary")
    check(launches["flash_attention"] == flash,
          f"{path}: flash launches {launches['flash_attention']} == {flash} attention layers")
    check(causal == want_causal, f"{path}: flash launches by mask {causal} == {want_causal}")
    check(attention == {"cuda": flash, "plain": 0}, f"{path}: attention dispatches {attention}")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"{path}: no GP kernel on the LM path")
    _record_path(kernels, path, launches)

    drops = []

    def count_drops(args, kwargs, out):
        slot, cap = out[2], out[3]
        drops.append(((slot >= cap).sum(), slot.numel()))

    ssd_args = []

    def first_ssd(args, kwargs, out):
        if not ssd_args:
            ssd_args.append((args, out))

    checks = {}
    with torch.no_grad():
        with _spy(ssm, "ssd_chunked", first_ssd):
            full = model_lib.forward_train(cfg, model, inputs)
        cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
        with _spy(moe, "route", count_drops):
            logits_k, cache = model_lib.prefill(cfg, model, inputs, cache)
        logits_k = logits_k[:, -1]
        check(torch.equal(torch.argmax(logits_k, dim=-1), toks[:, 0]),
              f"{path}: a second prefill gives generate's first tokens")
        check(bool(torch.isfinite(full).all()), f"{path}: forward_train's logits finite")
        checks["prefill_vs_forward"] = _excess(logits_k, full[:, -1], CONSIST_RTOL)
        if drops:
            dropped = [int(n.item()) for n, _ in drops]
            copies = sum(c for _, c in drops)
            checks["moe_dropped_copies"] = dict(
                dropped=sum(dropped), copies=copies, share=sum(dropped) / copies,
                share_by_layer=[n / c for n, (_, c) in zip(dropped, drops)])
        if ssd_args:
            (args, (y, state)) = ssd_args[0]
            x, dt, a_log, bmat, cmat, d_skip, _ = args
            y_seq, state_seq = ssm.ssm_scan_ref(x, dt, a_log, bmat, cmat, d_skip)
            checks["ssd_vs_sequential"] = dict(
                shape=list(x.shape), chunk=args[6], y=_excess(y, y_seq, SSD_TOL),
                state=_excess(state, state_seq, SSD_TOL), tol=SSD_TOL)
            del ssd_args[:]
        if "prefix" in fam:
            n = fam["prefix"]
            pre_cache = model_lib.zero_cache(cfg, b, prompt + gen_n)
            pre, pre_cache = model_lib.prefill(cfg, model, dict(inputs, tokens=tokens[:, :n]),
                                               pre_cache)
            dec = model_lib.decode_step(cfg, model, tokens[:, n:n + 1], pre_cache, n)[0]
            checks["prefix_prefill_vs_forward"] = dict(
                prefix=n, **_excess(pre[:, -1], full[:, n - 1], CONSIST_RTOL))
            checks["prefix_decode_vs_forward"] = _excess(dec[:, -1], full[:, n], CONSIST_RTOL)
            del pre_cache
        del full
        if flash:
            logits_p = model_lib.prefill(cfg, model, inputs,
                                         model_lib.zero_cache(cfg, b, prompt + gen_n),
                                         backend="plain")[0][:, -1]
            scale = max(1.0, logits_p.abs().max().item())
            checks["kernel_vs_plain_route"] = dict(
                max_abs_diff=(logits_k - logits_p).abs().max().item(), scale=scale,
                tol=LM_LOGIT_TOL * scale)
        if cfg.use_mla:
            step = [model_lib.decode_step(c, model, toks[:, :1], cache, prompt)[0][:, -1]
                    for c in (cfg, dataclasses.replace(cfg, mla_absorb=True))]
            checks["mla_absorbed_vs_baseline"] = _excess(step[1], step[0], MLA_RTOL)
    emit("lm_family_checks", arch=cfg.name, path=path, **checks, rtol=CONSIST_RTOL,
         atol=CONSIST_ATOL)
    for name in ("prefill_vs_forward", "prefix_prefill_vs_forward", "prefix_decode_vs_forward"):
        if name in checks:
            check(checks[name]["excess"] <= CONSIST_ATOL,
                  f"{path}: {name} {checks[name]['excess']} > {CONSIST_ATOL}")
    if "ssd_vs_sequential" in checks:
        for k in ("y", "state"):
            check(checks["ssd_vs_sequential"][k]["excess"] <= SSD_TOL,
                  f"{path}: chunked SSD's {k} against the sequential scan")
    if "kernel_vs_plain_route" in checks:
        line = checks["kernel_vs_plain_route"]
        check(line["max_abs_diff"] <= line["tol"], f"{path}: kernel against plain route {line}")
    if "mla_absorbed_vs_baseline" in checks:
        check(checks["mla_absorbed_vs_baseline"]["excess"] <= MLA_ATOL,
              f"{path}: absorbed MLA decode against the baseline")
    check(cfg.family != "ssm" or "ssd_vs_sequential" in checks, f"{path}: SSD checked")
    check(not cfg.is_moe or "moe_dropped_copies" in checks, f"{path}: MoE routes counted")

    with torch.no_grad():
        _lm_profile(torch, cfg, model, inputs, toks, cache, "_" + path)
    del model, cache
    torch.cuda.empty_cache()
    _lm_family_train(torch, kernels, fam, cfg)


def _lm_family_train(torch, kernels: dict, fam: dict, cfg) -> None:
    """How ``fam`` is trained on the card. ``full`` (mamba2-130m,
    whisper-tiny): LM_FAMILY_TRAIN["steps"] steps of the ``Trainer`` that
    ``launch/train.main`` runs, at LM_FAMILY_TRAIN's size and rate or the
    family's ``train``, on ``_lm_batch``'s batches (whisper's with their
    frames, which the launcher does not give, as the reference's does not),
    after the yardstick step (``_yardstick``) at full size on the first
    batch where the family asks for it; every loss finite and the mean of
    the last 5 at least LM_TRAIN_DROP below the first 5's, then
    ``profile_steps`` steps profiled. ``reduced`` (the MoE configs),
    ``yardstick`` (jamba, already reduced) and ``width`` (qwen2-vl-7b): one
    counted step of ``make_train_step``, timed from a warm-up step, on the
    reduced config at ``small``'s batch, or for ``width`` at full width with
    LM_FAMILY_TRAIN["qwen2vl"]'s layers and batch; jamba's gradients, and
    those of qwen2-vl reduced to as many layers, also held to the
    yardstick."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_lib
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig, init_opt_state

    tr_cfg = LM_FAMILY_TRAIN
    path = fam["path"] + "_train"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if fam["trained"] == "full":
        size = dict(batch=tr_cfg["batch"], seq=tr_cfg["seq"], lr=tr_cfg["lr"])
        size.update(fam.get("train", {}))
        b, s, lr = (size[k] for k in ("batch", "seq", "lr"))
        steps = tr_cfg["steps"]
        opt_cfg = AdamWConfig(lr=lr)
        yard = None
        if fam.get("yardstick"):
            model = model_lib.init_model_params(cfg,
                                                torch.Generator(device="cuda").manual_seed(SEED))
            _, _, yard = _yardstick(torch, cfg, model, _lm_batch(torch, cfg, 0, b, s), path)
            del model
        _reset_counts(torch)
        tr = Trainer(cfg, TrainerConfig(batch=b, seq_len=s, num_steps=steps, seed=SEED,
                                        log_every=0, opt=opt_cfg),
                     batches=lambda i: _lm_batch(torch, cfg, i, b, s), device="cuda")
        tr.run()
        losses, times = tr.losses, tr.step_times
        del tr
        torch.cuda.synchronize()
        launches, bf16 = _read_counts()[0], _read_bf16_counts()
        attention = dict(ops.ATTENTION_TRACE_COUNTS)
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        med = sorted(times)[len(times) // 2]
        emit("lm_family_train", arch=cfg.name, path=path, layers=cfg.num_layers, batch=b,
             seq=s, steps=steps, lr=lr, step_s=times, median_step_s=med,
             tok_per_s=b * s / med, max_memory_allocated_gb=torch.cuda.max_memory_allocated()
             / 1e9, losses=losses, first5_mean=first, last5_mean=last, drop=first - last,
             min_drop=LM_TRAIN_DROP, **(yard or {}), launches=launches,
             attention_dispatches=attention)
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{path}: every loss finite")
        check(first - last >= LM_TRAIN_DROP,
              f"{path}: the loss falls by {LM_TRAIN_DROP}: first 5 {first}, last 5 {last}")
        _train_counts(launches, attention, bf16, _flash_layers(cfg), steps, path)
        _record_path(kernels, path, launches)
        if yard is not None:
            _check_yardstick(yard, path)
        model = model_lib.init_model_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        opt = init_opt_state(model, opt_cfg)
        _lm_train_profile(torch, cfg, make_train_step(cfg, opt_cfg), model, opt, b, s, steps,
                          window=path, n=tr_cfg["profile_steps"])
        return

    yard = None
    if fam["trained"] == "width":
        cfg_y = get_config(cfg.name).reduced(num_layers=tr_cfg["qwen2vl"]["layers"])
        model = model_lib.init_model_params(cfg_y,
                                            torch.Generator(device="cuda").manual_seed(SEED))
        small = tr_cfg["small"]
        _, _, yard = _yardstick(torch, cfg_y, model,
                                _lm_batch(torch, cfg_y, 0, small["batch"], small["seq"]),
                                path + "_reduced")
        yard = dict(yardstick_config=dict(arch=cfg_y.name, reduced=True,
                                          layers=cfg_y.num_layers, **small), **yard)
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg_r = dataclasses.replace(cfg, num_layers=tr_cfg["qwen2vl"]["layers"])
        b, s = tr_cfg["qwen2vl"]["batch"], tr_cfg["qwen2vl"]["seq"]
    else:
        cfg_r = cfg if fam["reduced"] else get_config(cfg.name).reduced()
        b, s = tr_cfg["small"]["batch"], tr_cfg["small"]["seq"]
    model = model_lib.init_model_params(cfg_r, torch.Generator(device="cuda").manual_seed(SEED))
    batch = _lm_batch(torch, cfg_r, 0, b, s)
    if fam["trained"] == "yardstick":
        _, _, yard = _yardstick(torch, cfg_r, model, batch, path)
    opt_cfg = AdamWConfig(lr=LM_TRAIN["lr"])
    opt = init_opt_state(model, opt_cfg)
    step_fn = make_train_step(cfg_r, opt_cfg)
    model, opt, _ = step_fn(model, opt, _lm_batch(torch, cfg_r, 1, b, s))
    _reset_counts(torch)
    t0 = time.perf_counter()
    model, opt, metrics = step_fn(model, opt, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    launches, bf16 = _read_counts()[0], _read_bf16_counts()
    attention = dict(ops.ATTENTION_TRACE_COUNTS)
    emit("lm_family_train", arch=cfg_r.name, path=path, layers=cfg_r.num_layers,
         d_model=cfg_r.d_model, params=model_lib.count_params(cfg_r), batch=b, seq=s,
         step_s=step_s, tok_per_s=b * s / step_s, loss=loss, step=int(metrics["step"]),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         **(yard or {}), launches=launches, attention_dispatches=attention)
    check(math.isfinite(loss) and int(metrics["step"]) == 2, f"{path}: the step's loss, step")
    check(all(bool(torch.isfinite(t).all()) for t in model.parameters()),
          f"{path}: the parameters finite after the step")
    _train_counts(launches, attention, bf16, _flash_layers(cfg_r), 1, path)
    _record_path(kernels, path, launches)
    if yard is not None:
        _check_yardstick(yard, path)
    del model, opt


def profile_phase(torch, engine, sparse: dict, lkgp: dict) -> None:
    """The serving and training paths, each stochastic solver's
    fit → predict at PROFILE_STOCH_STEPS steps, one Thompson acquisition
    step of PROFILE_THOMPSON_ASCENT ascent steps, the serving path on Nyström CG, one cold solve batch of the
    serving engine (a full batch's worth of sample requests on fresh seeds),
    and the sparse and LKGP phases' iterative paths (``sgpr_iterative`` with
    its variance solve, ``inducing_posterior`` with its evaluations,
    ``lkgp_posterior``, on the problems those phases built), once more under
    ``torch.profiler``: device time by kernel and the card's idle share of the
    wall time. Run after the counted passes so
    that the profiler's overhead touches no other number."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        CG, SDD, IterativeGP, ThompsonState, inducing_posterior, lkgp_posterior, make_params,
        sample_prior, sgpr_iterative, thompson_step,
    )
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

    def stochastic(name, precision=None):
        def run():
            gp = IterativeGP("matern32", spec=_stochastic_spec(name, PROFILE_STOCH_STEPS[name],
                                                               precision=precision),
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
                      spec=SDD(**THOMPSON_SDD), ascent_steps=PROFILE_THOMPSON_ASCENT,
                      **{k: cfg[k] for k in ("acq_batch", "num_features", "num_candidates",
                                             "num_top")})
        return PROFILE_THOMPSON_ASCENT

    def precond(pc):
        def run():
            gp = IterativeGP("matern32", spec=CG(max_iters=MAIN_MAX_ITERS, tol=MAIN_TOL,
                                                 precond=pc),
                             lengthscale=math.sqrt(data["d"]) * 0.5, signal=1.0, noise=0.1,
                             seed=SEED)
            gp.fit(data["x"], data["y"]).predict(data["x_test"])
            return gp.posterior(64).solve_info.iterations  # cached: no launch
        return run

    xq = torch.as_tensor(data["x_test"][:ENGINE["num_rows"]], device=dev)
    sparams, sx, sy, sz, sxt = (sparse[k] for k in ("params", "x", "y", "z", "xt"))

    def sgpr_it():
        post = sgpr_iterative(sparams, sx, sy, sz)
        post.mean(sxt)
        return post.solve_info.iterations + post.var_solve(sxt).solve_info.iterations

    def inducing():
        post = inducing_posterior(sparams, sx, sy, sz, generator=gen,
                                  num_samples=SPARSE["num_samples"],
                                  num_features=SPARSE["num_features"])
        post.mean(sxt)
        post(sxt)
        return post.solve_info.iterations

    def lkgp_run():
        return lkgp_posterior(lkgp["gp"], lkgp["y"], generator=gen,
                              num_samples=LKGP["num_samples"],
                              max_iters=LKGP["max_iters"]).solve_info.iterations

    def engine_batch():
        cols = ENGINE["max_rhs_columns"] // ENGINE["req_samples"]
        for i in range(cols):
            engine.sample(xq, num_samples=ENGINE["req_samples"], seed=10_000 + i)
        (comp, *_) = engine.step()
        return comp.metrics["iterations"]

    for path, run in (("fit_predict", fit_predict), ("train", train),
                      *((name, stochastic(name)) for name in PROFILE_STOCH_STEPS),
                      *((f"{name}_bf16", stochastic(name, "bf16"))
                        for name in PROFILE_STOCH_STEPS),
                      ("thompson", thompson),
                      ("precond_nystrom", precond(_precond_specs()["nystrom"])),
                      ("engine_solve_batch", engine_batch), ("sgpr_iterative", sgpr_it),
                      ("inducing", inducing), ("lkgp", lkgp_run)):
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
                      if "gram_matvec_kernel" in k or "gram_matvec_bf16_kernel" in k
                      or "chunk_sum_kernel" in k)
        # the Gram backward and the RFF kernel (both orientations: the
        # feature pair, Φ̃ᵀu, Φ̃W), each with its fixed-order sum
        bwd_ms = sum(v for k, v in by_name.items()
                     if "gram_bwd_kernel" in k or "bwd_sum_kernel" in k)
        rff_ms = sum(v for k, v in by_name.items()
                     if "rff_kernel<" in k or "rff_bf16_kernel<" in k or "rff_sum_kernel" in k)
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
