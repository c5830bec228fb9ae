#!/usr/bin/env python3
"""Unsharded LM serving times of one checkout of the port: prefill s and ms a
decode step.

    python3 scripts/decode_ab.py [--src SRC] [--reps 3] [--tag NAME] [--cpu-width W]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src/``), so
that two checkouts can be timed on one card in one call, run alternately
(A, B, B, A) to compare them. Three cases, each served through
``launch.serve.generate`` on ``chip_smoke.py``'s ``lm_serve`` cell (4 prompts
of 1,024 tokens, 16 greedy tokens, random weights from seed 0): llama3-8b at
full width and depth in fp32, the same weights cast to bf16, and dbrx-132b at
full width with 2 layers in fp32 (MoE's decode route). A case's first run is a
warm-up; the next ``--reps`` are kept. Prints one JSON line: every kept run's
prefill s and ms a decode step for each case, their medians, and the card's
name and power limit as ``nvidia-smi`` gives them. Needs the card.

``--cpu-width W`` measures the host's share instead, on the CPU with one
thread: the same cases at full depth (dbrx at 2 layers) but width ``W`` (4
heads, 2 kv heads, vocab 256), 4 prompts of 16 tokens and 33 greedy tokens,
so that a step is almost all Python and dispatch. Each case's record also
holds ``python_calls_per_pass``: the Python function calls ``cProfile``
counts in one more ``generate`` call, over its passes (a prefill and 32
decode steps). Its times are host times of this CPU, never a device's.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import statistics
import subprocess
import sys
from pathlib import Path

CASES = (("llama3-8b", None, "fp32"), ("llama3-8b", None, "bf16"), ("dbrx-132b", 2, "fp32"))
BATCH, PROMPT, GEN, SEED = 4, 1024, 16, 0
CPU_PROMPT, CPU_GEN = 16, 33


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--cpu-width", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as model_lib

    width = args.cpu_width
    prompt, gen = (CPU_PROMPT, CPU_GEN) if width else (PROMPT, GEN)
    out = {"tag": args.tag or args.src, "batch": BATCH, "prompt": prompt, "gen": gen}
    if width:
        torch.set_num_threads(1)
        device, out["device"] = "cpu", f"cpu, one thread, width {width}"
    elif not torch.cuda.is_available():
        print("decode_ab: no card", file=sys.stderr)
        return 1
    else:
        device = "cuda"
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        out["nvidia_smi"] = smi.strip().splitlines()[0]
    out["cases"] = {}
    model, loaded = None, None
    for arch, layers, precision in CASES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if width:
            cfg = dataclasses.replace(cfg, d_model=width, num_heads=4, num_kv_heads=2,
                                      head_dim=width // 4, d_ff=2 * width,
                                      moe_d_ff=2 * width, vocab_size=256)
        if loaded != (arch, layers):
            model = None
            if device == "cuda":
                torch.cuda.empty_cache()
            model = model_lib.init_model_params(
                cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
            loaded = (arch, layers)
        if precision == "bf16":
            model_lib.cast_model_(model, torch.bfloat16)
        tokens = token_batch(SEED, 0, BATCH, prompt, cfg.vocab_size, device=device)["tokens"]
        runs = []
        with torch.no_grad():
            for _ in range(args.reps + 1):
                _, t = generate(cfg, model, tokens, prompt + gen, gen)
                runs.append((t["prefill_s"], 1e3 * t["decode_s"] / (gen - 1)))
        kept = runs[1:]
        rec = out["cases"][f"{arch}{'@%d' % layers if layers else ''}_{precision}"] = {
            "prefill_s": [r[0] for r in kept], "ms_per_decode_step": [r[1] for r in kept],
            "prefill_s_median": statistics.median(r[0] for r in kept),
            "ms_per_decode_step_median": statistics.median(r[1] for r in kept)}
        if width:
            prof = cProfile.Profile()
            with torch.no_grad():
                prof.runcall(generate, cfg, model, tokens, prompt + gen, gen)
            rec["python_calls_per_pass"] = pstats.Stats(prof).total_calls / gen
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
