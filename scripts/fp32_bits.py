#!/usr/bin/env python3
"""The fp32 kernels' output bits, for any checkout of the port, on the card.

    python3 scripts/fp32_bits.py [--src DIR]

Builds the ``repro_torch`` package under DIR (default: this checkout's
``src``) and runs each fp32 kernel entry once on fixed inputs made from a
seed at the main paths' shapes (protein's n = 45,730, d = 9): the Gram
matvec at s = 65 and 9 and as the cross-covariance, the row-panel pair and
rows matvec, Φ̃W, Φ̃ᵀu and the feature pair, the Gram backward (its FMA and
tensor-core variants) and RFF backward, and flash attention. Prints one JSON line: the SHA-256 of each output's bytes,
and the card's name and power limit. Two checkouts whose lines agree give
the same bits from every fp32 kernel on these inputs (a change that adds
kernels beside them, or moves shared code between their sources, is held to
that).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package to run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("fp32_bits: needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram_matvec import (
        gram_matvec, gram_matvec_bwd, gram_rows_matvec, gram_rows_pair,
    )
    from repro_torch.kernels.rff_matvec import rff_bwd, rff_matvec, rff_pair, rff_t_matvec

    info = _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    n, d = 45_730, 9
    x, xt = normal(n, d, scale=0.6), normal(1024, d, scale=0.6)
    idx = torch.randint(0, n, (512,), generator=gen, device=dev)
    xi = x[idx].contiguous()
    v65, v9, look, b = normal(n, 65), normal(n, 9), normal(n, 65), normal(512, 65)
    om100, om1024 = normal(100, d, scale=0.8), normal(1024, d, scale=0.8)
    w8, rowv, colv = normal(2048, 8), normal(n, 8), normal(n, 8)
    q, k = normal(4, 1024, 32, 128), normal(4, 1024, 8, 128)
    # the Gram backward's tensor-core variants: G (slices past 16 columns)
    # and stage 2 (d past 16)
    x32, r100, c100 = normal(3000, 32, scale=0.3), normal(400, 100), normal(3000, 100)
    cases = {
        "gram_s65": lambda: gram_matvec(x, x, v65, kind="matern32"),
        "gram_s9_se": lambda: gram_matvec(x, x, v9, kind="se"),
        "gram_cross_s64": lambda: gram_matvec(xt, x, v65[:, :64].contiguous(),
                                              kind="matern52"),
        "rows_pair": lambda: torch.cat(gram_rows_pair(xi, x, look, b, kind="matern32",
                                                      p_true=505)),
        "rows_matvec": lambda: gram_rows_matvec(xi, x, look, kind="matern12"),
        "rff_mv_m1024_s8": lambda: rff_matvec(x, om1024, w8),
        "rff_t_m100_s65": lambda: rff_t_matvec(x, om100, look),
        "rff_pair_m100_s65": lambda: rff_pair(x, om100, look),
        "gram_bwd_s8": lambda: gram_matvec_bwd(x, x, rowv, colv, kind="matern32"),
        "gram_bwd_s100": lambda: gram_matvec_bwd(x[:400].contiguous(), x[:3000].contiguous(),
                                                 r100, c100, kind="matern52"),
        "gram_bwd_d32_s100": lambda: gram_matvec_bwd(x32[:400].contiguous(), x32, r100, c100,
                                                     kind="se"),
        "rff_bwd": lambda: rff_bwd(x[:400].contiguous(), om1024[:512].contiguous(),
                                   rowv[:400].contiguous(), rowv[:400].contiguous(),
                                   colv[:512].contiguous(), colv[512:1024].contiguous(),
                                   scale=0.03125),
        "flash": lambda: flash_attention(q, k, k, causal=True),
    }
    digests = {}
    for name, fn in cases.items():
        out = fn()
        torch.cuda.synchronize()
        digests[name] = hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(package=str(Path(repro_torch.__file__).parent), library=info.path.name,
                          build_s=info.seconds, sha256=digests, nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
