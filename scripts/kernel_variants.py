"""Time the variants of the flash-attention kernel and of the RFF backward on
one card.

- Flash attention: ``csrc/flash_attention.cu`` as committed, with the B
  fragments of 1 or 4 n-tiles of q k^T read and split together before their
  MMAs (``kGroupQK``; 2 committed), and with text substitutions in
  ``gram_tile.cuh``'s MMA helpers: ``mma_asm`` (the mma.sync statement not
  volatile, so the compiler may schedule it), ``zero_c`` (the first of the
  three split products takes its C from zero constants instead of zeroed
  registers). Each is compiled alone
  with the port's nvcc flags (``kernels/_build.py``) into a library of its
  own and timed at ``chip_smoke.py``'s FLASH_CASES against the plain
  version in float64.
- Flash attention on bf16 inputs (``--only flash_bf16``):
  ``csrc/flash_attention_bf16.cu`` as committed, without the consumer
  warpgroups' turns (``no_pingpong``), and without the mask (``no_mask``:
  its output then wrong, its time what the rest costs), each at the first
  four FLASH_CASES against the bf16 plain version, beside SDPA on the same
  tensors; then the host time of one call through the wrapper, its launch
  and the C entry (``host_us``), which sets a floor under the wrapper's
  time of a small launch.
- The RFF backward: its factor products on the tensor cores and on the FMA
  pipe (``rff_bwd_plan``'s ``products``), at the Thompson ascent's 400 × 512,
  d = 8, for s from 8 to 100: where the plan's NARROW_G line falls; at its
  s = 100, both also on three slices of P and Q (168 CTAs) beside the plan's
  two (112 CTAs on 132 SMs); and,
  where the time goes, ``csrc/rff_bwd.cu`` with one stage taken out at a
  time (its results then wrong, its time what the rest costs): ``no_sincos``
  (the angle's sin and cos replaced by two FMAs), ``no_products`` (no factor
  products), ``no_stage2`` (no W C on the tensor cores); and ``unroll2``
  (the factor products' k-step loop unrolled twice); at the five shapes of
  ``chip_smoke.py``'s RFF-backward cases.

Times by CUDA events (20 launches after one warm-up; the RFF backward's
product variants also as 20 launches captured in a CUDA graph and replayed,
``graph_ms``: device time without the host work between launches). Prints one JSON line
per result, the card's name and power limit first. Run from the root of a
checkout, on a machine with a card and nvcc:

    python3 scripts/kernel_variants.py --out kernel_variants.jsonl
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MMA_ASM = ("  asm volatile(\n      \"mma.sync", "  asm(\n      \"mma.sync")
ZERO_C = ("""  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(f, alo, bhi);
""", """  float f[4];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\\n"
      : "=f"(f[0]), "=f"(f[1]), "=f"(f[2]), "=f"(f[3])
      : "r"(__float_as_uint(alo[0])), "r"(__float_as_uint(alo[1])),
        "r"(__float_as_uint(alo[2])), "r"(__float_as_uint(alo[3])),
        "r"(__float_as_uint(bhi[0])), "r"(__float_as_uint(bhi[1])), "f"(0.0f));
""")
#: variant -> {source: [(old, new), ...]}
FLASH_BF16_VARIANTS = {
    "committed": {},
    "no_pingpong": {"flash_attention_bf16.cu": [("kPingPong = true;", "kPingPong = false;")]},
    # where the time goes: its output then wrong, its time what the rest costs
    "no_mask": {"flash_attention_bf16.cu": [("  if (masked) {", "  if (false) {")]},
}
FLASH_VARIANTS = {
    "committed": {},
    "qk_group1": {"flash_attention.cu": [("kGroupQK = 2;", "kGroupQK = 1;")]},
    "qk_group4": {"flash_attention.cu": [("kGroupQK = 2;", "kGroupQK = 4;")]},
    "mma_asm": {"gram_tile.cuh": [MMA_ASM]},
    "zero_c": {"gram_tile.cuh": [ZERO_C]},
}


RFF_PRODUCTS = """      pair_product_tc<true>(wa, pt, pt + kB * ps, q1t, nullptr, ps, kp, rg, cb, g, t4);
      pair_product_tc<true>(wb, pt + 2 * kB * ps, pt + 3 * kB * ps, q2t, nullptr, ps, kp, rg,
                            cb, g, t4);
"""
RFF_VARIANTS = {
    "committed": {},
    "no_sincos": {"rff_bwd.cu": [("sincosf(proj[a][b], &sn, &cn);",
                                  "sn = fmaf(proj[a][b], 0.5f, 0.25f); "
                                  "cn = fmaf(proj[a][b], -0.5f, 1.0f);")]},
    "no_products": {"rff_bwd.cu": [(RFF_PRODUCTS, "")]},
    "no_stage2": {"rff_bwd.cu": [("    pair_contract_tc<DW>(acc, wa, chi, clo, CS, cb, g, t4);\n",
                                  "")]},
    "unroll2": {"gram_tile.cuh": [("  for (int k0 = 0; k0 < kp; k0 += 8) {\n    float ahi[2][4]",
                                   "#pragma unroll 2\n  for (int k0 = 0; k0 < kp; k0 += 8) {\n"
                                   "    float ahi[2][4]")]},
}


def build_variant(source: str, name: str, subs: dict, entries, out_dir: Path):
    """(library, nvcc seconds, ptxas of its kernels) of ``source`` under
    csrc/, compiled alone with the variant's substitutions ({file: [(old,
    new)]}, raising if one does not match once), its C ``entries`` bound."""
    from repro_torch.kernels import _build

    d = out_dir / f"{Path(source).stem}_{name}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in [*_build.CSRC.glob("*.cuh"), _build.CSRC / source]:
        text = src.read_text()
        for old, new in subs.get(src.name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once in {src.name}")
            text = text.replace(old, new)
        (d / src.name).write_text(text)
    so = d / f"lib{d.name}.so"
    rc, log, secs = _build._run([_build._nvcc(), *_build.COMPILE_FLAGS, *_build.LINK_FLAGS,
                                 str(d / source), "-o", str(so)])
    if rc != 0:
        raise RuntimeError(f"nvcc {name}: {log}")
    lib = ctypes.CDLL(str(so))
    for entry in entries:
        getattr(lib, entry).argtypes = list(_build.SIGNATURES[entry])
        getattr(lib, entry).restype = ctypes.c_int
    return lib, secs, _build.parse_ptxas(log)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    ap.add_argument("--only", choices=("flash", "flash_bf16", "rff"), default=None,
                    help="time one kernel's variants only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(**fields):
        print(json.dumps(fields), flush=True)
        lines.append(json.dumps(fields))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(card=smi.stdout.strip(), torch=torch.__version__, cuda=torch.version.cuda)

    def events_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def graph_ms(fn, reps=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    out_dir = ROOT / "build" / "kernel_variants"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.only in (None, "flash"):
        flash_variants(torch, emit, events_ms, out_dir, gen, stream)
    if args.only in (None, "flash_bf16"):
        flash_bf16_variants(torch, emit, events_ms, out_dir, gen, stream)
    if args.only in (None, "rff"):
        rff_variants(torch, emit, events_ms, graph_ms, out_dir, gen, stream)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


def flash_variants(torch, emit, events_ms, out_dir, gen, stream) -> None:
    from chip_smoke import FLASH_CASES
    from repro_torch.kernels.ref import flash_attention_ref

    libs = {}
    for name, subs in FLASH_VARIANTS.items():
        lib, secs, ptx = build_variant(
            "flash_attention.cu", name, subs,
            ("repro_flash_attention_f32", "repro_flash_attention_smem_bytes"), out_dir)
        libs[name] = lib
        emit(variant=name, nvcc_seconds=secs,
             kernels=[{k: p[k] for k in ("name", "registers", "spill_stores")} for p in ptx],
             smem_bytes={d: lib.repro_flash_attention_smem_bytes(d) for d in (64, 128)})
    dev = torch.device("cuda")
    for label, b, s, hq, hkv, d, causal in FLASH_CASES:
        q = torch.randn((b, s, hq, d), generator=gen, device=dev)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
        ref = flash_attention_ref(q.double(), k.double(), v.double(), causal=causal)
        scale = max(1.0, ref.abs().max().item())
        for name, lib in libs.items():
            out = torch.empty_like(q)

            def run():
                err = lib.repro_flash_attention_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq, hkv, d,
                    int(causal), d ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            run()
            torch.cuda.synchronize()
            emit(case=label, variant=name, b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
                 ms=events_ms(run), err_of_scale=(out.double() - ref).abs().max().item() / scale)
        del ref


def flash_bf16_variants(torch, emit, events_ms, out_dir, gen, stream) -> None:
    """``csrc/flash_attention_bf16.cu``'s variants at chip_smoke.py's first four
    FLASH_CASES, each against the bf16 plain version (error of max(1, scale)),
    beside SDPA on (b, h, s, d) copies of the same bf16 tensors."""
    import torch.nn.functional as F

    from chip_smoke import FLASH_CASES
    from repro_torch.kernels.ref import flash_attention_ref

    libs = {}
    for name, subs in FLASH_BF16_VARIANTS.items():
        lib, secs, ptx = build_variant(
            "flash_attention_bf16.cu", name, subs,
            ("repro_flash_attention_bf16", "repro_flash_attention_smem_bytes_bf16"), out_dir)
        libs[name] = lib
        emit(variant=name, nvcc_seconds=secs,
             kernels=[{k: p[k] for k in ("name", "registers", "spill_stores")} for p in ptx],
             smem_bytes={d: lib.repro_flash_attention_smem_bytes_bf16(d) for d in (64, 128)})
    dev = torch.device("cuda")
    for label, b, s, hq, hkv, d, causal in FLASH_CASES[:4]:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
                   for h in (hq, hkv, hkv))
        ref = flash_attention_ref(q, k, v, causal=causal).float()
        scale = max(1.0, ref.abs().max().item())
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        emit(case=label, variant="sdpa", b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
             ms=events_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True)))
        for name, lib in libs.items():
            out = torch.empty_like(q)

            def run():
                err = lib.repro_flash_attention_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq, hkv, d,
                    int(causal), d ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            run()
            torch.cuda.synchronize()
            emit(case=label, variant=name, b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
                 ms=events_ms(run), err_of_scale=(out.float() - ref).abs().max().item() / scale)
        del ref
    host_costs(torch, emit, stream)


def host_costs(torch, emit, stream, reps=200) -> None:
    """Host time of one call, µs over ``reps`` calls without a sync, on a
    tiny bf16 input (b 1, s 128, one head of 64: the card idles): through
    ``flash_attention`` (its autograd Function, checks, allocation and
    launch), through the wrapper's ``_launch`` alone, and of the committed
    library's C entry through ctypes (its tensor maps, attribute and launch)."""
    import time

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn((1, 128, 1, 64), device="cuda").bfloat16()
    out = torch.empty_like(q)
    entry = _build.library().repro_flash_attention_bf16

    def us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / reps

    emit(case="host_us", b=1, s=128, hq=1, hkv=1, d=64,
         wrapper=us(lambda: flash_attention(q, q, q, causal=True)),
         launch=us(lambda: flash_attention._launch(q, q, q, causal=True)),
         c_entry=us(lambda: entry(q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                                  1, 128, 1, 1, 64, 1, 0.125, stream)))


def rff_variants(torch, emit, events_ms, graph_ms, out_dir, gen, stream) -> None:
    import dataclasses
    import math

    from chip_smoke import THOMPSON
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram_matvec import round_chunks
    from repro_torch.kernels.ref import rff_bwd_ref
    from repro_torch.kernels.rff_matvec import rff_bwd, rff_bwd_plan

    dev = torch.device("cuda")
    rows, d, m = THOMPSON["num_top"] * THOMPSON["acq_batch"], THOMPSON["d"], 512
    r = torch.rand((rows, d), generator=gen, device=dev)
    c = torch.randn((m, d), generator=gen, device=dev) / THOMPSON["lengthscale"]
    for s in (8, 16, 24, 32, 48, 64, 100):
        p1, p2 = (torch.randn((rows, s), generator=gen, device=dev) for _ in range(2))
        q1, q2 = (torch.randn((m, s), generator=gen, device=dev) for _ in range(2))
        ref = rff_bwd_ref(*(t.double() for t in (r, c, p1, p2, q1, q2)), scale=m ** -0.5)
        scale = max(1.0, ref.abs().max().item())
        for products in ("fma", "tc"):
            plan = rff_bwd_plan(rows, m, d, s, products)
            plans = [plan]
            if s == 100:  # the plan's geometry on three slices
                per = round_chunks(-(-m // 64), plan.row_blocks * 3, 1 if products == "tc" else 2,
                                   1)
                plans.append(dataclasses.replace(plan, slices=3, width=8 * -(-s // 24),
                                                 chunk=64 * per, chunks=-(-m // (64 * per))))
            for pl in plans:
                out = torch.empty((rows, d), device=dev)
                ws = torch.empty(pl.workspace_floats(rows, d), device=dev)

                def run():
                    err = _build.library().repro_rff_bwd_f32(
                        r.data_ptr(), c.data_ptr(), p1.data_ptr(), p2.data_ptr(), q1.data_ptr(),
                        q2.data_ptr(), ws.data_ptr(), out.data_ptr(), rows, m, d, s, m ** -0.5,
                        pl.width, pl.chunk, int(products == "tc"),
                        torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"rff_bwd {products}: launch error {err}")
                run()
                torch.cuda.synchronize()
                emit(case="rff_bwd_products", rows=rows, cols=m, d=d, s=s, products=products,
                     width=pl.width, slices=pl.slices, ctas=pl.ctas, ms=events_ms(run),
                     graph_ms=graph_ms(run),
                     err_of_scale=(out.double() - ref).abs().max().item() / scale)

    libs = {}
    for name, subs in RFF_VARIANTS.items():
        lib, secs, ptx = build_variant("rff_bwd.cu", name, subs, ("repro_rff_bwd_f32",),
                                       out_dir)
        libs[name] = lib
        emit(variant=name, nvcc_seconds=secs,
             kernels=[{k: p[k] for k in ("name", "registers", "spill_stores")} for p in ptx])
    x = torch.as_tensor(regression_dataset("protein", seed=0)["x"], device=dev)
    n, dx = x.shape
    omega = {mm: torch.randn((mm, dx), generator=gen, device=dev) / (math.sqrt(dx) * 0.5)
             for mm in (100, 1024)}
    xq = torch.rand((rows, d), generator=gen, device=dev)
    cases = [("thompson_dx", xq, c, 100), ("dx_forward_vjp", x, omega[1024], 65),
             ("domega_forward_vjp", omega[1024], x, 65), ("dx_pair_vjp", x, omega[100], 130),
             ("domega_pair_vjp", omega[100], x, 130)]
    for label, rr, cc, s in cases:
        (nr, dd), nc = rr.shape, cc.shape[0]
        p1, p2 = (torch.randn((nr, s), generator=gen, device=dev) for _ in range(2))
        q1, q2 = (torch.randn((nc, s), generator=gen, device=dev) for _ in range(2))
        plan = rff_bwd_plan(nr, nc, dd, s)
        out = torch.empty((nr, dd), device=dev)
        ws = torch.empty(plan.workspace_floats(nr, dd), device=dev)
        for name, lib in libs.items():
            def run():
                err = lib.repro_rff_bwd_f32(
                    rr.data_ptr(), cc.data_ptr(), p1.data_ptr(), p2.data_ptr(), q1.data_ptr(),
                    q2.data_ptr(), ws.data_ptr(), out.data_ptr(), nr, nc, dd, s, 0.1,
                    plan.width, plan.chunk, int(plan.products == "tc"), stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            emit(case=label, variant=name, rows=nr, cols=nc, d=dd, s=s, ms=events_ms(run))


if __name__ == "__main__":
    sys.exit(main())
