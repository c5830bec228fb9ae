"""Build and time variants of the port's Gram matvec kernel on one card.

Each variant is the committed ``src/repro_torch/kernels/csrc/`` with one text
substitution in ``gram_matvec.cu``, compiled with the port's own nvcc flags
(``kernels/_build.py``) into a library of its own:

- ``committed``: the sources as they are;
- ``every_nt``: every n-tile count 1-16 instantiated (64 kernels), where the
  committed kernel instantiates the buckets of ``REPRO_GRAM_TILE_BUCKETS`` and
  runs a slice on the smallest bucket at or above its width;
- ``tile_accum``: the tensor cores sum a whole tile's k-steps in their
  accumulator, where the committed kernel sums one k-step's three products in
  the MMA and adds the k-steps by FADD.

Times by CUDA events (20 launches, 3droad 2, after one warm-up), errors
against the float64 plain version, nvcc seconds and ``ptxas`` spills of each
variant, and SGD's first 200 steps on protein with each variant's kernels
(as ``chip_smoke.py``'s route parity runs them) against the plain route in
fp32 and in float64 on the same draws. Prints one JSON line per result, and
the card's name and power limit first. Run from the root of a checkout, on a
machine with a card and nvcc:

    python3 scripts/gram_variants.py --out gram_variants.jsonl
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BUCKETS = "#define REPRO_GRAM_TILE_BUCKETS "
PER_STEP = """              float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_tf32(f, alo[mt], bhi);
              mma_tf32(f, ahi[mt], blo);
              mma_tf32(f, ahi[mt], bhi);
#pragma unroll
              for (int e = 0; e < 4; ++e) tacc[mt][q][e] += f[e];
"""
PER_TILE = """              mma_tf32(tacc[mt][q], alo[mt], bhi);
              mma_tf32(tacc[mt][q], ahi[mt], blo);
              mma_tf32(tacc[mt][q], ahi[mt], bhi);
"""
KINDS = ("se", "matern12", "matern32", "matern52")


def variant_sources(name: str, text: str) -> str:
    """gram_matvec.cu of a variant; raises if its substitution does not match."""
    if name == "committed":
        return text
    if name == "every_nt":
        line = next(ln for ln in text.splitlines() if ln.startswith(BUCKETS))
        return text.replace(line, BUCKETS + ", ".join(str(i) for i in range(1, 17)))
    if name == "tile_accum":
        if text.count(PER_STEP) != 1:
            raise RuntimeError("tile_accum: stage 2's per-k-step sum not found")
        return text.replace(PER_STEP, PER_TILE)
    raise ValueError(name)


def build_variants(names, out_dir: Path) -> dict:
    """{name: (library, nvcc seconds of gram_matvec.cu, ptxas of its kernels)}:
    every source of the port, as ``kernels/_build.py`` builds it, with the
    variant's gram_matvec.cu; every nvcc process runs at once."""
    from repro_torch.kernels import _build

    csrc, nvcc = _build.CSRC, _build._nvcc()
    cus = sorted(csrc.glob("*.cu"))
    cmds, dirs = {}, {}
    for name in names:
        d = out_dir / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for src in list(csrc.glob("*.cuh")) + cus:
            shutil.copy(src, d / src.name)
        (d / "gram_matvec.cu").write_text(
            variant_sources(name, (csrc / "gram_matvec.cu").read_text()))
        for src in cus:
            cmds[(name, src.stem)] = [nvcc, *_build.COMPILE_FLAGS, "-c", str(d / src.name),
                                      "-o", str(d / f"{src.stem}.o")]
        dirs[name] = d
    done = _build._run_all(cmds)
    bad = {k: out for k, (rc, out, _) in done.items() if rc != 0}
    if bad:
        raise RuntimeError(f"nvcc failed: {bad}")
    libs = {}
    for name, d in dirs.items():
        so = d / f"libgram_{name}.so"
        proc = subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(so),
                               *(str(d / f"{src.stem}.o") for src in cus)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link {name}: {proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in _build.SIGNATURES.items():
            getattr(lib, entry).argtypes = list(argtypes)
            getattr(lib, entry).restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        rc, log, secs = done[(name, "gram_matvec")]
        ptx = [p for p in _build.parse_ptxas(log) if p["name"].startswith("gram_matvec_kernel")]
        libs[name] = (lib, secs, ptx)
    return libs


def sgd_drift(torch, libs, steps: int = 200) -> dict:
    """SGD's first ``steps`` steps on protein (chip_smoke.py's route parity:
    the CG cell's θ, pathwise targets of 64 samples, the bench's spec) with
    each variant's kernels, and on the plain route in fp32 and in float64,
    all on one set of draws: {route: solution}."""
    from repro_torch.core import SGD, make_params
    from repro_torch.core.operators import Gram
    from repro_torch.core.pathwise import pathwise_targets
    from repro_torch.core.rff import sample_prior
    from repro_torch.core.solvers import solve
    from repro_torch.core.solvers.sgd import SGDDraws, draw_sgd
    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels import _build

    data = regression_dataset("protein", seed=0)
    d, dev = data["d"], torch.device("cuda")

    def theta(dtype):
        return make_params("matern32", lengthscale=math.sqrt(d) * 0.5, signal=1.0, noise=0.1,
                           d=d, dtype=dtype, device=dev)

    params = theta(torch.float32)
    x = torch.as_tensor(data["x"], device=dev)
    y = torch.as_tensor(data["y"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prior = sample_prior(params, 64, 2048, d, generator=gen)
    b, delta = pathwise_targets(Gram(x=x, params=params), y, prior, generator=gen)
    spec = dict(num_steps=steps, batch_size=512, num_features=100, step_size_times_n=0.5)
    draws = draw_sgd(Gram(x=x, params=params), steps, 512, 100,
                     generator=torch.Generator(device=dev).manual_seed(1))
    sols = {}
    for name, (lib, _, _) in libs.items():
        _build._LIB = lib
        sols[name] = solve(Gram(x=x, params=params), b, SGD(backend="cuda", **spec),
                           delta=delta, draws=draws).solution
    _build._LIB = None
    sols["plain_fp32"] = solve(Gram(x=x, params=params), b, SGD(backend="chunked", **spec),
                               delta=delta, draws=draws).solution
    sols["plain_fp64"] = solve(
        Gram(x=x.double(), params=theta(torch.float64)), b.double(),
        SGD(backend="chunked", **spec), delta=delta.double(),
        draws=SGDDraws(idx=draws.idx, omega=draws.omega.double())).solution
    return sols


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    ap.add_argument("--skip-3droad", action="store_true", help="leave out the n = 434,874 case")
    args = ap.parse_args()

    import torch

    from repro_torch.data.pipeline import regression_dataset
    from repro_torch.kernels.gram_matvec import gram_plan
    from repro_torch.kernels.ref import gram_matvec_ref

    if not torch.cuda.is_available():
        print("gram_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    lines = []

    def emit(**fields):
        print(json.dumps(fields), flush=True)
        lines.append(json.dumps(fields))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(card=smi.stdout.strip(), torch=torch.__version__, cuda=torch.version.cuda)

    names = ("committed", "every_nt", "tile_accum")
    libs = build_variants(names, ROOT / "build" / "gram_variants")
    for name, (_, secs, ptx) in libs.items():
        emit(variant=name, nvcc_seconds=secs, kernels=len(ptx),
             spills={p["name"]: p["spill_stores"] for p in ptx if p["spill_stores"]})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def matvec(lib, x, z, v, kind, width=None):
        (n, d), m, s = x.shape, z.shape[0], v.shape[1]
        plan = gram_plan(n, m, d, s)
        out = torch.empty((n, s), device=dev)
        ws = torch.empty(plan.workspace_floats(n, s), device=dev)

        def run():
            err = lib.repro_gram_matvec_f32(
                x.data_ptr(), z.data_ptr(), v.data_ptr(), None, ws.data_ptr(), out.data_ptr(),
                n, m, d, s, KINDS.index(kind), n, width or plan.width, plan.chunk,
                plan.rows_per_cta, stream)
            if err:
                raise RuntimeError(f"launch error {err}")
        return run, out

    def pair(lib, xi, x, look, b, kind):
        (p, d), n, s = xi.shape, x.shape[0], look.shape[1]
        panel, back = gram_plan(p, n, d, s), gram_plan(n, p, d, s)
        ws = torch.empty(max(panel.workspace_floats(p, s), back.workspace_floats(n, s)),
                         device=dev)
        err, g = torch.empty((p, s), device=dev), torch.empty((n, s), device=dev)

        def run():
            e = lib.repro_gram_rows_pair_f32(
                xi.data_ptr(), x.data_ptr(), look.data_ptr(), b.data_ptr(), ws.data_ptr(),
                err.data_ptr(), g.data_ptr(), p, n, d, s, KINDS.index(kind), p, panel.width,
                panel.chunk, panel.rows_per_cta, back.chunk, back.rows_per_cta, stream)
            if e:
                raise RuntimeError(f"launch error {e}")
        return run, g

    data = regression_dataset("protein", seed=0)
    d = data["d"]
    xs = (torch.as_tensor(data["x"], device=dev) / (math.sqrt(d) * 0.5)).contiguous()
    n = xs.shape[0]
    kind = "matern32"
    # the main path's shapes: CG (s = 65), training (s = 9), the Thompson
    # ascent's 400 x 50,000 (d = 8, s = 100), the SGD pair at p = 512
    xq = (torch.rand((400, 8), generator=gen, device=dev) / 0.3).contiguous()
    xt = (torch.rand((50_000, 8), generator=gen, device=dev) / 0.3).contiguous()
    cases = [("cg", xs, xs, 65, True), ("train", xs, xs, 9, True),
             ("thompson", xq, xt, 100, True)]
    for label, x, z, s, with_err in cases:
        v = torch.randn((z.shape[0], s), generator=gen, device=dev)
        ref = gram_matvec_ref(x.double(), z.double(), v.double(), kind=kind, row_chunk=2048)
        scale = max(1.0, ref.abs().max().item())
        for name, (lib, _, _) in libs.items():
            run, out = matvec(lib, x, z, v, kind)
            run()
            torch.cuda.synchronize()
            err = (out.double() - ref).abs().max().item()
            emit(case=label, variant=name, n=x.shape[0], m=z.shape[0], d=x.shape[1], s=s,
                 kind=kind, ms=events_ms(run, 20), max_abs_err=err, scale=scale,
                 err_of_scale=err / scale)
        del ref
    p = 512
    xi = xs[torch.randint(0, n, (p,), generator=gen, device=dev)].contiguous()
    look = torch.randn((n, 65), generator=gen, device=dev)
    b = torch.randn((p, 65), generator=gen, device=dev)
    for name, (lib, _, _) in libs.items():
        run, _ = pair(lib, xi, xs, look, b, kind)
        emit(case="sgd_pair", variant=name, p=p, n=n, d=d, s=65, kind=kind,
             ms=events_ms(run, 20))
    # every width of 8k columns and s = 17, committed (its buckets) against
    # every count instantiated
    sub = xs[:20_000].contiguous()
    for s in (17, *range(8, 129, 8)):
        v = torch.randn((sub.shape[0], s), generator=gen, device=dev)
        for name in ("committed", "every_nt"):
            run, _ = matvec(libs[name][0], sub, sub, v, kind)
            emit(case="width", variant=name, n=sub.shape[0], d=d, s=s, kind=kind,
                 width=gram_plan(1, 1, d, s).width, ms=events_ms(run, 20))
    sols = sgd_drift(torch, libs)
    ref64 = sols["plain_fp64"].double()
    for route, sol in sols.items():
        diff = sol.double() - ref64
        plain = sol.double() - sols["plain_fp32"].double()
        emit(case="sgd_200_steps", route=route,
             vs_fp64=dict(max_abs_diff=diff.abs().max().item(),
                          max_excess_over_rtol=(diff.abs() - 2e-3 * ref64.abs()).max().item()),
             vs_plain_fp32=dict(
                 max_abs_diff=plain.abs().max().item(),
                 max_excess_over_rtol=(plain.abs() - 2e-3 * sols["plain_fp32"].abs()).max().item()))
    if not args.skip_3droad:
        big = regression_dataset("3droad", seed=0)
        xb = (torch.as_tensor(big["x"], device=dev) / (math.sqrt(big["d"]) * 0.5)).contiguous()
        v = torch.randn((xb.shape[0], 17), generator=gen, device=dev)
        for name, (lib, _, _) in libs.items():
            run, _ = matvec(lib, xb, xb, v, kind)
            emit(case="3droad", variant=name, n=xb.shape[0], d=big["d"], s=17, kind=kind,
                 ms=events_ms(run, 2))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
