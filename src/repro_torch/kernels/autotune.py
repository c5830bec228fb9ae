"""Block resolution for the port's tile kernels, the twin of
``repro/kernels/autotune.py``: ``block="auto"`` resolves on the host, from
shapes alone, to a plain ``int``, so a call never synchronises with the
device and every run of a shape gets the same launch.

What ``block`` means here. The reference's block is the square Pallas tile
its grid pads to. The port pads nothing: its kernels run CTAs of 64 rows at
once, each over a K loop of 64-column tiles, and few rows cut that loop into
chunks along grid.y (``gram_plan``, ``gram_bwd_plan``; Φ̃ᵀu's row chunks in
``rff_plan``). ``block`` is **the fewest K-loop columns one chunk of a launch
holds**: ``block // 64`` tiles, ``MIN_CHUNK_TILES`` and ``MIN_ROW_TILES``
before this module. It is free of scale (a column count, the same across a
whole n bucket), does not depend on the width s, and never changes how v is
sliced, so a column's bits stay the same at every width.

Resolution order, as the reference's:

1. **The table** (``autotune_h100.json`` beside this module, or the file
   ``REPRO_TORCH_AUTOTUNE_TABLE`` names): keys
   ``"<family>|n<bucket>|d<bucket>|<dtype>"`` over the grid below, swept on
   an H100 by ``python -m repro_torch.kernels.autotune --sweep``. Shapes
   bucket to the nearest-lower grid point; n is the row count of the call's
   x (SGD's 128- and 512-row panels fall into the first bucket).
2. **The heuristic** for a missing key or a missing or unreadable file (not
   an error): 256, four tiles, the plans as they were before the table.
3. A table value larger than ``max(CANDIDATE_BLOCKS[-1], n)`` is ignored,
   the reference's guard.

The sweep times every candidate whose plans differ from the heuristic's at
each key's shapes (a CUDA graph of 20 launches, 3 repeats, the median) and
records a candidate only where it beat the heuristic at every such shape by
more than the repeats' spread; the JSON keeps every candidate's times.
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from types import MappingProxyType

#: Kernel families with distinct launch plans.
FAMILIES = ("gram", "rff")

#: Row-count buckets (rows of the call's x). Nearest-lower match.
N_GRID = (1024, 4096, 16384, 65536)

#: Input-dimension buckets. Nearest-lower match.
D_GRID = (2, 8, 32, 128)

#: Tile precisions the table distinguishes (``"bf16"`` tiles are ``bfloat16``).
DTYPES = ("float32", "bfloat16")

#: Blocks the sweep tries, largest first (the reference's tuple).
CANDIDATE_BLOCKS = (512, 256, 128)

#: The heuristic's block: four 64-column tiles, the plans' constants before
#: the table (``gram_matvec.MIN_CHUNK_TILES``, ``rff_matvec.MIN_ROW_TILES``).
HEURISTIC_BLOCK = 256

#: The RHS width the sweep times at (the solvers' pathwise multi-RHS batch is
#: num_samples + 1 ≈ 16; the estimate is deliberately round).
RHS_WIDTH_ESTIMATE = 16

#: Environment variable overriding the committed table path. Not the
#: reference's: its table holds TPU tiles, this one H100 chunk sizes.
AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"

#: The committed H100 table, found beside this module (never relative to the
#: working directory).
DEFAULT_TABLE_PATH = str(Path(__file__).resolve().with_name("autotune_h100.json"))

#: Dynamic shared memory one CTA may take on an H100 (227 KB).
SMEM_LIMIT_BYTES = 232_448


def _bucket(grid: tuple, v: int) -> int:
    lower = [g for g in grid if g <= v]
    return max(lower) if lower else grid[0]


def table_key(family: str, n: int, d: int, dtype: str = "float32") -> str:
    """Bucketed lookup key for a (family, n, d, dtype) shape."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}; expected {FAMILIES}")
    if dtype not in DTYPES:
        raise ValueError(f"unknown tile dtype {dtype!r}; expected {DTYPES}")
    return f"{family}|n{_bucket(N_GRID, n)}|d{_bucket(D_GRID, d)}|{dtype}"


def expected_keys() -> set:
    """Every key the committed table must cover — the sweep's shape grid."""
    return {
        table_key(f, n, d, t)
        for f in FAMILIES for n in N_GRID for d in D_GRID for t in DTYPES
    }


def smem_bytes(family: str, d: int, width: int, dtype: str = "float32",
               rows_per_cta: int = 1) -> int:
    """Dynamic shared memory of one CTA of the forward kernel of ``family``
    at feature dimension d and a slice of ``width`` columns, in bytes, as the
    C entries' own queries give it (``repro_gram_matvec_smem_bytes``,
    ``repro_rff_matvec_smem_bytes`` and their bf16 twins; 0 for a width no
    instance takes), so the kernels' library must be built. A plan whose
    slice needs more than SMEM_LIMIT_BYTES cannot launch."""
    from . import _build

    sfx = "_bf16" if dtype == "bfloat16" else ""
    if family == "gram":
        return getattr(_build.library(), f"repro_gram_matvec_smem_bytes{sfx}")(
            d, width, rows_per_cta)
    return getattr(_build.library(), f"repro_rff_matvec_smem_bytes{sfx}")(d, width)


def heuristic_block(
    family: str, n: int, d: int, dtype: str = "float32",
    s: int = RHS_WIDTH_ESTIMATE,
) -> int:
    """The block without a table: HEURISTIC_BLOCK at every shape, so with no
    table every plan is the one the port ran before its table. The
    reference's VMEM budget has no counterpart: a chunk's columns never
    change a CTA's shared memory (``smem_bytes`` depends on d and the width
    alone)."""
    return HEURISTIC_BLOCK


@functools.lru_cache(maxsize=8)
def _load_table(path: str) -> MappingProxyType:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return MappingProxyType({})
    table = data.get("table", data) if isinstance(data, dict) else {}
    return MappingProxyType({str(k): int(v) for k, v in table.items()})


def _table_path(path: str | None = None) -> str:
    return path or os.environ.get(AUTOTUNE_ENV) or DEFAULT_TABLE_PATH


def load_table(path: str | None = None) -> dict:
    """The autotune table as {key: block}; {} if absent or unreadable.

    Read once per path and cached — call ``load_table.cache_clear()`` (which
    clears the resolutions made from it too) after writing a table, or
    setting REPRO_TORCH_AUTOTUNE_TABLE, in-process.
    """
    return dict(_load_table(_table_path(path)))


def _pick(table, family: str, n: int, d: int, dtype: str, s: int) -> int:
    blk = table.get(table_key(family, n, d, dtype))
    # a key bucketed down from a larger n can advise a block above this
    # problem's rows; the reference's guard ignores such advice
    if blk is not None and int(blk) <= max(CANDIDATE_BLOCKS[-1], n):
        return int(blk)
    return heuristic_block(family, n, d, dtype=dtype, s=s)


@functools.lru_cache(maxsize=4096)
def _resolve(family: str, n: int, d: int, dtype: str, s: int) -> int:
    return _pick(_load_table(_table_path()), family, n, d, dtype, s)


def _cache_clear() -> None:
    _load_table.cache_clear()
    _resolve.cache_clear()


load_table.cache_clear = _cache_clear  # type: ignore[attr-defined]


def resolve_block(
    family: str, n: int, d: int, *,
    precision: str = "fp32", table: dict | None = None,
    s: int = RHS_WIDTH_ESTIMATE,
) -> int:
    """Resolve ``block="auto"`` to a plain ``int`` from shapes alone: the
    table first, the heuristic for a missing key or table. Without a
    ``table`` given, memoised by shape, since every launch of the ``cuda``
    routes resolves its block: a table written, or a REPRO_TORCH_AUTOTUNE_TABLE
    set, after the first resolution is seen once ``load_table.cache_clear()``
    has run."""
    dtype = "bfloat16" if precision == "bf16" else "float32"
    if table is None:
        return _resolve(family, n, d, dtype, s)
    return _pick(table, family, n, d, dtype, s)


# ---------------------------------------------------------------------------
# The sweep (on the card): python -m repro_torch.kernels.autotune --sweep
# ---------------------------------------------------------------------------

#: the column count of the Gram keys' wide shapes (protein's n), the few-row
#: panels of the first n bucket (SGD's and SDD's), and the RFF keys'
#: frequency counts
SWEEP_COLS, SWEEP_PANELS, SWEEP_FREQS = 45_730, (128, 512), (512, 1024)
SWEEP_KIND, SWEEP_SEED, SWEEP_LAUNCHES, SWEEP_REPEATS = "matern32", 0, 20, 3


def _resolved(op: str, rows: int, d: int, precision: str, block: int) -> int:
    """The block a call of ``op`` with ``rows`` rows runs where the table
    holds ``block`` at its key: ``resolve_block`` on that one-key table, so
    the sweep times the plans calls run."""
    family = "gram" if op.startswith("gram") else "rff"
    dtype = "bfloat16" if precision == "bf16" else "float32"
    return resolve_block(family, rows, d, precision=precision,
                         table={table_key(family, rows, d, dtype): block})


def sweep_cases(family: str, n: int) -> list:
    """The (op, rows, cols) a key of ``family`` at bucket n is timed at: the
    Gram forward and backward at n × n and n × SWEEP_COLS (and the panels
    at the first bucket); Φ̃W and Φ̃ᵀu at n rows and each of SWEEP_FREQS."""
    if family == "gram":
        shapes = [(n, n), (n, SWEEP_COLS)]
        if n == N_GRID[0]:
            shapes += [(p, SWEEP_COLS) for p in SWEEP_PANELS]
        return [(op, r, c) for r, c in shapes for op in ("gram_fwd", "gram_bwd")]
    return [(op, n, m) for m in SWEEP_FREQS for op in ("rff_mv", "rff_t")]


def case_plan(op: str, rows: int, cols: int, d: int, s: int, precision: str, block: int):
    """The launch plan ``op`` runs at this shape and block (what the timing
    distinguishes: candidates with equal plans make equal launches)."""
    from .gram_matvec import gram_bwd_plan, gram_plan
    from .rff_matvec import rff_plan

    block = _resolved(op, rows, d, precision, block)
    if op == "gram_fwd":
        return gram_plan(rows, cols, d, s, block)
    if op == "gram_bwd":
        return gram_bwd_plan(rows, cols, d, s, precision=precision, block=block)
    plan = rff_plan(rows, cols, d, s, block)
    # Φ̃W's frequency chunks do not take the block; Φ̃ᵀu's row chunks do
    return (plan.freq_chunks, plan.freq_chunk) if op == "rff_mv" else (
        plan.row_chunks, plan.row_chunk)


def case_smem(op: str, rows: int, cols: int, d: int, s: int, precision: str):
    """The forward kernel's shared memory a CTA at this shape (``smem_bytes``,
    the C entries' query; None for the backward, which the sweep launches
    unchecked)."""
    from .gram_matvec import gram_plan
    from .rff_matvec import rff_plan

    dtype = "bfloat16" if precision == "bf16" else "float32"
    if op == "gram_bwd":
        return None
    if op == "gram_fwd":
        plan = gram_plan(rows, cols, d, s)
        return smem_bytes("gram", d, plan.width, dtype, plan.rows_per_cta)
    return smem_bytes("rff", d, rff_plan(rows, cols, d, s).width, dtype)


def _case_launcher(torch, op, rows, cols, d, s, precision, gen):
    """Inputs of ``op`` at this shape on the card, from ``gen``, and a
    function of the block giving one launch on them as a closure."""
    from .gram_matvec import _launch_matvec, gram_matvec_bwd
    from .rff_matvec import rff_matvec, rff_t_matvec

    def draw(*shape, scale=None):
        if scale is None:
            return torch.randn(shape, generator=gen, device="cuda")
        return torch.rand(shape, generator=gen, device="cuda") * scale

    x = draw(rows, d, scale=4.0)
    if op == "gram_fwd":
        z, v = draw(cols, d, scale=4.0), draw(cols, s)
        return lambda b: lambda: _launch_matvec("autotune", x, z, v, SWEEP_KIND, precision, b)
    if op == "gram_bwd":
        z, rowv, colv = draw(cols, d, scale=4.0), draw(rows, s), draw(cols, s)
        return lambda b: lambda: gram_matvec_bwd._launch(x, z, rowv, colv, SWEEP_KIND,
                                                         precision=precision, block=b)
    omega = draw(cols, d)
    if op == "rff_mv":
        w = draw(2 * cols, s)
        return lambda b: lambda: rff_matvec._launch(x, omega, w, precision=precision)
    u = draw(rows, s)
    return lambda b: lambda: rff_t_matvec._launch(x, omega, u, cols, precision=precision,
                                                  block=b)


def graph_timer(torch, fn, launches: int):
    """A callable giving the device ms of one launch of ``fn``, averaged over
    a CUDA graph of ``launches`` launches (a Python launch costs more host
    time than a small shape's kernel, so eager launches would time the
    host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / launches

    return timed


def _median(xs: list) -> float:
    ys = sorted(xs)
    return ys[len(ys) // 2]


def decide(cases: list) -> int:
    """A key's block from its timed cases: a candidate other than the
    heuristic wins only where its plan differs from the heuristic's at one
    case at least and, at every case where it differs, its median beat the
    heuristic's by more than the larger of the two repeats' spreads; of
    several winners, the least total median time. Otherwise the heuristic."""
    h = str(HEURISTIC_BLOCK)
    best, best_total = HEURISTIC_BLOCK, None
    for cand in CANDIDATE_BLOCKS:
        c = str(cand)
        if cand == HEURISTIC_BLOCK:
            continue
        differs = [case for case in cases
                   if "skipped" not in case and case["plan_of"][c] != case["plan_of"][h]]
        if not differs:
            continue
        wins = all(
            case["median_ms"][h] - case["median_ms"][c]
            > max(case["spread_ms"][h], case["spread_ms"][c])
            for case in differs
        )
        total = sum(case["median_ms"][c] for case in differs)
        if wins and (best_total is None or total < best_total):
            best, best_total = cand, total
    return best


def sweep(launches: int = SWEEP_LAUNCHES, repeats: int = SWEEP_REPEATS,
          keys=None, log=print) -> dict:
    """Time every key of ``expected_keys()`` (or ``keys``) on the card and
    return the table's JSON document."""
    import datetime
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the autotune sweep times kernels on a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    s = RHS_WIDTH_ESTIMATE
    table, evidence = {}, {}
    for key in sorted(keys or expected_keys()):
        family, nb, db, dtype = key.split("|")
        n, d = int(nb[1:]), int(db[1:])
        precision = "bf16" if dtype == "bfloat16" else "fp32"
        cases = []
        for op, rows, cols in sweep_cases(family, n):
            smem = case_smem(op, rows, cols, d, s, precision)
            if smem is not None and not 0 < smem <= SMEM_LIMIT_BYTES:
                cases.append(dict(op=op, rows=rows, cols=cols, d=d, s=s,
                                  precision=precision, skipped=f"{smem} bytes of shared memory"))
                continue
            plans = {str(b): case_plan(op, rows, cols, d, s, precision, b)
                     for b in CANDIDATE_BLOCKS}
            # one timing per distinct plan; candidates with the same plan
            # launch the same kernels and share it
            distinct = {}
            for b in CANDIDATE_BLOCKS:
                distinct.setdefault(plans[str(b)], b)
            gen = torch.Generator(device="cuda").manual_seed(SWEEP_SEED)
            launcher = _case_launcher(torch, op, rows, cols, d, s, precision, gen)
            timers = {b: graph_timer(torch, launcher(_resolved(op, rows, d, precision, b)), launches)
                      for b in distinct.values()}
            runs = {b: [] for b in timers}
            for _ in range(repeats):  # the candidates in turns
                for b, timed in timers.items():
                    runs[b].append(timed())
            ms = {str(b): runs[distinct[plans[str(b)]]] for b in CANDIDATE_BLOCKS}
            case = dict(op=op, rows=rows, cols=cols, d=d, s=s, precision=precision,
                        plan_of={b: str(p) for b, p in plans.items()}, ms=ms,
                        median_ms={b: _median(v) for b, v in ms.items()},
                        spread_ms={b: max(v) - min(v) for b, v in ms.items()})
            cases.append(case)
            log(json.dumps({"key": key, **{k: case[k] for k in
                                           ("op", "rows", "cols", "median_ms")}}))
            del timers, launcher
            torch.cuda.empty_cache()
        table[key] = decide(cases)
        evidence[key] = cases
    return {
        "source": "h100-sweep",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "date": datetime.date.today().isoformat(),
        "method": (f"CUDA graph of {launches} launches, {repeats} repeats in turns, the "
                   f"median; s = {s}, {SWEEP_KIND}, uniform [0, 4) points, seed {SWEEP_SEED}; "
                   "a candidate wins where its plan differs and it beat the heuristic by "
                   "more than the repeats' spread at every such case"),
        "grid": dict(families=list(FAMILIES), n=list(N_GRID), d=list(D_GRID),
                     dtypes=list(DTYPES), candidates=list(CANDIDATE_BLOCKS),
                     heuristic=HEURISTIC_BLOCK),
        "table": table,
        "cases": evidence,
    }


def dump_table(doc: dict) -> str:
    """The table's JSON text: one line a top-level field, one a timed case."""
    head = [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in doc.items() if k != "cases"]
    cases = [f"  {json.dumps(key)}: [\n" + ",\n".join(f"   {json.dumps(c)}" for c in cs) + "\n  ]"
             for key, cs in doc["cases"].items()]
    return "{\n" + ",\n".join(head + [' "cases": {\n' + ",\n".join(cases) + "\n }"]) + "\n}\n"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Sweep the launch plans' block on the card and write the table.")
    ap.add_argument("--sweep", action="store_true", help="time every key on the card")
    ap.add_argument("--out", default=DEFAULT_TABLE_PATH, help="where to write the table")
    ap.add_argument("--keys", nargs="*", help="sweep only these keys")
    args = ap.parse_args(argv)
    if not args.sweep:
        ap.print_help()
        return 2
    doc = sweep(keys=args.keys)
    Path(args.out).write_text(dump_table(doc))
    print(json.dumps({"table": doc["table"], "out": args.out, "nvidia_smi": doc["nvidia_smi"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
