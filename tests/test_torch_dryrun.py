"""The dry run (``launch/dryrun.py``) and its op profiler
(``launch/hlo_analysis.py``), each in a subprocess of its own: the fake
world of 256 or 512 ranks must not leak into this one.

Cells: olmo-1b ``train_4k``, llama3-8b ``prefill_32k``, deepseek-v2-236b
``decode_32k`` (16 × 16), mamba2-130m ``long_500k`` on the 2 × 16 × 16
multi-pod mesh, a full-attention arch on ``long_500k`` (skipped, with the
reference's reason), and dbrx-132b's bf16 prefill of 4 × 1,024 on four
cards (a 1 × 4 mesh). Each record has the reference's keys (read from
``src/repro/launch/dryrun.py``'s own ``dict(...)`` calls); its
``hbm_per_device["arguments"]`` is the local bytes of every parameter,
moment, cache buffer and input as the **reference's** ``spec_for_axes`` /
``evenize_spec`` / ``_cache_spec`` lay them out on a ``FakeMesh``. Prefill
attends through the flash kernel's op, one a layer, never the s² product.
The profiler on a 10-iteration loop of an all-gather of f32[8,16] and a
(8,64) @ (64,16) product on a fake 8-rank group counts the reference test's
numbers (tests/test_sharding.py:91-98). The cells run at once, ~45 s.
"""
import ast
import json
import math
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import cell_is_applicable as jcell_is_applicable  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = {
    "olmo-train": ("olmo-1b", "train_4k", False),
    "llama-prefill": ("llama3-8b", "prefill_32k", False),
    "deepseek-decode": ("deepseek-v2-236b", "decode_32k", False),
    "mamba-long-multipod": ("mamba2-130m", "long_500k", True),
    "llama-long": ("llama3-8b", "long_500k", False),
}

_CELL = textwrap.dedent("""
    import json, sys
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import _shape_arg, lower_cell
    arch, shape, mp = sys.argv[1], _shape_arg(sys.argv[2]), sys.argv[3] == "1"
    mesh = tuple(int(n) for n in sys.argv[4].split("x")) if len(sys.argv) > 4 else None
    rec, prof = lower_cell(arch, shape, multi_pod=mp, mesh_shape=mesh)
    notes = None if prof is None else prof.notes
    print(json.dumps({"rec": rec, "notes": notes,
                      "attention": dict(ops.ATTENTION_TRACE_COUNTS)}))
""")

_LOOP = textwrap.dedent("""
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.hlo_analysis import analyze_ops
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 16), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        w = DTensor.from_local(torch.empty(64, 16), mesh, [Replicate(), Replicate()],
                               run_check=False)
    def loop():
        y = None
        for _ in range(10):
            y = x.redistribute(mesh, [Replicate(), Replicate()]) @ w
        return y
    prof, _ = analyze_ops(loop)
    print(json.dumps({"flops": prof.flops, "collective_bytes": prof.collective_bytes,
                      "collective_counts": prof.collective_counts}))
""")


def _run(code: str, *args: str) -> dict:
    # one thread each: fake tensors compute nothing, and the six run at once
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """Every cell and the loop, each in its own subprocess, all at once."""
    jobs = {k: (_CELL, a, s, "1" if mp else "0") for k, (a, s, mp) in CELLS.items()}
    jobs["dbrx-four-cards"] = (_CELL, "dbrx-132b", "prefill:4:1024", "0", "1x4")
    jobs["loop"] = (_LOOP,)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(_run, *v) for k, v in jobs.items()}
    out = {}
    for k, f in futs.items():
        try:
            out[k] = f.result()
        except Exception as err:  # noqa: BLE001 — raised to the test that reads it
            out[k] = err
    return out


def _get(runs, key):
    if isinstance(runs[key], Exception):
        raise runs[key]
    return runs[key]


def _reference_keys():
    """The reference record's keys, nested: read from ``lower_cell``'s
    ``rec = dict(base, status="ok", ...)`` and its ``base = dict(...)``."""
    src = open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")

    def keys(call):
        out = {}
        for kw in call.keywords:
            v = kw.value
            is_dict = isinstance(v, ast.Call) and getattr(v.func, "id", "") == "dict"
            out[kw.arg] = keys(v) if is_dict else None
        return out

    calls = {t.targets[0].id: n for t in ast.walk(fn) if isinstance(t, ast.Assign)
             and isinstance(t.targets[0], ast.Name)
             for n in [t.value] if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "dict"}
    return {**keys(calls["base"]), **keys(calls["rec"])}


def _shape_of(d):
    return {k: (_shape_of(v) if isinstance(v, dict) else None) for k, v in d.items()}


@pytest.mark.parametrize("cell", ["olmo-train", "llama-prefill", "deepseek-decode",
                                  "mamba-long-multipod"])
def test_record_has_the_reference_keys(runs, cell):
    rec = _get(runs, cell)["rec"]
    assert rec["status"] == "ok", rec
    want = _reference_keys()
    got = _shape_of(rec)
    for k in ("collective_by_kind", "collective_counts"):  # kind-keyed dicts
        got["hlo_profile"][k] = None
    assert got == want
    a, s, mp = CELLS[cell]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (a, s, "2x16x16" if mp else "16x16", 512 if mp else 256)
    assert rec["hbm_per_device"]["total_gb"] > 0 and rec["roofline"]["model_flops"] > 0


def test_long_500k_on_a_full_attention_arch_is_skipped_as_the_reference_skips(runs):
    rec = _get(runs, "llama-long")["rec"]
    ok, why = jcell_is_applicable(jget_config("llama3-8b"), JSHAPES["long_500k"])
    assert not ok
    assert rec == dict(arch="llama3-8b", shape="long_500k", mesh="16x16", chips=256,
                       mode="decode", profile="tp", status="skipped", reason=why)


class FakeMesh:
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _local(shape, spec, mesh) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= mesh.shape[a]
    return n


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _reference_arguments(arch, shape_name, multi_pod) -> int:
    """Local bytes of params (bf16), moments (bf16 mu, fp32 nu) or the cache
    (bf16, fp32 ssm), and the inputs (int32 tokens), by the reference's rules."""
    cfg, shape = jget_config(arch), JSHAPES[shape_name]
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
    b, s = shape.global_batch, shape.seq_len
    total = 0
    per_param = 2 + (2 + 4 if shape.mode == "train" else 0)
    for _, p in _leaves(jmodel.param_schema(cfg)):
        spec = jsharding.evenize_spec(jsharding.spec_for_axes(p.axes, mesh), p.shape, mesh)
        total += per_param * _local(p.shape, spec, mesh)
    if shape.mode != "train":
        for path, leaf in _leaves(jmodel.abstract_cache(cfg, b, s)):
            spec = jsharding._cache_spec("/".join(path), leaf.shape, mesh, b)
            total += leaf.dtype.itemsize * _local(leaf.shape, spec, mesh)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    tokens = [(b, s)] * (2 if shape.mode == "train" else 1) if shape.mode != "decode" \
        else [(b, 1)]
    for shp in tokens:
        spec = jsharding.evenize_spec(JP(dp if len(dp) > 1 else dp[0], None) if b > 1
                                      else JP(None, None), shp, mesh)
        total += 4 * _local(shp, spec, mesh)
    return total


@pytest.mark.parametrize("cell", ["olmo-train", "llama-prefill", "deepseek-decode",
                                  "mamba-long-multipod"])
def test_arguments_are_the_reference_layouts_local_bytes(runs, cell):
    rec = _get(runs, cell)["rec"]
    assert rec["hbm_per_device"]["arguments"] == _reference_arguments(*CELLS[cell])


def test_prefill_attends_through_the_kernel_op(runs):
    """32 flash ops (one a layer), no plain attention dispatch, and the
    profile's flops near the model's (an s² product counted on top of the
    kernel's, or in its place, would show)."""
    run = _get(runs, "llama-prefill")
    assert run["notes"]["kernel_ops"] == {"flash_attention": 32}
    assert run["attention"] == {"cuda": 32, "plain": 0}
    useful = run["rec"]["roofline"]["useful_fraction"]
    assert 0.7 < useful < 1.3, useful


def test_train_attends_through_the_kernel_op(runs):
    run = _get(runs, "olmo-train")
    assert run["notes"]["kernel_ops"] == {"flash_attention": 16}
    assert run["attention"]["plain"] == 0


def test_dbrx_served_in_bf16_fits_four_80gb_cards(runs):
    """The first four-card cell's candidate: dbrx-132b's bf16 prefill of
    4 × 1,024 tokens laid out under "tp" on a 1 × 4 mesh (its 264 GB of
    weights a quarter a card) holds under 79 GiB a card, temps included
    (``total_gb`` is GiB; an H100 80GB holds about 79.6 GiB)."""
    rec = _get(runs, "dbrx-four-cards")["rec"]
    assert (rec["status"], rec["mesh"], rec["chips"], rec["shape"]) == \
        ("ok", "1x4", 4, "prefill:4:1024")
    assert 60 < rec["hbm_per_device"]["total_gb"] < 79, rec["hbm_per_device"]


def test_the_profiler_counts_a_loop_once_an_iteration(runs):
    loop = _get(runs, "loop")
    assert loop["flops"] == 10 * 2 * 8 * 16 * 64
    assert loop["collective_bytes"] == 10 * 512
    assert loop["collective_counts"] == {"all-gather": 10}
