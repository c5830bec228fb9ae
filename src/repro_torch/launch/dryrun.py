"""Multi-pod dry run and roofline extraction — twin of ``repro/launch/dryrun.py``.

For every (architecture × input shape) cell:
  1. join a fake world of 256 or 512 ranks (``torch.distributed``'s "fake"
     backend: collectives return at once, moving nothing) and build the
     production mesh over it (16×16 single-pod, or 2×16×16 multi-pod);
  2. lay out fake parameters (in ``steps.COMPUTE_DTYPE``), optimizer state,
     caches and inputs by ``launch/sharding``'s rules: DTensors whose local
     shards are fake tensors, which hold shapes and no memory;
  3. run the step once, as rank 0, under the mesh context and the op
     profiler (``hlo_analysis.analyze_ops``): train is ``loss_and_grads``
     plus ``adamw_update``, prefill and decode as ``steps.py`` has them,
     with attention through the flash kernel's op (as on the card, never the
     plain s² product). An op with no sharding rule raises, and fails the
     cell, as a compile error fails the reference's;
  4. record per-device memory, the op profile and the H100 roofline, one JSON
     line a cell, with the reference's keys. ``compile_s`` is the trace time.
     ``main`` traces each cell in a fresh process.

Everything runs on the CPU in one process; nothing is timed on a device.
The mesh's device type is "cpu", where DTensor would run a change of split
dim as gloo's fallback (an all-gather and a chunk); the dry run has it run
the all-to-all op of the cards instead (:func:`cards_all_to_all`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \
      --shape prefill:4:1024 --mesh 1x4     # four cards, a mode:batch:seq_len shape
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from ..configs.base import (
    SHAPES, ModelConfig, ShapeConfig, cell_is_applicable, get_config, list_configs,
)
from ..models import model as model_lib
from ..models.sharding_ctx import to_placements, use_mesh
from ..train.optim import AdamWConfig, OptState
from . import steps as steps_lib
from .hlo_analysis import analyze_ops
from .mesh import num_chips
from .roofline import make_terms, model_flops
from .sharding import Sharding, activation_rules, batch_sharding, cache_shardings, param_shardings

#: the mesh shapes of ``launch/mesh.make_production_mesh``
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0), replacing a fake group of another size. A real
    group is never replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process group; a real one is up")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_fake_mesh(*, multi_pod: bool = False, shape: Optional[tuple] = None):
    """The production mesh, or a mesh of ``shape`` (two dims over ("data",
    "model"), three over ("pod", "data", "model")), over a fake world of its
    size (CPU device type)."""
    from torch.distributed.device_mesh import init_device_mesh

    if shape is None:
        shape, axes = MESHES[multi_pod]
    else:
        shape, axes = tuple(shape), MESHES[len(shape) == 3][1]
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def cards_all_to_all():
    """Within: DTensor changes a split dim with the all-to-all op it runs on
    the cards (``_dtensor.shard_dim_alltoall``), not the all-gather and chunk
    it falls back to on a CPU mesh, whose gathered whole would swell the
    memory peak. The dry run's tensors are fake, so the op only shapes its
    output."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    old = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = old


def _fake_dtensor(shape: tuple, dtype, sharding: Sharding):
    """A DTensor of global ``shape`` laid out by ``sharding`` whose local
    shard is an empty (under a FakeTensorMode, fake) tensor."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = to_placements(tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec)),
                               mesh)
    local = list(shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(j)
            if local[p.dim] % n:
                raise ValueError(f"{shape} dim {p.dim} does not split {n} ways")
            local[p.dim] //= n
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(shape), stride=stride)


def _zip_map(fn, a, b):
    """``fn`` over the leaves of two nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _flat(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _laid_out(abstract, shardings):
    """A tree of fake DTensors of ``abstract``'s shapes and dtypes (meta
    tensors), laid out by ``shardings`` (the same structure)."""
    return _zip_map(lambda t, sh: _fake_dtensor(tuple(t.shape), t.dtype, sh),
                    abstract, shardings)


def per_layer_cache(cfg, stacked: dict) -> dict:
    """``model.abstract_cache``'s stacked tree as the model takes its cache
    (``model.zero_cache``'s structure): a buffer dict a layer (a period's
    mamba blocks a list of them), each buffer a view of its stack."""
    def unstack(group: dict, depth: int):
        n = next(iter(group.values())).shape[0]
        rows = [{k: t[i] for k, t in group.items()} for i in range(n)]
        return rows if depth == 1 else [unstack(r, depth - 1) for r in rows]

    period = model_lib._layer_plan(cfg)["kind"] == "period"
    return {k: v if k == "memory" else unstack(v, 2 if (k == "mamba" and period) else 1)
            for k, v in stacked.items()}


def _cache_tree(cfg, shape: ShapeConfig, mesh):
    """The port's per-layer cache (:func:`per_layer_cache` of the abstract
    cache), each buffer a fake DTensor laid out by ``cache_shardings``."""
    b = shape.global_batch
    meta = per_layer_cache(cfg, model_lib.abstract_cache(cfg, b, shape.seq_len,
                                                         steps_lib.COMPUTE_DTYPE))
    shardings = cache_shardings(meta, mesh, b)

    def build(t, sh):
        if isinstance(t, dict):
            return {k: build(v, sh[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, s_) for v, s_ in zip(t, sh)]
        return _fake_dtensor(tuple(t.shape), t.dtype, sh)

    return build(meta, shardings)


def _inputs(cfg, shape: ShapeConfig, mesh) -> dict:
    specs = steps_lib.input_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        if k == "cache_index":
            continue
        out[k] = _fake_dtensor(tuple(v.shape), v.dtype,
                               batch_sharding(mesh, tuple(v.shape), shape.global_batch))
    return out


def lower_cell(arch: str, shape_name, *, multi_pod: bool = False,
               config_override=None, opt_cfg: AdamWConfig = AdamWConfig(),
               profile: str = "tp", micro_steps: int = 1, mesh_shape: Optional[tuple] = None):
    """Trace one cell on the fake world; returns (record dict, HloProfile) —
    the profile is None for inapplicable (skipped) cells. ``shape_name`` is a
    name of ``SHAPES`` or a ``ShapeConfig``; ``mesh_shape`` replaces the
    production mesh (e.g. (1, 4): four cards)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg: ModelConfig = config_override or get_config(arch)
    shape: ShapeConfig = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    mesh = make_fake_mesh(multi_pod=multi_pod, shape=mesh_shape)
    chips = num_chips(mesh)
    base = dict(arch=arch, shape=shape.name, mesh="x".join(map(str, mesh.shape)),
                chips=chips, mode=shape.mode, profile=profile)
    if not ok:
        return dict(base, status="skipped", reason=why), None

    schema = model_lib.param_schema(cfg)
    dtype = steps_lib.COMPUTE_DTYPE
    rules = activation_rules(mesh, profile)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        params_sh = param_shardings(schema, mesh, profile)
        if shape.mode == "train":
            params_abs, opt_abs = steps_lib.abstract_state(cfg, opt_cfg, dtype)
        else:
            params_abs = model_lib.abstract_model_params(cfg, dtype)
        tree = _laid_out(params_abs, params_sh)
        args_bytes = _local_bytes(tree)
        model = model_lib.Transformer(cfg, tree)
        batch = _inputs(cfg, shape, mesh)
        args_bytes += _local_bytes(batch)
        if shape.mode == "train":
            mu, nu = _laid_out(opt_abs.mu, params_sh), _laid_out(opt_abs.nu, params_sh)
            args_bytes += _local_bytes(mu) + _local_bytes(nu)
            opt = OptState(mu=model_lib.Transformer(cfg, mu), nu=model_lib.Transformer(cfg, nu),
                           step=torch.zeros((), dtype=opt_abs.step.dtype))
        else:
            cache = _cache_tree(cfg, shape, mesh)
            args_bytes += _local_bytes(cache)

    # the step runs outside the mode: its fake tensors carry it, and DTensor's
    # own index arithmetic (real tensors) must stay real
    t0 = time.time()
    with use_mesh(mesh, rules), cards_all_to_all():
        if shape.mode == "train":
            step = steps_lib.make_train_step(cfg, opt_cfg, micro_steps, backend="cuda")
            prof, out = analyze_ops(step, model, opt, batch, fake_mode=fake)
            result = out[2]
        elif shape.mode == "prefill":
            step = steps_lib.make_prefill_step(cfg, backend="cuda")
            prof, out = analyze_ops(step, model, cache, batch, fake_mode=fake)
            result = out[0]
        else:  # decode: one token against a full cache of seq_len
            step = steps_lib.make_serve_step(cfg)
            prof, out = analyze_ops(step, model, cache, batch["token"], shape.seq_len - 1,
                                   fake_mode=fake)
            result = out[:2]
    compile_s = time.time() - t0
    out_bytes = _local_bytes(result)

    n_params = model_lib.count_params(cfg)
    n_active = model_lib.active_param_count(cfg)
    mflops = model_flops(cfg, shape, n_active)
    # per-device flops from the profiler × chips = global; the memory term uses
    # the fusion-aware bytes model (the raw operand+output sum is the upper bound)
    terms = make_terms(prof.flops * chips, prof.bytes_fused * chips,
                       prof.collective_bytes * chips, mflops, chips)
    peak = prof.notes["peak_bytes"]
    temps = max(peak - out_bytes, 0)

    rec = dict(
        base,
        status="ok",
        compile_s=round(compile_s, 1),
        params=n_params,
        active_params=n_active,
        hbm_per_device=dict(
            arguments=args_bytes,
            temps=temps,
            outputs=out_bytes,
            total_gb=round((args_bytes + temps + out_bytes) / 2**30, 3),  # GiB, as the reference's
        ),
        # no compiler estimate exists here: the op stream's totals over all ranks
        cost_analysis=dict(
            flops_raw=prof.flops * chips,
            bytes_raw=prof.bytes * chips,
        ),
        hlo_profile=dict(
            flops_per_device=prof.flops,
            bytes_per_device=prof.bytes_fused,
            bytes_upper_per_device=prof.bytes,
            collective_bytes_per_device=prof.collective_bytes,
            collective_by_kind=prof.collective_by_kind,
            collective_counts=prof.collective_counts,
        ),
        roofline=dict(
            compute_s=terms.compute_s,
            memory_s=terms.memory_s,
            collective_s=terms.collective_s,
            dominant=terms.dominant,
            model_flops=mflops,
            useful_fraction=round(terms.useful_fraction, 4),
            mfu=round(terms.mfu, 4),
            step_time_s=terms.step_time_s,
        ),
    )
    return rec, prof


def _cell_record(arch: str, shape, multi_pod: bool, profile: str, mesh_shape=None) -> dict:
    torch.set_num_threads(1)  # fake tensors compute nothing: more threads only spin
    return lower_cell(arch, shape, multi_pod=multi_pod, profile=profile,
                      mesh_shape=mesh_shape)[0]


def _shape_arg(name: str):
    """A ``SHAPES`` name, or ``mode:batch:seq_len`` (e.g. ``prefill:4:1024``)."""
    if name in SHAPES or ":" not in name:
        return name
    mode, batch, seq = name.split(":")
    return ShapeConfig(name, int(seq), int(batch), mode)


def _cell_apart(arch: str, shape, multi_pod: bool, profile: str, mesh_shape=None) -> dict:
    """:func:`lower_cell`'s record, traced in a fresh process: one cell's
    fake world, caches and live objects never meet the next's (in one
    process, state left by an earlier cell has made a later one fail a
    reshape that passes alone)."""
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(1) as pool:
        return pool.apply(_cell_record, (arch, shape, multi_pod, profile, mesh_shape))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--resume", action="store_true", help="skip cells already in --out")
    ap.add_argument("--profile", default="tp", help="sharding profile: tp | fsdp")
    ap.add_argument("--mesh", default=None,
                    help="a mesh in place of the production ones, e.g. 1x4 (four cards)")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh else None

    cells = []
    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [_shape_arg(args.shape)]
    meshes = [False, True] if args.both_meshes and not mesh_shape else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"]))
            except (ValueError, KeyError):
                pass

    failures = 0
    for a, s, mp in cells:
        mesh_tag = args.mesh or ("2x16x16" if mp else "16x16")
        s_name = s.name if isinstance(s, ShapeConfig) else s
        if (a, s_name, mesh_tag) in done:
            print(f"[dryrun] {a} × {s_name} × {mesh_tag}: already done, skipping")
            continue
        print(f"[dryrun] {a} × {s_name} × {mesh_tag} ...", flush=True)
        try:
            rec = _cell_apart(a, s, mp, args.profile, mesh_shape)
        except Exception as e:  # a cell that cannot be traced is recorded, not fatal
            traceback.print_exc()
            rec = dict(arch=a, shape=s_name, mesh=mesh_tag, status="error",
                       error=f"{type(e).__name__}: {e}")
            failures += 1
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  status=ok  trace={rec['compile_s']}s  "
                  f"hbm/dev={rec['hbm_per_device']['total_gb']}GiB  "
                  f"dominant={r['dominant']}  mfu={r['mfu']}", flush=True)
        else:
            print(f"  status={rec['status']}  {rec.get('reason', rec.get('error', ''))}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] finished; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
