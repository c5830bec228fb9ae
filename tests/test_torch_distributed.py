"""The port's distributed GP solve (``ShardedGram`` under gather, gather_once
and ring, ``ShardedFourierFeatures``, ``distributed_solve``) over
``torch.distributed`` on the CPU, against the JAX reference.

Ranks are spawned processes in a gloo group, one torch thread each; every run
joins within RUN_TIMEOUT seconds and every group's collectives time out after
GROUP_TIMEOUT, so a hang fails its test. The reference's values are computed
here: its single-device ``Gram`` on the same numpy inputs, and its own
4-device ``ShardedGram`` in a subprocess on a forced 4-device CPU platform,
as its tests run it, wherever it runs (its ``block_at`` under plain gather
and its AP under gather and ring raise ``ShardingTypeError``; the port is
held to the single-device ``Gram`` there). Held:

* the comm flags without spawning, and P = 1 in this process against the
  reference's ``ShardedGram`` on a 1-device mesh;
* at P = 2 and 4 under every comm: ``mv``, the row primitives, ``block_at``,
  ``diag_part`` and the sharded feature matvecs against the reference's
  ``Gram`` at the reference's ring-vs-gather bound, 1e-5; 18 CG iterations,
  and SGD, SDD and AP on the reference's own draws;
* bench_distributed's problem at P = 4: the committed rows of
  ``results/BENCH_bench_distributed.json`` exactly (collectives a matvec, CG,
  SGD and AP's counts), and the reference's solution bounds (SGD's, as the
  reference holds it, under ring alone);
* ring iterates stay row blocks; n % P != 0 raises.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from repro_torch.convert import params_from_numpy, row_draws_from_numpy, sgd_draws_from_numpy
from repro_torch.core import (
    AP, CG, SDD, SGD, Gram, Jacobi, Nystrom, PivotedCholesky, PrecondDraws,
    ShardedFourierFeatures, ShardedGram, distributed_solve, shard_training_rows, solve,
)
from repro_torch.core import collectives as coll
from repro_torch.core.operators import supports
from repro_torch.core.rff import FourierFeatures
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.testing.ranks import free_port, join_mesh, run_ranks

ROOT = Path(__file__).resolve().parents[1]
#: seconds a spawned run may take, and a group's collectives
RUN_TIMEOUT, GROUP_TIMEOUT = 180, 60
#: the reference's ring-vs-gather bound (tests/test_distributed_ring.py:49),
#: a fixed CG budget against the single-device solve, and a stochastic
#: solver's steps (tests/test_torch_stochastic.py's STEP_TOL, LONG_TOL)
PRIM_TOL, CG_TOL, STEP_TOL, LONG_TOL = 1e-5, 1e-4, 1e-4, 2e-3
COMMS = (("gather", False), ("gather", True), ("ring", False))
COMM_IDS = ("gather", "gather_once", "ring")
#: the primitives' problem (tests/test_distributed_ring.py:43-47): n, d, s,
#: ℓ, σ²; the parity solves' the same points at ℓ = 0.3, where 18 fp32 CG
#: iterations of the two packages' single-device Gram agree within 7e-6 of
#: scale (on the reference's ring problem, ℓ = 1 and σ² = 0.2, they part by
#: 1.6e-3 after 10: fp32 CG's drift between the packages, ROADMAP queue 3)
PRIM = dict(n=128, d=3, s=2, ls=0.9, noise=0.3)
SOLVE = dict(n=128, d=3, ls=0.3, noise=0.3)
#: preconditioned CG: rank, budget (below where the fp32 routes part), and
#: the Nyström subset
PRECOND = dict(rank=16, iters=8, idx=tuple(range(3, 128, 8)))
#: the stochastic runs on the reference's draws
STOCH = dict(steps=60, batch=16, q=8, sgd=dict(step_size_times_n=0.5),
             sdd=dict(step_size_times_n=2.0, averaging=0.05))
BENCH_JSON = ROOT / "results" / "BENCH_bench_distributed.json"


def _tag(comm, once):
    return "gather_once" if once else comm


def _scaled(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(1.0, float(np.max(np.abs(ref)))))


# ---------------------------------------------------------------------------
# inputs and the reference's values (this process, JAX imported lazily so that
# the spawned ranks, which import this module, never load it)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _inputs() -> dict:
    """The numpy inputs every run shares, drawn from the reference's keys."""
    import jax

    from repro.core.kernels_fn import make_params, spectral_sample

    key = jax.random.PRNGKey(0)
    n, d, s = PRIM["n"], PRIM["d"], PRIM["s"]
    x = np.array(jax.random.normal(key, (n, d)))
    out = dict(x=x, v=np.array(jax.random.normal(jax.random.fold_in(key, 1), (n, s))),
               idx=np.array(jax.random.randint(jax.random.fold_in(key, 2), (16,), 0, n)),
               u=np.array(jax.random.normal(jax.random.fold_in(key, 3), (16, s))),
               y=np.sin(x.sum(-1)).astype(np.float32))
    m = 8
    out["omega"] = np.array(jax.random.normal(jax.random.fold_in(key, 4), (m, d)))
    out["w"] = np.array(jax.random.normal(jax.random.fold_in(key, 5), (2 * m, s)))
    for name, kw in (("prim", PRIM), ("solve", SOLVE)):
        p = make_params("se", lengthscale=kw["ls"], noise=kw["noise"], d=d)
        out[name] = tuple(np.asarray(a) for a in (p.log_lengthscale, p.log_signal,
                                                  p.log_noise))
    p_solve = make_params("se", lengthscale=SOLVE["ls"], noise=SOLVE["noise"], d=d)
    steps, batch, q = STOCH["steps"], STOCH["batch"], STOCH["q"]
    sgd_idx, sgd_omega, rows = [], [], []
    for t in range(steps):
        kt = jax.random.fold_in(key, t)
        ki, kf = jax.random.split(kt)
        sgd_idx.append(np.array(jax.random.randint(ki, (batch,), 0, n)))
        sgd_omega.append(np.asarray(spectral_sample(p_solve, kf, q, d)))
        rows.append(np.array(jax.random.randint(kt, (batch,), 0, n)))
    out.update(sgd_idx=np.stack(sgd_idx), sgd_omega=np.stack(sgd_omega), rows=np.stack(rows))
    return out


def _reference_specs():
    from repro.core.solvers.spec import AP as JAP, CG as JCG, SDD as JSDD, SGD as JSGD

    steps, batch, q = STOCH["steps"], STOCH["batch"], STOCH["q"]
    return dict(
        cg=JCG(max_iters=18, tol=1e-12),
        sgd=JSGD(num_steps=steps, batch_size=batch, num_features=q, **STOCH["sgd"]),
        sdd=JSDD(num_steps=steps, batch_size=batch, **STOCH["sdd"]),
        ap=JAP(num_steps=steps, block_size=batch))


def _port_specs():
    steps, batch, q = STOCH["steps"], STOCH["batch"], STOCH["q"]
    return dict(
        cg=CG(max_iters=18, tol=1e-12),
        sgd=SGD(num_steps=steps, batch_size=batch, num_features=q, **STOCH["sgd"]),
        sdd=SDD(num_steps=steps, batch_size=batch, **STOCH["sdd"]),
        ap=AP(num_steps=steps, block_size=batch))


@lru_cache(maxsize=None)
def _reference_gram() -> dict:
    """The reference's single-device ``Gram`` on the shared inputs."""
    import jax
    import jax.numpy as jnp

    from repro.core.kernels_fn import KernelParams
    from repro.core.operators import Gram as JGram
    from repro.core.rff import FourierFeatures as JFF
    from repro.core.solvers.spec import solve as jsolve

    a = _inputs()
    jp = KernelParams(*(jnp.asarray(t) for t in a["prim"]), kind="se")
    op = JGram(x=jnp.asarray(a["x"]), params=jp)
    v, idx, u = jnp.asarray(a["v"]), jnp.asarray(a["idx"]), jnp.asarray(a["u"])
    err, g = op.rows_pair_mv(idx, v, u)
    ff = JFF(omega=jnp.asarray(a["omega"]), phase=jnp.zeros(8), signal=jp.signal)
    out = dict(mv=op.mv(v), rows_mv=op.rows_mv(idx, v), rows_t_mv=op.rows_t_mv(idx, u),
               pair_err=err, pair_g=g, block_at=op.block_at(idx), diag=op.diag_part(),
               phi_mv=ff.phi_mv(jnp.asarray(a["x"]), jnp.asarray(a["w"])),
               phi_t_mv=ff.phi_t_mv(jnp.asarray(a["x"]), v),
               phi_pair_mv=ff.phi_pair_mv(jnp.asarray(a["x"]), v))
    js = KernelParams(*(jnp.asarray(t) for t in a["solve"]), kind="se")
    sop = JGram(x=jnp.asarray(a["x"]), params=js)
    key = jax.random.PRNGKey(0)
    for name, spec in _reference_specs().items():
        out[name] = jsolve(sop, jnp.asarray(a["y"]), spec, key=key).solution
    return {k: np.asarray(val) for k, val in out.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _params(logs):
    return params_from_numpy(*logs, "se", device="cpu")


def _rows(a, rank, world):
    n_local = a.shape[0] // world
    return a[rank * n_local:(rank + 1) * n_local]


def _draws(a):
    return dict(sgd=sgd_draws_from_numpy(a["sgd_idx"], a["sgd_omega"], device="cpu"),
                sdd=row_draws_from_numpy(a["rows"], device="cpu"),
                ap=row_draws_from_numpy(a["rows"], device="cpu"),
                cg=None)


def _preconds():
    return dict(nystrom=Nystrom(rank=PRECOND["rank"]),
                pivoted_cholesky=PivotedCholesky(rank=PRECOND["rank"]), jacobi=Jacobi())


def _precond_draws():
    return PrecondDraws(idx=torch.tensor(PRECOND["idx"], dtype=torch.long))


def _whole(t, op):
    """A ring result's row blocks gathered in rank order (outside any count)."""
    return coll.all_gather_rows(t, op._group) if op._resolve_comm() == "ring" else t


def _primitives_rank(rank, world, port, a, out_dir):
    """Every primitive and solve under each comm on this rank's rows."""
    torch.set_num_threads(1)
    mesh = join_mesh(rank, world, port, "cpu", timeout=GROUP_TIMEOUT)
    x = torch.from_numpy(a["x"])
    xs = shard_training_rows(mesh, x)
    v, u = torch.from_numpy(a["v"]), torch.from_numpy(a["u"])
    idx = torch.from_numpy(a["idx"]).long()
    p, ps = _params(a["prim"]), _params(a["solve"])
    y = torch.from_numpy(a["y"])
    res = {}
    for comm, once in COMMS:
        op = ShardedGram(x=xs, params=p, mesh=mesh, comm=comm,
                         gather_once=once).prepare_for_solve()
        ring = comm == "ring"
        v_in = _rows(v, rank, world) if ring else v
        coll.reset_collective_counts()
        mv = op.mv(v_in)
        counts = coll.collective_counts()
        rt = op.rows_t_mv(idx, u)
        err, g = op.rows_pair_mv(idx, v_in, u)
        sff = op.wrap_features(FourierFeatures(omega=torch.from_numpy(a["omega"]),
                                               phase=torch.zeros(8), signal=p.signal))
        rec = dict(mv=_whole(mv, op), mv_shape=tuple(mv.shape), counts=counts,
                   rows_mv=op.rows_mv(idx, v_in), rows_t_mv=_whole(rt, op),
                   rows_t_shape=tuple(rt.shape), pair_err=err, pair_g=_whole(g, op),
                   block_at=op.block_at(idx), diag=_whole(op.diag_part(), op),
                   sff_caps=(isinstance(sff, ShardedFourierFeatures),
                             supports(sff, "features"), sff.num_features),
                   phi_mv=coll.all_gather_rows(
                       sff.phi_mv(xs, torch.from_numpy(a["w"])), op._group),
                   phi_t_mv=sff.phi_t_mv(xs, _rows(v, rank, world)),
                   phi_pair_mv=coll.all_gather_rows(
                       sff.phi_pair_mv(xs, _rows(v, rank, world)), op._group))
        for name, spec in _port_specs().items():
            r = distributed_solve(ps, xs, y, mesh, spec, comm=comm, gather_once=once,
                                  draws=_draws(a)[name])
            sop = ShardedGram(x=xs, params=ps, mesh=mesh, comm=comm)
            rec[name] = _whole(r.solution, sop)
            rec[name + "_counts"] = (r.iterations, r.matvecs, tuple(r.solution.shape))
        # preconditioned CG: the factor whole on every rank, the Woodbury
        # apply on the iterate's rows (one psum of Lᵀr under ring, none else)
        for name, pc in _preconds().items():
            r = distributed_solve(ps, xs, y, mesh, CG(max_iters=PRECOND["iters"], tol=1e-12,
                                                      precond=pc),
                                  comm=comm, gather_once=once, draws=_precond_draws())
            rec["precond/" + name] = _whole(r.solution, op)
        sop = ShardedGram(x=xs, params=ps, mesh=mesh, comm=comm,
                          gather_once=once).prepare_for_solve()
        apply = _preconds()["nystrom"].build(sop, draws=_precond_draws())
        coll.reset_collective_counts()
        apply(sop.layout.iterate(torch.ones(PRIM["n"], 3)))
        rec["precond_apply_counts"] = coll.collective_counts()
        res[_tag(comm, once)] = rec
    # auto against the byte budget: a 1.5 KiB panel stays gather, 8 bytes ring
    res["auto"] = (ShardedGram(x=xs, params=p, mesh=mesh, comm="auto")._resolve_comm(),
                   ShardedGram(x=xs, params=p, mesh=mesh, comm="auto",
                               comm_budget_bytes=8)._resolve_comm())
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


_RUNS = {}


def _spawn(rank_fn, world: int, inputs: dict, *extra) -> list:
    """Every rank's saved results of one spawned run of ``rank_fn(rank,
    world, port, inputs, out_dir, *extra)``, run once for the module; a
    failed run is kept too, and raised to each test that reads it."""
    import tempfile

    key = (rank_fn.__name__, world, *extra)
    if key not in _RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                run_ranks(rank_fn, world, inputs, tmp, *extra, timeout=RUN_TIMEOUT)
                _RUNS[key] = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]
            except Exception as err:  # noqa: BLE001 — re-raised below to every reader
                _RUNS[key] = err
    if isinstance(_RUNS[key], Exception):
        raise _RUNS[key]
    return _RUNS[key]


def _run_primitives(world: int) -> list:
    return _spawn(_primitives_rank, world, _inputs())


# ---------------------------------------------------------------------------
# the reference's own 4-device ShardedGram, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE_4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.core import ShardedGram, CG, SGD, AP
from repro.core.kernels_fn import KernelParams
from repro.core.distributed import distributed_solve, shard_training_rows

a = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((4,), ("data",))
x = shard_training_rows(mesh, jnp.asarray(a["x"]))
p = KernelParams(*(jnp.asarray(a["prim_" + k]) for k in ("ls", "sig", "noise")), kind="se")
ps = KernelParams(*(jnp.asarray(a["solve_" + k]) for k in ("ls", "sig", "noise")), kind="se")
v, idx, u, y = (jnp.asarray(a[k]) for k in ("v", "idx", "u", "y"))
key = jax.random.PRNGKey(0)
steps, batch, q = (int(a[k]) for k in ("steps", "batch", "q"))
for comm, once, tag in (("gather", False, "gather"), ("gather", True, "gather_once"),
                        ("ring", False, "ring")):
    op = ShardedGram(x=x, params=p, mesh=mesh, comm=comm, gather_once=once).prepare_for_solve()
    out[tag + "/mv"] = op.mv(v)
    out[tag + "/rows_mv"] = op.rows_mv(idx, v)
    out[tag + "/rows_t_mv"] = op.rows_t_mv(idx, u)
    if tag != "gather":  # ShardingTypeError on a row-sharded take under gather
        out[tag + "/block_at"] = op.block_at(idx)
    out[tag + "/cg"] = distributed_solve(ps, x, y, mesh, CG(max_iters=18, tol=1e-12),
                                         comm=comm, gather_once=once).solution
    out[tag + "/sgd"] = distributed_solve(
        ps, x, y, mesh, SGD(num_steps=steps, batch_size=batch, num_features=q,
                            step_size_times_n=float(a["sgd_step"])),
        comm=comm, gather_once=once, key=key).solution
out["gather_once/ap"] = distributed_solve(ps, x, y, mesh, AP(num_steps=steps, block_size=batch),
                                          gather_once=True, key=key).solution
np.savez(sys.argv[2], **{k: np.asarray(val) for k, val in out.items()})
"""


@lru_cache(maxsize=None)
def _reference_sharded() -> dict:
    import tempfile

    a = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.npz", Path(tmp) / "out.npz"
        flat = {k: a[k] for k in ("x", "v", "idx", "u", "y")}
        for name in ("prim", "solve"):
            flat.update({f"{name}_{k}": t for k, t in zip(("ls", "sig", "noise"), a[name])})
        flat.update(steps=STOCH["steps"], batch=STOCH["batch"], q=STOCH["q"],
                    sgd_step=STOCH["sgd"]["step_size_times_n"])
        np.savez(src, **flat)
        r = subprocess.run([sys.executable, "-c", _REFERENCE_4, str(src), str(dst)],
                           capture_output=True, text=True, timeout=600, cwd=ROOT,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        assert r.returncode == 0, r.stderr[-4000:]
        return dict(np.load(dst))


# ---------------------------------------------------------------------------
# in this process: a one-rank world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo world in this process, torn down after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = tmesh.make_data_mesh("cpu", 1, rank=0, init_method=f"tcp://localhost:{free_port()}")
    yield mesh
    dist.destroy_process_group()
    torch.set_num_threads(threads)


def test_comm_flag_validation(mesh1):
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    p = _params(_inputs()["solve"])
    with pytest.raises(ValueError, match="comm strategy"):
        ShardedGram(x=x, params=p, mesh=mesh1, comm="bogus")
    with pytest.raises(ValueError, match="gather_once"):
        ShardedGram(x=x, params=p, mesh=mesh1, comm="ring", gather_once=True)
    with pytest.raises(ValueError, match="comm strategy"):
        distributed_solve(p, x, torch.zeros(16), mesh1, "cg", comm="bogus")
    with pytest.raises(ValueError, match="gather_once"):
        distributed_solve(p, x, torch.zeros(16), mesh1, "cg", comm="ring", gather_once=True)
    # auto: a 1-rank mesh has no ring to run, over budget or not; gather_once
    # wins; an explicit comm pins whatever the budget
    assert ShardedGram(x=x, params=p, mesh=mesh1, comm="auto")._resolve_comm() == "gather"
    assert ShardedGram(x=x, params=p, mesh=mesh1, comm="auto",
                       comm_budget_bytes=8)._resolve_comm() == "gather"
    assert ShardedGram(x=x, params=p, mesh=mesh1, comm="auto", gather_once=True,
                       comm_budget_bytes=8)._resolve_comm() == "gather"
    assert ShardedGram(x=x, params=p, mesh=mesh1, comm="gather",
                       comm_budget_bytes=0)._resolve_comm() == "gather"


def test_meshes(mesh1):
    host = tmesh.make_host_mesh()
    assert host.mesh_dim_names == ("data", "model")
    assert tmesh.data_axes(host) == ("data",) and tmesh.num_chips(host) == 1
    assert tmesh.data_axes(mesh1) == ("data",) and tmesh.num_chips(mesh1) == 1
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    # a one-rank ShardedGram on the host mesh's data axis, or on its two axes
    # flattened into one group, is the Gram operator
    a = _inputs()
    ref = Gram(x=torch.from_numpy(a["x"]), params=_params(a["prim"]))
    v = torch.from_numpy(a["v"])
    for axes in (("data",), ("data", "model")):
        op = ShardedGram(x=torch.from_numpy(a["x"]), params=_params(a["prim"]), mesh=host,
                         data_axes=axes)
        torch.testing.assert_close(op.mv(v), ref.mv(v), rtol=0, atol=PRIM_TOL)


@pytest.mark.parametrize("comm,once", COMMS, ids=COMM_IDS)
def test_one_rank_matches_the_reference_sharded_gram(mesh1, comm, once):
    """P = 1 against the reference's ``ShardedGram`` on a 1-device mesh: the
    primitives, 18 CG iterations and SGD on the reference's draws."""
    import jax
    import jax.numpy as jnp

    from repro.core import ShardedGram as JShardedGram
    from repro.core.distributed import distributed_solve as jdistributed_solve
    from repro.core.kernels_fn import KernelParams

    a = _inputs()
    jmesh = jax.make_mesh((1,), ("data",))
    jp = KernelParams(*(jnp.asarray(t) for t in a["prim"]), kind="se")
    jps = KernelParams(*(jnp.asarray(t) for t in a["solve"]), kind="se")
    jop = JShardedGram(x=jnp.asarray(a["x"]), params=jp, mesh=jmesh, comm=comm,
                       gather_once=once).prepare_for_solve()
    op = ShardedGram(x=torch.from_numpy(a["x"]), params=_params(a["prim"]), mesh=mesh1,
                     comm=comm, gather_once=once).prepare_for_solve()
    v, u = torch.from_numpy(a["v"]), torch.from_numpy(a["u"])
    idx = torch.from_numpy(a["idx"]).long()
    jv, ju, jidx = jnp.asarray(a["v"]), jnp.asarray(a["u"]), jnp.asarray(a["idx"])
    for got, want in ((op.mv(v), jop.mv(jv)), (op.rows_mv(idx, v), jop.rows_mv(jidx, jv)),
                      (op.rows_t_mv(idx, u), jop.rows_t_mv(jidx, ju)),
                      (op.block_at(idx), jop.block_at(jidx))):
        assert _scaled(got.numpy(), want) <= PRIM_TOL
    key = jax.random.PRNGKey(0)
    y = torch.from_numpy(a["y"])
    specs, jspecs, draws = _port_specs(), _reference_specs(), _draws(a)
    for name in ("cg", "sgd"):
        got = distributed_solve(_params(a["solve"]), torch.from_numpy(a["x"]), y, mesh1,
                                specs[name], comm=comm, gather_once=once, draws=draws[name])
        want = jdistributed_solve(jps, jnp.asarray(a["x"]), jnp.asarray(a["y"]), jmesh,
                                  jspecs[name], comm=comm, gather_once=once, key=key)
        assert got.iterations == int(want.iterations)
        assert got.matvecs == int(want.matvecs)
        tol = CG_TOL if name == "cg" else STEP_TOL
        assert _scaled(got.solution.numpy(), want.solution) <= tol, name


# ---------------------------------------------------------------------------
# P = 2 and P = 4, spawned
# ---------------------------------------------------------------------------

PRIMITIVES = ("mv", "rows_mv", "rows_t_mv", "pair_err", "pair_g", "block_at", "diag",
              "phi_mv", "phi_t_mv", "phi_pair_mv")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", COMM_IDS)
def test_primitives_match_the_reference_gram(world, tag):
    want = _reference_gram()
    for rank, res in enumerate(_run_primitives(world)):
        rec = res[tag]
        for k in PRIMITIVES:
            assert _scaled(rec[k].numpy(), want[k]) <= PRIM_TOL, (rank, k)
        assert rec["sff_caps"] == (True, False, 16)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", COMM_IDS)
def test_solves_match_the_reference_gram(world, tag):
    """18 CG iterations within 1e-4 of scale of the reference's single-device
    solve, SGD, SDD and AP after 60 steps on its draws within 1e-4, with the
    reference's counts: CG 18 = 18 matvecs, SGD and SDD 1, AP 0."""
    want = _reference_gram()
    for rank, res in enumerate(_run_primitives(world)):
        rec = res[tag]
        for name, tol in (("cg", CG_TOL), ("sgd", STEP_TOL), ("sdd", STEP_TOL),
                          ("ap", STEP_TOL)):
            assert _scaled(rec[name].numpy(), want[name]) <= tol, (rank, name)
        assert rec["cg_counts"][:2] == (18, 18)
        assert rec["sgd_counts"][1] == rec["sdd_counts"][1] == 1
        assert rec["ap_counts"][1] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", COMM_IDS)
def test_preconditioned_cg_matches_the_single_device_solve(world, tag):
    """Nyström, pivoted-Cholesky and Jacobi CG through ``distributed_solve``
    against the same specs on the single-device ``Gram`` (whose
    preconditioners tests/test_torch_precond.py holds to the reference's),
    on the same draws: the factor is built whole on every rank, and under
    ring the Woodbury apply's only collective is one psum of Lᵀr."""
    a = _inputs()
    op = Gram(x=torch.from_numpy(a["x"]), params=_params(a["solve"]))
    y = torch.from_numpy(a["y"])
    for name, pc in _preconds().items():
        want = solve(op, y, CG(max_iters=PRECOND["iters"], tol=1e-12, precond=pc),
                     draws=_precond_draws()).solution
        for rank, res in enumerate(_run_primitives(world)):
            got = res[tag]["precond/" + name]
            assert _scaled(got.numpy(), want.numpy()) <= CG_TOL, (rank, name)
    for res in _run_primitives(world):
        counts = res[tag]["precond_apply_counts"]
        want = dict(all_gather=0, psum=1 if tag == "ring" else 0, ppermute=0)
        assert {k: counts[k] for k in want} == want


@pytest.mark.parametrize("world", [2, 4])
def test_ring_iterates_stay_row_blocks(world):
    n_local = PRIM["n"] // world
    for res in _run_primitives(world):
        assert res["ring"]["mv_shape"] == (n_local, PRIM["s"])
        assert res["ring"]["rows_t_shape"] == (n_local, PRIM["s"])
        for name in ("cg", "sgd", "sdd", "ap"):
            assert res["ring"][name + "_counts"][2] == (n_local,)
        for tag in ("gather", "gather_once"):
            assert res[tag]["mv_shape"] == (PRIM["n"], PRIM["s"])
            assert res[tag]["cg_counts"][2] == (PRIM["n"],)
        assert res["auto"] == ("gather", "ring")


@pytest.mark.parametrize("tag", COMM_IDS)
def test_four_ranks_match_the_reference_sharded_gram(tag):
    """P = 4 against the reference's own 4-device ``ShardedGram``, wherever
    it runs: every primitive, ``block_at`` (not under plain gather), 18 CG
    iterations and SGD on every comm, AP under gather_once."""
    ref = _reference_sharded()
    for rank, res in enumerate(_run_primitives(4)):
        rec = res[tag]
        for k in ("mv", "rows_mv", "rows_t_mv", "block_at", "cg", "sgd", "ap"):
            key = f"{tag}/{k}"
            if key not in ref:
                continue
            tol = {"cg": CG_TOL, "sgd": STEP_TOL}.get(k, PRIM_TOL)
            assert _scaled(rec[k].numpy(), ref[key]) <= tol, (rank, key)


# ---------------------------------------------------------------------------
# bench_distributed's problem at P = 4, and the reference's solution bounds
# ---------------------------------------------------------------------------


def _bench_rank(rank, world, port, a, out_dir):
    torch.set_num_threads(1)
    mesh = join_mesh(rank, world, port, "cpu", timeout=GROUP_TIMEOUT)
    xs = shard_training_rows(mesh, torch.from_numpy(a["x"]))
    y = torch.from_numpy(a["y"])
    p = _params(a["params"])
    v = torch.from_numpy(a["v"])
    res = {}
    for comm in ("gather", "ring"):
        op = ShardedGram(x=xs, params=p, mesh=mesh, comm=comm)
        coll.reset_collective_counts()
        out = op.mv(v if comm == "gather" else _rows(v, rank, world))
        rec = dict(coll.collective_counts(), mv=out)
        cg = distributed_solve(p, xs, y, mesh, CG(max_iters=15, tol=1e-12), comm=comm)
        rec.update(cg_matvecs=cg.matvecs, cg_iterations=cg.iterations)
        ops.reset_feature_trace_counts()
        sgd = distributed_solve(p, xs, y, mesh,
                                SGD(num_steps=200, batch_size=64, num_features=32),
                                comm=comm, backend="cuda",
                                generator=torch.Generator().manual_seed(0))
        rec.update(sgd_matvecs=sgd.matvecs,
                   sgd_features_materialised=ops.FEATURE_TRACE_COUNTS["features"],
                   sgd_features_fused=ops.FEATURE_TRACE_COUNTS["cuda"])
        ap = distributed_solve(p, xs, y, mesh, AP(num_steps=30, block_size=32), comm=comm,
                               generator=torch.Generator().manual_seed(0))
        rec["ap_matvecs"] = ap.matvecs
        res[comm] = rec
    # n % P != 0: no canonical layout
    with pytest.raises(ValueError, match="n % P"):
        shard_training_rows(mesh, torch.from_numpy(a["x"])[:130])
    uneven = xs[:-1] if rank == 0 else xs
    with pytest.raises(ValueError, match="n % P"):
        distributed_solve(p, uneven, y[:uneven.shape[0]], mesh, "cg")
    res["uneven_raised"] = True
    # the operator built by hand and solved directly: solve() checks it once
    # through prepare_for_solve, before any collective of the loop
    for comm in ("gather", "ring"):
        with pytest.raises(ValueError, match="n % P"):
            solve(ShardedGram(x=uneven, params=p, mesh=mesh, comm=comm),
                  y[:uneven.shape[0]], CG(max_iters=5))
    res["uneven_solve_raised"] = True
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _bounds_rank(rank, world, port, a, out_dir, comm, once, solvers):
    """The reference's solution bounds (tests/test_distributed_ring.py:137-170)
    on its n = 128 problem under one comm: CG to 1e-8 and AP's 150 steps
    (``solvers="cg_ap"``), or SGD's 2,000 steps (``"sgd"``, run under ring
    alone: the reference holds the prediction bound on ring's SGD; gather's
    SGD count is bench_distributed's row), the draws from generators seeded
    alike on every rank. SGD runs apart so that each run stays well inside
    RUN_TIMEOUT on a loaded machine."""
    torch.set_num_threads(1)
    mesh = join_mesh(rank, world, port, "cpu", timeout=GROUP_TIMEOUT)
    p = _params(a["params"])
    xb = shard_training_rows(mesh, torch.from_numpy(a["xb"]))
    yb = torch.from_numpy(a["yb"])
    kw = dict(comm=comm, gather_once=once)
    op = ShardedGram(x=xb, params=p, mesh=mesh, comm=comm)
    if solvers == "cg_ap":
        cg = distributed_solve(p, xb, yb, mesh, CG(max_iters=300, tol=1e-8), **kw)
        ap = distributed_solve(p, xb, yb, mesh, AP(num_steps=150, block_size=32),
                               generator=torch.Generator().manual_seed(0), **kw)
        out = dict(cg=_whole(cg.solution, op), cg_counts=(cg.iterations, cg.matvecs),
                   ap=_whole(ap.solution, op), ap_matvecs=ap.matvecs)
    else:
        sgd = distributed_solve(p, xb, yb, mesh,
                                SGD(num_steps=2000, batch_size=32, step_size_times_n=0.5,
                                    num_features=64),
                                generator=torch.Generator().manual_seed(0), **kw)
        out = dict(sgd=_whole(sgd.solution, op), sgd_matvecs=sgd.matvecs)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


@lru_cache(maxsize=None)
def _bench_inputs() -> dict:
    import jax

    from repro.core.kernels_fn import make_params

    key = jax.random.PRNGKey(0)
    x = np.array(jax.random.normal(key, (256, 3)))   # bench_distributed.py:40-46
    xb = np.array(jax.random.normal(key, (128, 3)))  # test_distributed_ring.py:114-118
    p = make_params("se", lengthscale=1.0, noise=0.2, d=3)
    return dict(x=x, y=np.sin(x.sum(-1)).astype(np.float32),
                v=np.array(jax.random.normal(jax.random.fold_in(key, 1), (256, 4))),
                xb=xb, yb=np.sin(xb.sum(-1)).astype(np.float32),
                params=tuple(np.asarray(t) for t in (p.log_lengthscale, p.log_signal,
                                                     p.log_noise)))


def _run_bench() -> list:
    return _spawn(_bench_rank, 4, _bench_inputs())


@pytest.mark.parametrize("comm", ["gather", "ring"])
def test_bench_distributed_rows_exactly(comm):
    rows = {r["method"]: r["metrics"] for r in json.loads(BENCH_JSON.read_text())["rows"]}
    mv, cg, sgd, ap = (rows[f"{k}_{comm}"] for k in ("mv", "cg", "sgd", "ap"))
    for res in _run_bench():
        rec = res[comm]
        for k in ("all_gather", "ppermute", "psum"):
            assert rec[k] == mv[k], k
        assert rec["all_gather"] + rec["ppermute"] + rec["psum"] == mv["collectives"]
        assert rec["staged_bytes"] == 0  # CPU tensors on gloo move as they are
        assert (rec["cg_iterations"], rec["cg_matvecs"]) == (cg["iterations"], cg["matvecs"])
        assert rec["sgd_matvecs"] == sgd["matvecs"]
        assert rec["sgd_features_materialised"] == sgd["feature_traces_materialised"] == 0
        assert rec["sgd_features_fused"] > 0
        assert rec["ap_matvecs"] == ap["matvecs"]


@pytest.mark.parametrize("comm,once", COMMS, ids=COMM_IDS)
def test_solutions_within_the_reference_bounds(comm, once):
    a = _bench_inputs()
    p = _params(a["params"])
    dense = Gram(x=torch.from_numpy(a["xb"]), params=p).dense().double()
    ref = torch.linalg.solve(dense, torch.from_numpy(a["yb"]).double())
    for rec in _spawn(_bounds_rank, 4, a, comm, once, "cg_ap"):
        assert rec["cg_counts"][0] == rec["cg_counts"][1]
        assert (rec["cg"].double() - ref).abs().max().item() <= 1e-3
        assert rec["ap_matvecs"] == 0
        assert (rec["ap"].double() - ref).abs().max().item() <= 2e-2


def test_ring_sgd_within_the_reference_bound():
    a = _bench_inputs()
    p = _params(a["params"])
    dense = Gram(x=torch.from_numpy(a["xb"]), params=p).dense().double()
    ref = torch.linalg.solve(dense, torch.from_numpy(a["yb"]).double())
    for rec in _spawn(_bounds_rank, 4, a, "ring", False, "sgd"):
        assert rec["sgd_matvecs"] == 1
        assert (dense @ (rec["sgd"].double() - ref)).abs().max().item() < 0.2


def test_uneven_rows_raise():
    assert all(res["uneven_raised"] for res in _run_bench())


def test_ring_order_gram_is_rings_arithmetic_on_one_device():
    """``RingOrderGram`` — the yardstick the card holds ring CG to — gives
    each rank's ring ``mv`` rows bit for bit at P = 4."""
    from repro_torch.testing.ranks import RingOrderGram

    a = _bench_inputs()
    v = torch.from_numpy(a["v"])
    want = RingOrderGram(x=torch.from_numpy(a["x"]), params=_params(a["params"]), world=4).mv(v)
    whole = Gram(x=torch.from_numpy(a["x"]), params=_params(a["params"])).mv(v)
    for rank, res in enumerate(_run_bench()):
        assert torch.equal(res["ring"]["mv"], _rows(want, rank, 4)), rank
        assert _scaled(res["gather"]["mv"].numpy(), whole.numpy()) <= PRIM_TOL


def test_uneven_rows_raise_through_solve():
    assert all(res["uneven_solve_raised"] for res in _run_bench())


@pytest.mark.parametrize("device,env,local_world,cards,want", [
    ("cpu", {}, None, 0, "gloo"),
    ("cuda", {"LOCAL_WORLD_SIZE": "8", "WORLD_SIZE": "16"}, None, 8, "nccl"),
    ("cuda", {"LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "2"}, None, 1, "gloo"),
    ("cuda", {"LOCAL_WORLD_SIZE": "8"}, 1, 1, "nccl"),
    ("cuda", {}, 4, 4, "nccl"),
    ("cuda", {}, None, 8, ValueError),
], ids=["cpu", "two_nodes_of_8", "two_ranks_one_card", "arg_over_env", "spawned",
        "unknown"])
def test_data_backend_from_the_ranks_on_this_node(monkeypatch, device, env, local_world,
                                                   cards, want):
    """NCCL where each of this node's ranks has a card: torchrun's
    LOCAL_WORLD_SIZE (or ``local_world``) against the node's cards, never
    the global world size; an unknown count raises rather than guess."""
    for k in ("LOCAL_WORLD_SIZE", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is ValueError:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            tmesh.data_backend(device, local_world=local_world)
    else:
        assert tmesh.data_backend(device, local_world=local_world) == want
