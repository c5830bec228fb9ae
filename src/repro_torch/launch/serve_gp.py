"""GP posterior serving launcher: drive a `GPEngine` with synthetic traffic —
twin of ``repro/launch/serve_gp.py``.

`python -m repro_torch.launch.serve_gp --n 1024 --d 4 --requests 64 --depth 8`

Closed-loop load generator over the continuous-batching engine
(:mod:`repro_torch.serve`): keep ``--depth`` requests outstanding, submit a
mixed predict/sample/thompson stream, drive ``engine.step()`` until the stream
drains, and print throughput plus the engine's cumulative counter snapshot.
``--repeat`` replays a fraction of the stream with previously-used seeds, which
exercises the warm-start cache (repeat solves re-enter CG at their cached
solution and finish in a couple of iterations).

Write-traffic knobs: ``--write-every K`` interleaves an
``engine.add_observations`` call after every K completed read requests,
appending ``--write-batch`` fresh rows from a held-out pool; ``--update``
picks the refit policy (``auto`` takes the rank-k incremental path and
compacts when certified drift exceeds the budget, ``lowrank``/``full`` force
one path).

Fault-tolerance knobs: ``--deadline-ms`` stamps a relative deadline on every
request; ``--fault-rate`` injects a transient matvec fault
(``repro_torch.testing.FaultyOperator``) into that fraction of solve batches —
the poisoned request is rescued solo through the escalation ladder and the
failure counters show up in the summary and the ``--json`` snapshot.

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import random
import time

import torch

from ..core.kernels_fn import make_params
from ..device import DeviceLike, make_generator, resolve_device
from ..serve import GPEngine, PREDICT, SAMPLE, THOMPSON


def synthetic_dataset(n: int, d: int, seed: int = 0, *, device: DeviceLike = None):
    """x uniform on [0, 1]^d, y = sin(4·x w) + 0.1·cos(7·x₀) for a normal w."""
    gen = make_generator(seed, device)
    x = torch.rand((n, d), generator=gen, device=gen.device)
    w = torch.randn((d,), generator=gen, device=gen.device)
    y = torch.sin(4.0 * (x @ w)) + 0.1 * torch.cos(7.0 * x[:, 0])
    return x, y


def request_stream(num, mix, d, seed, num_rows, num_samples, *, device: DeviceLike = None):
    """The synthetic workload: a (kind, kwargs) iterator of ``num`` requests.
    Request i's query block comes from a generator seeded (seed << 32) + i."""
    dev = resolve_device(device)
    kinds = [k for k in mix for _ in range(mix[k])]
    for i in itertools.count():
        if i >= num:
            return
        kind = kinds[i % len(kinds)]
        if kind == THOMPSON:
            yield kind, dict(num_samples=num_samples, seed=i, num_candidates=128,
                             ascent_steps=5)
        else:
            gen = make_generator((int(seed) << 32) + i, dev)
            xs = torch.rand((num_rows, d), generator=gen, device=dev)
            if kind == PREDICT:
                yield kind, dict(xs=xs, seed=i)
            else:
                yield kind, dict(xs=xs, num_samples=num_samples, seed=i)


def drive(engine: GPEngine, stream, depth: int, *, writes=(), write_every=0,
          update="auto"):
    """Closed loop: keep `depth` requests outstanding until the stream drains.

    With ``write_every > 0``, pop one ``(x_new, y_new)`` batch off ``writes``
    after every ``write_every`` completions and apply it via
    ``engine.add_observations``. A write drains the in-flight queue against
    the pre-update posterior before mutating it, so outstanding has to be
    recounted from the handles afterwards rather than decremented.
    """
    handles = []
    outstanding = 0
    writes_done = 0
    writes = list(writes)
    t0 = time.perf_counter()
    stream = iter(stream)
    exhausted = False
    while not exhausted or outstanding > 0:
        while not exhausted and outstanding < depth:
            nxt = next(stream, None)
            if nxt is None:
                exhausted = True
                break
            kind, kw = nxt
            kw = dict(kw)  # the repeat tail aliases earlier entries
            xs = kw.pop("xs", None)
            h = engine.submit(kind, xs, **kw)
            handles.append(h)
            if not h.done:  # quarantined submits complete immediately
                outstanding += 1
        outstanding -= len(engine.step())
        if write_every > 0 and writes:
            completed = sum(1 for h in handles if h.done)
            if completed // write_every > writes_done:
                xb, yb = writes.pop(0)
                engine.add_observations(xb, yb, update=update)
                writes_done += 1
                outstanding = sum(1 for h in handles if not h.done)
    return handles, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024, help="training set size")
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8, help="outstanding requests")
    ap.add_argument("--solver", default="cg")
    ap.add_argument("--num-rows", type=int, default=16, help="query rows/request")
    ap.add_argument("--num-samples", type=int, default=4, help="RHS cols/request")
    ap.add_argument("--num-features", type=int, default=512)
    ap.add_argument("--max-batch-requests", type=int, default=16)
    ap.add_argument("--max-rhs-columns", type=int, default=64)
    ap.add_argument("--mix", default="predict=2,sample=2,thompson_step=1",
                    help="kind=weight comma list")
    ap.add_argument("--repeat", type=float, default=0.25,
                    help="fraction of the stream replayed with repeat seeds "
                    "(exercises the warm-start cache)")
    ap.add_argument("--write-every", type=int, default=0,
                    help="append a batch of fresh observations after every "
                    "K completed requests (0 = read-only stream)")
    ap.add_argument("--write-batch", type=int, default=4,
                    help="rows per add_observations call")
    ap.add_argument("--update", choices=("auto", "lowrank", "full"),
                    default="auto",
                    help="refit policy for interleaved writes: auto certifies "
                    "the rank-k incremental update and falls back to a full "
                    "warm refit when drift exceeds the compaction budget")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="relative deadline stamped on every request; "
                    "requests still queued past it complete with a "
                    "structured deadline_exceeded error")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="fraction of solve batches hit by a transient "
                    "matvec fault (chaos mode: exercises flag detection, "
                    "solo rescue and the failure counters)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    ap.add_argument("--json", action="store_true", help="print stats as JSON")
    args = ap.parse_args(argv)

    mix = {}
    for part in args.mix.split(","):
        kind, _, weight = part.partition("=")
        if kind not in (PREDICT, SAMPLE, THOMPSON):
            raise SystemExit(f"unknown kind {kind!r} in --mix")
        mix[kind] = int(weight or 1)

    dev = resolve_device(args.device)
    total_reads = args.requests + int(args.requests * args.repeat)
    num_writes = (
        total_reads // args.write_every if args.write_every > 0 else 0
    )
    # one synthetic draw covers the training set plus the write pool, so the
    # appended rows come from the same function as the fit data
    x_all, y_all = synthetic_dataset(
        args.n + num_writes * args.write_batch, args.d, args.seed, device=dev
    )
    x, y = x_all[:args.n], y_all[:args.n]
    writes = [
        (x_all[args.n + i * args.write_batch:args.n + (i + 1) * args.write_batch],
         y_all[args.n + i * args.write_batch:args.n + (i + 1) * args.write_batch])
        for i in range(num_writes)
    ]
    params = make_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1,
                         d=args.d, device=dev)
    print(f"[serve_gp] fitting posterior state: n={args.n} d={args.d} "
          f"solver={args.solver} device={dev}", flush=True)
    operator_transform = None
    if args.fault_rate > 0:
        from ..testing import FaultyOperator

        chaos = random.Random(args.seed + 2)

        def operator_transform(op):
            if chaos.random() < args.fault_rate:
                # transient: fires at batch width, vanishes on the narrower
                # solo rescue solve — the rescuable fault model
                return FaultyOperator(
                    op, columns=(0,), min_width=args.num_samples + 1
                )
            return op

    t0 = time.perf_counter()
    engine = GPEngine(
        params, x, y,
        spec=args.solver,
        num_features=args.num_features,
        seed=args.seed,
        device=dev,
        max_batch_requests=args.max_batch_requests,
        max_rhs_columns=args.max_rhs_columns,
        default_deadline_s=(
            None if args.deadline_ms is None else args.deadline_ms / 1e3
        ),
        operator_transform=operator_transform,
    )
    print(f"[serve_gp] fit in {time.perf_counter() - t0:.2f}s "
          f"({int(engine.state.fit_result.iterations)} iters)", flush=True)

    stream = list(request_stream(
        args.requests, mix, args.d, args.seed + 1, args.num_rows, args.num_samples,
        device=dev,
    ))
    nrep = int(len(stream) * args.repeat)
    stream = stream + stream[:nrep]  # repeat seeds → warm-start cache hits

    handles, wall = drive(engine, stream, args.depth, writes=writes,
                          write_every=args.write_every, update=args.update)
    snap = engine.stats()
    served = snap["requests_served"]
    if args.json:
        print(json.dumps(snap, indent=2, sort_keys=True, default=float))
    else:
        rate = len(handles) / wall if wall > 0 else float("inf")
        print(f"[serve_gp] served {len(handles)} requests in {wall:.2f}s "
              f"({rate:.1f} req/s) at depth {args.depth}: {served}")
        print(f"[serve_gp] steps={snap['steps']} batches={snap['batches']} "
              f"solves={snap['solves']} rhs_columns={snap['rhs_columns']} "
              f"(+{snap['padded_columns']} pad)")
        print(f"[serve_gp] solver iterations={snap['solver_iterations']} "
              f"matvecs={snap['solver_matvecs']}; warm hits={snap['warm_hits']} "
              f"(saved {snap['iterations_saved_warm']} iters)")
        print(f"[serve_gp] latency p50={snap['total_latency_p50_s']*1e3:.1f}ms "
              f"p99={snap['total_latency_p99_s']*1e3:.1f}ms "
              f"queue p50={snap['queue_latency_p50_s']*1e3:.1f}ms")
        if snap["refits"]:
            print(f"[serve_gp] writes: refits={snap['refits']} "
                  f"lowrank_updates={snap['lowrank_updates']} "
                  f"(+{snap['lowrank_rows']} rows) "
                  f"compactions={snap['compactions']} "
                  f"refit_iters={snap['refit_iterations']} "
                  f"(saved {snap['refit_iterations_saved']}) "
                  f"cache_purged={snap['cache_purged']} n={snap['n']}")
        faults = {k: snap[k] for k in (
            "failed", "escalations", "deadline_misses", "quarantined",
            "retries", "shed", "degraded",
        ) if snap[k]}
        if faults:
            print("[serve_gp] faults: " + " ".join(
                f"{k}={v}" for k, v in sorted(faults.items())
            ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
