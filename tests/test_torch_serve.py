"""The port's serving engine (``repro_torch.serve``, ``IterativeGP.engine``,
``repro_torch.launch.serve_gp``) against the JAX reference's ``repro.serve`` on
the CPU, at the reference tests' sizes (tests/test_serve.py:35-43: n = 96,
d = 2).

* The scheduler, the bucket ladder and ``percentile`` are host code: the same
  request streams give the same batch plans (ids, groups, order, skips)
  exactly, the cases of tests/test_serve.py:169-213 and
  tests/test_robustness.py:250-300 among them.
* Both engines start from one fitted state (the reference's, carried across
  by ``convert.posterior_state_from_numpy``) and serve the same stream on the
  reference's own per-request draws (``draws_fn`` fed by the reference
  engine's ``_request_draws`` and its ascent key's splits): predict within
  1e-4 of scale, sample payloads within 1e-3 at CG(200, 1e-4), Thompson
  points within 1e-3 where the top-k margin of ROADMAP queue 3 holds, the
  deterministic counters equal and the ``stats()`` key sets equal.
* The engine's own contract on the port's draws: twins of the engine tests of
  tests/test_serve.py and tests/test_robustness.py:314-435 (rescue and
  isolation, structural failure, quarantine, deadlines and overload, the
  reject policy, retries), and of ``test_engine_compaction_trigger`` with its
  threshold set from the drift it measures (the reference's fixed 1.0 × tol
  sits on a knife edge and fails there, ROADMAP queue 3).
* The launcher runs, and its ``--json`` snapshot has the reference's keys.

Tolerances are max|Δ| ≤ tol·max(1, max|ref|).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.serve as jserve
from repro.core.kernels_fn import make_params as jmake_params
from repro.core.solvers.spec import CG as JCG
from repro.core.solvers.spec import spec_to_dict as jspec_to_dict
import repro_torch.serve as tserve
from repro_torch.convert import (
    params_from_numpy, posterior_state_from_numpy, request_draws_from_numpy,
)
from repro_torch.core import CG, IterativeGP
from repro_torch.launch import serve_gp
from repro_torch.serve import EngineOverloaded, GPEngine
from repro_torch.testing import FaultyFeatureOperator, FaultyOperator

#: the payload tolerances (predict; sample and Thompson at CG(200, 1e-4))
PREDICT_TOL, SAMPLE_TOL, POINT_TOL = 1e-4, 1e-3, 1e-3
SPEC = dict(max_iters=200, tol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float64)


def _assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _tparams(jp, device="cpu"):
    return params_from_numpy(np.asarray(jp.log_lengthscale), np.asarray(jp.log_signal),
                             np.asarray(jp.log_noise), jp.kind, device=device)


@pytest.fixture(scope="module")
def small_problem():
    """tests/test_serve.py:35-43's problem, as numpy arrays."""
    key = jax.random.PRNGKey(0)
    n, d = 96, 2
    x = jax.random.uniform(key, (n, d))
    y = jnp.sin(4.0 * x[:, 0]) + 0.5 * jnp.cos(3.0 * x[:, 1])
    jp = jmake_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=d)
    return dict(x=np.asarray(x), y=np.asarray(y), jp=jp, params=_tparams(jp), n=n, d=d)


def _engine(p, **kw):
    """tests/test_serve.py:219's engine, on the port's draws."""
    kw.setdefault("spec", CG(max_iters=300, tol=1e-4))
    kw.setdefault("num_samples", 4)
    kw.setdefault("num_features", 128)
    return GPEngine(p["params"], p["x"], p["y"], device="cpu", **kw)


# ---------------------------------------------------------------------------
# scheduler, bucket ladder, percentile: the same plans as the reference's
# ---------------------------------------------------------------------------


def _run_script(mod, script, caps):
    """Play ``script`` against ``mod``'s FIFOScheduler; return the trace of
    every plan (group, ids, the skips left behind), expiry and refusal."""
    sched = mod.FIFOScheduler(**caps)
    trace = []
    for op in script:
        if op[0] == "add":
            _, i, kind, cols, warm, skips, deadline = op
            xs = None if kind == "thompson_step" else (
                jnp.zeros((4, 2)) if mod is jserve else torch.zeros((4, 2)))
            req = mod.Request(id=i, kind=kind, xs=xs, num_samples=cols, seed=i,
                              arrival=float(i), warm=warm, deadline=deadline)
            req.skips = skips
            try:
                sched.add(req)
            except ValueError as exc:
                trace.append(("refused", i, "RHS columns" in str(exc)))
        elif op[0] == "next":
            plan = sched.next_batch()
            trace.append(None if plan is None else (
                plan.group, [r.id for r in plan.requests], plan.total_columns,
                plan.max_rows, [(r.id, r.skips) for r in sched.pending()]))
        else:
            trace.append(("expired", [r.id for r in sched.expire(op[1])], len(sched)))
    return trace


def _add(i, kind, cols=4, warm=False, skips=0, deadline=None):
    return ("add", i, kind, cols, warm, skips, deadline)


def _random_script(seed, count=60):
    rng = np.random.default_rng(seed)
    kinds = ("predict", "sample", "thompson_step")
    script = []
    for i in range(count):
        script.append(_add(i, kinds[rng.integers(3)], int(rng.integers(1, 9)),
                           bool(rng.integers(2)), 0,
                           None if rng.random() < 0.7 else float(rng.integers(count))))
        if rng.random() < 0.4:
            script.append(("next",))
        if rng.random() < 0.1:
            script.append(("expire", float(i)))
    return script + [("next",)] * count


SCHEDULER_CASES = {
    # tests/test_serve.py:180 — coalescing, warm never mixes with cold
    "coalesce": (dict(max_batch_requests=8, max_rhs_columns=64),
                 [_add(0, "sample"), _add(1, "predict"), _add(2, "thompson_step"),
                  _add(3, "sample", warm=True)] + [("next",)] * 4),
    # tests/test_serve.py:196 — the column cap, and a request over it refused
    "column_cap": (dict(max_batch_requests=8, max_rhs_columns=8),
                   [_add(i, "sample") for i in range(3)] + [("next",)] * 2
                   + [_add(9, "sample", cols=9)]),
    # tests/test_robustness.py:262 — the starvation guard promotes a request
    "starvation_guard": (dict(max_batch_requests=4, max_rhs_columns=8, max_skips=2),
                         [_add(0, "predict"), _add(1, "sample", skips=2)]
                         + [("next",)] * 3),
    # tests/test_robustness.py:281 — FIFO wait is bounded by queue position
    "fifo_wait": (dict(max_batch_requests=1, max_skips=16),
                  [_add(0, "predict"), _add(1, "sample"), _add(2, "predict")]
                  + [("next",)] * 4),
    # tests/test_robustness.py:294 — expiry removes past-deadline requests
    "expire": (dict(), [_add(0, "predict", deadline=1.0), _add(1, "predict", deadline=5.0),
                        _add(2, "predict"), ("expire", 2.0), ("expire", 2.0), ("next",)]),
    "request_cap": (dict(max_batch_requests=3, max_rhs_columns=64),
                    [_add(i, "predict") for i in range(7)] + [("next",)] * 4),
    "random_a": (dict(max_batch_requests=5, max_rhs_columns=16, max_skips=3),
                 _random_script(1)),
    "random_b": (dict(max_batch_requests=16, max_rhs_columns=64), _random_script(2)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_scheduler_plans_equal_the_reference(case):
    caps, script = SCHEDULER_CASES[case]
    want = _run_script(jserve, script, caps)
    assert _run_script(tserve, script, caps) == want
    assert any(step is not None for step in want)


def test_scheduler_rejects_bad_caps_like_the_reference():
    for kw in (dict(max_batch_requests=0), dict(max_rhs_columns=0), dict(max_skips=0)):
        with pytest.raises(ValueError):
            jserve.FIFOScheduler(**kw)
        with pytest.raises(ValueError):
            tserve.FIFOScheduler(**kw)


def test_bucket_ladder_and_percentile_equal_the_reference():
    for minimum in (1, 2, 8, 16):
        assert [tserve.bucket(n, minimum) for n in range(0, 300)] == [
            jserve.bucket(n, minimum) for n in range(0, 300)]
    assert tserve.bucket(1, 16) == 16 and tserve.bucket(17, 16) == 32
    assert tserve.bucket(5, 1) == 8 and tserve.bucket(8, 8) == 8
    rng = np.random.default_rng(0)
    for size in (0, 1, 2, 4, 7, 100):
        xs = [float(v) for v in rng.normal(size=size)]
        for q in (0, 1, 25, 50, 51, 90, 99, 100):
            assert tserve.percentile(xs, q) == jserve.percentile(xs, q)
    # tests/test_serve.py:340's nearest-rank cases
    assert tserve.percentile([4.0, 1.0, 3.0, 2.0], 50) == 2.0
    assert tserve.percentile([float(i) for i in range(1, 101)], 50) == 50.0


def test_exports_are_the_reference_names():
    want = {n for n in dir(jserve) if not n.startswith("_")} - {
        "engine", "metrics", "request", "scheduler", "state"}
    got = {n for n in dir(tserve) if not n.startswith("_")} - {
        "engine", "metrics", "request", "scheduler", "state"}
    assert got == want


# ---------------------------------------------------------------------------
# engine payloads against the reference engine, from one fitted state, on
# the reference's own per-request draws
# ---------------------------------------------------------------------------


def _reference_request_draws(jeng, req, d):
    """The reference engine's draws of ``req`` (engine.py:477-489), and for a
    Thompson request its ascent key's candidates (thompson.py:49-55)."""
    w, eps, ka = jeng._request_draws(req)
    extra = {}
    if req.kind == "thompson_step":
        c = int(req.options.get("num_candidates", 256))
        n_exploit = int(c * 0.9)
        ku, ke, kp = jax.random.split(ka, 3)
        extra = dict(
            uniform=np.asarray(jax.random.uniform(ku, (c - n_exploit, d))),
            pick=np.asarray(jax.random.choice(ke, jeng.state.n, (n_exploit,),
                                              p=jax.nn.softmax(jeng.state.y))),
            perturb=np.asarray(jax.random.normal(kp, (n_exploit, d))))
    return request_draws_from_numpy(np.asarray(w), np.asarray(eps), device="cpu", **extra)


def _carry_state(jst, device="cpu"):
    """The reference's PosteriorState in the port."""
    post = jst.post
    res = jst.fit_result
    return posterior_state_from_numpy(
        _tparams(jst.params, device), np.asarray(jst.x), np.asarray(jst.y),
        np.asarray(post.prior.ff.omega), np.asarray(post.prior.w), np.asarray(post.v_mean),
        np.asarray(post.alpha), np.asarray(jst.eps), np.asarray(jst.f_x),
        jspec_to_dict(jst.spec), iterations=int(res.iterations), matvecs=int(res.matvecs),
        rel_residual=np.asarray(res.rel_residual), flags=np.asarray(res.flags),
        device=device)


#: the stream both engines serve: (kind, rows offset, rows, num_samples, seed)
STREAM = [
    ("sample", 0, 5, 3, 101), ("predict", 5, 7, None, 1), ("sample", 10, 3, 2, 202),
    ("thompson_step", 0, 0, 3, 11), ("predict", 20, 16, None, 2),
    ("sample", 30, 9, 4, 303), ("thompson_step", 0, 0, 2, 12),
    ("thompson_step", 0, 0, 4, 13), ("predict", 40, 1, None, 3),
]


@pytest.fixture(scope="module")
def engine_pair(small_problem):
    """The reference engine and the port's engine on its carried state, both
    after serving STREAM, then STREAM's solve requests again (warm)."""
    p = small_problem
    jeng = jserve.GPEngine(p["jp"], jnp.asarray(p["x"]), jnp.asarray(p["y"]),
                           spec=JCG(**SPEC), num_samples=4, num_features=128, seed=0)
    teng = GPEngine(p["params"], p["x"], p["y"], spec=CG(**SPEC), device="cpu",
                    state=_carry_state(jeng.state),
                    draws_fn=lambda req: _reference_request_draws(jeng, req, p["d"]))
    handles = {"jax": [], "torch": []}
    stream = STREAM + [s for s in STREAM if s[0] != "predict"]
    for eng, name, arr in ((jeng, "jax", jnp.asarray), (teng, "torch", torch.as_tensor)):
        for kind, lo, rows, ns, seed in stream:
            kw = dict(seed=seed)
            if ns is not None:
                kw["num_samples"] = ns
            if kind == "thompson_step":
                handles[name].append(eng.thompson_step(num_candidates=64, ascent_steps=5,
                                                       **kw))
            else:
                handles[name].append(eng.submit(kind, arr(p["x"][lo:lo + rows] + 0.01),
                                                **kw))
            if len(handles[name]) % 4 == 0:
                eng.step()
        eng.run_until_idle()
    return jeng, teng, handles


def test_carried_state_keeps_the_reference_fingerprint(engine_pair):
    jeng, teng, _ = engine_pair
    assert teng.stats()["hypers_key"] == jeng.stats()["hypers_key"]


def test_engine_payloads_match_the_reference(engine_pair):
    jeng, teng, handles = engine_pair
    kinds = set()
    for hj, ht in zip(handles["jax"], handles["torch"]):
        cj, ct = hj.result(), ht.result()
        assert cj.ok and ct.ok and cj.kind == ct.kind
        kinds.add(ct.kind)
        if ct.kind == "predict":
            _assert_close(ct.value["mean"], cj.value["mean"], PREDICT_TOL)
            _assert_close(ct.value["var"], cj.value["var"], PREDICT_TOL)
        elif ct.kind == "sample":
            _assert_close(ct.value["samples"], cj.value["samples"], SAMPLE_TOL)
        for key in ("batch_requests", "group", "batch_columns", "bucket_columns",
                    "bucket_rows", "bucket_blocks", "warm"):
            assert ct.metrics.get(key) == cj.metrics.get(key), key
    assert kinds == {"predict", "sample", "thompson_step"}


def _top_margin(vals, k):
    """Smallest gap, over columns, between the k-th and (k+1)-th values."""
    srt = -np.sort(-vals, axis=0)
    return float(np.min(srt[k - 1] - srt[k]))


def test_thompson_points_match_the_reference_where_the_margin_holds(engine_pair):
    """The candidates' top-2 selection and the final argmax over starts are
    discrete: a point is compared where both margins exceed 2·1e-4 of scale
    on the reference's own values (ROADMAP queue 3)."""
    from repro.core.pathwise import PosteriorFunctions as JPost
    from repro.core.rff import PriorSamples as JPrior

    jeng, teng, handles = engine_pair
    held = 0
    for hj, ht in zip(handles["jax"], handles["torch"]):
        cj, ct = hj.result(), ht.result()
        if ct.kind != "thompson_step":
            continue
        pj, pt = np.asarray(cj.value["points"]), _np(ct.value["points"])
        assert pt.shape == pj.shape and (pt >= 0).all() and (pt <= 1).all()
        # the reference's candidate values on this request's sample paths
        req = hj.request
        w, _, _ = jeng._request_draws(req)
        st = jeng.state
        pad = ((0, 0), (0, 8 - req.num_samples))  # the column bucket
        alpha = jnp.asarray(jeng.cache.lookup(st.hypers_key, req.kind, req.seed))
        post = JPost(params=st.params, x=st.x, prior=JPrior(ff=st.prior.ff, w=jnp.pad(w, pad)),
                     v_mean=st.post.v_mean, alpha=jnp.pad(alpha, pad))
        dr = _reference_request_draws(jeng, req, 2)
        near = np.asarray(st.x)[_np(dr.pick).astype(int)] + (
            float(jnp.mean(st.params.lengthscale)) / 2.0) * _np(dr.perturb)
        cands = np.clip(np.concatenate([_np(dr.uniform), near]), 0.0, 1.0)
        vals = np.asarray(post(jnp.asarray(cands, dtype=jnp.float32)))
        if _top_margin(vals, 2) > 2e-4 * max(1.0, float(np.abs(vals).max())):
            _assert_close(pt, pj, POINT_TOL)
            _assert_close(ct.value["values"], cj.value["values"], POINT_TOL)
            held += 1
    assert held >= 1


def test_engine_counters_match_the_reference(engine_pair):
    jeng, teng, _ = engine_pair
    sj, st = jeng.stats(), teng.stats()
    assert set(st) == set(sj)
    for key in ("requests_submitted", "requests_served", "steps", "batches", "solves",
                "rhs_columns", "padded_columns", "warm_hits", "warm_misses",
                "predict_rows", "predict_padded_rows", "queue_depth", "n",
                "posterior_samples", "solver", "warm_cache_entries", "failed",
                "escalations"):
        assert st[key] == sj[key], key
    assert st["warm_hits"] > 0
    # fp32 CG drifts between the packages (ROADMAP queue 3): counts within 15%
    assert abs(st["solver_iterations"] - sj["solver_iterations"]) <= 0.15 * sj[
        "solver_iterations"]


# ---------------------------------------------------------------------------
# the engine's own contract on the port's draws (tests/test_serve.py)
# ---------------------------------------------------------------------------


def test_predict_padding_matches_direct_evaluation(small_problem):
    eng = _engine(small_problem)
    xs = torch.as_tensor(small_problem["x"][:5] + 0.01)  # odd row count: padding
    h = eng.predict(xs)
    eng.step()
    mean, var = h.result().value["mean"], h.result().value["var"]
    mean_ref, var_ref = eng.state.post.sample_mean_and_var(xs)
    torch.testing.assert_close(mean, mean_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(var, var_ref, atol=1e-5, rtol=0)


def test_fifo_completion_order_and_batching(small_problem):
    eng = _engine(small_problem)
    xs = small_problem["x"][:3]
    ids = [
        eng.sample(xs, num_samples=2, seed=1).request.id,
        eng.predict(xs).request.id,
        eng.sample(xs, num_samples=2, seed=2).request.id,
    ]
    first = eng.step()  # head is a cold sample → both samples coalesce
    assert [c.request_id for c in first] == [ids[0], ids[2]]
    assert first[0].metrics["batch_columns"] == 4
    assert first[0].metrics["iterations"] == first[1].metrics["iterations"]
    assert [c.request_id for c in eng.step()] == [ids[1]]


def test_warm_repeat_uses_fewer_iterations(small_problem):
    eng = _engine(small_problem)
    xs = small_problem["x"][:4]
    cold = eng.sample(xs, num_samples=4, seed=77)
    eng.run_until_idle()
    warm = eng.sample(xs, num_samples=4, seed=77)
    assert warm.request.warm
    eng.run_until_idle()
    assert warm.result().metrics["iterations"] < cold.result().metrics["iterations"]
    torch.testing.assert_close(cold.result().value["samples"],
                               warm.result().value["samples"], rtol=1e-4, atol=1e-5)
    snap = eng.stats()
    assert snap["warm_hits"] == 1 and snap["iterations_saved_warm"] > 0


def test_deterministic_under_interleaved_arrival_orders(small_problem):
    xs_a, xs_b = small_problem["x"][:5], small_problem["x"][5:8]
    eng1 = _engine(small_problem)  # both samples coalesce into one solve
    h1a = eng1.sample(xs_a, num_samples=3, seed=101)
    h1b = eng1.sample(xs_b, num_samples=2, seed=202)
    eng1.run_until_idle()
    eng2 = _engine(small_problem)  # a predict interleaves; solves split
    h2b = eng2.sample(xs_b, num_samples=2, seed=202)
    eng2.step()
    eng2.predict(xs_a)
    h2a = eng2.sample(xs_a, num_samples=3, seed=101)
    eng2.run_until_idle()
    for ha, hb in ((h1a, h2a), (h1b, h2b)):
        torch.testing.assert_close(ha.result().value["samples"],
                                   hb.result().value["samples"], rtol=1e-4, atol=1e-5)


def test_row_and_column_buckets_do_not_change_payloads(small_problem):
    """Twin of tests/test_serve.py:288, at the chip check's 1e-3 of scale. On
    the CPU the port's CG sums its column dots in float32 over dim 0, which
    rounds each column by the batch's width, and 75 CG iterations carry that
    to 3.4e-4 of the payload between these two buckets, where the
    reference's sums do not depend on the width (ROADMAP queue 3). On the
    card the dots run in float64 and the right-hand sides in fixed slices,
    and a request's solved columns are the same in any batch
    (tests/test_torch_gpu.py)."""
    eng1 = _engine(small_problem, row_bucket_min=16, col_bucket_min=8)
    eng2 = _engine(small_problem, row_bucket_min=4, col_bucket_min=2)
    xs = small_problem["x"][:5]
    h1 = eng1.sample(xs, num_samples=3, seed=5)
    h2 = eng2.sample(xs, num_samples=3, seed=5)
    eng1.run_until_idle()
    eng2.run_until_idle()
    assert h1.result().metrics["bucket_columns"] == 8
    assert h2.result().metrics["bucket_columns"] == 4
    _assert_close(h2.result().value["samples"], h1.result().value["samples"], SAMPLE_TOL)


def test_thompson_step_returns_in_bounds_points(small_problem):
    eng = _engine(small_problem)
    h = eng.thompson_step(num_samples=3, seed=4, ascent_steps=5, num_candidates=64)
    eng.run_until_idle()
    pts = h.result().value["points"]
    assert tuple(pts.shape) == (3, small_problem["d"])
    assert bool(((pts >= 0) & (pts <= 1)).all())
    assert tuple(h.result().value["values"].shape) == (3,)


def test_engine_stats_counters_and_handles(small_problem):
    eng = _engine(small_problem)
    with pytest.raises(ValueError, match="unknown request kind"):
        eng.submit("decode", small_problem["x"][:2])
    with pytest.raises(ValueError, match="xs must be None"):
        eng.submit("thompson_step", small_problem["x"][:2])
    with pytest.raises(ValueError, match="feature dimension"):
        eng.predict(np.zeros((2, 3), dtype=np.float32))
    h = eng.sample(small_problem["x"][:2], num_samples=2, seed=1)
    with pytest.raises(RuntimeError, match="still queued"):
        h.result()
    eng.predict(small_problem["x"][:3])
    eng.run_until_idle()
    snap = eng.stats()
    assert snap["requests_submitted"] == 2
    assert snap["requests_served"] == {"sample": 1, "predict": 1}
    assert snap["rhs_columns"] == 2
    assert snap["padded_columns"] == 6  # bucketed up to col_bucket_min=8
    assert snap["solves"] == 1 and snap["queue_depth"] == 0
    assert snap["solver"] == "cg" and snap["predict_rows"] == 3


def test_add_observations_rekeys_and_updates_counters(small_problem):
    x_new = small_problem["x"][:6] + 0.02
    y_new = small_problem["y"][:6]
    eng = _engine(small_problem)
    eng.sample(small_problem["x"][:2], num_samples=2, seed=1)
    eng.run_until_idle()
    old_key = eng.state.hypers_key
    eng.add_observations(x_new, y_new)
    assert eng.state.hypers_key != old_key
    assert eng.state.n == small_problem["n"] + 6
    assert eng.stats()["refits"] == 1
    repeat = eng.sample(small_problem["x"][:2], num_samples=2, seed=1)
    assert not repeat.request.warm  # cache is keyed by (hypers, n): re-keyed
    eng.run_until_idle()
    assert repeat.result().ok


def test_engine_update_policies_and_cache_purge(small_problem):
    x_new = small_problem["x"][:6] + 0.02
    y_new = small_problem["y"][:6]
    with pytest.raises(ValueError, match="update_policy"):
        _engine(small_problem, update_policy="bogus")
    with pytest.raises(ValueError, match="overload_policy"):
        _engine(small_problem, overload_policy="bogus")
    eng = _engine(small_problem)  # default auto
    with pytest.raises(ValueError, match="update must be"):
        eng.add_observations(x_new, y_new, update="bogus")
    eng.sample(small_problem["x"][:2], num_samples=2, seed=1)
    eng.run_until_idle()
    assert eng.stats()["warm_cache_entries"] == 1
    eng.add_observations(x_new, y_new)  # auto: drift within budget → lowrank
    snap = eng.stats()
    assert snap["refits"] == 1 and snap["lowrank_updates"] == 1
    assert snap["lowrank_rows"] == 6 and snap["compactions"] == 0
    assert snap["refit_iterations"] == 0  # no full solve ran
    assert snap["lowrank_matvecs"] == snap["lowrank_iterations"] + 1
    assert 0.0 < snap["last_refit_rel_residual"] <= 4.0 * 1e-4
    assert snap["n"] == small_problem["n"] + 6
    assert snap["cache_purged"] == 1 and snap["warm_cache_entries"] == 0
    h = eng.predict(small_problem["x"][:3])
    eng.run_until_idle()
    assert bool(torch.isfinite(h.result().value["mean"]).all())
    eng2 = _engine(small_problem)
    eng2.add_observations(x_new, y_new, update="full")
    snap2 = eng2.stats()
    assert snap2["refits"] == 1 and snap2["lowrank_updates"] == 0
    assert snap2["refit_iterations"] > 0


@pytest.mark.parametrize("below", [True, False], ids=["below_drift", "above_drift"])
def test_engine_compaction_trigger_at_the_measured_drift(small_problem, below):
    """Twin of tests/test_serve.py:545 with its threshold set from the drift
    the lowrank path certifies on this update: a budget at half that drift
    forces the auto fallback to a full refit (a compaction), certified at the
    spec tolerance; a budget at twice it accepts the rank-k update."""
    x_new = small_problem["x"][:6] + 0.02
    y_new = small_problem["y"][:6]
    probe = _engine(small_problem)
    probe.add_observations(x_new, y_new, update="lowrank")
    drift = probe.stats()["last_refit_rel_residual"]
    assert drift > 0
    factor = (0.5 if below else 2.0) * drift / 1e-4
    eng = _engine(small_problem, compaction_tol_factor=factor)
    eng.add_observations(x_new, y_new)
    snap = eng.stats()
    assert snap["refits"] == 1 and eng.state.n == small_problem["n"] + 6
    if below:
        assert snap["compactions"] == 1 and snap["lowrank_updates"] == 0
        assert snap["refit_iterations"] > 0  # the fallback full refit ran
        assert snap["last_refit_rel_residual"] <= 1e-4
        assert eng.state.fit_result.converged
    else:
        assert snap["compactions"] == 0 and snap["lowrank_updates"] == 1
        assert snap["last_refit_rel_residual"] == drift


def test_interleaved_writes_fifo_and_bystanders(small_problem):
    """``add_observations`` drains the queue first: a request submitted before
    the write is served against the state it was submitted under, bit-exact
    with a write-free engine; post-write requests keep FIFO order."""
    xs = small_problem["x"][:3]
    x_new = small_problem["x"][:4] + 0.03
    y_new = small_problem["y"][:4]
    writer, bystander = _engine(small_problem), _engine(small_problem)
    hw = writer.sample(xs, num_samples=2, seed=11)
    hb = bystander.sample(xs, num_samples=2, seed=11)
    writer.add_observations(x_new, y_new)
    bystander.run_until_idle()
    assert torch.equal(hw.result().value["samples"], hb.result().value["samples"])
    ids = [writer.sample(xs, num_samples=2, seed=21).request.id,
           writer.predict(xs).request.id,
           writer.sample(xs, num_samples=2, seed=22).request.id]
    first, second = writer.step(), writer.step()
    assert [c.request_id for c in first] == [ids[0], ids[2]]
    assert [c.request_id for c in second] == [ids[1]]
    for comp in (*first, *second):
        assert comp.ok and all(bool(torch.isfinite(v).all()) for v in comp.value.values())
    writer.add_observations(x_new + 0.05, y_new)
    h2 = writer.sample(xs, num_samples=2, seed=21)
    writer.run_until_idle()
    assert not h2.request.warm and writer.state.n == small_problem["n"] + 8
    assert bool(torch.isfinite(h2.result().value["samples"]).all())


def test_refit_savings_rebaseline(small_problem):
    eng = _engine(small_problem)
    snap0 = eng.stats()
    assert snap0["refit_baseline_n"] == small_problem["n"]
    assert snap0["refit_baseline_iters"] == int(eng.state.fit_result.iterations)
    x1, y1 = small_problem["x"][:4] + 0.02, small_problem["y"][:4]
    eng.add_observations(x1, y1, update="full", warm=False)
    snap1 = eng.stats()
    cold_iters = int(eng.state.fit_result.iterations)
    assert snap1["refit_baseline_n"] == small_problem["n"] + 4
    assert snap1["refit_baseline_iters"] == cold_iters
    assert snap1["refit_iterations_saved"] == 0
    eng.add_observations(x1 + 0.05, y1, update="full", warm=True)
    snap2 = eng.stats()
    warm_iters = snap2["refit_iterations"] - cold_iters
    assert snap2["refit_baseline_n"] == small_problem["n"] + 4
    assert snap2["refit_iterations_saved"] == max(0, cold_iters - warm_iters)


def test_same_seed_same_engine_payload(small_problem):
    """One seed, one device: two engines give bit-identical payloads."""
    a, b = _engine(small_problem, seed=3), _engine(small_problem, seed=3)
    ha = a.sample(small_problem["x"][:4], num_samples=3, seed=9)
    hb = b.sample(small_problem["x"][:4], num_samples=3, seed=9)
    a.run_until_idle()
    b.run_until_idle()
    assert torch.equal(ha.result().value["samples"], hb.result().value["samples"])


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_robustness.py:314-435)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_problem():
    """tests/test_robustness.py:305's problem, as numpy arrays."""
    key = jax.random.PRNGKey(5)
    x = jax.random.uniform(key, (64, 2))
    y = jnp.sin(3.0 * x[:, 0]) + 0.1 * jax.random.normal(key, (64,))
    jp = jmake_params("se", lengthscale=0.5, signal=1.0, noise=1e-2)
    return dict(params=_tparams(jp), x=np.asarray(x), y=np.asarray(y))


def _mk_engine(p, **kw):
    kw.setdefault("spec", CG(max_iters=80, tol=1e-5))
    kw.setdefault("num_features", 256)
    kw.setdefault("num_samples", 8)
    return GPEngine(p["params"], p["x"], p["y"], device="cpu", **kw)


def test_engine_rescues_transient_fault_and_isolates(engine_problem):
    faulty = _mk_engine(engine_problem, operator_transform=lambda op: FaultyOperator(
        op, columns=(3,), min_width=5))
    clean = _mk_engine(engine_problem)
    hs_f = [faulty.sample(faulty.state.x[:6], num_samples=2, seed=s) for s in (1, 2)]
    hs_c = [clean.sample(clean.state.x[:6], num_samples=2, seed=s) for s in (1, 2)]
    faulty.run_until_idle()
    clean.run_until_idle()
    assert all(h.result().ok for h in hs_f)
    assert torch.equal(hs_f[0].result().value["samples"], hs_c[0].result().value["samples"])
    assert bool(torch.isfinite(hs_f[1].result().value["samples"]).all())
    st = faulty.stats()
    assert st["escalations"] == 1 and st["failed"] == 0


def test_engine_fails_structurally_without_escalation(engine_problem):
    eng = _mk_engine(engine_problem, escalation=None,
                     operator_transform=lambda op: FaultyOperator(op, columns=(0,)))
    h = eng.sample(eng.state.x[:4], num_samples=2, seed=1)
    eng.run_until_idle()
    res = h.result()
    assert not res.ok and res.error["code"] == "solver_failure"
    assert "nonfinite" in res.error["message"]
    assert eng.stats()["escalations"] == 0


def test_engine_quarantines_repeat_offender(engine_problem):
    eng = _mk_engine(engine_problem, quarantine_after=2)
    eng.state.post = dataclasses.replace(
        eng.state.post, prior=FaultyFeatureOperator(eng.state.prior, columns=(0,)))
    for _ in range(2):
        h = eng.sample(eng.state.x[:4], num_samples=2, seed=77)
        eng.run_until_idle()
        res = h.result()
        assert not res.ok and res.error["code"] == "solver_failure"
        assert res.error["rungs"]  # the ladder was tried and recorded
    res3 = eng.sample(eng.state.x[:4], num_samples=2, seed=77).result()  # at submit
    assert not res3.ok and res3.error["code"] == "quarantined"
    st = eng.stats()
    assert st["quarantined"] == 1 and st["escalations"] == 2 and st["failed"] == 3
    h4 = eng.sample(eng.state.x[:4], num_samples=2, seed=78)
    eng.run_until_idle()
    assert h4.result().error["code"] == "solver_failure"


def test_engine_deadline_and_overload(engine_problem):
    eng = _mk_engine(engine_problem, max_queue_depth=2, overload_policy="degrade")
    xs = eng.state.x[:4]
    h_exp = eng.sample(xs, num_samples=2, deadline_s=-1.0)  # already late
    eng.predict(xs)
    hd = eng.sample(xs, num_samples=2)  # depth 2 hit → degraded to predict
    assert hd.request.kind == "predict"
    with pytest.raises(EngineOverloaded):
        eng.thompson_step(num_samples=2)  # not degradable → shed
    eng.run_until_idle()
    assert h_exp.result().error["code"] == "deadline_exceeded"
    assert hd.result().ok and hd.result().metrics["degraded"] is True
    st = eng.stats()
    assert st["deadline_misses"] == 1 and st["shed"] == 1 and st["degraded"] == 1


def test_engine_reject_policy(engine_problem):
    eng = _mk_engine(engine_problem, max_queue_depth=1, overload_policy="reject")
    eng.predict(eng.state.x[:4])
    with pytest.raises(EngineOverloaded):
        eng.predict(eng.state.x[:4])
    eng.run_until_idle()
    assert eng.stats()["shed"] == 1


def test_engine_retries_then_fails_raising_batch(engine_problem):
    def boom(op):
        raise RuntimeError("injected dispatch failure")

    eng = _mk_engine(engine_problem, operator_transform=boom, max_exec_retries=1,
                     retry_backoff_s=0.0)
    h1 = eng.sample(eng.state.x[:4], num_samples=2, seed=1)
    h2 = eng.sample(eng.state.x[:4], num_samples=2, seed=2)
    eng.run_until_idle()
    for h in (h1, h2):
        res = h.result()
        assert not res.ok and res.error["code"] == "exec_error"
        assert "injected dispatch failure" in res.error["message"]
    st = eng.stats()
    assert st["retries"] == 1 and st["failed"] == 2
    hp = eng.predict(eng.state.x[:4])
    eng.run_until_idle()
    assert hp.result().ok


def test_fault_wrapper_sees_the_pinned_operator(engine_problem):
    """The inner operator's backend is pinned before ``operator_transform``
    wraps it (engine.py:514-518 of the reference), so the wrapper survives
    solve()'s pinning and fires."""
    seen = []

    def wrap(op):
        seen.append(op.backend)
        return FaultyOperator(op, columns=(0,))

    eng = _mk_engine(engine_problem, spec=CG(max_iters=80, tol=1e-5, backend="dense"),
                     operator_transform=wrap, escalation=None)
    h = eng.sample(eng.state.x[:4], num_samples=2, seed=1)
    eng.run_until_idle()
    assert seen == ["dense"] and h.result().error["code"] == "solver_failure"


# ---------------------------------------------------------------------------
# the façade and the launcher
# ---------------------------------------------------------------------------


def test_iterative_gp_engine_serves_the_fitted_gp(small_problem):
    gp = IterativeGP("matern32", lengthscale=0.5, noise=0.1, spec=CG(max_iters=300, tol=1e-5),
                     device="cpu").fit(small_problem["x"], small_problem["y"])
    eng = gp.engine(num_samples=4, num_features=128, max_rhs_columns=32)
    assert isinstance(eng, GPEngine) and eng.device == torch.device("cpu")
    assert eng.scheduler.max_rhs_columns == 32 and eng.state.n == small_problem["n"]
    h = eng.thompson_step(num_samples=2, seed=1, ascent_steps=3, num_candidates=32)
    eng.run_until_idle()
    assert h.result().ok


@pytest.mark.parametrize("extra", [[], ["--write-every", "4"], ["--fault-rate", "0.3"]],
                         ids=["read_only", "writes", "faults"])
def test_launcher_json_snapshot_has_the_reference_keys(small_problem, capsys, extra):
    args = ["--n", "256", "--d", "2", "--requests", "16", "--device", "cpu", "--json"]
    assert serve_gp.main(args + extra) == 0
    out = capsys.readouterr().out
    snap = json.loads(out[out.index("\n{") + 1:])
    p = small_problem
    jeng = jserve.GPEngine(p["jp"], jnp.asarray(p["x"]), jnp.asarray(p["y"]),
                           spec=JCG(max_iters=5), num_samples=2, num_features=16)
    assert set(snap) == set(jeng.stats())
    assert sum(snap["requests_served"].values()) + snap["failed"] == 20
    if extra[:1] == ["--write-every"]:
        # writes land while reads are still outstanding (drive's loop)
        assert snap["refits"] >= 1 and snap["n"] == 256 + 4 * snap["refits"]
    if extra[:1] == ["--fault-rate"]:
        assert snap["escalations"] >= 1 and snap["failed"] == 0
