"""The port's block resolution (``repro_torch.kernels.autotune``) on the CPU,
the twin of tests/test_autotune.py: its keys, buckets and grid equal the
reference's, the table resolves before the heuristic (with the reference's
guard), a missing table is no error and a table is read once per path, the
committed H100 table covers the grid with its own evidence, the heuristic
block gives the plans the port ran before its table, a pinned block cuts the
plans' chunks, and ``block`` reaches the plans through ``Gram`` and every
``ops`` entry point without changing a plain result."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as ref_autotune
from repro_torch.core.kernels_fn import make_params
from repro_torch.core.operators import Gram
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.gram_matvec import (
    MIN_CHUNK_TILES, TILE_COLS, check_block, gram_bwd_plan, gram_plan,
)
from repro_torch.kernels.rff_matvec import MIN_ROW_TILES, ROW_TILE, rff_plan
from test_torch_gram_plan import FEW_ROWS, PHASE2, SQUARE
from test_torch_rff_plan import PATHS as RFF_PATHS

#: bucket edges and values on either side of them, and far past the grid
N_VALUES = (0, 1, 127, 128, 192, 512, 1023, 1024, 1025, 4095, 4096, 16383, 16384,
            45_730, 65_535, 65_536, 434_874)
D_VALUES = (1, 2, 3, 7, 8, 9, 31, 32, 33, 127, 128, 1000)


@pytest.fixture
def table_env(tmp_path, monkeypatch):
    """A table file of the test's own under REPRO_TORCH_AUTOTUNE_TABLE; the
    cache cleared around the test."""
    path = tmp_path / "table.json"
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, str(path))
    autotune.load_table.cache_clear()
    yield path
    autotune.load_table.cache_clear()


# ---------------------------------------------------------------------------
# keys, buckets and the grid: the reference's exactly
# ---------------------------------------------------------------------------


def test_grid_constants_equal_the_references():
    for name in ("FAMILIES", "N_GRID", "D_GRID", "DTYPES", "CANDIDATE_BLOCKS",
                 "RHS_WIDTH_ESTIMATE"):
        assert getattr(autotune, name) == getattr(ref_autotune, name), name
    assert autotune.expected_keys() == ref_autotune.expected_keys()
    assert len(autotune.expected_keys()) == 64


@pytest.mark.parametrize("family", ["gram", "rff"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_and_table_key_equal_the_references(family, dtype):
    for n in N_VALUES:
        assert autotune._bucket(autotune.N_GRID, n) == ref_autotune._bucket(ref_autotune.N_GRID, n)
        for d in D_VALUES:
            got = autotune.table_key(family, n, d, dtype)
            assert got == ref_autotune.table_key(family, n, d, dtype), (n, d)
            assert got in autotune.expected_keys()
    for d in D_VALUES:
        assert autotune._bucket(autotune.D_GRID, d) == ref_autotune._bucket(ref_autotune.D_GRID, d)


@pytest.mark.parametrize("args", [("attention", 1024, 2), ("gram", 1024, 2, "float16"),
                                  ("rff", 5000, 3, "fp32")])
def test_table_key_raises_the_references_errors(args):
    with pytest.raises(ValueError) as want:
        ref_autotune.table_key(*args)
    with pytest.raises(ValueError) as got:
        autotune.table_key(*args)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# resolution: the table, then the heuristic, the guard; a plain int, no sync
# ---------------------------------------------------------------------------


def test_resolve_block_prefers_table_then_heuristic(table_env):
    key = autotune.table_key("gram", 2048, 4)
    table_env.write_text(json.dumps({"table": {key: 128}}))
    got = autotune.resolve_block("gram", 2048, 4)
    assert got == 128 and type(got) is int
    # another key, another dtype: the heuristic, a plain int
    for args, kw in ((("rff", 2048, 4), {}), (("gram", 2048, 4), dict(precision="bf16"))):
        fallback = autotune.resolve_block(*args, **kw)
        assert fallback == autotune.heuristic_block(args[0], 2048, 4) == autotune.HEURISTIC_BLOCK
        assert type(fallback) is int


@pytest.mark.parametrize("n,value,want", [(192, 512, 256), (1024, 512, 512), (100, 128, 128),
                                          (300, 512, 256), (511, 512, 256), (512, 512, 512)])
def test_values_above_the_rows_are_ignored(table_env, n, value, want):
    # n = 192 buckets down to n1024, whose value may exceed the call's rows:
    # the reference's guard, max(CANDIDATE_BLOCKS[-1], n)
    table_env.write_text(json.dumps({"table": {autotune.table_key("gram", n, 8): value}}))
    assert autotune.resolve_block("gram", n, 8) == want
    # the reference takes or ignores the same value (its heuristic differs)
    ref = ref_autotune.resolve_block("gram", n, 8,
                                     table={ref_autotune.table_key("gram", n, 8): value})
    assert (ref == value) == (want == value)


@pytest.mark.parametrize("content", [None, "{not json", "[1, 2]"])
def test_missing_or_unreadable_table_is_not_an_error(table_env, content):
    if content is not None:
        table_env.write_text(content)
    assert autotune.load_table() == {}
    got = autotune.resolve_block("gram", 1024, 2)
    assert got == autotune.HEURISTIC_BLOCK and type(got) is int


def test_table_is_read_once_per_path(table_env, monkeypatch):
    key = autotune.table_key("rff", 4096, 8)
    table_env.write_text(json.dumps({"table": {key: 128}}))
    opened = []
    real_open = open

    def counting_open(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", counting_open)
    blocks = [autotune.resolve_block("rff", n, 8) for n in (4096, 5000, 9000) for _ in range(5)]
    assert blocks == [128] * 15
    assert opened.count(str(table_env)) == 1  # the twin of "no retrace"
    # a rewritten file is not seen until the cache is cleared
    table_env.write_text(json.dumps({"table": {key: 512}}))
    assert autotune.resolve_block("rff", 4096, 8) == 128
    autotune.load_table.cache_clear()
    assert autotune.resolve_block("rff", 4096, 8) == 512
    assert opened.count(str(table_env)) == 2


def test_default_table_lives_beside_the_module():
    from pathlib import Path

    path = Path(autotune.DEFAULT_TABLE_PATH)
    assert path.is_absolute() and path.parent == Path(autotune.__file__).resolve().parent
    assert autotune.AUTOTUNE_ENV != ref_autotune.AUTOTUNE_ENV


# ---------------------------------------------------------------------------
# the committed H100 table: the freshness gate, and its own evidence
# ---------------------------------------------------------------------------


def _committed():
    with open(autotune.DEFAULT_TABLE_PATH) as f:
        return json.load(f)


def test_committed_table_covers_the_grid_with_candidate_values():
    doc = _committed()
    assert doc["source"] == "h100-sweep"
    assert set(doc["table"]) == autotune.expected_keys()
    assert all(v in autotune.CANDIDATE_BLOCKS for v in doc["table"].values())
    # the card it was swept on, by nvidia-smi: "<name>, <power limit> W"
    assert "H100" in doc["device"] and doc["nvidia_smi"].startswith(doc["device"])
    assert doc["nvidia_smi"].rstrip().endswith("W")
    for k in ("torch", "cuda", "date", "method", "grid"):
        assert doc[k]


@pytest.mark.parametrize("family", ["gram", "rff"])
def test_committed_table_carries_every_candidates_times_and_its_decision(family):
    doc = _committed()
    for key, block in doc["table"].items():
        if not key.startswith(family):
            continue
        cases = doc["cases"][key]
        fam, nb, db, dtype = key.split("|")
        want = [(op, r, c) for op, r, c in autotune.sweep_cases(fam, int(nb[1:]))]
        assert [(c["op"], c["rows"], c["cols"]) for c in cases] == want, key
        for case in cases:
            if "skipped" in case:
                continue
            assert set(case["ms"]) == {str(b) for b in autotune.CANDIDATE_BLOCKS}
            assert all(len(v) == autotune.SWEEP_REPEATS and min(v) > 0
                       for v in case["ms"].values())
            # the plans it timed are the plans the code runs today
            for b in autotune.CANDIDATE_BLOCKS:
                assert case["plan_of"][str(b)] == str(autotune.case_plan(
                    case["op"], case["rows"], case["cols"], case["d"], case["s"],
                    case["precision"], b)), (key, case["op"], b)
        # a non-heuristic value beat the heuristic wherever its plan differs
        assert autotune.decide(cases) == block, key


# ---------------------------------------------------------------------------
# the plans: the heuristic gives today's, a pinned block cuts the chunks
# ---------------------------------------------------------------------------


def test_heuristic_block_is_the_plans_default():
    assert autotune.HEURISTIC_BLOCK == MIN_CHUNK_TILES * TILE_COLS == MIN_ROW_TILES * ROW_TILE
    for fam in autotune.FAMILIES:
        for n in N_VALUES:
            assert autotune.heuristic_block(fam, n, 9) == 256


@pytest.mark.parametrize("shape", SQUARE + FEW_ROWS + [PHASE2])
def test_heuristic_block_gives_todays_gram_plans(table_env, shape):
    n, m, d, s = shape
    blk = autotune.resolve_block("gram", n, d)  # no table: the heuristic
    assert gram_plan(n, m, d, s, blk) == gram_plan(n, m, d, s)
    for precision in ("fp32", "bf16"):
        sb = min(s, 64)
        assert (gram_bwd_plan(n, m, d, sb, precision=precision, block=blk)
                == gram_bwd_plan(n, m, d, sb, precision=precision))


@pytest.mark.parametrize("shape", RFF_PATHS)
def test_heuristic_block_gives_todays_rff_plans(table_env, shape):
    n, m, d, s = shape
    assert rff_plan(n, m, d, s, autotune.resolve_block("rff", n, d)) == rff_plan(n, m, d, s)


def test_the_heuristic_plans_are_the_ones_before_the_table():
    # the hand-set plans before the table, field for field (tests/test_torch_gram_plan.py)
    assert gram_plan(512, 45_730, 9, 65, 256).chunk == 1344
    assert gram_plan(400, 50_000, 8, 100, 256).chunks == 40
    assert gram_plan(1024, 1024, 8, 16, 256).chunk == 4 * TILE_COLS


@pytest.mark.parametrize("block", [128, 256, 512, 1024])
def test_a_pinned_block_sets_the_fewest_columns_a_chunk_holds(block):
    # 1,024 × 1,024: 16 row blocks, 16 tiles, so the floor binds
    plan = gram_plan(1024, 1024, 8, 16, block)
    assert plan.chunk == min(block, 1024) and plan.chunks == -(-1024 // plan.chunk)
    # 128 rows against protein's n: 2 CTAs a chunk, ≥ 5 tiles to fill the card
    panel = gram_plan(128, 45_730, 9, 65, block)
    assert panel.chunk == max(block, 5 * TILE_COLS)
    # many rows run one chunk whatever the block, and v is sliced alike
    for s in (1, 65, 129):
        square = gram_plan(45_730, 45_730, 9, s, block)
        assert square.chunks == 1 and square.width == gram_plan(45_730, 45_730, 9, s).width
    # the backward's chunks hold at least block columns (or all of them)
    bwd = gram_bwd_plan(1024, 1024, 8, 16, block=block)
    assert bwd.chunk >= min(block, 1024)
    assert gram_bwd_plan(1024, 1024, 8, 16, block=128).chunk == 128
    # Φ̃ᵀu's row chunks likewise; Φ̃W's frequency chunks do not take it
    rp = rff_plan(1024, 512, 9, 16, block)
    assert rp.row_chunk >= min(block, 1024)
    assert (rp.freq_chunks, rp.freq_chunk, rp.width) == (
        (p := rff_plan(1024, 512, 9, 16)).freq_chunks, p.freq_chunk, p.width)


@pytest.mark.parametrize("bad", [0, -64, 63, 100, 96, True, 64.0, "big", "Auto"])
def test_a_block_not_a_positive_multiple_of_64_raises(bad):
    with pytest.raises(ValueError, match="multiple of 64"):
        check_block(bad)
    with pytest.raises(ValueError):
        gram_plan(1024, 1024, 8, 16, bad)
    x = torch.zeros((8, 2))
    p = make_params("se", lengthscale=1.0, d=2, device="cpu")
    with pytest.raises(ValueError):
        ops.gram_mv(p, x, torch.zeros((8, 1)), backend="cuda", block=bad)


def test_block_accepts_numpy_ints():
    assert check_block(np.int64(192)) == 192
    assert gram_plan(1024, 1024, 8, 16, np.int64(128)) == gram_plan(1024, 1024, 8, 16, 128)


def test_resolution_is_memoised_until_the_cache_is_cleared(table_env, monkeypatch):
    # every cuda launch resolves its block: a repeated shape builds no key
    # and reads no environment; a new table path is seen after cache_clear
    key = autotune.table_key("gram", 2048, 8)
    table_env.write_text(json.dumps({"table": {key: 128}}))
    assert autotune.resolve_block("gram", 2048, 8) == 128
    keys = []
    real_key = autotune.table_key
    monkeypatch.setattr(autotune, "table_key", lambda *a: keys.append(a) or real_key(*a))
    assert [autotune.resolve_block("gram", 2048, 8) for _ in range(10)] == [128] * 10
    assert keys == []
    other = table_env.with_name("other.json")
    other.write_text(json.dumps({"table": {key: 512}}))
    monkeypatch.setenv(autotune.AUTOTUNE_ENV, str(other))
    assert autotune.resolve_block("gram", 2048, 8) == 128
    autotune.load_table.cache_clear()
    assert autotune.resolve_block("gram", 2048, 8) == 512
    # a table given by the caller is never cached
    assert autotune.resolve_block("gram", 2048, 8, table={}) == autotune.HEURISTIC_BLOCK
    assert len(keys) == 2


@pytest.mark.parametrize("op", ["gram_fwd", "gram_bwd", "rff_mv", "rff_t"])
@pytest.mark.parametrize("rows", [128, 192, 512, 1024])
def test_the_sweep_times_the_plans_calls_run(table_env, op, rows):
    # case_plan resolves a candidate through resolve_block's own guard: a
    # block above the rows is timed as the heuristic's plan, as calls run it
    family = "gram" if op.startswith("gram") else "rff"
    for block in autotune.CANDIDATE_BLOCKS:
        for precision, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            table_env.write_text(json.dumps(
                {"table": {autotune.table_key(family, rows, 8, dtype): block}}))
            autotune.load_table.cache_clear()
            runs = autotune.resolve_block(family, rows, 8, precision=precision)
            want = autotune.case_plan(op, rows, 45_730, 8, 16, precision, runs)
            assert autotune.case_plan(op, rows, 45_730, 8, 16, precision, block) == want


def test_launch_bindings_are_built_once():
    # the cuda routes bind their launches to (precision, block) at every
    # call: the same objects come back, so no call builds them anew
    from repro_torch.kernels import gram_matvec as gm, rff_matvec as rm

    assert rm._kernel_ops(128) is rm._kernel_ops(128)
    assert rm._kernel_ops(None) is rm._KERNEL_OPS
    assert gm._pair_ops("bf16", 256) is gm._pair_ops("bf16", 256)
    assert gm._at(gm.gram_matvec._launch, "bf16", 128) is gm._at(gm.gram_matvec._launch,
                                                                 "bf16", 128)
    assert gm._at(gm.gram_matvec._launch, "fp32") == gm.gram_matvec._launch


def test_decide_takes_a_candidate_only_where_it_beat_the_heuristic_everywhere():
    def case(plans, ms):
        return dict(plan_of=plans, ms={b: [t] * 3 for b, t in ms.items()},
                    median_ms=ms, spread_ms={b: 0.001 for b in ms})

    same = {"512": "a", "256": "a", "128": "a"}
    diff = {"512": "a", "256": "b", "128": "c"}
    # identical plans everywhere: the heuristic
    assert autotune.decide([case(same, {"512": 1.0, "256": 1.0, "128": 1.0})]) == 256
    # 128 faster wherever its plan differs; the identical case does not count
    assert autotune.decide([case(diff, {"512": 2.0, "256": 1.0, "128": 0.5}),
                            case(same, {"512": 3.0, "256": 3.0, "128": 3.0})]) == 128
    # faster at one case, slower at another: the heuristic
    assert autotune.decide([case(diff, {"512": 2.0, "256": 1.0, "128": 0.5}),
                            case(diff, {"512": 2.0, "256": 1.0, "128": 1.5})]) == 256
    # within the spread: the heuristic
    near = case(diff, {"512": 2.0, "256": 1.0, "128": 0.9995})
    assert autotune.decide([near]) == 256


# ---------------------------------------------------------------------------
# the API: Gram(block=...) and every ops entry point take block on the CPU
# ---------------------------------------------------------------------------


def _problem(seed=0, n=96, d=3, s=5, m=40):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32))  # noqa: E731
    params = make_params("matern32", lengthscale=0.9, signal=1.3, noise=0.2, d=d,
                         device="cpu")
    return params, f(n, d), f(n, s), f(m, d), torch.as_tensor(rng.integers(0, n, 24))


@pytest.mark.parametrize("block", ["auto", 128, 512])
@pytest.mark.parametrize("backend", ["cuda", "chunked"])
def test_every_ops_entry_takes_block_and_gives_the_plain_result(block, backend):
    params, x, v, omega, idx = _problem()
    u = v[:24]
    calls = {
        "gram_mv": lambda **kw: ops.gram_mv(params, x, v, jitter=params.noise, **kw),
        "gram_mv_cross": lambda **kw: ops.gram_mv(params, x[:30], v, z=x, **kw),
        "gram_rows_matvec": lambda **kw: ops.gram_rows_matvec(params, x, idx, v, **kw),
        "gram_rows_matvec_t": lambda **kw: ops.gram_rows_matvec(params, x, idx, u,
                                                                transpose=True, **kw),
        "gram_rows_pair": lambda **kw: ops.gram_rows_pair(params, x, idx, v, u, **kw),
        "rff_mv": lambda **kw: ops.rff_mv(x, omega, torch.ones((80, 5)), signal=1.3, **kw),
        "rff_t_mv": lambda **kw: ops.rff_t_mv(x, omega, v, signal=1.3, **kw),
        "rff_pair_mv": lambda **kw: ops.rff_pair_mv(x, omega, v, signal=1.3, **kw),
    }
    for name, call in calls.items():
        want = call(backend=backend)
        got = call(backend=backend, block=block)
        for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    pins = {
        "gram_matvec": lambda **kw: ops.gram_matvec(params, x, v, jitter=params.noise, **kw),
        "rff_matvec": lambda **kw: ops.rff_matvec(x, omega, torch.ones((80, 5)), **kw),
        "rff_t_matvec": lambda **kw: ops.rff_t_matvec(x, omega, v, **kw),
    }
    for name, call in pins.items():
        torch.testing.assert_close(call(block=block), call(), rtol=0, atol=0, msg=name)


def test_the_plain_backends_ignore_block_as_the_references_chunked_does():
    params, x, v, omega, idx = _problem(1)
    want = ops.gram_mv(params, x, v, backend="chunked")
    torch.testing.assert_close(ops.gram_mv(params, x, v, backend="chunked", block=100), want,
                               rtol=0, atol=0)
    feats = ops.rff_mv(x, omega, torch.ones((80, 2)), backend="features", block="big")
    assert feats.shape == (96, 2)


@pytest.mark.parametrize("block", ["auto", 64, 512])
@pytest.mark.parametrize("backend", ["cuda", "chunked", "dense"])
def test_gram_takes_block_and_gives_the_same_result(block, backend):
    params, x, v, _, idx = _problem(2)
    base, op = Gram(x, params, backend=backend), Gram(x, params, backend=backend, block=block)
    assert op.block == block and Gram(x, params).block == "auto"
    for name in ("mv", "mv_k"):
        torch.testing.assert_close(getattr(op, name)(v), getattr(base, name)(v), rtol=0, atol=0)
    torch.testing.assert_close(op.rows_mv(idx, v), base.rows_mv(idx, v), rtol=0, atol=0)
    torch.testing.assert_close(op.rows_t_mv(idx, v[:24]), base.rows_t_mv(idx, v[:24]),
                               rtol=0, atol=0)
    for g, w in zip(op.rows_pair_mv(idx, v, v[:24]), base.rows_pair_mv(idx, v, v[:24])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_sharded_gram_has_a_block_field():
    import dataclasses

    from repro_torch.core.operators import ShardedGram

    fields = {f.name: f.default for f in dataclasses.fields(ShardedGram)}
    assert fields["block"] == "auto"
    names = [f.name for f in dataclasses.fields(Gram)]
    assert names.index("block") == names.index("backend") + 1  # the reference's order


def test_cuda_route_hands_the_resolved_block_to_the_wrapper(table_env, monkeypatch):
    # gram_mv resolves on the host from (n of its x, d, precision) and passes
    # a plain int on; a table's value reaches the wrapper
    key = autotune.table_key("gram", 96, 3, "bfloat16")
    table_env.write_text(json.dumps({"table": {key: 128}}))
    seen = []
    real = ops._gram_kernel

    def spy(*a, **kw):
        seen.append(kw["block"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "_gram_kernel", spy)
    params, x, v, _, _ = _problem(3)
    ops.gram_mv(params, x, v, backend="cuda", precision="bf16")
    ops.gram_mv(params, x, v, backend="cuda")
    ops.gram_mv(params, x, v, backend="cuda", block=512)
    assert seen == [128, 256, 512] and all(type(b) is int for b in seen)
