"""The Gram matvec kernel's launch plan (``kernels.gram_matvec.gram_plan``) and
its backward's (``gram_bwd_plan``) on the CPU: how the main path's shapes are
cut into CTAs, column chunks, slices of v (or rowv and colv) and row blocks
per CTA. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``); the plans are plain Python, so their numbers
are held here, and the chunked routes' arithmetic (partial products over the
plan's column chunks and slices, summed in order) is held against the whole
product through the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gram_matvec import (
    CHUNK_ROUNDS, FILL_CTAS, GRID_Y, MAX_BWD_COLUMNS, MIN_CHUNK_TILES, SLICE_COLS, SMS,
    TILE_COLS, GramBwdPlan, GramPlan, gram_bwd_plan, gram_plan, round_chunks,
)
from repro_torch.kernels.ref import gram_matvec_bwd_ref, gram_matvec_ref

#: (n, m, d, s) of the main path: CG serving, MLL training and 3droad (square),
#: the Thompson ascent's 400 query rows, the row panel at p = 128, 512 and
#: 1,024 (SGD's phase 0, SDD, Thompson's SDD), and the SGD pair's phase 2
SQUARE = [(45_730, 45_730, 9, 65), (45_730, 45_730, 9, 9), (434_874, 434_874, 3, 17)]
FEW_ROWS = [(400, 50_000, 8, 100), (128, 45_730, 9, 65), (512, 45_730, 9, 65),
            (1024, 45_730, 9, 65), (128, 50_000, 8, 101)]
PHASE2 = (45_730, 512, 9, 65)


def _covers(plan: GramPlan, m: int) -> bool:
    return plan.chunk % TILE_COLS == 0 and (plan.chunks - 1) * plan.chunk < m <= (
        plan.chunks * plan.chunk)


@pytest.mark.parametrize("n,m,d,s", SQUARE)
def test_many_rows_run_one_chunk_one_row_block_per_cta(n, m, d, s):
    plan = gram_plan(n, m, d, s)
    assert (plan.chunks, plan.rows_per_cta, plan.slices) == (1, 1, 1)
    assert plan.ctas == plan.row_blocks == -(-n // 64) >= FILL_CTAS
    assert _covers(plan, m) and plan.workspace_floats(n, s) == 0


@pytest.mark.parametrize("n,m,d,s", FEW_ROWS)
def test_few_rows_are_cut_into_chunks_that_fill_the_card(n, m, d, s):
    plan = gram_plan(n, m, d, s)
    assert plan.chunks > 1 and plan.rows_per_cta == 1
    assert plan.ctas >= FILL_CTAS  # two waves of one CTA per SM on 132 SMs
    assert plan.chunk >= MIN_CHUNK_TILES * TILE_COLS and _covers(plan, m)
    assert plan.chunks <= GRID_Y
    assert plan.workspace_floats(n, s) == plan.chunks * n * s


def test_the_table_s_few_row_plans():
    # the Thompson ascent's 400 x 50,000 (7 row blocks, 7 CTAs before) and
    # the row panel at p = 512 on protein
    assert gram_plan(400, 50_000, 8, 100) == GramPlan(
        row_blocks=7, rows_per_cta=1, chunks=40, chunk=1280, slices=1, width=104)
    assert gram_plan(512, 45_730, 9, 65) == GramPlan(
        row_blocks=8, rows_per_cta=1, chunks=35, chunk=1344, slices=1, width=72)


def test_phase2_runs_two_row_blocks_per_cta():
    # g = K(x, xi) @ err: 715 row blocks against an 8-tile column loop
    plan = gram_plan(*PHASE2)
    assert (plan.chunks, plan.rows_per_cta) == (1, 2)
    assert plan.ctas == 358 >= FILL_CTAS
    # a wide d keeps one x buffer: one row block per CTA
    assert gram_plan(45_730, 512, 128, 65).rows_per_cta == 1


@pytest.mark.parametrize("s,slices,width", [(1, 1, 8), (8, 1, 8), (9, 1, 16), (17, 1, 24),
                                            (65, 1, 72), (101, 1, 104), (128, 1, 128),
                                            (129, 2, 72), (257, 3, 88)])
def test_v_is_padded_to_multiples_of_8_and_sliced_at_128(s, slices, width):
    plan = gram_plan(1000, 1000, 9, s)
    assert (plan.slices, plan.width) == (slices, width)
    assert plan.slices * plan.width >= s and plan.width <= 128


@pytest.mark.parametrize("d,s,slices,width", [(64, 128, 1, 128), (65, 128, 2, 64),
                                              (128, 65, 2, 40), (128, 129, 3, 48)])
def test_wide_d_slices_v_at_64_columns(d, s, slices, width):
    # past d = 64 the x and z tiles take the shared memory of half of v's
    plan = gram_plan(1000, 1000, d, s)
    assert (plan.slices, plan.width) == (slices, width)


@pytest.mark.parametrize("d", [9, 128])
def test_every_slice_holds_columns(d):
    # slices of equal width, a multiple of 8, none past s and none empty
    widest = SLICE_COLS if d <= 64 else SLICE_COLS // 2
    for s in range(1, 5000):
        plan = gram_plan(64, 64, d, s)
        assert plan.width % 8 == 0 and plan.width <= widest, s
        assert (plan.slices - 1) * plan.width < s <= plan.slices * plan.width, s


def test_wide_d_halves_the_chunks_of_a_row_panel():
    # past d = 64, s = 65 takes two slices, so half the chunks fill the card:
    # the chunks depend on d, not only on (n, m, s)
    narrow, wide = gram_plan(512, 45_730, 9, 65), gram_plan(512, 45_730, 128, 65)
    assert (narrow.slices, narrow.chunks) == (1, 35)
    assert (wide.slices, wide.chunks) == (2, 18)
    assert narrow.ctas >= FILL_CTAS and wide.ctas >= FILL_CTAS


@pytest.mark.parametrize("n,m", [(1, 2_000_000_000), (1, 10), (63, 64), (65, 4 * 64 + 1),
                                 (200, 20_000), (130, 20_000)])
def test_plans_stay_inside_the_grid_limits(n, m):
    plan = gram_plan(n, m, 9, 17)
    assert 1 <= plan.chunks <= GRID_Y and _covers(plan, m)
    assert plan.slices <= GRID_Y and plan.rows_per_cta >= 1


def test_chunked_partials_sum_to_the_product():
    # the chunked route's arithmetic: K(x, z_c) @ v_c over the plan's column
    # chunks c, summed in order, is K(x, z) @ v
    rng = np.random.default_rng(0)
    n, m, d, s = 70, 3000, 5, 9
    x, z, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * sc)
               for shape, sc in (((n, d), 0.6), ((m, d), 0.6), ((m, s), 1.0)))
    plan = gram_plan(n, m, d, s)
    assert plan.chunks > 1
    parts = [gram_matvec_ref(x, z[c:c + plan.chunk], v[c:c + plan.chunk], kind="matern32")
             for c in range(0, m, plan.chunk)]
    assert len(parts) == plan.chunks
    total = torch.zeros(n, s)
    for part in parts:
        total = total + part
    want = gram_matvec_ref(x.double(), z.double(), v.double(), kind="matern32")
    assert float((total.double() - want).abs().max()) <= 2e-4 * max(1.0, float(want.abs().max()))


# --- the backward's plan ---------------------------------------------------


def test_backward_plan_fills_the_card_at_the_thompson_ascent():
    # 400 query rows against 50,000 observations: 7 row blocks (7 CTAs
    # before) are cut into column chunks, at least two waves on 132 SMs; one
    # CTA is resident on an SM (G on the tensor cores), and 392 CTAs of 14
    # tiles take three rounds where 280 of 20 would take three too
    plan = gram_bwd_plan(400, 50_000, 8, 100)
    assert plan.ctas >= FILL_CTAS
    assert plan == GramBwdPlan(row_blocks=7, chunks=56, chunk=896, slices=1, width=104,
                               stage2="fma")
    assert plan.workspace_floats(400, 8) == 56 * 400 * 9


@pytest.mark.parametrize("n,m,d,s", [(45_730, 45_730, 9, 8), (45_730, 45_730, 9, 1),
                                     (45_730, 1024, 9, 8)])
def test_backward_plan_runs_one_chunk_at_training_shapes(n, m, d, s):
    # the MLL's fit (s = 1) and trace (s = 8) terms at protein's n: 715 row
    # blocks fill the card, one part, no workspace
    plan = gram_bwd_plan(n, m, d, s)
    assert (plan.chunks, plan.slices, plan.parts) == (1, 1, 1)
    assert plan.ctas == -(-n // 64) >= FILL_CTAS
    assert plan.workspace_floats(n, d) == 0 and _covers(plan, m)


@pytest.mark.parametrize("d,s,slices,width", [(9, 100, 1, 104), (9, 128, 1, 128), (33, 128, 2, 64),
                                              (128, 128, 4, 32), (128, 3, 1, 8), (9, 1, 1, 8)])
def test_backward_plan_slices_rowv_and_colv_by_d(d, s, slices, width):
    # past d = 32 the x, z and [z | 1] tiles take the shared memory of half
    # the slice, past d = 64 of three quarters
    plan = gram_bwd_plan(1000, 1000, d, s)
    assert (plan.slices, plan.width) == (slices, width)
    assert (plan.slices - 1) * plan.width < s <= plan.slices * plan.width


@pytest.mark.parametrize("n,m", [(1, 2_000_000_000), (1, 10), (63, 64), (65, 4 * 64 + 1),
                                 (400, 50_000), (45_730, 45_730)])
@pytest.mark.parametrize("s", [1, 100, MAX_BWD_COLUMNS])
def test_backward_plans_stay_inside_the_grid_limits(n, m, s):
    plan = gram_bwd_plan(n, m, 9, s)
    assert 1 <= plan.chunks <= GRID_Y and _covers(plan, m)
    assert 1 <= plan.slices <= GRID_Y and plan.width % 8 == 0


def test_backward_stage2_variants():
    # the FMA variant by default up to d = 16 (the faster at the path's
    # shapes), the tensor cores above; both variants take the path's d
    assert gram_bwd_plan(400, 50_000, 8, 100).stage2 == "fma"
    assert gram_bwd_plan(45_730, 45_730, 9, 8).stage2 == "fma"
    assert gram_bwd_plan(400, 50_000, 8, 100, "tc").stage2 == "tc"
    assert gram_bwd_plan(100, 100, 16, 8).stage2 == "fma"
    assert gram_bwd_plan(100, 100, 17, 8).stage2 == "tc"
    assert gram_bwd_plan(100, 100, 128, 8).stage2 == "tc"
    with pytest.raises(ValueError, match="does not take"):
        gram_bwd_plan(100, 100, 17, 8, "fma")
    with pytest.raises(ValueError, match="does not take"):
        gram_bwd_plan(100, 100, 9, 8, "wgmma")


@pytest.mark.parametrize("kind", ["se", "matern12", "matern32", "matern52"])
def test_backward_chunked_partials_sum_to_the_cotangent(kind):
    # the backward's parts: dx over the plan's column chunks and rowv/colv
    # slices, in float64 through the plain version and summed in the plan's
    # order (slice-major, as the kernel lays out its partials), is the
    # whole dx (dx is linear in the columns j and in the rank-s factors)
    rng = np.random.default_rng(1)
    n, m, d, s = 70, 1500, 40, 70
    x, z, rowv, colv = (torch.from_numpy(rng.normal(size=shape) * sc)
                        for shape, sc in (((n, d), 0.3), ((m, d), 0.3), ((n, s), 1.0),
                                          ((m, s), 1.0)))
    plan = gram_bwd_plan(n, m, d, s)
    assert plan.chunks > 1 and plan.slices > 1
    total = torch.zeros(n, d, dtype=torch.float64)
    parts = 0
    for c in range(0, s, plan.width):
        for j in range(0, m, plan.chunk):
            total = total + gram_matvec_bwd_ref(
                x, z[j:j + plan.chunk], rowv[:, c:c + plan.width],
                colv[j:j + plan.chunk, c:c + plan.width], kind=kind)
            parts += 1
    assert parts == plan.parts
    want = gram_matvec_bwd_ref(x, z, rowv, colv, kind=kind)
    assert float((total - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


def _steps(tiles, base, resident, per):
    """round_chunks' cost of a cut: rounds of resident CTAs × tiles per CTA."""
    slots = SMS * resident
    return -(-base * -(-tiles // per) // slots) * per


@pytest.mark.parametrize("tiles,base,resident,min_per", [
    (782, 7, 1, 4), (782, 7, 2, 4), (715, 4, 2, 4), (715, 32, 2, 4), (16, 7, 1, 1),
    (4, 79, 2, 1), (3, 5, 2, 4), (100, 300, 2, 4), (9, 1, 2, 1),
])
def test_round_chunks_minimises_the_modeled_rounds(tiles, base, resident, min_per):
    # against every cut up to CHUNK_ROUNDS rounds of CTAs: none finishes in
    # fewer tile-steps, and of the cuts that tie, it has the fewest chunks
    per = round_chunks(tiles, base, resident, min_per)
    assert 1 <= per <= tiles and -(-tiles // per) <= GRID_Y
    if base >= SMS * resident or tiles <= min_per:
        assert per == tiles
        return
    assert per >= min_per
    cands = {max(min_per, -(-tiles // c)) for c in range(1, tiles + 1)
             if base * c <= CHUNK_ROUNDS * SMS * resident}
    best = min(_steps(tiles, base, resident, q) for q in cands)
    assert _steps(tiles, base, resident, per) == best
    assert per == max(q for q in cands if _steps(tiles, base, resident, q) == best)
