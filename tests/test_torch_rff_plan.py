"""The random-feature kernels' launch plans on the CPU: ``rff_plan``, how the
paths' shapes are cut into frequency blocks, row chunks, row blocks,
frequency chunks and column slices, in both orientations of the kernel (Φ̃ᵀu,
Φ̃W) and the pair that chains them; and ``rff_bwd_plan``, the backward's row
blocks, column chunks and slices of the factors. The kernels themselves run
only on the card (``tests/test_torch_gpu.py``); the plans are plain Python,
so their numbers are held here, and the chunked routes' arithmetic (partial
products over the plan's chunks, summed in order) is held against the whole
product through the plain versions in float64."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gram_matvec import GRID_Y, SMS, round_chunks
from repro_torch.kernels.ref import rff_bwd_ref, rff_matvec_ref, rff_pair_ref, rff_t_matvec_ref
from repro_torch.kernels.rff_matvec import (
    FREQ_GROUP, FREQ_TILE, MIN_ROW_TILES, ROW_TILE, RFF_BWD_SLICE_COLS, RFFBwdPlan, RFFPlan,
    rff_bwd_plan, rff_plan, rff_resident,
)

#: (n, m, d, s) of the paths: SGD's feature pair, f_X and Φ(X*)W at serving
#: (2,048 features), the MLL's prior f_X, the Thompson ascent's prior at 400
#: query rows
SGD = (45_730, 100, 9, 65)
PATHS = [SGD, (45_730, 1024, 9, 64), (1024, 1024, 9, 64), (45_730, 512, 9, 8),
         (400, 512, 8, 100)]


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.normal(size=shape) * scale)


def test_sgd_pair_plan():
    plan = rff_plan(*SGD)
    assert plan == RFFPlan(slices=1, width=72, freq_blocks=4, row_chunks=65, row_chunk=704,
                           row_blocks=715, freq_chunks=1, freq_chunk=128, padded_freqs=104)
    # Φ̃ᵀu: 4 frequency blocks alone would be 4 CTAs; 260 fill one round of
    # two resident CTAs on 132 SMs (288 would take a second round of 24)
    assert plan.t_ctas == 260 <= 2 * SMS
    # Φ̃t: one chunk, no workspace; Φ̃ᵀu's partials are (65, 200, 65)
    assert plan.mv_ctas == 715 and plan.mv_workspace_floats(45_730, 65) == 0
    assert plan.t_workspace_floats(100, 65) == 65 * 200 * 65


def test_m_100_pads_fewer_than_128_frequencies():
    # frequencies are computed in groups of 8 (one tensor-core k-step or
    # m-tile), not in blocks of 32 or 64: m = 100 runs as 104
    plan = rff_plan(*SGD)
    assert plan.padded_freqs == 104 < 128
    assert FREQ_GROUP * math.ceil(100 / FREQ_GROUP) == plan.padded_freqs
    for m in range(1, 600):
        padded = rff_plan(45_730, m, 9, 65).padded_freqs
        assert m <= padded < m + FREQ_GROUP


@pytest.mark.parametrize("n,m,d,s", PATHS)
def test_path_plans_cut_the_k_loops_by_round_chunks(n, m, d, s):
    # both K loops cut by round_chunks: Φ̃ᵀu's rows (at least MIN_ROW_TILES
    # tiles a chunk) under its frequency blocks, Φ̃W's frequencies under its
    # row blocks, as many resident CTAs as the kernel's launch bounds allow
    plan = rff_plan(n, m, d, s)
    resident = rff_resident(d, plan.width)
    assert resident == (3 if plan.width <= 16 else 2 if plan.width <= 72 else 1)
    assert plan.row_chunk == ROW_TILE * round_chunks(
        -(-n // ROW_TILE), plan.freq_blocks * plan.slices, resident, MIN_ROW_TILES)
    assert plan.freq_chunk == FREQ_TILE * round_chunks(
        -(-m // FREQ_TILE), plan.row_blocks * plan.slices, resident, 1)
    # enough CTAs for the card, or as many as the chunks' floors allow
    assert plan.t_ctas >= min(SMS, plan.freq_blocks * -(-n // (ROW_TILE * MIN_ROW_TILES)))
    assert plan.mv_ctas >= min(SMS, plan.row_blocks * -(-m // FREQ_TILE))


def test_few_rows_cut_the_frequencies_into_chunks():
    # the Thompson ascent's prior at 400 rows: 7 row blocks, so Φ̃W's 16
    # frequency tiles run one a chunk
    plan = rff_plan(400, 512, 8, 100)
    assert (plan.row_blocks, plan.freq_chunks, plan.freq_chunk) == (7, 16, 32)
    assert plan.mv_workspace_floats(400, 100) == 16 * 400 * 100


@pytest.mark.parametrize("n,m", [(1, 1), (1, 2_000_000), (2_000_000, 1), (63, 33), (45_730, 100),
                                 (5_000_000, 100)])
@pytest.mark.parametrize("d,s", [(9, 1), (9, 65), (9, 129), (128, 65)])
def test_plans_stay_inside_the_grid_limits(n, m, d, s):
    plan = rff_plan(n, m, d, s)
    assert 1 <= plan.row_chunks <= GRID_Y and 1 <= plan.freq_chunks <= GRID_Y
    assert 1 <= plan.slices <= GRID_Y and plan.width % 8 == 0 and plan.width <= 128
    assert (plan.row_chunks - 1) * plan.row_chunk < n <= plan.row_chunks * plan.row_chunk
    assert (plan.freq_chunks - 1) * plan.freq_chunk < m <= plan.freq_chunks * plan.freq_chunk
    assert (plan.slices - 1) * plan.width < s <= plan.slices * plan.width
    assert plan.freq_blocks == -(-m // FREQ_TILE) and plan.row_blocks == -(-n // ROW_TILE)


def test_wide_d_slices_at_64_columns():
    assert (rff_plan(1000, 100, 128, 65).slices, rff_plan(1000, 100, 128, 65).width) == (2, 40)
    assert (rff_plan(1000, 100, 64, 128).slices, rff_plan(1000, 100, 64, 128).width) == (1, 128)


@pytest.mark.parametrize("m_true", [37, 40])
def test_t_row_chunks_sum_to_the_transpose(m_true):
    # Φ̃ᵀu over the plan's row chunks, summed in order, then masked: the sum
    # kernel's arithmetic, in float64
    rng = np.random.default_rng(0)
    n, m, d, s = 3000, 40, 5, 9
    x, omega, u = _normal(rng, n, d), _normal(rng, m, d, scale=0.8), _normal(rng, n, s)
    plan = rff_plan(n, m, d, s)
    assert plan.row_chunks > 1
    total = torch.zeros(2 * m, s, dtype=torch.float64)
    for i in range(0, n, plan.row_chunk):
        total = total + rff_t_matvec_ref(x[i:i + plan.row_chunk], omega, u[i:i + plan.row_chunk])
    keep = (torch.arange(2 * m) % m < m_true)[:, None]
    total = torch.where(keep, total, torch.zeros_like(total))
    want = rff_t_matvec_ref(x, omega, u, m_true=m_true)
    assert float((total - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


def test_frequency_chunks_sum_to_the_matvec():
    # Φ̃W over the plan's frequency chunks (each with √(1/m) of the whole m),
    # summed in order
    rng = np.random.default_rng(1)
    n, m, d, s = 300, 200, 8, 17
    x, omega, w = _normal(rng, n, d), _normal(rng, m, d, scale=0.8), _normal(rng, 2 * m, s)
    plan = rff_plan(n, m, d, s)
    assert plan.freq_chunks > 1
    total = torch.zeros(n, s, dtype=torch.float64)
    for f in range(0, m, plan.freq_chunk):
        e = min(m, f + plan.freq_chunk)
        om, wc = omega[f:e], torch.cat([w[f:e], w[m + f:m + e]])
        total = total + math.sqrt(om.shape[0] / m) * rff_matvec_ref(x, om, wc)
    want = rff_matvec_ref(x, omega, w)
    assert float((total - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


def test_pair_chains_the_two_orientations():
    # the pair is Φ̃ᵀu's masked t, then Φ̃t: each phase on its own chunks
    rng = np.random.default_rng(2)
    n, m, d, s, m_true = 2000, 100, 9, 5, 93
    x, omega, u = _normal(rng, n, d), _normal(rng, m, d, scale=0.8), _normal(rng, n, s)
    t = rff_t_matvec_ref(x, omega, u, m_true=m_true)
    want = rff_pair_ref(x, omega, u, m_true=m_true)
    assert float((rff_matvec_ref(x, omega, t) - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


#: (rows, cols, d, s) of the backward's cases: the Thompson ascent's dx at
#: 400 query rows against 512 frequencies, and protein's dx and dω of the
#: forward VJP (1,024 frequencies, s = 65) and of the SGD pair's VJP (100
#: frequencies, 2s = 130)
THOMPSON_BWD = (400, 512, 8, 100)
BWD_CASES = {
    THOMPSON_BWD: RFFBwdPlan(row_blocks=7, chunks=8, chunk=64, slices=2, width=56,
                             products="tc"),
    (45_730, 1024, 9, 65): RFFBwdPlan(row_blocks=715, chunks=1, chunk=1024, slices=1,
                                      width=72, products="tc"),
    (1024, 45_730, 9, 65): RFFBwdPlan(row_blocks=16, chunks=33, chunk=1408, slices=1,
                                      width=72, products="tc"),
    (45_730, 100, 9, 130): RFFBwdPlan(row_blocks=715, chunks=1, chunk=128, slices=2,
                                      width=72, products="tc"),
    (100, 45_730, 9, 130): RFFBwdPlan(row_blocks=2, chunks=33, chunk=1408, slices=2,
                                      width=72, products="tc"),
}


@pytest.mark.parametrize("shape", list(BWD_CASES))
def test_rff_bwd_plans_at_the_kernels_phase_shapes(shape):
    rows, cols, d, s = shape
    plan = rff_bwd_plan(*shape)
    assert plan == BWD_CASES[shape]
    # s = 65 in one slice (a projection and sincos a pair, not two); the
    # column loop cut by round_chunks, down to one tile, with one CTA an SM
    assert plan.width == 8 * math.ceil(s / plan.slices / 8) <= RFF_BWD_SLICE_COLS[16]
    tiles = -(-cols // 64)
    assert plan.chunk == 64 * round_chunks(tiles, plan.row_blocks * plan.slices, 1, 1)
    assert plan.workspace_floats(rows, d) == (plan.parts * rows * d if plan.parts > 1 else 0)
    # the dω orientation's few output rows fill at least one round of CTAs
    assert plan.ctas >= min(SMS, plan.row_blocks * tiles * plan.slices)


def test_thompson_bwd_runs_one_tile_a_cta_in_one_round():
    # a rule of two waves of CTAs in whole 64-column tiles gives 7 row blocks
    # x 8 chunks = 56 CTAs; the plan cuts the 512 columns into their 8 tiles,
    # each slice of s = 100 apart: 112 CTAs, every one resident at once with
    # one tile, the shortest the K loop can be cut. A full round of 132 would
    # need three slices, each repeating the projection and sincos of every
    # pair (168 CTAs, no faster on the H100: PERF.md §6).
    plan = rff_bwd_plan(*THOMPSON_BWD)
    assert plan.chunk == 64 and plan.chunks == 8 == -(-512 // 64)
    assert plan.ctas == 112 == 2 * 56 and plan.ctas <= SMS
    assert plan.parts == 16


def test_rff_bwd_plan_variants():
    # the factor products on the FMA pipe for slices of at most 16 columns,
    # on the tensor cores above; either can be asked for, to time both
    assert rff_bwd_plan(400, 512, 8, 16).products == "fma"
    assert rff_bwd_plan(400, 512, 8, 17).products == "tc"
    assert rff_bwd_plan(*THOMPSON_BWD, products="fma").products == "fma"
    assert rff_bwd_plan(*THOMPSON_BWD, products="fma").width == rff_bwd_plan(
        *THOMPSON_BWD).width
    with pytest.raises(ValueError, match="no factor-product variant 'wgmma'"):
        rff_bwd_plan(400, 512, 8, 100, products="wgmma")
    # narrower slices past d = 16 and d = 64, where the R and C tiles grow
    assert rff_bwd_plan(1000, 1000, 64, 65).width <= RFF_BWD_SLICE_COLS[64]
    assert rff_bwd_plan(1000, 1000, 128, 65).width <= RFF_BWD_SLICE_COLS[128]


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 2_000_000), (2_000_000, 1), (63, 65),
                                       (100, 5_000_000), (5_000_000, 100)])
@pytest.mark.parametrize("d,s", [(9, 1), (8, 100), (9, 130), (64, 65), (128, 300)])
def test_rff_bwd_plans_stay_inside_the_grid_limits(rows, cols, d, s):
    plan = rff_bwd_plan(rows, cols, d, s)
    assert 1 <= plan.chunks <= GRID_Y and 1 <= plan.slices <= GRID_Y
    assert plan.chunk % 64 == 0 and plan.width % 8 == 0
    assert (plan.chunks - 1) * plan.chunk < cols <= plan.chunks * plan.chunk
    assert (plan.slices - 1) * plan.width < s <= plan.slices * plan.width
    assert plan.row_blocks == -(-rows // 64)


@pytest.mark.parametrize("rows,cols,d,s", [(100, 3000, 8, 100), (3000, 100, 9, 130),
                                           (70, 5000, 3, 150)])
def test_rff_bwd_parts_sum_to_the_cotangent(rows, cols, d, s):
    # each (chunk, slice) part through the plain version in float64, summed in
    # the kernel's order (part = slice x chunks + chunk), then scaled: the
    # whole cotangent, with P1 != P2 and Q1 != Q2
    rng = np.random.default_rng(3)
    r, c = _normal(rng, rows, d), _normal(rng, cols, d, scale=2.0)
    p1, p2 = _normal(rng, rows, s), _normal(rng, rows, s)
    q1, q2 = _normal(rng, cols, s), _normal(rng, cols, s)
    scale = (1.0 / min(rows, cols)) ** 0.5
    plan = rff_bwd_plan(rows, cols, d, s)
    assert plan.parts > 1
    parts = []
    for k in range(0, s, plan.width):
        sl = slice(k, k + plan.width)
        for j in range(0, cols, plan.chunk):
            cj = slice(j, j + plan.chunk)
            parts.append(rff_bwd_ref(r, c[cj], p1[:, sl], p2[:, sl], q1[cj, sl], q2[cj, sl],
                                     scale=1.0))
    assert len(parts) == plan.parts
    total = torch.zeros(rows, d, dtype=torch.float64)
    for part in parts:
        total = total + part
    want = rff_bwd_ref(r, c, p1, p2, q1, q2, scale=scale)
    assert float((scale * total - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))
