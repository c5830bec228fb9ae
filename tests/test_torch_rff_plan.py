"""The random-feature kernel's launch plan (``kernels.rff_matvec.rff_plan``) on
the CPU: how the paths' shapes are cut into frequency blocks, row chunks,
row blocks, frequency chunks and column slices, in both orientations of the
kernel (Φ̃ᵀu, Φ̃W) and the pair that chains them. The kernel itself runs only
on the card (``tests/test_torch_gpu.py``); the plan is plain Python, so its
numbers are held here, and the chunked routes' arithmetic (partial products
over the plan's chunks, summed in order) is held against the whole product
through the plain versions in float64."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gram_matvec import GRID_Y, SMS, round_chunks
from repro_torch.kernels.ref import rff_matvec_ref, rff_pair_ref, rff_t_matvec_ref
from repro_torch.kernels.rff_matvec import (
    FREQ_GROUP, FREQ_TILE, MIN_ROW_TILES, ROW_TILE, RFFPlan, rff_plan, rff_resident,
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
