"""Fused random-Fourier-feature matvecs and their backward — the CUDA kernels
``csrc/rff_matvec.cu`` (Φ̃W, Φ̃ᵀu and the pair, one tensor-core kernel in two
orientations) and ``csrc/rff_bwd.cu``, their launch plan ``rff_plan`` and
their wrappers.

``rff_matvec(x, omega, w)`` computes √(1/m)·[sin(xΩᵀ) | cos(xΩᵀ)] @ w with w's
m sin rows first and m cos rows second, the twin of
``repro.kernels.rff_matvec.rff_matvec_pallas``. The feature edge is masked in
the kernel, so the √(1/m) uses the true m and nothing is padded. σ_f² is applied
by the caller (``kernels/ops.py``), outside the kernel, as in the reference.

``rff_t_matvec(x, omega, u)`` is the transpose Φ̃ᵀu → (2m, s), sin rows first
(``rff_t_matvec_pallas``), and ``rff_pair(x, omega, u)`` the SGD regulariser
Φ̃(Φ̃ᵀu) (``rff_pair_pallas``); both take ``m_true``, the reference's mask of
padded frequencies (a zero frequency's cos is 1), with √(1/m) of the padded m.

``rff_bwd(r, c, p1, p2, q1, q2, scale=...)`` is the input cotangent of the
projection RCᵀ (``rff_bwd_pallas``), scale·(cos(RCᵀ)⊙P₁Q₁ᵀ − sin(RCᵀ)⊙P₂Q₂ᵀ)·C,
on ``rff_bwd_plan``'s launch.

All three matvecs are differentiable in x, ω and their operand, with the
reference's fused VJPs (``rff_matvec.py:299-338,342-377,491-537`` there):
∂x and ∂ω by ``rff_bwd``, ∂w of Φ̃w by the transposed kernel, ∂u of Φ̃ᵀu by the
forward kernel and ∂u of the pair by the pair itself, each only where autograd
asks for it. Every VJP is ported.

A CUDA tensor launches the kernels or raises. CPU tensors go through the same
autograd Functions with the plain versions (``ref.rff_matvec_ref``,
``ref.rff_t_matvec_ref``, ``ref.rff_pair_ref``, ``ref.rff_bwd_ref``) in place of
the launches; ``plain_rff_matvec``, ``plain_rff_t_matvec`` and
``plain_rff_pair`` are those Functions on any device and dtype, the float64
yardstick of the kernels' gradients on the card.

The three matvecs take the reference's tile ``precision``: ``"fp32"``, or
``"bf16"``, bfloat16 contraction operands (x and ω before the projection, the
sin/cos tiles, the operand; the pair's second phase its scaled intermediate)
with fp32 accumulation, in ``csrc/rff_matvec_bf16.cu``. A bf16 forward's
backward runs at the same precision, as the reference's VJPs do: its matvecs
on the bf16 tiles and ∂x, ∂ω on the backward kernel's
(``csrc/rff_bwd_bf16.cu``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .gram_matvec import (
    _ENTRY, _SUFFIX, GRID_Y, MAX_DIM, NARROW_G, SLICE_COLS, TILE_COLS, TILE_ROWS, WIDE_DIM,
    LaunchCounts, _at, _cdiv, bf16_bwd_columns, check_operands, min_tiles, round_chunks,
)
from .ref import check_precision, rff_bwd_ref, rff_matvec_ref, rff_pair_ref, rff_t_matvec_ref

#: The kernel's tile (``csrc/rff_matvec.cu``): Φ̃W runs 64 data rows a CTA over
#: feature tiles of FREQ_TILE frequencies; Φ̃ᵀu runs FREQ_TILE frequencies a
#: CTA over tiles of ROW_TILE data rows. Frequencies are computed in groups of
#: FREQ_GROUP (one k-step or m-tile of the tensor-core product); s is sliced
#: as the Gram kernel slices v. Few output blocks cut the K loop into
#: ``round_chunks``' chunks, a chunk of Φ̃ᵀu at least ``block`` rows
#: (MIN_ROW_TILES row tiles unless a block is given: ``kernels/autotune.py``).
ROW_TILE = 64
FREQ_TILE = 32
FREQ_GROUP = 8
MIN_ROW_TILES = 4


def rff_resident(d: int, width: int) -> int:
    """CTAs of the kernel resident on an SM (its launch bounds, and its shared
    memory past d = WIDE_DIM): three up to 16 columns a slice, two up to 72,
    one above."""
    if d > WIDE_DIM or width > 72:
        return 1
    return 3 if width <= 16 else 2


@dataclasses.dataclass(frozen=True)
class RFFPlan:
    """The kernel's launches at (n, m, d, s), both orientations: v, w or u in
    ``slices`` column slices of ``width`` columns (a multiple of 8); Φ̃ᵀu on
    ``freq_blocks`` blocks of FREQ_TILE frequencies × ``row_chunks`` chunks of
    ``row_chunk`` rows (a multiple of 64); Φ̃W on ``row_blocks`` blocks of 64
    rows × ``freq_chunks`` chunks of ``freq_chunk`` frequencies (a multiple of
    32). ``padded_freqs`` is the frequencies computed, m rounded up to a group
    of FREQ_GROUP."""

    slices: int
    width: int
    freq_blocks: int
    row_chunks: int
    row_chunk: int
    row_blocks: int
    freq_chunks: int
    freq_chunk: int
    padded_freqs: int

    @property
    def t_ctas(self) -> int:
        return self.freq_blocks * self.row_chunks * self.slices

    @property
    def mv_ctas(self) -> int:
        return self.row_blocks * self.freq_chunks * self.slices

    def t_workspace_floats(self, m: int, s: int) -> int:
        """Floats of Φ̃ᵀu's (row_chunks, 2m, s) partial sums."""
        return self.row_chunks * 2 * m * s

    def mv_workspace_floats(self, n: int, s: int) -> int:
        """Floats of Φ̃W's (freq_chunks, n, s) partial sums; 0 for one chunk."""
        return self.freq_chunks * n * s if self.freq_chunks > 1 else 0


@functools.lru_cache(maxsize=None)
def rff_plan(n: int, m: int, d: int, s: int, block=None) -> RFFPlan:
    """The launch plan of Φ̃W and Φ̃ᵀu for x (n, d), ω (m, d) and a (2m, s) or
    (n, s) operand: a plain function of the shapes and ``block`` (Φ̃ᵀu's row
    chunks of at least that many rows; None: MIN_ROW_TILES tiles), memoised,
    so every run of a shape is cut the same way (and its fixed-order chunk
    sum gives the same bits)."""
    slice_cols = SLICE_COLS if d <= WIDE_DIM else SLICE_COLS // 2
    width = 8 * _cdiv(_cdiv(s, _cdiv(s, slice_cols)), 8)
    slices = _cdiv(s, width)
    freq_blocks, row_tiles = _cdiv(m, FREQ_TILE), _cdiv(n, ROW_TILE)
    row_blocks, freq_tiles = _cdiv(n, ROW_TILE), _cdiv(m, FREQ_TILE)
    resident = rff_resident(d, width)
    per = round_chunks(row_tiles, freq_blocks * slices, resident,
                       min_tiles(block, MIN_ROW_TILES))
    fper = round_chunks(freq_tiles, row_blocks * slices, resident, 1)
    return RFFPlan(slices=slices, width=width, freq_blocks=freq_blocks,
                   row_chunks=_cdiv(row_tiles, per), row_chunk=per * ROW_TILE,
                   row_blocks=row_blocks, freq_chunks=_cdiv(freq_tiles, fper),
                   freq_chunk=fper * FREQ_TILE,
                   padded_freqs=FREQ_GROUP * _cdiv(m, FREQ_GROUP))


#: The backward kernel's tile (``csrc/rff_bwd.cu``), the Gram backward's: 64
#: rows by 64 columns. P and Q are sliced at RFF_BWD_SLICE_COLS[d] columns
#: (s = 65 in one slice; fewer past d = 16 and d = 64: the R and C tiles take
#: the shared memory), each slice's width a multiple of 8. The
#: factor products run on the FMA pipe for slices of at most NARROW_G columns
#: (two CTAs resident on an SM) and on the tensor cores above (one); W C on
#: the tensor cores. Few row blocks cut the column loop into ``round_chunks``'
#: chunks, down to one tile.
RFF_BWD_SLICE_COLS = {16: 72, 64: 32, MAX_DIM: 16}  # by the largest d they take


@dataclasses.dataclass(frozen=True)
class RFFBwdPlan:
    """The backward kernel's launch at (rows, cols, d, s): ``row_blocks`` of 64
    rows along grid.x, ``chunks`` column chunks of ``chunk`` columns (a
    multiple of 64) along grid.y, ``slices`` slices of P and Q, each
    ``width`` columns (a multiple of 8), along grid.z; the factor products
    (``products``) on the tensor cores (``"tc"``) or the FMA pipe
    (``"fma"``). Each (chunk, slice) is a part;
    more than one part writes (parts, rows, d) partial sums that a second
    launch adds in a fixed order."""

    row_blocks: int
    chunks: int
    chunk: int
    slices: int
    width: int
    products: str

    @property
    def ctas(self) -> int:
        return self.row_blocks * self.chunks * self.slices

    @property
    def parts(self) -> int:
        return self.chunks * self.slices

    def workspace_floats(self, rows: int, d: int) -> int:
        """Floats of the (parts, rows, d) partial sums; 0 for one part."""
        return self.parts * rows * d if self.parts > 1 else 0


#: two CTAs of the bf16 backward are resident on an SM up to d =
#: RFF_BF16_BWD_TWO_CTAS_DIM (its launch bounds: two C n-tiles) and slices of
#: RFF_BF16_BWD_TWO_CTAS_WIDTH columns (its shared memory)
RFF_BF16_BWD_TWO_CTAS_DIM, RFF_BF16_BWD_TWO_CTAS_WIDTH = 16, 72


@functools.lru_cache(maxsize=None)
def rff_bwd_plan(rows: int, cols: int, d: int, s: int, products=None,
                 precision: str = "fp32") -> RFFBwdPlan:
    """The launch plan of the RFF backward for R (rows, d), C (cols, d), P
    (rows, s), Q (cols, s), any s: a plain function of the shapes, so every
    run of a shape is cut the same way (and its fixed-order sum gives the same
    bits); memoised, since every launch asks for it. ``products`` (``"tc"``
    or ``"fma"``) overrides the plan's variant, to time both. The bf16 tiles
    run the products on the tensor cores, on slices of up to
    ``bf16_bwd_columns(d)`` columns (the reference rounds W over all s at
    once)."""
    check_precision(precision)
    if precision == "bf16":
        slice_cols = bf16_bwd_columns(d)
    else:
        slice_cols = next(w for dmax, w in RFF_BWD_SLICE_COLS.items() if d <= dmax)
    width = 8 * _cdiv(_cdiv(s, _cdiv(s, slice_cols)), 8)
    slices = _cdiv(s, width)
    if products is None:
        products = "fma" if width <= NARROW_G and precision == "fp32" else "tc"
    if products not in ("tc", "fma") or (products == "fma" and precision == "bf16"):
        raise ValueError(f"no factor-product variant {products!r} at {precision}")
    row_blocks, tiles = _cdiv(rows, TILE_ROWS), _cdiv(cols, TILE_COLS)
    if precision == "bf16":
        two = d <= RFF_BF16_BWD_TWO_CTAS_DIM and width <= RFF_BF16_BWD_TWO_CTAS_WIDTH
        resident = 2 if two else 1
    else:
        resident = 1 if products == "tc" else 2
    per = round_chunks(tiles, row_blocks * slices, resident, 1)
    return RFFBwdPlan(row_blocks=row_blocks, chunks=_cdiv(tiles, per), chunk=per * TILE_COLS,
                      slices=slices, width=width, products=products)


def _projection_grads(ctx, x, omega, p, q):
    """(dx, dω) when the cotangent of Φ̃(x) is p qᵀ, p (n, s), q = [q_sin; q_cos]
    (2m, s): dx = rff_bwd(x, ω, p, p, q_sin, q_cos) and dω = rff_bwd(ω, x,
    q_sin, q_cos, p, p), each only where autograd asks for it."""
    need_x, need_omega = ctx.needs_input_grad[:2]
    if not (need_x or need_omega):
        return None, None
    m = omega.shape[0]
    q_sin, q_cos = q[:m].contiguous(), q[m:].contiguous()
    scale = math.sqrt(1.0 / m)
    bwd = _at(ctx.ops["bwd"], ctx.precision)
    return (bwd(x, omega, p, p, q_sin, q_cos, scale=scale) if need_x else None,
            bwd(omega, x, q_sin, q_cos, p, p, scale=scale) if need_omega else None)


class _RFFMatvecFn(torch.autograd.Function):
    """Φ̃(x) @ w with the reference's fused VJP: the cotangent of Φ̃ is ḡwᵀ, so
    dx and dω are ``_projection_grads`` of (ḡ, w), and dw = Φ̃ᵀḡ. ``ops`` holds
    the implementations: the kernels' wrappers, or the plain versions, each
    run at the forward's tile ``precision``."""

    @staticmethod
    def forward(ctx, x, omega, w, ops, precision="fp32"):
        ctx.save_for_backward(x, omega, w)
        ctx.ops, ctx.precision = ops, precision
        return _at(ops["mv"], precision)(x, omega, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, omega, w = ctx.saved_tensors
        g = grad.contiguous()
        dx, domega = _projection_grads(ctx, x, omega, g, w)
        t = _at(ctx.ops["t"], ctx.precision)
        dw = t(x, omega, g, omega.shape[0]) if ctx.needs_input_grad[2] else None
        return dx, domega, dw, None, None


class _RFFTMatvecFn(torch.autograd.Function):
    """Φ̃(x)ᵀ @ u, rows of frequencies ≥ m_true zeroed, with the reference's
    fused VJP on the masked cotangent ḡ (2m, s): the cotangent of Φ̃ is uḡᵀ,
    so dx and dω are ``_projection_grads`` of (u, ḡ), and du = Φ̃ḡ."""

    @staticmethod
    def forward(ctx, x, omega, u, m_true, ops, precision="fp32"):
        ctx.save_for_backward(x, omega, u)
        ctx.m_true, ctx.ops, ctx.precision = m_true, ops, precision
        return _at(ops["t"], precision)(x, omega, u, m_true)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, omega, u = ctx.saved_tensors
        m = omega.shape[0]
        keep = (torch.arange(2 * m, device=x.device) % m < ctx.m_true)[:, None]
        g = torch.where(keep, grad, torch.zeros_like(grad)).contiguous()
        dx, domega = _projection_grads(ctx, x, omega, u, g)
        mv = _at(ctx.ops["mv"], ctx.precision)
        du = mv(x, omega, g) if ctx.needs_input_grad[2] else None
        return dx, domega, du, None, None, None


class _RFFPairFn(torch.autograd.Function):
    """Φ̃(M Φ̃ᵀu), M the m_true mask, with the reference's composed VJP:
    du is the pair itself (the operator is symmetric), and with t = MΦ̃ᵀu,
    t̃ = MΦ̃ᵀḡ the cotangent of Φ̃ is ḡtᵀ + ut̃ᵀ = [ḡ | u][t | t̃]ᵀ, whose
    rank-2s factors give dx and dω."""

    @staticmethod
    def forward(ctx, x, omega, u, m_true, ops, precision="fp32"):
        ctx.save_for_backward(x, omega, u)
        ctx.m_true, ctx.ops, ctx.precision = m_true, ops, precision
        return _at(ops["pair"], precision)(x, omega, u, m_true)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, omega, u = ctx.saved_tensors
        g, m_true = grad.contiguous(), ctx.m_true
        t_mv, pair = (_at(ctx.ops[k], ctx.precision) for k in ("t", "pair"))
        dx = domega = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            t = t_mv(x, omega, u, m_true)  # masked to m_true, like the forward's
            tt = t_mv(x, omega, g, m_true)
            dx, domega = _projection_grads(ctx, x, omega, torch.cat([g, u], dim=1).contiguous(),
                                           torch.cat([t, tt], dim=1))
        du = pair(x, omega, g, m_true) if ctx.needs_input_grad[2] else None
        return dx, domega, du, None, None, None


def _t_ref(x, omega, u, m_true, *, precision="fp32"):
    return rff_t_matvec_ref(x, omega, u, m_true=m_true, precision=precision)


def _pair_ref(x, omega, u, m_true, *, precision="fp32"):
    return rff_pair_ref(x, omega, u, m_true=m_true, precision=precision)


_PLAIN_OPS = dict(mv=rff_matvec_ref, t=_t_ref, pair=_pair_ref, bwd=rff_bwd_ref)


def plain_rff_matvec(x: torch.Tensor, omega: torch.Tensor, w: torch.Tensor, *,
                     precision: str = "fp32") -> torch.Tensor:
    """The differentiable Φ̃(x) @ w with the plain versions in place of the
    kernels, on any device and dtype: what CPU tensors take, and the yardstick
    of the kernels' gradients on the card."""
    return _RFFMatvecFn.apply(x, omega, w, _PLAIN_OPS, precision)


def plain_rff_t_matvec(x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                       m_true=None, precision: str = "fp32") -> torch.Tensor:
    """The differentiable Φ̃(x)ᵀ @ u on the plain versions (see
    :func:`plain_rff_matvec`)."""
    return _RFFTMatvecFn.apply(x, omega, u, _m_true(omega, m_true), _PLAIN_OPS, precision)


def plain_rff_pair(x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                   m_true=None, precision: str = "fp32") -> torch.Tensor:
    """The differentiable Φ̃(Φ̃ᵀu) on the plain versions (see
    :func:`plain_rff_matvec`)."""
    return _RFFPairFn.apply(x, omega, u, _m_true(omega, m_true), _PLAIN_OPS, precision)


def _check_rff(name, x, omega, u):
    (n, d), (m, dw), (nu, _) = x.shape, omega.shape, u.shape
    if dw != d or nu != n:
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, omega {tuple(omega.shape)}, "
            f"operand {tuple(u.shape)} do not chain"
        )
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
    if m == 0:
        raise ValueError(f"{name}: needs at least one frequency")


def _m_true(omega, m_true):
    m = omega.shape[0]
    m_true = m if m_true is None else int(m_true)
    if not 0 <= m_true <= m:
        raise ValueError(f"needs 0 <= m_true <= m = {m}, got {m_true}")
    return m_true


class RFFMatvec(LaunchCounts):
    """The wrapper of the fused RFF matvec kernels, fp32 and bf16. Its
    ``LaunchCounts`` count the launches it made (never the plain version's
    calls)."""

    name = "rff_matvec"

    def __call__(self, x: torch.Tensor, omega: torch.Tensor, w: torch.Tensor, *,
                 precision: str = "fp32", block=None) -> torch.Tensor:
        """x:(n,d) ω:(m,d) w:(2m,s) → (n,s); ``block`` (None: the plan's
        default) sets the Φ̃ᵀu launches of its backward."""
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (x, omega, w)):
            return plain_rff_matvec(x, omega, w, precision=precision)
        return _RFFMatvecFn.apply(x, omega, w, _kernel_ops(block), precision)

    @staticmethod
    def smem_bytes(d: int, s: int, precision: str = "fp32") -> int:
        """Dynamic shared memory per CTA of a launch at these d and s (either
        orientation)."""
        return getattr(_build.library(), f"repro_rff_matvec_smem_bytes{_SUFFIX[precision]}")(
            d, rff_plan(1, 1, d, s).width)

    def _launch(self, x, omega, w, *, precision="fp32", block=None):
        check_operands(self.name, x, omega, w)
        (n, d), (m, dw), (mw, s) = x.shape, omega.shape, w.shape
        if dw != d or mw != 2 * m:
            raise ValueError(
                f"{self.name}: shapes x {tuple(x.shape)}, omega "
                f"{tuple(omega.shape)}, w {tuple(w.shape)} do not chain "
                f"(w needs 2m rows: sin rows, then cos rows)"
            )
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"{self.name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
        if m == 0:
            raise ValueError(f"{self.name}: needs at least one frequency")
        out = torch.empty((n, s), dtype=torch.float32, device=x.device)
        if n == 0 or s == 0:
            return out
        plan = rff_plan(n, m, d, s, block)
        ws = torch.empty(plan.mv_workspace_floats(n, s), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(_build.library(), f"repro_rff_matvec_{_ENTRY[precision]}")(
                x.data_ptr(), omega.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(),
                n, m, d, s, plan.width, plan.freq_chunk, stream,
            )
        _build.check(err, self.name)
        self._count(precision)
        return out


class RFFTMatvec(LaunchCounts):
    """The wrapper of the transposed RFF kernel (``repro_rff_t_matvec_f32``:
    ``rff_plan``'s row chunks into a partial-sum workspace, then a
    fixed-order sum). ``launches`` counts the launches it made (never the
    plain version's calls)."""

    name = "rff_t_matvec"

    def __call__(self, x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                 m_true=None, precision: str = "fp32", block=None) -> torch.Tensor:
        """x:(n,d) ω:(m,d) u:(n,s) → (2m,s), sin rows then cos rows; rows of
        frequencies ≥ ``m_true`` (default m) zeroed; ``block`` (None: the
        plan's default) sets its row chunks."""
        check_precision(precision)
        m_true = _m_true(omega, m_true)
        cpu = all(t.device.type == "cpu" for t in (x, omega, u))
        ops = _PLAIN_OPS if cpu else _kernel_ops(block)
        return _RFFTMatvecFn.apply(x, omega, u, m_true, ops, precision)

    def _launch(self, x, omega, u, m_true, *, precision="fp32", block=None):
        check_operands(self.name, x, omega, u)
        _check_rff(self.name, x, omega, u)
        (n, d), m, s = x.shape, omega.shape[0], u.shape[1]
        out = torch.empty((2 * m, s), dtype=torch.float32, device=x.device)
        if s == 0:
            return out
        if n == 0:
            return out.zero_()
        plan = rff_plan(n, m, d, s, block)
        ws = torch.empty(plan.t_workspace_floats(m, s), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(_build.library(), f"repro_rff_t_matvec_{_ENTRY[precision]}")(
                x.data_ptr(), omega.data_ptr(), u.data_ptr(), ws.data_ptr(),
                out.data_ptr(), n, m, d, s, m_true, plan.width, plan.row_chunk, stream,
            )
        _build.check(err, self.name)
        self._count(precision)
        return out


class RFFPair(LaunchCounts):
    """The wrapper of the fused regulariser pair (``repro_rff_pair_f32``: the
    kernel's Φ̃ᵀu orientation and its fixed-order sum into a (2m, s) buffer,
    masked to ``m_true``, then its Φ̃W orientation on it; three or four
    launches on one stream, on ``rff_plan``'s geometry, with one allocation
    for t and the workspace). ``launches`` counts the pair launches it made
    (never the plain version's calls)."""

    name = "rff_pair"

    def __call__(self, x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                 m_true=None, precision: str = "fp32", block=None) -> torch.Tensor:
        """x:(n,d) ω:(m,d) u:(n,s) → Φ̃(Φ̃ᵀu) (n,s), Φ̃ = √(1/m)[sin | cos]."""
        check_precision(precision)
        m_true = _m_true(omega, m_true)
        cpu = all(t.device.type == "cpu" for t in (x, omega, u))
        ops = _PLAIN_OPS if cpu else _kernel_ops(block)
        return _RFFPairFn.apply(x, omega, u, m_true, ops, precision)

    def _launch(self, x, omega, u, m_true, *, precision="fp32", block=None):
        check_operands(self.name, x, omega, u)
        _check_rff(self.name, x, omega, u)
        (n, d), m, s = x.shape, omega.shape[0], u.shape[1]
        out = torch.empty((n, s), dtype=torch.float32, device=x.device)
        if n == 0 or s == 0:
            return out
        plan = rff_plan(n, m, d, s, block)
        ws_floats = max(plan.t_workspace_floats(m, s), plan.mv_workspace_floats(n, s))
        buf = torch.empty(2 * m * s + ws_floats, dtype=torch.float32, device=x.device)
        t, ws = buf[:2 * m * s], buf[2 * m * s:]  # t first: 16-byte aligned
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(_build.library(), f"repro_rff_pair_{_ENTRY[precision]}")(
                x.data_ptr(), omega.data_ptr(), u.data_ptr(), ws.data_ptr(),
                t.data_ptr(), out.data_ptr(), n, m, d, s, m_true, plan.width,
                plan.row_chunk, plan.freq_chunk, stream,
            )
        _build.check(err, self.name)
        self._count(precision)
        return out


class RFFBwd(LaunchCounts):
    """The wrapper of the RFF backward kernels (``repro_rff_bwd_f32`` or
    ``_bf16`` on ``rff_bwd_plan``'s geometry: with more than one (chunk,
    slice) part, a partial-sum workspace, then a fixed-order sum). Its
    ``LaunchCounts`` count the calls of the C entries it made, one a call at
    every s (never the plain version's calls)."""

    name = "rff_bwd"

    def __call__(self, r: torch.Tensor, c: torch.Tensor, p1: torch.Tensor,
                 p2: torch.Tensor, q1: torch.Tensor, q2: torch.Tensor, *,
                 scale: float, precision: str = "fp32") -> torch.Tensor:
        """r:(rows,d) c:(cols,d) p1,p2:(rows,s) q1,q2:(cols,s) → (rows,d) =
        scale·(cos(rcᵀ)⊙p1q1ᵀ − sin(rcᵀ)⊙p2q2ᵀ)·c."""
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (r, c, p1, p2, q1, q2)):
            return rff_bwd_ref(r, c, p1, p2, q1, q2, scale=scale, precision=precision)
        return self._launch(r, c, p1, p2, q1, q2, float(scale), precision=precision)

    @staticmethod
    def smem_bytes(d: int, s: int, products=None, precision: str = "fp32") -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        plan = rff_bwd_plan(1, 1, d, s, products, precision)
        if precision == "bf16":
            return _build.library().repro_rff_bwd_smem_bytes_bf16(d, plan.width)
        return _build.library().repro_rff_bwd_smem_bytes(d, plan.width,
                                                         int(plan.products == "tc"))

    def _launch(self, r, c, p1, p2, q1, q2, scale, products=None, precision="fp32"):
        """The launch on ``rff_bwd_plan``'s geometry at the tile precision;
        ``products`` overrides its fp32 factor-product variant (to time
        both)."""
        check_operands(self.name, r, c, p1, p2, q1, q2)
        (rows, d), (cols, dc), s = r.shape, c.shape, p1.shape[1]
        if (dc != d or tuple(p2.shape) != (rows, s)
                or tuple(p1.shape) != (rows, s) or tuple(q1.shape) != (cols, s)
                or tuple(q2.shape) != (cols, s)):
            raise ValueError(
                f"{self.name}: shapes r {tuple(r.shape)}, c {tuple(c.shape)}, p1 "
                f"{tuple(p1.shape)}, p2 {tuple(p2.shape)}, q1 {tuple(q1.shape)}, "
                f"q2 {tuple(q2.shape)} do not chain"
            )
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"{self.name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
        out = torch.empty((rows, d), dtype=torch.float32, device=r.device)
        if rows == 0:
            return out
        if cols == 0 or s == 0:
            return out.zero_()
        plan = rff_bwd_plan(rows, cols, d, s, products, precision)
        if plan.slices > GRID_Y:
            raise ValueError(f"{self.name}: {plan.slices} slices exceed grid.z's {GRID_Y}")
        ws = torch.empty(plan.workspace_floats(rows, d), dtype=torch.float32, device=r.device)
        args = (r.data_ptr(), c.data_ptr(), p1.data_ptr(), p2.data_ptr(), q1.data_ptr(),
                q2.data_ptr(), ws.data_ptr(), out.data_ptr(), rows, cols, d, s, scale,
                plan.width, plan.chunk)
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            if precision == "bf16":
                err = _build.library().repro_rff_bwd_bf16(*args, stream)
            else:
                err = _build.library().repro_rff_bwd_f32(
                    *args, int(plan.products == "tc"), stream)
        _build.check(err, self.name)
        self._count(precision)
        return out


rff_matvec = RFFMatvec()
rff_t_matvec = RFFTMatvec()
rff_pair = RFFPair()
rff_bwd = RFFBwd()
_KERNEL_OPS = dict(mv=rff_matvec._launch, t=rff_t_matvec._launch, pair=rff_pair._launch,
                   bwd=rff_bwd)


@functools.lru_cache(maxsize=None)
def _kernel_ops(block) -> dict:
    """The kernels' ops with Φ̃W, Φ̃ᵀu and the pair bound to ``block`` (the
    backward's plan takes none), built once for each block."""
    if block is None:
        return _KERNEL_OPS
    return {k: fn if k == "bwd" else functools.partial(fn, block=block)
            for k, fn in _KERNEL_OPS.items()}
