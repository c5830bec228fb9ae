"""Fused Gram matvec, its backward and the row-panel kernels — the CUDA kernels
``csrc/gram_matvec.cu``, ``csrc/gram_matvec_bwd.cu`` and
``csrc/gram_rows_pair.cu`` and their wrappers.

``gram_matvec(x, z, v, kind=...)`` computes K̃(x, z) @ v: the unit-signal,
jitter-free covariance core of already lengthscale-scaled inputs, the twin of
``repro.kernels.gram_matvec.gram_matvec_fused``, differentiable in x, z and v.
σ_f², 1/ℓ and the jitter are applied by the caller (``kernels/ops.py``),
outside the core, as in the reference. Its backward is the reference's fused
VJP: dv = K̃(z, x) @ ḡ by the forward kernel with swapped operands, and dx and
dz by ``gram_matvec_bwd`` (the twin of ``gram_matvec_bwd_pallas``, on
``gram_bwd_plan``'s launch), each only where autograd asks for it.

``gram_rows_matvec(xi, x, u)`` is the row panel K̃(xi, x) @ u of a few hundred
gathered rows (SDD's ``rows_mv``), and ``gram_rows_pair(xi, x, look, b)`` the
SGD pair err = K̃(xi, x) @ look − b, g = K̃(xi, x)ᵀ @ err, twin of
``gram_rows_pair_fused`` with its composed VJP.

A CUDA tensor launches the kernels or raises. CPU tensors go through the same
autograd Function with the plain versions (``ref.gram_matvec_ref``,
``ref.gram_matvec_bwd_ref``) in place of the launches, so the gradients keep
the reference's conventions on both devices (Matérn-1/2's zero-distance mask
among them).

Every forward takes the reference's tile ``precision``: ``"fp32"``, or
``"bf16"``, bfloat16 contraction operands with fp32 accumulation
(``csrc/gram_matvec_bf16.cu``, the Gram kernel's own casts, which the row
panel and the pair run too). A bf16 forward's backward runs at the same
precision, as the reference's VJPs do: its matvecs on the bf16 tiles and dx,
dz on the backward kernel's (``csrc/gram_matvec_bwd_bf16.cu``).
"""
from __future__ import annotations

import dataclasses
import functools
import numbers

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .ref import (
    check_precision, gram_matvec_bwd_ref, gram_matvec_ref, gram_rows_matvec_ref,
    gram_rows_pair_ref,
)

#: kernel kinds the CUDA kernel implements (tanimoto has no distance form)
CUDA_KINDS = ("se", "matern12", "matern32", "matern52")
#: largest feature dimension the kernels take
MAX_DIM = 128
#: widest rowv/colv one backward launch takes (``kMaxS``); wider ones are sliced
MAX_BWD_COLUMNS = 128

#: The forward kernel's tile (``csrc/gram_matvec.cu``), whose geometry this
#: module alone sets: 64 rows by 64 columns, v sliced at SLICE_COLS columns
#: (16 n-tiles of 8), at half that where d > WIDE_DIM, each slice's width a
#: multiple of 8. Its launch plan fills the card: with fewer than FILL_CTAS
#: (two waves of 132 SMs) row blocks × slices, the column loop is cut into
#: chunks of at least ``block`` columns along grid.y (MIN_CHUNK_TILES tiles
#: unless a block is given: ``kernels/autotune.py``; at most GRID_Y chunks);
#: with one chunk of fewer than LOOP_TILES tiles, each CTA runs several row
#: blocks, as long as FILL_CTAS remain and the second x buffer fits
#: (d ≤ MAX_LOOP_DIM).
TILE_ROWS = TILE_COLS = 64
SLICE_COLS = 128
WIDE_DIM = 64
FILL_CTAS = 264
MIN_CHUNK_TILES = 4
LOOP_TILES = 16
GRID_Y = 65535
MAX_LOOP_DIM = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_block(block) -> int:
    """``block`` as the plans take it, the fewest K-loop columns one chunk of
    a launch holds: a positive multiple of 64 (one tile), else
    ``ValueError``."""
    if (isinstance(block, bool) or not isinstance(block, numbers.Integral)
            or block <= 0 or block % TILE_COLS):
        raise ValueError(f"block must be a positive multiple of {TILE_COLS}, got {block!r}")
    return int(block)


def min_tiles(block, default: int) -> int:
    """Tiles a chunk holds at least: ``default`` for no block, else block / 64."""
    return default if block is None else check_block(block) // TILE_COLS


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """The forward kernel's launch at (n, m, d, s): ``row_blocks`` of 64 rows,
    ``rows_per_cta`` of them in each CTA, ``chunks`` column chunks of
    ``chunk`` columns (a multiple of 64; one chunk when ``chunks == 1``), and
    ``slices`` column slices of v, each ``width`` columns (a multiple of 8)."""

    row_blocks: int
    rows_per_cta: int
    chunks: int
    chunk: int
    slices: int
    width: int

    @property
    def ctas(self) -> int:
        return _cdiv(self.row_blocks, self.rows_per_cta) * self.chunks * self.slices

    def workspace_floats(self, n: int, s: int) -> int:
        """Floats of the (chunks, n, s) partial sums; 0 for one chunk."""
        return self.chunks * n * s if self.chunks > 1 else 0


@functools.lru_cache(maxsize=None)
def gram_plan(n: int, m: int, d: int, s: int, block=None) -> GramPlan:
    """The launch plan of K̃(x, z) @ v for x (n, d), z (m, d), v (m, s): a plain
    function of the shapes and ``block`` (chunks of at least that many
    columns; None: MIN_CHUNK_TILES tiles), so every run of a shape is cut the
    same way (and its fixed-order chunk sum gives the same bits); memoised,
    since every launch asks for it. The block never changes how v is
    sliced."""
    min_per = min_tiles(block, MIN_CHUNK_TILES)
    slice_cols = SLICE_COLS if d <= WIDE_DIM else SLICE_COLS // 2
    row_blocks, tiles = _cdiv(n, TILE_ROWS), _cdiv(m, TILE_COLS)
    width = 8 * _cdiv(_cdiv(s, _cdiv(s, slice_cols)), 8)  # even slices, 8-aligned
    slices = _cdiv(s, width)
    base = row_blocks * slices
    chunks, per = 1, tiles
    if base < FILL_CTAS and tiles > min_per:
        per = max(min_per, tiles // _cdiv(FILL_CTAS, base), _cdiv(tiles, GRID_Y))
        chunks = _cdiv(tiles, per)
    rows_per_cta = 1
    if chunks == 1 and tiles < LOOP_TILES and d <= MAX_LOOP_DIM:
        rows_per_cta = max(1, min(_cdiv(LOOP_TILES, tiles), base // FILL_CTAS))
    return GramPlan(row_blocks=row_blocks, rows_per_cta=rows_per_cta, chunks=chunks,
                    chunk=per * TILE_COLS, slices=slices, width=width)


#: The backward kernel's tile (``csrc/gram_matvec_bwd.cu``): 64 rows by 64
#: columns, rowv/colv sliced at BWD_SLICE_COLS columns (half that past d = 32,
#: a quarter past d = 64: the x and z tiles and [z | 1] take the shared
#: memory), G = rowv·colvᵀ on the FMA pipe for slices of at most NARROW_G
#: columns (two CTAs resident on an SM) and on the tensor cores above (one).
#: Its stage 2, [Σⱼ W | W z], runs on the FMA pipe for d ≤ FMA_STAGE2_DIM
#: (faster than the tensor-core variant at both path shapes on the H100,
#: PERF.md §6) and on the tensor cores above, or where ``stage2="tc"`` is
#: asked. Few rows are cut into column chunks by ``round_chunks``.
BWD_SLICE_COLS = MAX_BWD_COLUMNS
NARROW_G = 16
FMA_STAGE2_DIM = 16
BWD_STAGE2 = ("tc", "fma")
#: SMs of the card, and the chunk counts ``round_chunks`` weighs, up to
#: CHUNK_ROUNDS rounds of resident CTAs
SMS = 132
CHUNK_ROUNDS = 4


@functools.lru_cache(maxsize=None)
def round_chunks(tiles: int, base: int, resident: int, min_per: int) -> int:
    """Tiles per chunk when a K loop of ``tiles`` tiles is cut into chunks
    along grid.y under ``base`` CTAs each (rows × slices), with ``resident``
    CTAs on an SM: the cut whose CTAs finish first, counted as rounds of
    resident CTAs × tiles per CTA (the card runs ⌈CTAs / (SMS · resident)⌉
    rounds, so 280 CTAs take three rounds of 132 where 264 take two). Ties
    take fewer chunks; chunks hold at least ``min_per`` tiles (or all), at
    most GRID_Y chunks. A plain function, so every run of a shape is cut the
    same way; memoised, since every launch asks for its plan."""
    slots = SMS * resident
    if base >= slots or tiles <= min_per:
        return max(tiles, 1)
    best_per, best = tiles, _cdiv(base, slots) * tiles
    for chunks in range(2, min(tiles, _cdiv(CHUNK_ROUNDS * slots, base)) + 1):
        per = max(min_per, _cdiv(tiles, chunks), _cdiv(tiles, GRID_Y))
        steps = _cdiv(base * _cdiv(tiles, per), slots) * per
        if steps < best:
            best_per, best = per, steps
    return best_per


@dataclasses.dataclass(frozen=True)
class GramBwdPlan:
    """The backward kernel's launch at (n, m, d, s): ``row_blocks`` of 64 rows,
    ``chunks`` column chunks of ``chunk`` columns (a multiple of 64),
    ``slices`` slices of rowv/colv, each ``width`` columns (a multiple of 8),
    and stage 2 on the tensor cores (``"tc"``) or the FMA pipe (``"fma"``).
    Each (chunk, slice) is a part; more than one part writes (parts, n, d + 1)
    partial sums that a second launch adds in a fixed order."""

    row_blocks: int
    chunks: int
    chunk: int
    slices: int
    width: int
    stage2: str

    @property
    def ctas(self) -> int:
        return self.row_blocks * self.chunks * self.slices

    @property
    def parts(self) -> int:
        return self.chunks * self.slices

    def workspace_floats(self, n: int, d: int) -> int:
        """Floats of the (parts, n, d + 1) partial sums; 0 for one part."""
        return self.parts * n * (d + 1) if self.parts > 1 else 0


#: the widest d at which two CTAs of the bf16 backward are resident on an SM
#: (its launch bounds: four z n-tiles)
BF16_BWD_TWO_CTAS_DIM = 32
#: The widest slice of rowv/colv (or P and Q) a bf16 backward launch takes,
#: by the largest d it takes (the shared memory of its bf16 and staging
#: tiles). The reference rounds the weights W over all s columns at once, so
#: a bf16 launch runs every column up to this width in one slice (the SGD
#: pair's 2s = 130, the Thompson ascent's s = 100); wider factors are cut
#: into slices, each of whose weights is rounded apart.
BF16_BWD_SLICE_COLS = {64: 136, MAX_DIM: 64}


def bf16_bwd_columns(d: int) -> int:
    """The widest one-slice bf16 backward launch at feature dimension d."""
    return next(w for dmax, w in BF16_BWD_SLICE_COLS.items() if d <= dmax)


@functools.lru_cache(maxsize=None)
def gram_bwd_plan(n: int, m: int, d: int, s: int, stage2=None,
                  precision: str = "fp32", block=None) -> GramBwdPlan:
    """The launch plan of the Gram backward for x (n, d), z (m, d), rowv (n, s),
    colv (m, s), s ≤ MAX_BWD_COLUMNS (bf16: ``bf16_bwd_columns(d)``; the
    wrapper slices wider ones): a plain function of the shapes and
    ``block``, memoised, so every run of a shape is cut the same way. Few
    row blocks × slices cut the column loop into ``round_chunks``' chunks (at
    least ``block`` columns each; None: MIN_CHUNK_TILES tiles). ``stage2``
    (``"tc"`` or ``"fma"``)
    overrides the variant, to time both. The bf16 tiles run both products on
    the tensor cores (stage 2 ``"tc"``), two CTAs to an SM up to
    BF16_BWD_TWO_CTAS_DIM."""
    check_precision(precision)
    if stage2 is None:
        stage2 = "fma" if d <= FMA_STAGE2_DIM and precision == "fp32" else "tc"
    if (stage2 not in BWD_STAGE2 or (stage2 == "fma" and d > FMA_STAGE2_DIM)
            or (stage2 == "fma" and precision == "bf16")):
        raise ValueError(f"stage 2 {stage2!r} does not take d = {d} at {precision}")
    if precision == "bf16":
        slice_cols = bf16_bwd_columns(d)
    else:
        slice_cols = BWD_SLICE_COLS >> (0 if d <= 32 else 1 if d <= 64 else 2)
    row_blocks, tiles = _cdiv(n, TILE_ROWS), _cdiv(m, TILE_COLS)
    width = 8 * _cdiv(_cdiv(s, _cdiv(s, slice_cols)), 8)
    slices = _cdiv(s, width)
    if precision == "bf16":
        resident = 2 if d <= BF16_BWD_TWO_CTAS_DIM else 1
    else:
        resident = 1 if width > NARROW_G else 2
    per = round_chunks(tiles, row_blocks * slices, resident,
                       min_tiles(block, MIN_CHUNK_TILES))
    return GramBwdPlan(row_blocks=row_blocks, chunks=_cdiv(tiles, per), chunk=per * TILE_COLS,
                       slices=slices, width=width, stage2=stage2)


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype, rank and contiguity checks shared by the kernel wrappers
    (the bf16 tiles' operands are float32 too: the kernels round them)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operands must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: operands must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_chain(name, x, z, v):
    (n, d), (m, dz), (mv, _) = x.shape, z.shape, v.shape
    if dz != d or mv != m:
        raise ValueError(
            f"{name}: shapes {tuple(x.shape)}, {tuple(z.shape)} and "
            f"{tuple(v.shape)} do not chain"
        )
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: needs 1 <= d <= {MAX_DIM}, got d={d}")


def check_kind(kind: str) -> None:
    if kind not in CUDA_KINDS:
        raise ValueError(
            f"kernel kind {kind!r} has no fused covariance map; supported "
            f"kinds: {CUDA_KINDS} — use the chunked backend instead"
        )


class LaunchCounts:
    """A kernel wrapper's launch counts: ``launches`` of its fp32 kernel and
    ``bf16_launches`` of its bf16 kernel, one a call of its C entry (never
    the plain version's calls)."""

    def __init__(self) -> None:
        self.launches = 0
        self.bf16_launches = 0

    def _count(self, precision: str) -> None:
        if precision == "bf16":
            self.bf16_launches += 1
        else:
            self.launches += 1


class _GramMatvecFn(torch.autograd.Function):
    """K̃(x, z) @ v with the reference's fused VJP (``gram_matvec.py:317-327``
    there). ``fwd`` and ``bwd`` are the forward and backward implementations:
    the kernels' wrappers, or the plain versions, ``fwd`` bound to the
    forward's tile ``precision``, at which ``bwd`` runs too."""

    @staticmethod
    def forward(ctx, x, z, v, kind, fwd, bwd, precision="fp32"):
        ctx.save_for_backward(x, z, v)
        ctx.kind, ctx.fwd, ctx.bwd, ctx.precision = kind, fwd, bwd, precision
        return fwd(x, z, v, kind=kind)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, z, v = ctx.saved_tensors
        g = grad.contiguous()
        need_x, need_z, need_v = ctx.needs_input_grad[:3]
        bwd = _at(ctx.bwd, ctx.precision)
        dx = bwd(x, z, g, v, kind=ctx.kind) if need_x else None
        dz = bwd(z, x, v, g, kind=ctx.kind) if need_z else None
        dv = ctx.fwd(z, x, g, kind=ctx.kind) if need_v else None
        return dx, dz, dv, None, None, None, None


def plain_gram_matvec(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                      kind: str = "se", precision: str = "fp32") -> torch.Tensor:
    """The differentiable K̃(x, z) @ v with the plain versions in place of both
    kernels, on any device and dtype: what CPU tensors take, and the yardstick
    of the kernels' gradients on the card."""
    return _GramMatvecFn.apply(x, z, v, kind, _at(gram_matvec_ref, precision),
                               gram_matvec_bwd_ref, precision)


#: the C entries by tile precision: a launch ``repro_<kernel>_f32`` or
#: ``_bf16`` (``csrc/gram_matvec_bf16.cu``, ``csrc/rff_matvec_bf16.cu``), a
#: shared-memory query ``repro_<kernel>_smem_bytes`` or ``_bf16``
_ENTRY = {"fp32": "f32", "bf16": "bf16"}
_SUFFIX = {"fp32": "", "bf16": "_bf16"}


@functools.lru_cache(maxsize=256)
def _at(fn, precision: str, block=None):
    """``fn`` (a forward or a backward) bound to the tile precision and, for
    a launch given one, the plans' ``block``; memoised, since every call
    binds its launches."""
    kw = {} if precision == "fp32" else {"precision": precision}
    if block is not None:
        kw["block"] = block
    return functools.partial(fn, **kw) if kw else fn


class GramMatvec(LaunchCounts):
    """The wrapper of the fused Gram matvec kernels, fp32 and bf16. Its
    ``LaunchCounts`` count the launches it made (never the plain version's
    calls), the backward's dv among them."""

    name = "gram_matvec"

    def __call__(self, x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                 kind: str = "se", precision: str = "fp32", block=None) -> torch.Tensor:
        """x:(n,d) z:(m,d) v:(m,s) → (n,s), inputs pre-scaled by 1/ℓ; ``block``
        (None: the plans' default) sets the launches' chunks, the backward's
        too."""
        check_kind(kind)
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (x, z, v)):
            return plain_gram_matvec(x, z, v, kind=kind, precision=precision)
        return _GramMatvecFn.apply(x, z, v, kind, _at(self._launch, precision, block),
                                   _at(gram_matvec_bwd, "fp32", block), precision)

    @staticmethod
    def smem_bytes(d: int, s: int, rows_per_cta: int = 1, precision: str = "fp32") -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        return getattr(_build.library(), f"repro_gram_matvec_smem_bytes{_SUFFIX[precision]}")(
            d, gram_plan(1, 1, d, s).width, rows_per_cta)

    def _launch(self, x, z, v, *, kind, precision="fp32", block=None):
        out = _launch_matvec(self.name, x, z, v, kind, precision, block)
        self._count(precision)  # one call, one or two launches
        return out


def _launch_matvec(name, x, z, v, kind, precision="fp32", block=None, signal=None,
                   jitter=0.0):
    """K̃(x, z) @ v by the Gram kernel of the tile precision on ``gram_plan``'s
    launch (its column chunks summed in a fixed order inside the C entry);
    with a ``signal``, (signal·K̃ + jitter·I) @ v by the scaled entry."""
    check_operands(name, x, z, v)
    _check_chain(name, x, z, v)
    (n, d), m, s = x.shape, z.shape[0], v.shape[1]
    out = torch.empty((n, s), dtype=torch.float32, device=x.device)
    if n == 0 or s == 0:
        return out
    if m == 0:
        return out.zero_()
    plan = gram_plan(n, m, d, s, block)
    ws = torch.empty(plan.workspace_floats(n, s), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if signal is None:
            err = getattr(lib, f"repro_gram_matvec_{_ENTRY[precision]}")(
                x.data_ptr(), z.data_ptr(), v.data_ptr(), None, ws.data_ptr(), out.data_ptr(),
                n, m, d, s, CUDA_KINDS.index(kind), n, plan.width, plan.chunk,
                plan.rows_per_cta, stream,
            )
        else:
            err = getattr(lib, f"repro_gram_matvec_scaled_{_ENTRY[precision]}")(
                x.data_ptr(), z.data_ptr(), v.data_ptr(), ws.data_ptr(), out.data_ptr(),
                n, m, d, s, CUDA_KINDS.index(kind), float(signal), float(jitter),
                plan.width, plan.chunk, plan.rows_per_cta, stream,
            )
    _build.check(err, name)
    return out


class GramMatvecBwd(LaunchCounts):
    """The wrapper of the Gram matvec's backward kernels, fp32 and bf16. Its
    ``LaunchCounts`` count the calls of the C entries it made, one a call of
    at most MAX_BWD_COLUMNS columns (bf16: ``bf16_bwd_columns(d)``; never
    the plain version's calls)."""

    name = "gram_matvec_bwd"

    def __call__(self, x: torch.Tensor, z: torch.Tensor, rowv: torch.Tensor,
                 colv: torch.Tensor, *, kind: str = "se",
                 precision: str = "fp32", block=None) -> torch.Tensor:
        """dx (n,d) of v ↦ K̃(x, z) @ v at ḡ = rowv (n,s), v = colv (m,s),
        inputs pre-scaled by 1/ℓ; with (z, x, colv, rowv) it gives dz."""
        check_kind(kind)
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (x, z, rowv, colv)):
            return gram_matvec_bwd_ref(x, z, rowv, colv, kind=kind, precision=precision)
        return self._launch(x, z, rowv, colv, kind, precision=precision, block=block)

    @staticmethod
    def smem_bytes(d: int, s: int, stage2=None, precision: str = "fp32") -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        plan = gram_bwd_plan(1, 1, d, s, stage2, precision)
        if precision == "bf16":
            return _build.library().repro_gram_matvec_bwd_smem_bytes_bf16(d, plan.width)
        return _build.library().repro_gram_matvec_bwd_smem_bytes(
            d, plan.width, int(plan.stage2 == "tc"))

    def _launch(self, x, z, rowv, colv, kind, stage2=None, precision="fp32", block=None):
        """The launch on ``gram_bwd_plan``'s geometry at the tile precision and
        block; ``stage2`` overrides its fp32 stage-2 variant (to time both)."""
        check_operands(self.name, x, z, rowv, colv)
        (n, d), (m, dz), (nr, s), (mc, sc) = x.shape, z.shape, rowv.shape, colv.shape
        if dz != d or nr != n or mc != m or sc != s:
            raise ValueError(
                f"{self.name}: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
                f"rowv {tuple(rowv.shape)}, colv {tuple(colv.shape)} do not chain"
            )
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"{self.name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
        cols = MAX_BWD_COLUMNS if precision == "fp32" else bf16_bwd_columns(d)
        if s > cols:  # dx is linear in the rank-s product rowv colvᵀ
            return sum(
                self._launch(x, z, rowv[:, c:c + cols].contiguous(),
                             colv[:, c:c + cols].contiguous(), kind, stage2, precision, block)
                for c in range(0, s, cols)
            )
        out = torch.empty((n, d), dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        if m == 0 or s == 0:
            return out.zero_()
        plan = gram_bwd_plan(n, m, d, s, stage2, precision, block)
        ws = torch.empty(plan.workspace_floats(n, d), dtype=torch.float32, device=x.device)
        args = (x.data_ptr(), z.data_ptr(), rowv.data_ptr(), colv.data_ptr(), ws.data_ptr(),
                out.data_ptr(), n, m, d, s, CUDA_KINDS.index(kind), plan.width, plan.chunk)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if precision == "bf16":
                err = _build.library().repro_gram_matvec_bwd_bf16(*args, stream)
            else:
                err = _build.library().repro_gram_matvec_bwd_f32(
                    *args, int(plan.stage2 == "tc"), stream)
        _build.check(err, self.name)
        self._count(precision)
        return out


class GramRowsMatvec(LaunchCounts):
    """The row-panel matvec K̃(xi, x) @ u of SDD's ``rows_mv``: the Gram
    kernel on ``gram_plan(p, n, d, s)``, as ``gram_matvec`` runs it, counted
    apart (``launches``, never the plain version's calls). Differentiable in
    xi, x and u through ``_GramMatvecFn``."""

    name = "gram_rows_matvec"

    def __call__(self, xi: torch.Tensor, x: torch.Tensor, u: torch.Tensor, *,
                 kind: str = "se", precision: str = "fp32", block=None) -> torch.Tensor:
        """xi:(p,d) x:(n,d) u:(n,s) → (p,s), inputs pre-scaled by 1/ℓ."""
        check_kind(kind)
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (xi, x, u)):
            return _GramMatvecFn.apply(xi, x, u, kind, _at(gram_rows_matvec_ref, precision),
                                       gram_matvec_bwd_ref, precision)
        return _GramMatvecFn.apply(xi, x, u, kind, _at(self._launch, precision, block),
                                   _at(gram_matvec_bwd, "fp32", block), precision)

    def _launch(self, xi, x, u, *, kind, precision="fp32", block=None):
        out = _launch_matvec(self.name, xi, x, u, kind, precision, block)
        self._count(precision)
        return out


class _GramRowsPairFn(torch.autograd.Function):
    """(err, g) = (A @ look − b masked to p_true rows, Aᵀ @ err), A = K̃(xi, x),
    with the reference's composed VJP (``gram_matvec.py:464-489`` there): with
    ê = ē + A ḡ masked like err, dlook = Aᵀ ê, db = −ê, and dA = ê lookᵀ + err ḡᵀ,
    a rank-2s product the Gram backward takes on the concatenated factors.
    ``ops`` holds the implementations: the kernels' wrappers, or the plain
    versions, each bound to the forward's tile ``precision``."""

    @staticmethod
    def forward(ctx, xi, x, look, b, kind, p_true, ops, precision="fp32"):
        err, g = ops["pair"](xi, x, look, b, kind=kind, p_true=p_true)
        ctx.save_for_backward(xi, x, look, err)
        ctx.kind, ctx.p_true, ctx.ops, ctx.precision = kind, p_true, ops, precision
        return err, g

    @staticmethod
    @once_differentiable
    def backward(ctx, e_bar, g_bar):
        xi, x, look, err = ctx.saved_tensors
        ops, kind = ctx.ops, ctx.kind
        e_bar = torch.zeros_like(err) if e_bar is None else e_bar.contiguous()
        g_bar = torch.zeros_like(look) if g_bar is None else g_bar.contiguous()
        keep = (torch.arange(xi.shape[0], device=xi.device) < ctx.p_true)[:, None]
        ehat = torch.where(keep, e_bar + ops["rows"](xi, x, g_bar, kind=kind),
                           torch.zeros_like(err))
        need_xi, need_x, need_look, need_b = ctx.needs_input_grad[:4]
        dlook = ops["mv"](x, xi, ehat, kind=kind) if need_look else None
        db = -ehat if need_b else None
        dxi = dx = None
        if need_xi or need_x:
            rowv = torch.cat([ehat, err], dim=1).contiguous()  # (p, 2s)
            colv = torch.cat([look, g_bar], dim=1).contiguous()  # (n, 2s)
            dxi = ops["bwd"](xi, x, rowv, colv, kind=kind) if need_xi else None
            dx = ops["bwd"](x, xi, colv, rowv, kind=kind) if need_x else None
        return dxi, dx, dlook, db, None, None, None, None


_PLAIN_PAIR_OPS = dict(pair=gram_rows_pair_ref, rows=gram_rows_matvec_ref,
                       mv=gram_matvec_ref, bwd=gram_matvec_bwd_ref)


def plain_gram_rows_pair(xi: torch.Tensor, x: torch.Tensor, look: torch.Tensor,
                         b: torch.Tensor, *, kind: str = "se", p_true=None,
                         precision: str = "fp32") -> tuple:
    """The differentiable pair with the plain versions in place of the
    kernels, on any device and dtype: what CPU tensors take, and the
    yardstick of the kernels' gradients on the card."""
    p_true = xi.shape[0] if p_true is None else int(p_true)
    ops = {name: _at(fn, precision) for name, fn in _PLAIN_PAIR_OPS.items()}
    return _GramRowsPairFn.apply(xi, x, look, b, kind, p_true, ops, precision)


class GramRowsPair(LaunchCounts):
    """The wrapper of the fused pair step (``repro_gram_rows_pair_f32``, or
    ``_bf16``: the row panel's matvec, the chunk sum minus b, then the Gram
    kernel on (x, xi, err), all at the tile precision; three or four launches
    on one stream). ``launches`` counts the pair launches it made (never the
    plain version's calls, nor its backward's)."""

    name = "gram_rows_pair"

    def __call__(self, xi: torch.Tensor, x: torch.Tensor, look: torch.Tensor,
                 b: torch.Tensor, *, kind: str = "se", p_true=None,
                 precision: str = "fp32", block=None) -> tuple:
        """xi:(p,d) x:(n,d) look:(n,s) b:(p,s) → (err (p,s), g (n,s)), inputs
        pre-scaled by 1/ℓ; err rows ≥ ``p_true`` (default p) are zeroed."""
        check_kind(kind)
        check_precision(precision)
        if all(t.device.type == "cpu" for t in (xi, x, look, b)):
            return plain_gram_rows_pair(xi, x, look, b, kind=kind, p_true=p_true,
                                        precision=precision)
        p_true = xi.shape[0] if p_true is None else int(p_true)
        return _GramRowsPairFn.apply(xi, x, look, b, kind, p_true,
                                     _pair_ops(precision, block), precision)

    def _launch(self, xi, x, look, b, *, kind, p_true, precision="fp32", block=None):
        check_operands(self.name, xi, x, look, b)
        _check_chain(self.name, xi, x, look)
        (p, d), n, s = xi.shape, x.shape[0], look.shape[1]
        if tuple(b.shape) != (p, s):
            raise ValueError(f"{self.name}: b has shape {tuple(b.shape)}, needs {(p, s)}")
        if not 0 <= p_true <= p:
            raise ValueError(f"{self.name}: needs 0 <= p_true <= p = {p}, got {p_true}")
        err = torch.empty((p, s), dtype=torch.float32, device=x.device)
        g = torch.empty((n, s), dtype=torch.float32, device=x.device)
        if p == 0 or n == 0 or s == 0:
            keep = (torch.arange(p, device=x.device) < p_true)[:, None]
            err = torch.where(keep, -b, torch.zeros_like(b))
            return err, g.zero_()
        panel, back = gram_plan(p, n, d, s, block), gram_plan(n, p, d, s, block)
        ws = torch.empty(max(panel.workspace_floats(p, s), back.workspace_floats(n, s)),
                         dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = getattr(_build.library(), f"repro_gram_rows_pair_{_ENTRY[precision]}")(
                xi.data_ptr(), x.data_ptr(), look.data_ptr(), b.data_ptr(),
                ws.data_ptr(), err.data_ptr(), g.data_ptr(), p, n, d, s,
                CUDA_KINDS.index(kind), p_true, panel.width, panel.chunk,
                panel.rows_per_cta, back.chunk, back.rows_per_cta, stream,
            )
        _build.check(code, self.name)
        self._count(precision)
        return err, g


gram_matvec = GramMatvec()
gram_matvec_bwd = GramMatvecBwd()
gram_rows_matvec = GramRowsMatvec()
gram_rows_pair = GramRowsPair()


@functools.lru_cache(maxsize=None)
def _pair_ops(precision: str, block) -> dict:
    """The pair's launches (the fused pair, and the rows matvec, the
    forward and the backward its VJP runs) bound to the tile precision and
    ``block``, once for each."""
    ops = dict(pair=gram_rows_pair._launch, rows=gram_rows_matvec._launch,
               mv=gram_matvec._launch, bwd=gram_matvec_bwd)
    return {name: _at(fn, precision, block) for name, fn in ops.items()}


def gram_matvec_scaled(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                       kind: str = "se", signal: float = 1.0, jitter: float = 0.0,
                       precision: str = "fp32", block=None) -> torch.Tensor:
    """(signal·K̃(x, z) + jitter·I) @ v with both inside the kernel: the twin of
    ``gram_matvec_pallas(x, z, v, kind=, signal=, jitter=, precision=)``, its
    signal scaling the k tile before the tile's cast and product and its
    jitter·v[r] added to row r (``repro_gram_matvec_scaled_f32`` or
    ``_bf16``). ``jitter`` needs z = x (m = n) and raises otherwise, as the
    reference asserts. Not differentiable, as that kernel is not (the
    differentiable core is :data:`gram_matvec`, whose callers apply σ_f² and
    the jitter outside it). CPU tensors take the plain version; a launch
    counts under ``gram_matvec``'s ``LaunchCounts``."""
    check_kind(kind)
    check_precision(precision)
    if jitter and x.shape[0] != z.shape[0]:
        raise ValueError(
            f"jitter adds jitter·v[r] to row r, which needs z = x (m = n); got n = "
            f"{x.shape[0]}, m = {z.shape[0]}"
        )
    if all(t.device.type == "cpu" for t in (x, z, v)):
        return gram_matvec_ref(x, z, v, kind=kind, precision=precision, signal=signal,
                               jitter=jitter)
    out = _launch_matvec("gram_matvec_scaled", x, z, v, kind, precision, block,
                         signal=signal, jitter=jitter)
    gram_matvec._count(precision)
    return out
