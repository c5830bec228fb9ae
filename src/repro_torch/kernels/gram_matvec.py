"""Fused Gram matvec and its backward — the CUDA kernels ``csrc/gram_matvec.cu``
and ``csrc/gram_matvec_bwd.cu`` and their wrappers.

``gram_matvec(x, z, v, kind=...)`` computes K̃(x, z) @ v: the unit-signal,
jitter-free covariance core of already lengthscale-scaled inputs, the twin of
``repro.kernels.gram_matvec.gram_matvec_fused``, differentiable in x, z and v.
σ_f², 1/ℓ and the jitter are applied by the caller (``kernels/ops.py``),
outside the core, as in the reference. Its backward is the reference's fused
VJP: dv = K̃(z, x) @ ḡ by the forward kernel with swapped operands, and dx and
dz by ``gram_matvec_bwd`` (the twin of ``gram_matvec_bwd_pallas``), each only
where autograd asks for it.

A CUDA tensor launches the kernels or raises. CPU tensors go through the same
autograd Function with the plain versions (``ref.gram_matvec_ref``,
``ref.gram_matvec_bwd_ref``) in place of the launches, so the gradients keep
the reference's conventions on both devices (Matérn-1/2's zero-distance mask
among them).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .ref import gram_matvec_bwd_ref, gram_matvec_ref

#: kernel kinds the CUDA kernel implements (tanimoto has no distance form)
CUDA_KINDS = ("se", "matern12", "matern32", "matern52")
#: largest feature dimension the kernels take
MAX_DIM = 128
#: widest rowv/colv one backward launch takes (``kMaxS``); wider ones are sliced
MAX_BWD_COLUMNS = 128


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype, rank and contiguity checks shared by the kernel wrappers."""
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


def check_kind(kind: str) -> None:
    if kind not in CUDA_KINDS:
        raise ValueError(
            f"kernel kind {kind!r} has no fused covariance map; supported "
            f"kinds: {CUDA_KINDS} — use the chunked backend instead"
        )


class _GramMatvecFn(torch.autograd.Function):
    """K̃(x, z) @ v with the reference's fused VJP (``gram_matvec.py:317-327``
    there). ``fwd`` and ``bwd`` are the forward and backward implementations:
    the kernels' wrappers, or the plain versions."""

    @staticmethod
    def forward(ctx, x, z, v, kind, fwd, bwd):
        ctx.save_for_backward(x, z, v)
        ctx.kind, ctx.fwd, ctx.bwd = kind, fwd, bwd
        return fwd(x, z, v, kind=kind)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, z, v = ctx.saved_tensors
        g = grad.contiguous()
        need_x, need_z, need_v = ctx.needs_input_grad[:3]
        dx = ctx.bwd(x, z, g, v, kind=ctx.kind) if need_x else None
        dz = ctx.bwd(z, x, v, g, kind=ctx.kind) if need_z else None
        dv = ctx.fwd(z, x, g, kind=ctx.kind) if need_v else None
        return dx, dz, dv, None, None, None


def plain_gram_matvec(x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                      kind: str = "se") -> torch.Tensor:
    """The differentiable K̃(x, z) @ v with the plain versions in place of both
    kernels, on any device and dtype: what CPU tensors take, and the yardstick
    of the kernels' gradients on the card."""
    return _GramMatvecFn.apply(x, z, v, kind, gram_matvec_ref, gram_matvec_bwd_ref)


class GramMatvec:
    """The wrapper of the fused Gram matvec kernel. ``launches`` counts the
    kernel launches it made (never the plain version's calls), the backward's
    dv among them."""

    name = "gram_matvec"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                 kind: str = "se") -> torch.Tensor:
        """x:(n,d) z:(m,d) v:(m,s) → (n,s), inputs pre-scaled by 1/ℓ."""
        check_kind(kind)
        if all(t.device.type == "cpu" for t in (x, z, v)):
            return plain_gram_matvec(x, z, v, kind=kind)
        return _GramMatvecFn.apply(x, z, v, kind, self._launch, gram_matvec_bwd)

    @staticmethod
    def smem_bytes(d: int, s: int) -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        return _build.library().repro_gram_matvec_smem_bytes(d, s)

    def _launch(self, x, z, v, *, kind):
        check_operands(self.name, x, z, v)
        (n, d), (m, dz), (mv, s) = x.shape, z.shape, v.shape
        if dz != d or mv != m:
            raise ValueError(
                f"{self.name}: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
                f"v {tuple(v.shape)} do not chain"
            )
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"{self.name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
        out = torch.empty((n, s), dtype=torch.float32, device=x.device)
        if n == 0 or s == 0:
            return out
        if m == 0:
            return out.zero_()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().repro_gram_matvec_f32(
                x.data_ptr(), z.data_ptr(), v.data_ptr(), out.data_ptr(),
                n, m, d, s, CUDA_KINDS.index(kind), stream,
            )
        _build.check(err, self.name)
        self.launches += 1
        return out


class GramMatvecBwd:
    """The wrapper of the Gram matvec's backward kernel. ``launches`` counts the
    kernel launches it made (never the plain version's calls)."""

    name = "gram_matvec_bwd"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, z: torch.Tensor, rowv: torch.Tensor,
                 colv: torch.Tensor, *, kind: str = "se") -> torch.Tensor:
        """dx (n,d) of v ↦ K̃(x, z) @ v at ḡ = rowv (n,s), v = colv (m,s),
        inputs pre-scaled by 1/ℓ; with (z, x, colv, rowv) it gives dz."""
        check_kind(kind)
        if all(t.device.type == "cpu" for t in (x, z, rowv, colv)):
            return gram_matvec_bwd_ref(x, z, rowv, colv, kind=kind)
        return self._launch(x, z, rowv, colv, kind)

    @staticmethod
    def smem_bytes(d: int, s: int) -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        return _build.library().repro_gram_matvec_bwd_smem_bytes(d, s)

    def _launch(self, x, z, rowv, colv, kind):
        check_operands(self.name, x, z, rowv, colv)
        (n, d), (m, dz), (nr, s), (mc, sc) = x.shape, z.shape, rowv.shape, colv.shape
        if dz != d or nr != n or mc != m or sc != s:
            raise ValueError(
                f"{self.name}: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
                f"rowv {tuple(rowv.shape)}, colv {tuple(colv.shape)} do not chain"
            )
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"{self.name}: needs 1 <= d <= {MAX_DIM}, got d={d}")
        if s > MAX_BWD_COLUMNS:  # dx is linear in the rank-s product rowv colvᵀ
            return sum(
                self._launch(x, z, rowv[:, c:c + MAX_BWD_COLUMNS].contiguous(),
                             colv[:, c:c + MAX_BWD_COLUMNS].contiguous(), kind)
                for c in range(0, s, MAX_BWD_COLUMNS)
            )
        out = torch.empty((n, d), dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        if m == 0 or s == 0:
            return out.zero_()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().repro_gram_matvec_bwd_f32(
                x.data_ptr(), z.data_ptr(), rowv.data_ptr(), colv.data_ptr(),
                out.data_ptr(), n, m, d, s, CUDA_KINDS.index(kind), stream,
            )
        _build.check(err, self.name)
        self.launches += 1
        return out


gram_matvec = GramMatvec()
gram_matvec_bwd = GramMatvecBwd()
