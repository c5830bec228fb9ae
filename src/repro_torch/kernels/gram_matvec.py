"""Fused Gram matvec — the CUDA kernel ``csrc/gram_matvec.cu`` and its wrapper.

``gram_matvec(x, z, v, kind=...)`` computes K̃(x, z) @ v: the unit-signal,
jitter-free covariance core of already lengthscale-scaled inputs, the twin of
``repro.kernels.gram_matvec.gram_matvec_pallas`` as ``gram_matvec_fused``
reaches it. σ_f², 1/ℓ and the jitter are applied by the caller
(``kernels/ops.py``), outside the core, as in the reference.

A CUDA tensor launches the kernel or raises; CPU tensors take the plain version
(``ref.gram_matvec_ref``). There is no backward kernel yet: differentiating
through the launch raises instead of returning a wrong gradient.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import gram_matvec_ref

#: kernel kinds the CUDA kernel implements (tanimoto has no distance form)
CUDA_KINDS = ("se", "matern12", "matern32", "matern52")
#: largest feature dimension the kernel takes
MAX_DIM = 128


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


class _GramMatvecFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, z, v, kind, kernel):
        return kernel._launch(x, z, v, kind)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("gram_matvec_bwd: ROADMAP queue 2 item 4")


class GramMatvec:
    """The wrapper of the fused Gram matvec kernel. ``launches`` counts the
    kernel launches it made (never the plain version's calls)."""

    name = "gram_matvec"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, z: torch.Tensor, v: torch.Tensor, *,
                 kind: str = "se") -> torch.Tensor:
        """x:(n,d) z:(m,d) v:(m,s) → (n,s), inputs pre-scaled by 1/ℓ."""
        if kind not in CUDA_KINDS:
            raise ValueError(
                f"kernel kind {kind!r} has no fused covariance map; supported "
                f"kinds: {CUDA_KINDS} — use the chunked backend instead"
            )
        if all(t.device.type == "cpu" for t in (x, z, v)):
            return gram_matvec_ref(x, z, v, kind=kind)
        return _GramMatvecFn.apply(x, z, v, kind, self)

    @staticmethod
    def smem_bytes(d: int, s: int) -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        return _build.library().repro_gram_matvec_smem_bytes(d, s)

    def _launch(self, x, z, v, kind):
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


gram_matvec = GramMatvec()
