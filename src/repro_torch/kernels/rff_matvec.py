"""Fused random-Fourier-feature matvec — the CUDA kernel ``csrc/rff_matvec.cu``
and its wrapper.

``rff_matvec(x, omega, w)`` computes √(1/m)·[sin(xΩᵀ) | cos(xΩᵀ)] @ w with w's
m sin rows first and m cos rows second, the twin of
``repro.kernels.rff_matvec.rff_matvec_pallas``. The feature edge is masked in
the kernel, so the √(1/m) uses the true m and nothing is padded. σ_f² is applied
by the caller (``kernels/ops.py``), outside the kernel, as in the reference.

A CUDA tensor launches the kernel or raises; CPU tensors take the plain version
(``ref.rff_matvec_ref``). The transpose and backward kernels are not ported
yet: differentiating through the launch raises.
"""
from __future__ import annotations

import torch

from . import _build
from .gram_matvec import MAX_DIM, check_operands
from .ref import rff_matvec_ref


class _RFFMatvecFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, omega, w, kernel):
        return kernel._launch(x, omega, w)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("rff_matvec_bwd: ROADMAP queue 2 items 3 and 7")


class RFFMatvec:
    """The wrapper of the fused RFF matvec kernel. ``launches`` counts the
    kernel launches it made (never the plain version's calls)."""

    name = "rff_matvec"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, omega: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        """x:(n,d) ω:(m,d) w:(2m,s) → (n,s)."""
        if all(t.device.type == "cpu" for t in (x, omega, w)):
            return rff_matvec_ref(x, omega, w)
        return _RFFMatvecFn.apply(x, omega, w, self)

    @staticmethod
    def smem_bytes(d: int, s: int) -> int:
        """Dynamic shared memory per CTA of a launch at these d and s."""
        return _build.library().repro_rff_matvec_smem_bytes(d, s)

    def _launch(self, x, omega, w):
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
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().repro_rff_matvec_f32(
                x.data_ptr(), omega.data_ptr(), w.data_ptr(), out.data_ptr(),
                n, m, d, s, stream,
            )
        _build.check(err, self.name)
        self.launches += 1
        return out


rff_matvec = RFFMatvec()
