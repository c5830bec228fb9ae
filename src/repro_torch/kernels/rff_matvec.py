"""Fused random-Fourier-feature matvecs — the CUDA kernels ``csrc/rff_matvec.cu``
and ``csrc/rff_t_matvec.cu`` and their wrappers.

``rff_matvec(x, omega, w)`` computes √(1/m)·[sin(xΩᵀ) | cos(xΩᵀ)] @ w with w's
m sin rows first and m cos rows second, the twin of
``repro.kernels.rff_matvec.rff_matvec_pallas``. The feature edge is masked in
the kernel, so the √(1/m) uses the true m and nothing is padded. σ_f² is applied
by the caller (``kernels/ops.py``), outside the kernel, as in the reference.

``rff_t_matvec(x, omega, u)`` is the transpose Φ̃ᵀu → (2m, s), sin rows first
(``rff_t_matvec_pallas``), and ``rff_pair(x, omega, u)`` the SGD regulariser
Φ̃(Φ̃ᵀu) (``rff_pair_pallas``); both take ``m_true``, the reference's mask of
padded frequencies (a zero frequency's cos is 1), with √(1/m) of the padded m.

A CUDA tensor launches the kernel or raises; CPU tensors take the plain
versions (``ref.rff_matvec_ref``, ``ref.rff_t_matvec_ref``,
``ref.rff_pair_ref``). Gradients: ∂w of Φ̃w and ∂u of Φ̃ᵀu are the other
kernel; ∂x and ∂ω need the RFF backward kernel, which is not ported
(ROADMAP queue 2 item 7), and the pair's VJP needs it too: they raise.
"""
from __future__ import annotations

import torch

from . import _build
from .gram_matvec import MAX_DIM, check_operands
from .ref import rff_matvec_ref, rff_pair_ref, rff_t_matvec_ref

_NO_RFF_BWD = "ROADMAP queue 2 item 7 (the RFF backward kernel)"


class _RFFMatvecFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, omega, w):
        ctx.save_for_backward(x, omega)
        return rff_matvec._launch(x, omega, w)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError(f"rff_matvec: ∂x and ∂ω need {_NO_RFF_BWD}")
        x, omega = ctx.saved_tensors
        # ∂w = Φ̃ᵀ ḡ, the transposed kernel
        return None, None, rff_t_matvec._launch(x, omega, grad.contiguous(),
                                                 omega.shape[0])


class _RFFTMatvecFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, omega, u, m_true):
        ctx.save_for_backward(x, omega)
        ctx.m_true = m_true
        return rff_t_matvec._launch(x, omega, u, m_true)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError(f"rff_t_matvec: ∂x and ∂ω need {_NO_RFF_BWD}")
        x, omega = ctx.saved_tensors
        m = omega.shape[0]
        keep = (torch.arange(2 * m, device=x.device) % m < ctx.m_true)[:, None]
        g = torch.where(keep, grad, torch.zeros_like(grad)).contiguous()
        # ∂u = Φ̃ (mask ⊙ ḡ), the forward kernel
        return None, None, rff_matvec._launch(x, omega, g), None


class _RFFPairFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, omega, u, m_true):
        return rff_pair._launch(x, omega, u, m_true)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(f"rff_pair: its VJP needs {_NO_RFF_BWD}")


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
        return _RFFMatvecFn.apply(x, omega, w)

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


class RFFTMatvec:
    """The wrapper of the transposed RFF kernel (``repro_rff_t_matvec_f32``:
    row chunks into a partial-sum workspace, then a fixed-order sum).
    ``launches`` counts the launches it made (never the plain version's
    calls)."""

    name = "rff_t_matvec"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                 m_true=None) -> torch.Tensor:
        """x:(n,d) ω:(m,d) u:(n,s) → (2m,s), sin rows then cos rows; rows of
        frequencies ≥ ``m_true`` (default m) zeroed."""
        m_true = _m_true(omega, m_true)
        if all(t.device.type == "cpu" for t in (x, omega, u)):
            return rff_t_matvec_ref(x, omega, u, m_true=m_true)
        return _RFFTMatvecFn.apply(x, omega, u, m_true)

    @staticmethod
    def smem_bytes(d: int, s: int) -> int:
        """Dynamic shared memory per CTA of the partial kernel at these d, s."""
        return _build.library().repro_rff_t_matvec_smem_bytes(d, s)

    @staticmethod
    def workspace_floats(n: int, m: int, s: int) -> int:
        """Floats of the (chunks, 2m, s) partial-sum workspace of a launch."""
        return _build.library().repro_rff_t_workspace_floats(n, m, s)

    def _launch(self, x, omega, u, m_true):
        check_operands(self.name, x, omega, u)
        _check_rff(self.name, x, omega, u)
        (n, d), m, s = x.shape, omega.shape[0], u.shape[1]
        out = torch.empty((2 * m, s), dtype=torch.float32, device=x.device)
        if s == 0:
            return out
        if n == 0:
            return out.zero_()
        ws = torch.empty(self.workspace_floats(n, m, s), dtype=torch.float32,
                         device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().repro_rff_t_matvec_f32(
                x.data_ptr(), omega.data_ptr(), u.data_ptr(), ws.data_ptr(),
                out.data_ptr(), n, m, d, s, m_true, stream,
            )
        _build.check(err, self.name)
        self.launches += 1
        return out


class RFFPair:
    """The wrapper of the fused regulariser pair (``repro_rff_pair_f32``: the
    transposed kernel into a (2m, s) buffer, masked to ``m_true``, then the
    RFF matvec kernel on it; three launches on one stream). ``launches``
    counts the pair launches it made (never the plain version's calls)."""

    name = "rff_pair"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *,
                 m_true=None) -> torch.Tensor:
        """x:(n,d) ω:(m,d) u:(n,s) → Φ̃(Φ̃ᵀu) (n,s), Φ̃ = √(1/m)[sin | cos]."""
        m_true = _m_true(omega, m_true)
        if all(t.device.type == "cpu" for t in (x, omega, u)):
            return rff_pair_ref(x, omega, u, m_true=m_true)
        return _RFFPairFn.apply(x, omega, u, m_true)

    def _launch(self, x, omega, u, m_true):
        check_operands(self.name, x, omega, u)
        _check_rff(self.name, x, omega, u)
        (n, d), m, s = x.shape, omega.shape[0], u.shape[1]
        out = torch.empty((n, s), dtype=torch.float32, device=x.device)
        if n == 0 or s == 0:
            return out
        ws = torch.empty(rff_t_matvec.workspace_floats(n, m, s), dtype=torch.float32,
                         device=x.device)
        t = torch.empty((2 * m, s), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().repro_rff_pair_f32(
                x.data_ptr(), omega.data_ptr(), u.data_ptr(), ws.data_ptr(),
                t.data_ptr(), out.data_ptr(), n, m, d, s, m_true, stream,
            )
        _build.check(err, self.name)
        self.launches += 1
        return out


rff_matvec = RFFMatvec()
rff_t_matvec = RFFTMatvec()
rff_pair = RFFPair()
