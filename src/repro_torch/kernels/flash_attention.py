"""Causal flash attention — the CUDA kernels ``csrc/flash_attention.cu`` (fp32
q, k, v) and ``csrc/flash_attention_bf16.cu`` (bf16 q, k, v) and their
wrapper, twin of ``repro.kernels.flash_attention.flash_attention_pallas``
behind ``repro.kernels.ops.flash_attention``.

``flash_attention(q, k, v, causal=...)`` takes q (b, s, hq, d) and k, v
(b, s, hkv, d) with hq a multiple of hkv (grouped-query heads) and returns
(b, s, hq, d). The kernel reads the tensors in that layout and maps the heads
itself: nothing is gathered, transposed or padded first. q, k and v share one
dtype, float32 or bfloat16 (the reference kernel's casts on bf16 inputs: fp32
logits, max and normaliser, p rounded to bf16 for p·v, a bf16 output); a mix
raises.

A CUDA tensor launches the kernel or raises, inside ``_FlashAttentionFn``: the
kernel has no backward (nor has the reference's, which defines no VJP), so the
Function's backward recomputes the output through the plain version under
autograd and differentiates that. CPU tensors take the plain version
``ref.flash_attention_ref`` (materialised logits) directly, as the reference
runs the Pallas kernel in interpret mode off the TPU.

Fake tensors (the dry run's, ``launch/dryrun.py``) take the kernel's op,
``torch.ops.repro_torch.flash_attention``: a custom op that only shapes fake
tensors (its fake implementation checks what the launch checks and returns
the output's shape; real tensors never reach it), so a profile of the dry run
counts one kernel op (:func:`flash_flops`, q, k, v and o bytes) where the card
launches the kernel, never the plain s² product. Its backward is the
Function's, as on the card.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.autograd.function import once_differentiable

from . import _build
from .gram_matvec import _ENTRY, LaunchCounts
from .ref import flash_attention_ref

#: head dimensions the kernel is instantiated for (the reduced configs', llama3-8b's)
HEAD_DIMS = (64, 128)
#: query rows of a block, and keys of a tile, by the tile precision of the
#: launch: ``kBlock`` in ``flash_attention.cu`` (a CTA per batch × query head
#: and block, the blocks along grid.y), ``kRows`` in
#: ``flash_attention_bf16.cu`` (a work item of its persistent CTAs)
BLOCKS = {"fp32": 64, "bf16": 128}
#: the dtypes the kernels take, by the tile precision they count launches as
DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def query_blocks(s: int, precision: str) -> int:
    """The query blocks of a launch over s rows at the block of its tile
    precision, or a ValueError past the 65,535 that both C entries take
    (grid.y's limit in the fp32 kernel)."""
    blocks = -(-s // BLOCKS[precision])
    if blocks > 65535:
        raise ValueError(f"flash_attention: {blocks} query blocks of {BLOCKS[precision]} rows "
                         f"exceed the 65,535 a launch takes")
    return blocks


def check_dtypes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The tile precision of q, k and v: one dtype of DTYPES for all three,
    or a TypeError."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise TypeError(f"{name}: q, k and v must share one dtype of "
                        f"{tuple(DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    return DTYPES[q.dtype]


def flash_flops(q_shape: tuple, causal: bool) -> float:
    """The kernel's multiply-adds ×2 on q (b, s, hq, d): q·kᵀ and p·v over
    every (query, key) pair, half of them under the causal mask."""
    b, s, hq, d = q_shape
    return 4.0 * b * hq * s * s * d * (0.5 if causal else 1.0)


def _check_launch(name: str, q, k, v, precision: str) -> None:
    """The launch's shape checks (everything but device and layout)."""
    (b, s, hq, d), (bk, sk, hkv, dk) = q.shape, k.shape
    if (bk, sk, dk) != (b, s, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not chain (equal b, s and d; hq a multiple of hkv)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dimension {d} not in {HEAD_DIMS}")
    query_blocks(s, precision)


_OP = None


def kernel_op():
    """``torch.ops.repro_torch.flash_attention(q, k, v, causal)``: the kernel
    as a custom op for fake tensors, registered at its first use. Its real
    implementation is never run and raises: :class:`FlashAttention` hands
    the op fake tensors only, and launches the kernel on CUDA tensors
    itself."""
    global _OP
    if _OP is None:
        @torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
        def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
            raise RuntimeError(f"{flash_attention.name}: the kernel's op only shapes fake "
                               "tensors; real ones go through FlashAttention")

        @op.register_fake
        def _(q, k, v, causal):
            _check_launch(flash_attention.name, q, k, v,
                          check_dtypes(flash_attention.name, q, k, v))
            return torch.empty_like(q)

        _OP = op
    return _OP


def _op_launch(q, k, v, *, causal):
    return kernel_op()(q, k, v, causal)


class _FlashAttentionFn(torch.autograd.Function):
    """``fwd(q, k, v, causal=...)`` with the gradients of autograd through the
    plain version: the backward recomputes ``flash_attention_ref`` on the
    saved inputs (its (b, hq, s, s) logits live only inside the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, fwd):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return fwd(q, k, v, causal=causal)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = flash_attention_ref(*ins, causal=ctx.causal)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in ins), None, None)


class FlashAttention(LaunchCounts):
    """The wrapper of the flash-attention kernels. Its ``LaunchCounts`` count
    the launches it made, fp32 in ``launches`` and bf16 in ``bf16_launches``
    (never the plain version's calls)."""

    name = "flash_attention"

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True) -> torch.Tensor:
        check_dtypes(self.name, q, k, v)
        if is_fake(q):
            return _FlashAttentionFn.apply(q, k, v, causal, _op_launch)
        if all(t.device.type == "cpu" for t in (q, k, v)):
            return flash_attention_ref(q, k, v, causal=causal)
        return _FlashAttentionFn.apply(q, k, v, causal, self._launch)

    @staticmethod
    def smem_bytes(d: int, precision: str = "fp32") -> int:
        """Dynamic shared memory per CTA of a launch at head dimension d."""
        suffix = "_bf16" if precision == "bf16" else ""
        return getattr(_build.library(), f"repro_flash_attention_smem_bytes{suffix}")(d)

    def _launch(self, q, k, v, *, causal):
        dev = q.device
        precision = check_dtypes(self.name, q, k, v)
        for t in (q, k, v):
            if t.device != dev or dev.type != "cuda":
                raise ValueError(f"{self.name}: q, k and v must be on one CUDA device")
            if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{self.name}: operands must be contiguous, 16-byte "
                                 f"aligned (b, s, heads, d) tensors")
        _check_launch(self.name, q, k, v, precision)
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        out = torch.empty_like(q)
        if b == 0 or s == 0:
            return out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(_build.library(), f"repro_flash_attention_{_ENTRY[precision]}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, hq, hkv, d, int(causal), d ** -0.5, stream,
            )
        _build.check(err, self.name)
        self._count(precision)
        return out


flash_attention = FlashAttention()
