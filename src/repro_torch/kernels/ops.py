"""The port's matvec backend-selection layer, for Gram *and* feature-map (RFF)
contractions — twin of ``repro/kernels/ops.py``.

Every Gram matvec goes through :func:`gram_mv`, dispatching on ``backend``:

* ``"cuda"``    — the fused CUDA kernel (``gram_matvec.py``): K never exists in
  device memory. CPU tensors take the kernel's plain version, as the reference
  runs Pallas in interpret mode off the TPU.
* ``"chunked"`` — the plain row-chunked matvec (``core/kernels_fn.py``), any
  kernel kind, autograd throughout.
* ``"dense"``   — materialise K and multiply (small-n reference / tests).
* ``"auto"``    — ``cuda`` for tensors on the card, ``chunked`` for CPU
  tensors; always ``chunked`` for ``tanimoto``.

Row-panel matvecs go through :func:`gram_rows_matvec` (K[idx, :] @ u, or its
transpose) and :func:`gram_rows_pair` (SGD's err/g pair, counted as two
matvecs), on the same backends.

Every feature matvec Φ(x) @ w goes through :func:`rff_mv`, its transpose
Φ(x)ᵀ @ u through :func:`rff_t_mv`, and the pair Φ(Φᵀu) through
:func:`rff_pair_mv` (counted as two), on ``"cuda"`` (fused, the (n, 2m)
feature matrix never in device memory), ``"features"`` (materialise Φ) or
``"auto"``; the Gram names ``chunked``/``dense`` coerce to ``features``.
``"pallas"`` names the reference's TPU kernels and raises with a pointer to
``"cuda"``.

σ_f², 1/ℓ and the jitter are applied here, outside the kernel cores, as in the
reference (``ops.py:150-163,200-204,287-297,381,496`` there): the cores'
autograd Functions carry the kernels' VJPs (∂x, ∂ω and the operand's), and
the factors around them keep their plain autodiff.

``block`` is the reference's tile argument, ``"auto"`` (the default) or an
int: on ``cuda`` it sets the fewest K-loop columns one chunk of a launch
holds, resolved on the host from the call's shapes (the row count of its x,
d, the tile precision) by ``kernels/autotune.py``'s H100 table, so no call
synchronises with the device; the plain backends ignore it, as the
reference's ``chunked`` does.

``precision`` is the reference's tile precision, pinned by a spec through
``solve()`` like ``backend``: ``"fp32"``, or ``"bf16"``, bfloat16 contraction
operands with fp32 accumulation. On ``cuda`` it selects the kernels' bf16
tiles (their own cast points, ``kernels/ref.py``); on the plain backends it
applies to the panel and feature contractions alone (:func:`_dot`, the
reference's ``ops._dot``: the panel, the covariance map and the features stay
fp32), and ``gram_mv`` on ``chunked``/``dense`` ignores it, as the
reference's does.

Causal attention goes through :func:`flash_attention` on ``"cuda"`` (the flash
kernels, ``flash_attention.py``, fp32 or bf16 inputs) or ``"plain"``
(materialised logits, with the kernels' casts on bf16 inputs).

:func:`gram_matvec`, :func:`rff_matvec` and :func:`rff_t_matvec` are the
reference's pins of the fused kernels (``ops.py:303,360,384`` there): the
conventional names of the kernel tests and benches, each ``backend="cuda"``,
differentiable through the kernels' VJPs at the tile ``precision``.

``MATVEC_TRACE_COUNTS`` / ``FEATURE_TRACE_COUNTS`` count the matvecs each
backend dispatched, ``ATTENTION_TRACE_COUNTS`` the attention calls (every call
is eager in PyTorch), so a run can show that its hot path never took the plain
backends.
"""
from __future__ import annotations

import torch

from .autotune import resolve_block
from .flash_attention import check_dtypes, flash_attention as _flash_kernel
from .gram_matvec import (
    CUDA_KINDS, check_block, gram_matvec as _gram_kernel, gram_rows_matvec as _rows_kernel,
    gram_rows_pair as _pair_kernel,
)
from .ref import PRECISIONS, check_precision, flash_attention_ref, tile_cast
from .rff_matvec import (
    rff_matvec as _rff_kernel, rff_pair as _rff_pair_kernel, rff_t_matvec as _rff_t_kernel,
)

BACKENDS = ("auto", "cuda", "chunked", "dense")
FEATURE_BACKENDS = ("auto", "cuda", "features")
ATTENTION_BACKENDS = ("auto", "cuda", "plain")

MATVEC_TRACE_COUNTS = {"cuda": 0, "chunked": 0, "dense": 0}
FEATURE_TRACE_COUNTS = {"cuda": 0, "features": 0}
ATTENTION_TRACE_COUNTS = {"cuda": 0, "plain": 0}


def reset_matvec_trace_counts() -> None:
    for k in MATVEC_TRACE_COUNTS:
        MATVEC_TRACE_COUNTS[k] = 0


def reset_feature_trace_counts() -> None:
    for k in FEATURE_TRACE_COUNTS:
        FEATURE_TRACE_COUNTS[k] = 0


def reset_attention_trace_counts() -> None:
    for k in ATTENTION_TRACE_COUNTS:
        ATTENTION_TRACE_COUNTS[k] = 0


def _no_pallas(backend: str) -> None:
    if backend in ("pallas", "fused"):
        raise ValueError(
            f"backend {backend!r} names the reference's TPU kernels; the port's "
            f"fused kernels are backend='cuda'"
        )


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at the tile precision, the reference's ``ops._dot``: bfloat16
    operands and fp32 accumulation for ``"bf16"``, taken as a product of the
    rounded operands in fp32 (a bfloat16 matmul would round its result); the
    fp32 path stays a plain ``@``."""
    return tile_cast(a, precision) @ tile_cast(b, precision)


def _resolve_block(block, family: str, n: int, d: int, precision: str) -> int:
    """``"auto"`` → the autotuned or heuristic block of (family, n, d,
    precision); an int passes through, checked (a positive multiple of 64)."""
    if isinstance(block, str) and block == "auto":
        return resolve_block(family, n, d, precision=precision)
    return check_block(block)


def resolve_backend(backend: str, kind: str, device: torch.device) -> str:
    """Normalise a Gram backend request for kernel ``kind`` on ``device``.

    ``auto`` is ``cuda`` for tensors on the card and ``chunked`` otherwise, and
    ``chunked`` for kinds the kernel cannot express (``tanimoto``). Asking for
    ``cuda`` explicitly for such a kind is an error.
    """
    _no_pallas(backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if (device.type == "cuda" and kind in CUDA_KINDS) else "chunked"
    if backend == "cuda" and kind not in CUDA_KINDS:
        raise ValueError(
            f"kernel kind {kind!r} is not supported by the fused CUDA backend "
            f"(no distance-as-matmul form); supported kinds: {CUDA_KINDS}. "
            f"Use backend='chunked', or backend='auto' to fall back automatically."
        )
    return backend


def gram_mv(
    params,
    x: torch.Tensor,
    v: torch.Tensor,
    z=None,
    *,
    jitter=None,
    backend: str = "auto",
    block="auto",
    row_chunk: int = 2048,
    precision: str = "fp32",
) -> torch.Tensor:
    """(σ_f² k(x, z) + jitter·I) @ v through the selected backend — THE Gram
    matvec entry point. v: (m,) or (m, s). ``jitter`` (typically σ²) is added
    as ``out + jitter·v``, only for the symmetric z-is-None case."""
    from ..core.kernels_fn import gram, matvec  # deferred: core imports kernels

    if jitter is not None and z is not None:
        raise ValueError(
            "jitter adds jitter·I, which only makes sense for the symmetric "
            "K(x, x) operator — drop jitter for cross-Gram matvecs (z given)"
        )
    bk = resolve_backend(backend, params.kind, x.device)
    check_precision(precision)
    MATVEC_TRACE_COUNTS[bk] += 1
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    if bk == "cuda":
        ls = params.lengthscale
        xs = (x / ls).contiguous()
        zs = xs if z is None else (z / ls).contiguous()
        blk = _resolve_block(block, "gram", x.shape[0], x.shape[1], precision)
        out = params.signal * _gram_kernel(xs, zs, v2.contiguous(), kind=params.kind,
                                           precision=precision, block=blk)
    elif bk == "chunked":  # the plain backends ignore precision, as the reference's
        out = matvec(params, x, v2, z=z, row_chunk=row_chunk)
    else:
        out = gram(params, x, z) @ v2
    if jitter is not None:
        out = out + jitter * v2
    return out[:, 0] if squeeze else out


def gram_rows_matvec(
    params,
    x: torch.Tensor,
    idx: torch.Tensor,
    u: torch.Tensor,
    *,
    transpose: bool = False,
    backend: str = "auto",
    block="auto",
    precision: str = "fp32",
) -> torch.Tensor:
    """Row-block matvec: K[idx, :] @ u, or K[idx, :]ᵀ @ u with ``transpose``
    — the SGD/SDD/AP primitive. u: (n, s) (or (|idx|, s) with ``transpose``).

    On ``cuda`` the (|idx|, n) panel never exists in device memory: the
    forward is the row-panel kernel (column chunks across CTAs), and the
    transpose is the Gram kernel on (x, x[idx]), counted by ``gram_mv``. The
    chunked/dense backends build the panel once per call, as the reference's.
    """
    from ..core.kernels_fn import gram  # deferred: core imports kernels

    bk = resolve_backend(backend, params.kind, x.device)
    check_precision(precision)
    if bk == "cuda" and transpose:
        return gram_mv(params, x, u, z=x[idx], backend="cuda", block=block,
                       precision=precision)
    MATVEC_TRACE_COUNTS[bk] += 1
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    if bk == "cuda":
        xs = (x / params.lengthscale).contiguous()
        blk = _resolve_block(block, "gram", idx.shape[0], x.shape[1], precision)
        out = params.signal * _rows_kernel(xs[idx].contiguous(), xs, u2.contiguous(),
                                           kind=params.kind, precision=precision, block=blk)
    else:
        panel = gram(params, x[idx], x)  # (|idx|, n)
        out = _dot(panel.T, u2, precision) if transpose else _dot(panel, u2, precision)
    return out[:, 0] if squeeze else out


def gram_rows_pair(
    params,
    x: torch.Tensor,
    idx: torch.Tensor,
    look: torch.Tensor,
    b: torch.Tensor,
    *,
    backend: str = "auto",
    block="auto",
    precision: str = "fp32",
) -> tuple:
    """The SGD pair step: err = K[idx,:] @ look − b and g = K[idx,:]ᵀ @ err in
    one dispatch, counted as TWO row-block matvecs (the two calls it replaces).
    look: (n, s); b: (|idx|, s) → ((|idx|, s), (n, s)). Differentiable in θ
    on every backend.

    On ``cuda`` the unit-signal core takes b/σ_f²: err = σ_f²·err_u and
    g = σ_f⁴·g_u, with σ_f² outside the kernel as in the reference; ``"auto"``
    resolves at the panel's |idx| rows, the phase whose chunks the block sets.
    The chunked/dense backends build the panel once and use it twice.
    """
    from ..core.kernels_fn import gram  # deferred: core imports kernels

    bk = resolve_backend(backend, params.kind, x.device)
    check_precision(precision)
    MATVEC_TRACE_COUNTS[bk] += 2
    if bk == "cuda":
        xs = (x / params.lengthscale).contiguous()
        blk = _resolve_block(block, "gram", idx.shape[0], x.shape[1], precision)
        err_u, g_u = _pair_kernel(xs[idx].contiguous(), xs, look.contiguous(),
                                  (b / params.signal).contiguous(), kind=params.kind,
                                  precision=precision, block=blk)
        return params.signal * err_u, params.signal ** 2 * g_u
    panel = gram(params, x[idx], x)  # (|idx|, n), built once, used twice
    err = _dot(panel, look, precision) - b
    return err, _dot(panel.T, err, precision)


def resolve_feature_backend(backend: str, device: torch.device, paired: bool = True) -> str:
    """Normalise a feature-matvec backend request. The Gram names
    ``chunked``/``dense`` coerce to ``features``, so a spec's single
    ``backend`` field pins both sides of a solve. The fused kernel implements
    the paired sin/cos map only: ``auto`` gives ``features`` for the cos-only
    map, and an explicit ``cuda`` raises."""
    _no_pallas(backend)
    if backend in ("chunked", "dense"):
        backend = "features"
    if backend not in FEATURE_BACKENDS:
        raise ValueError(
            f"unknown feature backend {backend!r}; expected one of "
            f"{FEATURE_BACKENDS} (or a Gram backend name, coerced to 'features')"
        )
    if backend == "auto":
        return "cuda" if (device.type == "cuda" and paired) else "features"
    if backend == "cuda" and not paired:
        raise ValueError(
            "the fused RFF kernel only implements the paired sin/cos feature "
            "map; use paired features or backend='features'"
        )
    return backend


def materialised_features(x: torch.Tensor, omega: torch.Tensor, signal) -> torch.Tensor:
    """Φ(x) = √(σ_f²/m)·[sin xΩᵀ | cos xΩᵀ] — (n, 2m)."""
    m = omega.shape[0]
    proj = x @ omega.T
    return torch.sqrt(signal / m) * torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def rff_mv(
    x: torch.Tensor,
    omega: torch.Tensor,
    w: torch.Tensor,
    *,
    signal=1.0,
    backend: str = "auto",
    block="auto",
    precision: str = "fp32",
) -> torch.Tensor:
    """Φ(x) @ w through the selected feature backend — THE feature matvec entry
    point. x:(n,d) ω:(m,d) w:(2m,) or (2m,s) → (n, s-like)."""
    bk = resolve_feature_backend(backend, x.device)
    check_precision(precision)
    FEATURE_TRACE_COUNTS[bk] += 1
    signal = torch.as_tensor(signal, dtype=x.dtype, device=x.device)
    squeeze = w.ndim == 1
    w2 = w[:, None] if squeeze else w
    if bk == "cuda":
        # the kernel carries √(1/m); σ_f² is folded in here, outside it
        blk = _resolve_block(block, "rff", x.shape[0], x.shape[1], precision)
        out = torch.sqrt(signal) * _rff_kernel(
            x.contiguous(), omega.contiguous(), w2.contiguous(), precision=precision,
            block=blk,
        )
    else:
        out = _dot(materialised_features(x, omega, signal), w2, precision)
    return out[:, 0] if squeeze else out


def rff_t_mv(
    x: torch.Tensor,
    omega: torch.Tensor,
    u: torch.Tensor,
    *,
    signal=1.0,
    backend: str = "auto",
    block="auto",
    precision: str = "fp32",
) -> torch.Tensor:
    """Φ(x)ᵀ @ u through the selected feature backend — the transposed feature
    matvec. x:(n,d) ω:(m,d) u:(n,) or (n,s) → (2m, s-like), sin rows first."""
    bk = resolve_feature_backend(backend, x.device)
    check_precision(precision)
    FEATURE_TRACE_COUNTS[bk] += 1
    signal = torch.as_tensor(signal, dtype=x.dtype, device=x.device)
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    if bk == "cuda":
        blk = _resolve_block(block, "rff", x.shape[0], x.shape[1], precision)
        out = torch.sqrt(signal) * _rff_t_kernel(
            x.contiguous(), omega.contiguous(), u2.contiguous(), precision=precision,
            block=blk,
        )
    else:
        out = _dot(materialised_features(x, omega, signal).T, u2, precision)
    return out[:, 0] if squeeze else out


def rff_pair_mv(
    x: torch.Tensor,
    omega: torch.Tensor,
    u: torch.Tensor,
    *,
    signal=1.0,
    backend: str = "auto",
    block="auto",
    precision: str = "fp32",
) -> torch.Tensor:
    """Φ(x) (Φ(x)ᵀ u) — the SGD regulariser (Eq. 3.3) in ONE dispatch,
    counted as TWO feature matvecs. On ``cuda`` the (2m, s) intermediate stays
    in a device buffer between the pair kernel's phases and Φ is never
    materialised; on ``features`` Φ is built once and used twice.
    x:(n,d) ω:(m,d) u:(n,) or (n,s) → (n, s-like)."""
    bk = resolve_feature_backend(backend, x.device)
    check_precision(precision)
    FEATURE_TRACE_COUNTS[bk] += 2
    signal = torch.as_tensor(signal, dtype=x.dtype, device=x.device)
    squeeze = u.ndim == 1
    u2 = u[:, None] if squeeze else u
    if bk == "cuda":
        # the core's two √(1/m) factors give 1/m; σ_f² is applied here
        blk = _resolve_block(block, "rff", x.shape[0], x.shape[1], precision)
        out = signal * _rff_pair_kernel(x.contiguous(), omega.contiguous(), u2.contiguous(),
                                        precision=precision, block=blk)
    else:
        feats = materialised_features(x, omega, signal)  # built once, used twice
        out = _dot(feats, _dot(feats.T, u2, precision), precision)
    return out[:, 0] if squeeze else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: str = "auto") -> torch.Tensor:
    """q: (b, s, hq, d), k/v: (b, s, hkv, d) with hq % hkv == 0 (GQA) →
    (b, s, hq, d) — THE attention entry point, as the reference's. ``auto``
    is ``cuda`` for tensors on the card and ``plain`` for CPU tensors; the
    kernel maps the heads and masks the ragged edge itself, so nothing is
    gathered or padded here. The plain route also takes float64 q, k and v,
    the yardstick of a model cast to float64."""
    _no_pallas(backend)
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {ATTENTION_BACKENDS}")
    bk = ("cuda" if q.device.type == "cuda" else "plain") if backend == "auto" else backend
    if not (bk == "plain" and q.dtype == k.dtype == v.dtype == torch.float64):
        check_dtypes("flash_attention", q, k, v)
    ATTENTION_TRACE_COUNTS[bk] += 1
    if bk == "cuda":
        return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def gram_matvec(params, x: torch.Tensor, v: torch.Tensor, z=None, *, jitter=None,
                block="auto", precision: str = "fp32") -> torch.Tensor:
    """(σ_f² k(x, z) + jitter·I) @ v — the fused Gram kernel, the reference's
    ``backend="pallas"`` pin over :func:`gram_mv` (its ``ops.gram_matvec``):
    σ_f², 1/ℓ and the jitter applied outside the core, differentiable in x,
    z, v and the hyperparameters. CPU tensors take the kernel's plain
    version."""
    return gram_mv(params, x, v, z=z, jitter=jitter, backend="cuda", block=block,
                   precision=precision)


def rff_matvec(x: torch.Tensor, omega: torch.Tensor, w: torch.Tensor, *, signal=1.0,
               block="auto", precision: str = "fp32") -> torch.Tensor:
    """Φ(x) @ w (paired sin/cos RFF) by the fused kernel — the reference's
    ``ops.rff_matvec`` pin, :func:`rff_mv` on ``"cuda"``: w (2m, s), sin rows
    first; differentiable in x, ω, w and ``signal`` (σ_f², outside the core).
    The reference pads ω to its block and rescales by √(m_pad/m); the port's
    kernel masks the feature edge, so nothing is padded. Counted among the
    feature matvecs (the reference's pin passes its counter by)."""
    return rff_mv(x, omega, w, signal=signal, backend="cuda", block=block,
                  precision=precision)


def rff_t_matvec(x: torch.Tensor, omega: torch.Tensor, u: torch.Tensor, *, signal=1.0,
                 block="auto", precision: str = "fp32") -> torch.Tensor:
    """Φ(x)ᵀ @ u (paired sin/cos RFF) → (2m, s) by the fused kernel — the
    reference's ``ops.rff_t_matvec`` pin, :func:`rff_t_mv` on ``"cuda"``
    (see :func:`rff_matvec`)."""
    return rff_t_mv(x, omega, u, signal=signal, backend="cuda", block=block,
                    precision=precision)
