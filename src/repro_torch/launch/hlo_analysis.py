"""One rank's op profile for the dry-run roofline — the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses XLA's partitioned HLO text, a program it compiled. The
port has no HLO: its program is the stream of aten ops that one rank runs.
This file keeps the reference's name so that a reader finds the
counterpart; :func:`analyze_ops` runs a step under a ``TorchDispatchMode``
that sees the *local* ops of a DTensor program (a DTensor op is let through
to DTensor's own dispatch, which runs each rank's local op, collectives
included, beneath the mode) and derives the three roofline inputs:

  flops             — ``torch.utils.flop_counter``'s formulas on the local
                      shapes (mm, bmm, addmm, baddbmm, convolution, …), and
                      the flash kernel's op at 4·b·h·s²·d (half that causal)
  bytes             — Σ (operand + output bytes) of every op that moves data
                      (views, factories and waits excluded)
  bytes_fused       — the same over the ops of the reference's
                      ``_MATERIALIZING`` categories mapped to aten ops, plus
                      each kernel op; slices and gathers count 2 × their
                      output, in-place updates 2 × the update (the
                      reference's rules)
  collective_bytes  — Σ operand bytes of the ``_c10d_functional`` (and
                      ``_dtensor``) collectives, under the reference's kind
                      names

**Counts are executions, by design.** Eager execution runs every loop
iteration, so each op is counted each time it runs; the reference counts
instructions and multiplies by ``while`` trip counts. The two agree where the
reference's trip counts are exact.

The ops DTensor runs while it propagates a sharding (to infer a global
output's shape on fake tensors of the global shape, and to cost candidate
layouts) are not the rank's and are left out. The mode also tracks the live
bytes of the storages the step creates, for the dry run's per-device memory
(:attr:`HloProfile.notes`).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch._subclasses.fake_tensor import is_fake
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention import flash_flops


@dataclasses.dataclass
class HloProfile:
    flops: float
    bytes: float  # upper bound: every op pays operand+output traffic
    bytes_fused: float  # fusion model: only materialising ops and kernels move bytes
    collective_bytes: float
    collective_by_kind: dict
    collective_counts: dict
    notes: dict


#: the reference's collective kinds, by the functional op that runs each
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

#: the reference's _MATERIALIZING categories (ops that move HBM bytes even
#: under aggressive fusion), as the aten ops that play them
_MATERIALIZING = {
    # dot
    "mm": "dot", "bmm": "dot", "addmm": "dot", "baddbmm": "dot", "_scaled_mm": "dot",
    # convolution
    "convolution": "convolution", "convolution_backward": "convolution",
    # dynamic-update-slice / scatter (in-place updates)
    "copy_": "dynamic-update-slice", "slice_scatter": "dynamic-update-slice",
    "select_scatter": "dynamic-update-slice", "index_put": "scatter", "index_put_": "scatter",
    "scatter": "scatter", "scatter_add": "scatter", "scatter_add_": "scatter",
    "index_add": "scatter", "index_add_": "scatter", "embedding_dense_backward": "scatter",
    # dynamic-slice / gather
    "gather": "gather", "index_select": "gather", "embedding": "gather", "index": "gather",
    # copy / transpose (a materialised layout change)
    "clone": "copy", "_to_copy": "copy",
    # reduce
    "sum": "reduce", "mean": "reduce", "amax": "reduce", "amin": "reduce", "max": "reduce",
    "min": "reduce", "argmax": "reduce", "prod": "reduce", "var_mean": "reduce",
    "_softmax": "reduce", "_log_softmax": "reduce", "_softmax_backward_data": "reduce",
    "cumsum": "reduce-window", "logsumexp": "reduce",
    # concatenate / pad / sort / rng
    "cat": "concatenate", "constant_pad_nd": "pad", "sort": "sort", "topk": "sort",
    "normal_": "rng", "uniform_": "rng", "bernoulli_": "rng",
}

#: ops with no data traffic of their own
_FREE = {"empty", "empty_strided", "empty_like", "zeros_like", "detach", "alias", "lift_fresh",
         "wait_tensor", "_local_scalar_dense", "set_", "resize_", "size", "stride",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}

#: the module in which DTensor infers a global output's shape and costs its
#: candidate layouts (ops it runs there are not the rank's)
_PROPAGATION = "/_sharding_prop.py"
#: DTensor's own modules: their index arithmetic needs its real tensors
_DTENSOR = "/torch/distributed/tensor/"


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _called_from(part: str) -> bool:
    """Whether a frame of the current stack runs a file whose path holds
    ``part``."""
    f = sys._getframe(2)
    while f is not None:
        if part in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


class _OpProfiler(TorchDispatchMode):
    """Counts the local ops that run beneath it (see the module docstring)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_fused = 0.0
        self.coll_bytes: dict = defaultdict(float)
        self.coll_counts: dict = defaultdict(int)
        self.ops = 0
        self.kernel_ops: dict = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._tracked: dict = {}

    # ---- memory: the storages the step creates, live and at their peak ----

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self._tracked:
                continue
            n = min(st.nbytes(), _nbytes(t))  # a view's base may be larger (fake impls)
            self._tracked[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._tracked.pop(key, 0)

    # ---- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops beneath this mode
        out = func(*args, **kwargs)
        if _called_from(_PROPAGATION):
            return out
        if self.fake_mode is not None and any(
                isinstance(t, torch.Tensor) and not is_fake(t) for t in tree_flatten(out)[0]) \
                and not _called_from(_DTENSOR):
            out = tree_map(self._faked, out)
        self._account(func, args, kwargs, out)
        self._track(out)
        return out

    def _faked(self, t):
        if isinstance(t, torch.Tensor) and not is_fake(t):
            return self.fake_mode.from_tensor(t)
        return t

    def _account(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "prim" or (ns == "aten" and (name in _FREE or func.is_view)):
            return
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        kind = _COLLECTIVES.get(name) if ns in ("_c10d_functional", "_dtensor") else None
        if kind is not None:
            self.coll_bytes[kind] += in_b
            self.coll_counts[kind] += 1
            self.bytes += in_b + out_b
            self.bytes_fused += in_b + out_b
            return
        if ns == "repro_torch":  # a hand-written kernel's op
            self.kernel_ops[name] += 1
            if name == "flash_attention":
                self.flops += flash_flops(tuple(args[0].shape), bool(args[3]))
            self.bytes += in_b + out_b
            self.bytes_fused += in_b + out_b
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += in_b + out_b
        cat = _MATERIALIZING.get(name)
        if cat is None:
            return
        if cat == "gather":
            eff = 2.0 * out_b
        elif cat in ("dynamic-update-slice", "scatter") and len(ins) > 1:
            eff = 2.0 * min(_nbytes(ins[-1]), out_b)  # the update, read and written
        else:
            eff = in_b + out_b
        self.bytes_fused += eff


def analyze_ops(fn, *args, fake_mode=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the op profiler; returns
    ``(HloProfile, fn's result)``. ``notes`` holds the op count, the kernel
    ops by name, and ``peak_bytes``/``live_bytes``: the largest and the last
    total of live local bytes in storages created during the run. Given a
    ``FakeTensorMode``, every real tensor an op returns is replaced by a
    fake one of its shape (the dry run's: the model's own plain tensors,
    positions and masks, would otherwise take host memory)."""
    prof = _OpProfiler(fake_mode)
    with prof:
        result = fn(*args, **kwargs)
    return HloProfile(
        flops=prof.flops,
        bytes=prof.bytes,
        bytes_fused=prof.bytes_fused,
        collective_bytes=sum(prof.coll_bytes.values()),
        collective_by_kind=dict(prof.coll_bytes),
        collective_counts=dict(prof.coll_counts),
        notes={"ops": prof.ops, "kernel_ops": dict(prof.kernel_ops),
               "peak_bytes": prof.peak, "live_bytes": prof.live},
    ), result
