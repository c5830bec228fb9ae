"""Atomic, step-tagged checkpointing with a manifest — twin of
``repro/train/checkpoint.py``, with the same files on disk:

    <dir>/step_00000123.tmp/...   (written first)
    <dir>/step_00000123/          (atomic rename when complete)
        manifest.json             {step, leaves: {key: {shape, dtype}}, extra}
        arrays.npz                one entry per flattened leaf

Leaves are keyed by the reference's tree paths: dict keys sorted and joined
by ``/``, a named tuple's fields as ``.name`` (``o/.mu/embed/tok``,
``o/.step``). A :class:`~repro_torch.models.model.Transformer` is stored as
the reference's params pytree, its layers stacked (``p/layers/mlp/up`` of
shape (L, d, ff)), through ``convert.lm_params_to_numpy`` and restored through
``convert.lm_params_from_numpy``, so a checkpoint is the same file whichever
package wrote it. bf16 leaves are written as the reference's are: raw 2-byte
words (``|V2`` in the npz) with the manifest's dtype ``"bfloat16"``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..convert import (
    _lm_t, bf16_to_words, is_bf16_words, lm_params_from_numpy, lm_params_to_numpy,
)
from ..models.model import Transformer, cast_model_, param_schema


def _numpy_tree(tree: Any) -> Any:
    """``tree`` as the reference's pytree of numpy arrays (bf16 as words)."""
    if isinstance(tree, Transformer):
        return lm_params_to_numpy(tree, bf16="words")
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f".{name}": _numpy_tree(getattr(tree, name)) for name in tree._fields}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (bf16_to_words(tree) if tree.dtype == torch.bfloat16
                else tree.detach().cpu().numpy())
    return np.asarray(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if is_bf16_words(a) else str(a.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Atomic write: tmp dir + rename. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(_numpy_tree(tree))
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                   for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def _restore(template: Any, data, key: str) -> Any:
    """The leaves under ``key`` in the structure, dtypes and devices of
    ``template``."""
    if isinstance(template, Transformer):
        def fill(schema, path):
            if isinstance(schema, dict):
                return {k: fill(v, f"{path}/{k}") for k, v in schema.items()}
            return data[path]

        tree = fill(param_schema(template.cfg), key)
        like = template.embed["tok"]
        model = lm_params_from_numpy(template.cfg, tree, device=like.device)
        return model if like.dtype == model.embed["tok"].dtype else cast_model_(model, like.dtype)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_restore(getattr(template, name), data, f"{key}/.{name}")
                                for name in template._fields))
    if isinstance(template, dict):
        return {k: _restore(v, data, f"{key}/{k}" if key else str(k))
                for k, v in template.items()}
    arr = data[key]
    if isinstance(template, torch.Tensor):
        t = (_lm_t(arr, template.device) if is_bf16_words(arr)
             else torch.as_tensor(arr, device=template.device))
        return t.to(template.dtype)
    return np.asarray(arr).astype(np.asarray(template).dtype)


def restore_checkpoint(directory: str, template: Any, step: Optional[int] = None):
    """Restore into the structure of ``template`` (a ``Transformer``, an
    ``OptState``, dicts of these, tensors or arrays), each leaf cast to its
    template's dtype on its device. Returns (tree, step, extra) or
    (None, None, None) when no checkpoint exists."""
    st = latest_step(directory) if step is None else step
    if st is None:
        return None, None, None
    path = os.path.join(directory, f"step_{st:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = _restore(template, data, "")
    return tree, st, manifest.get("extra", {})


def prune_checkpoints(directory: str, keep: int = 3):
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n[5:]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for st in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{st:08d}"), ignore_errors=True)

