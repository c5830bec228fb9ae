"""Step functions driven by ``launch/serve.py`` — the serving half of
``repro/launch/steps.py``:

    prefill_step(model, cache, batch)        → (logits, cache)
    serve_step(model, cache, token, index)   → (next_token, logits, cache)

Decoding is greedy (``argmax``; ties go to the first index in both packages).
The training step is not ported yet: ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import model as model_lib


def make_prefill_step(cfg: ModelConfig, *, backend: str = "auto"):
    """``backend`` routes the prompt's attention (``ops.flash_attention``)."""

    def prefill_step(model, cache: dict, batch: dict):
        return model_lib.prefill(cfg, model, batch, cache, backend=backend)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache: dict, token: torch.Tensor, cache_index: int):
        logits, cache = model_lib.decode_step(cfg, model, token, cache, cache_index)
        next_token = torch.argmax(logits[:, -1], dim=-1)[:, None]
        return next_token, logits, cache

    return serve_step
