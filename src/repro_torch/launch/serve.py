"""Serving launcher: batched prefill + greedy decode — twin of
``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch llama3-8b              # on the card
    python -m repro_torch.launch.serve --arch olmo-1b --reduced --device cpu
    python -m repro_torch.launch.serve --arch mamba2-130m                # on the card
    python -m repro_torch.launch.serve --arch whisper-tiny --reduced --device cpu

Weights are random, drawn from ``--seed`` as the reference's launcher draws
them: the repository holds no checkpoint. whisper's stub frames and
qwen2-vl's stub patch embeddings are ones, as the reference's launcher gives
them.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs.base import get_config, list_configs
from ..data.pipeline import token_batch
from ..device import make_generator, resolve_device
from ..models import model as model_lib
from . import steps as steps_lib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg, model, tokens: torch.Tensor, max_len: int, gen: int,
             extra_inputs: Optional[dict] = None, *, backend: str = "auto"):
    """Prefill the prompt ``tokens`` (b, prompt_len) with ``extra_inputs``
    (whisper's ``frames``, qwen2-vl's ``vision_embeds``), then greedy-decode
    ``gen`` tokens into a cache of ``max_len`` positions. Decode goes on from
    position prompt_len, as the reference's does.

    Returns ``(tokens, timings)``: ``tokens`` is (b, gen) and ``timings`` has
    separate ``prefill_s`` and ``decode_s`` walls, each ended by a device
    synchronisation on the card, so the split is real and not dispatch time.
    ``backend`` routes the prompt's attention (``ops.flash_attention``)."""
    b, prompt_len = tokens.shape
    dev = tokens.device
    cache = model_lib.zero_cache(cfg, b, max_len, torch.float32, dev)
    prefill = steps_lib.make_prefill_step(cfg, backend=backend)
    serve_step = steps_lib.make_serve_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, cache, dict(extra_inputs or {}, tokens=tokens))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(gen - 1):
        tok, _, cache = serve_step(model, cache, tok, prompt_len + i)
        out.append(tok)
    result = torch.cat(out, dim=1)
    _sync(dev)
    return result, {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = model_lib.init_model_params(cfg, make_generator(args.seed, dev), device=dev)
    batch = token_batch(args.seed, 0, args.batch, args.prompt_len, cfg.vocab_size, device=dev)
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.ones((args.batch, cfg.encoder_seq, cfg.d_model), device=dev)
    if cfg.family == "vlm":
        extra["vision_embeds"] = torch.ones((args.batch, cfg.vision_tokens, cfg.d_model),
                                            device=dev)
    toks, timings = generate(cfg, model, batch["tokens"], args.prompt_len + args.gen, args.gen,
                             extra)
    dt = timings["prefill_s"] + timings["decode_s"]
    # the decode phase emits gen - 1 tokens a row (prefill's argmax gives the
    # first); a short decode can finish inside timer resolution
    decode_s = timings["decode_s"]
    decoded = args.batch * (args.gen - 1)
    rate = f"{decoded / decode_s:.1f} tok/s" if decode_s > 0 else "n/a"
    print(f"[serve] generated {tuple(toks.shape)} in {dt:.2f}s on {dev} "
          f"(prefill {timings['prefill_s']:.2f}s, decode {decode_s:.2f}s, {rate})")
    print(toks[0].tolist())


if __name__ == "__main__":
    main()
