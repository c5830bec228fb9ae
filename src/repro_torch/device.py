"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a card raises
    ``RuntimeError``: the port never carries on quietly on the CPU. Pass
    ``device="cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA card by default and none is visible; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def make_generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
