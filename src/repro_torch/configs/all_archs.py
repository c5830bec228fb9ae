"""Imports every per-arch config module so the registry is populated."""
from . import (  # noqa: F401
    dbrx_132b,
    deepseek_v2_236b,
    deepseek_coder_33b,
    minitron_8b,
    llama3_8b,
    olmo_1b,
    whisper_tiny,
    jamba_1_5_large_398b,
    mamba2_130m,
    qwen2_vl_7b,
)
