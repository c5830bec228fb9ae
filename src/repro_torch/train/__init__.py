"""Training: AdamW (``optim``), atomic checkpoints (``checkpoint``), gradient
compression with error feedback (``compress``), the training loop
(``trainer``), and learning-curve prediction with the latent Kronecker GP
(``curve_gp``)."""
from .checkpoint import latest_step, prune_checkpoints, restore_checkpoint, save_checkpoint
from .compress import (
    Compressed, compress, compress_with_feedback, decompress, init_error_state,
    tree_compress_with_feedback, tree_decompress,
)
from .curve_gp import CurvePrediction, divergence_score, fit_curve_gp, should_stop_early
from .optim import AdamWConfig, OptState, adamw_update, init_opt_state
from .trainer import StragglerReport, Trainer, TrainerConfig

__all__ = [
    "AdamWConfig", "Compressed", "CurvePrediction", "OptState", "StragglerReport", "Trainer",
    "TrainerConfig", "adamw_update", "compress", "compress_with_feedback", "decompress",
    "divergence_score", "fit_curve_gp", "init_error_state", "init_opt_state", "latest_step",
    "prune_checkpoints", "restore_checkpoint", "save_checkpoint", "should_stop_early",
    "tree_compress_with_feedback", "tree_decompress",
]
