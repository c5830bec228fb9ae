"""Training-side features of the port: learning-curve prediction with the
latent Kronecker GP (``curve_gp``)."""
from .curve_gp import CurvePrediction, divergence_score, fit_curve_gp, should_stop_early

__all__ = ["CurvePrediction", "divergence_score", "fit_curve_gp", "should_stop_early"]
