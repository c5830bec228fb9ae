"""Test and benchmark support — fault injection for the robustness checks,
twin of ``repro/testing``. Not imported by the library proper."""
from .faults import (  # noqa: F401
    DenseOperator,
    FaultyFeatureOperator,
    FaultyOperator,
    nan_columns,
    near_singular_problem,
)
