"""GP posterior serving engine — continuous batching of predict/sample/Thompson
queries over shared multi-RHS solves; twin of ``repro/serve``, with the same
public names."""
from .engine import EngineOverloaded, GPEngine  # noqa: F401
from .metrics import EngineStats, percentile  # noqa: F401
from .request import (  # noqa: F401
    Completion,
    KINDS,
    PREDICT,
    Request,
    RequestHandle,
    SAMPLE,
    SOLVE_KINDS,
    THOMPSON,
)
from .scheduler import BatchPlan, FIFOScheduler, bucket  # noqa: F401
from .state import (  # noqa: F401
    PosteriorState,
    WarmStartCache,
    extend_state,
    fit_state,
    hypers_fingerprint,
    update_state_lowrank,
)
