"""Property-based guardrail test of the port, twin of
tests/test_robustness_property.py:52: no solver family returns a silently
poisoned result on randomly generated near-singular or badly scaled systems.
For every RHS column the solution is finite OR the column carries a freezing
flag, and warm-starting from any previous solution keeps it so."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import Gram, make_params, solve  # noqa: E402
from repro_torch.core.solvers import FROZEN_FLAGS  # noqa: E402

FAMILIES = {
    "cg": dict(max_iters=60, tol=1e-5, stall_window=25),
    "sgd": dict(num_steps=150, batch_size=16),
    "sdd": dict(num_steps=150, batch_size=16, step_size_times_n=1.0),
    "ap": dict(num_steps=60, block_size=16),
}


def _problem(seed, n, dup, log_noise, log_ls, scale):
    """A Gram system whose conditioning is driven by the draw: duplicated rows
    (rank deficiency), tiny noise, extreme lengthscales, badly scaled b."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.rand((n, 2), generator=gen)
    if dup:
        half = base[: n // 2]
        base = torch.cat([half, half], dim=0)[:n]
    params = make_params("se", lengthscale=10.0 ** log_ls, signal=1.0,
                         noise=10.0 ** log_noise, device="cpu")
    b = torch.randn((n, 2), generator=gen) * (10.0 ** scale)
    return Gram(x=base, params=params), b


def _no_silent_poison(res) -> None:
    finite = torch.isfinite(res.solution).all(dim=0).numpy()
    frozen = (res.flags.numpy().astype(np.int64) & FROZEN_FLAGS) != 0
    assert (finite | frozen).all(), f"non-finite column without a freezing flag ({res.flags})"


@pytest.mark.parametrize("family", sorted(FAMILIES))
@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    n=st.sampled_from([24, 48]),
    dup=st.booleans(),
    log_noise=st.sampled_from([-8, -4, -1]),
    log_ls=st.sampled_from([-2, 0, 2]),
    scale=st.sampled_from([-6, 0, 6]),
)
def test_no_silent_poison(family, seed, n, dup, log_noise, log_ls, scale):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        op, b = _problem(seed, n, dup, log_noise, log_ls, scale)
        kw = FAMILIES[family]
        res = solve(op, b, family, generator=torch.Generator().manual_seed(seed), **kw)
        _no_silent_poison(res)
        if res.converged:  # converged never co-exists with a flagged column
            assert (res.flags == 0).all()
        # warm-starting from this result (NaN columns and all) keeps the
        # invariant: a poisoned x0 is caught at initialisation
        res2 = solve(op, b, family, generator=torch.Generator().manual_seed(seed + 1),
                     x0=res.solution, **kw)
        _no_silent_poison(res2)
    finally:
        torch.set_num_threads(threads)
