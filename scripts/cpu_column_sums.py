#!/usr/bin/env python3
"""CG's column dots and norms on the CPU: how far a serving request's payload
moves with its batch's width, and what a width-independent float32 sum does
to CG's iteration counts.

    PYTHONPATH=src python scripts/cpu_column_sums.py

For each way of summing a column (``dim0``, the port's ``torch.sum`` over
dim 0 of the (n, s) tensor, and three sums that give a column the same bits
at every width: ``pad64``, the columns zero-padded to a multiple of 64;
``groups8``, each group of 8 columns summed as its own (n, 8) block; ``tree``,
a pairwise tree of elementwise adds; ``rows``, the columns as the contiguous
rows of the transpose, each summed over its last dimension), it prints one
JSON line with

* ``payload_gap``: the largest difference, over its scale, between one
  sample request's payload served by an engine with 8-column buckets and by
  one with 4-column buckets (the problem of tests/test_serve.py:35-43, made
  with numpy: 96 uniform points in 2-D, Matérn-3/2, ℓ = 0.5, σ² = 0.1);
* ``cg_iterations``: CG(400, 1e-6) on 400 normal points in 3-D (Matérn-3/2,
  ℓ = 0.8, σ² = 0.3), one column plain and with Jacobi, and 5 columns.

Runs on the CPU, one torch thread, in a few seconds. With ``--tests`` it
also runs, for each sum, the port's parity tests whose CG iteration counts
sit within one or two of the JAX package's (``KNIFE_EDGE_TESTS``; they
import JAX, so run with ``JAX_PLATFORMS=cpu`` beside the JAX package) and
prints which pass, with each failure's assertion.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import CG, make_params  # noqa: E402
from repro_torch.core.operators import Gram  # noqa: E402
from repro_torch.core.solvers import Jacobi, solve  # noqa: E402
from repro_torch.core.solvers import base as solver_base  # noqa: E402
from repro_torch.core.solvers import cg as solver_cg  # noqa: E402
from repro_torch.serve import GPEngine  # noqa: E402


def _pad64(p):
    s = p.shape[1]
    return torch.nn.functional.pad(p, (0, (-s) % 64)).sum(dim=0)[:s]


def _groups8(p):
    n, s = p.shape
    p = torch.nn.functional.pad(p, (0, (-s) % 8))
    return p.view(n, -1, 8).transpose(0, 1).contiguous().sum(dim=1).reshape(-1)[:s]


def _rows(p):
    return p.T.contiguous().sum(dim=1)


def _tree(p):
    n = p.shape[0]
    t = torch.nn.functional.pad(p, (0, 0, 0, (1 << max(0, (n - 1).bit_length())) - n))
    while t.shape[0] > 1:
        t = t[:t.shape[0] // 2] + t[t.shape[0] // 2:]
    return t[0]


SUMS = {"dim0": None, "pad64": _pad64, "groups8": _groups8, "tree": _tree, "rows": _rows}
ROOT = Path(__file__).resolve().parents[1]
KNIFE_EDGE_TESTS = (
    "tests/test_torch_serve.py::test_row_and_column_buckets_do_not_change_payloads",
    "tests/test_torch_precond.py::test_precond_specs_match_reference_counts",
    "tests/test_torch_serve_state.py::test_fit_state_matches_the_reference_on_its_draws",
    "tests/test_torch_solvers.py::test_pol_3750_iterations_match_committed_bench",
    "tests/test_torch_mll.py::test_mll_grad_matches_jax",
)


def _use(name):
    """Point CG's dots and finalize's norms at the sum ``name`` (on CPU tensors)."""
    col_sum = SUMS[name]
    if col_sum is None:
        solver_cg._col_dot = lambda a, b: torch.sum(a * b, dim=0)
        norm = lambda a: torch.linalg.norm(a, dim=0)  # noqa: E731
    else:
        solver_cg._col_dot = lambda a, b: col_sum(a * b)
        norm = lambda a: torch.linalg.vector_norm(a.T.contiguous(), dim=1)  # noqa: E731
    solver_cg._col_norm = solver_base._col_norm = norm


def payload_gap() -> float:
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(96, 2)).astype(np.float32)
    y = (np.sin(4.0 * x[:, 0]) + 0.5 * np.cos(3.0 * x[:, 1])).astype(np.float32)
    params = make_params("matern32", lengthscale=0.5, signal=1.0, noise=0.1, d=2,
                         device="cpu")
    out = []
    for cols in (8, 4):
        eng = GPEngine(params, x, y, device="cpu", spec=CG(max_iters=300, tol=1e-4),
                       num_samples=4, num_features=128, col_bucket_min=cols,
                       row_bucket_min=2 * cols)
        h = eng.sample(x[:5], num_samples=3, seed=5)
        eng.run_until_idle()
        assert h.result().metrics["bucket_columns"] == cols
        out.append(np.asarray(h.result().value["samples"]))
    return float(np.abs(out[0] - out[1]).max() / max(1.0, np.abs(out[1]).max()))


def cg_iterations() -> dict:
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    y = torch.sin(2.0 * x[:, 0]) + torch.cos(x[:, 1] + x[:, 2])
    params = make_params("matern32", lengthscale=0.8, signal=1.0, noise=0.3, d=3,
                         device="cpu")
    op = Gram(x=x, params=params)
    b5 = torch.cat([y[:, None], torch.from_numpy(rng.normal(size=(400, 4)).astype(np.float32))],
                   dim=1)
    return dict(one_column=solve(op, y, CG(max_iters=400, tol=1e-6)).iterations,
                one_column_jacobi=solve(op, y, CG(max_iters=400, tol=1e-6,
                                                  precond=Jacobi())).iterations,
                five_columns=solve(op, b5, CG(max_iters=400, tol=1e-6)).iterations)


def knife_edge_tests() -> dict:
    """{test id: "passed" or the failure's assertion} of KNIFE_EDGE_TESTS
    under the sum in use."""
    import pytest

    class Collect:
        def __init__(self):
            self.out = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call":
                lines = str(report.longrepr).splitlines()
                said = [ln[1:].strip() for ln in lines if ln.startswith("E ")][:3]
                self.out[report.nodeid.split("::", 1)[1]] = (
                    "passed" if report.passed else " / ".join(said or lines[-1:]))

    collect = Collect()
    pytest.main(["-q", "-p", "no:cacheprovider", "--rootdir", str(ROOT),
                 *(str(ROOT / t) for t in KNIFE_EDGE_TESTS)], plugins=[collect])
    return collect.out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", action="store_true",
                    help="also run the knife-edge parity tests under each sum")
    ap.add_argument("--sums", nargs="+", choices=list(SUMS), default=list(SUMS),
                    help="the sums to try (default: all)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for name in args.sums:
        _use(name)
        line = dict(sum=name, payload_gap=payload_gap(), cg_iterations=cg_iterations())
        if args.tests:
            line["tests"] = knife_edge_tests()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
