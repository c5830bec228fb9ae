"""The port's façade (repro_torch.core.api.IterativeGP), its device rule, its
data copy, and its independence from JAX — on the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import regression_dataset as jregression_dataset
from repro_torch.core import CG, IterativeGP, exact_posterior
from repro_torch.core.solvers import as_spec
from repro_torch.data.pipeline import UCI_SHAPES, regression_dataset
from repro_torch.device import resolve_device
from repro_torch.serve import GPEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs on several xdist workers at once: one intra-op thread per
    # worker keeps these small CPU problems from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(n=300, d=3, seed=0):
    data = regression_dataset(n, d=d, seed=seed, n_test=64)
    return data["x"], data["y"], data["x_test"]


def test_fit_predict_matches_exact_posterior_mean():
    # CG to relative residual 1e-5 in fp32: the posterior mean agrees with the
    # Cholesky oracle to 1e-3 relative (measured ~1e-5).
    x, y, xt = _toy()
    gp = IterativeGP("matern32", lengthscale=0.8, noise=0.1,
                     spec=CG(max_iters=500, tol=1e-5), device="cpu")
    mean, var = gp.fit(x, y).predict(xt)
    info = gp.posterior(64).solve_info
    assert info.converged and info.healthy and info.matvecs == info.iterations
    assert mean.shape == var.shape == (64,)
    ep = exact_posterior(gp.params, gp.x, gp.y)
    exact = ep.mean(torch.from_numpy(xt))
    assert float((mean - exact).norm() / exact.norm()) <= 1e-3
    # 64 pathwise samples: the MC variance is within sampling error of the exact
    # one (relative standard error √(2/64) ≈ 0.18 per point; 0.5 on the mean)
    ratio = (var / ep.var(torch.from_numpy(xt))).mean().item()
    assert 0.5 < ratio < 1.5
    assert gp.posterior(64) is gp._post  # cached until the arguments change
    assert gp.sample(xt, num_samples=8).shape == (64, 8)


def test_seed_makes_runs_reproducible():
    x, y, xt = _toy(n=120)
    a = IterativeGP("se", seed=7, device="cpu").fit(x, y).predict(xt)[1]
    b = IterativeGP("se", seed=7, device="cpu").fit(x, y).predict(xt)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IterativeGP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_serves_the_gps_predict():
    # IterativeGP.engine hands the fitted GP to the serving engine on its
    # device; the engine's first predict is the posterior mean of its own fit,
    # which equals gp.predict's to CG's accuracy (both CG to 1e-6)
    x, y, xt = _toy(n=120)
    gp = IterativeGP("matern32", lengthscale=0.8, noise=0.1,
                     spec=CG(max_iters=500, tol=1e-6), device="cpu").fit(x, y)
    mean, _ = gp.predict(xt)
    eng = gp.engine(num_samples=8, num_features=256)
    assert isinstance(eng, GPEngine) and eng.device == gp.device
    assert eng.state.n == 120 and eng.spec == gp.spec
    h = eng.predict(xt[:10])
    eng.run_until_idle()
    got = h.result().value["mean"]
    assert float((got - mean[:10]).abs().max()) <= 1e-5
    with pytest.raises(RuntimeError, match="fit"):
        IterativeGP(device="cpu").engine()


def test_paths_outside_the_slice_raise():
    x, y, _ = _toy(n=50)
    # the stochastic solvers are ported: "sgd", "sdd" and "ap" run end to end
    # (SDD at a step size for n = 50: the paper's 50/n is for large n)
    for name, kw in (("sgd", dict(batch_size=16)),
                     ("sdd", dict(batch_size=16, step_size_times_n=1.0)),
                     ("ap", dict(block_size=16))):
        spec = as_spec(name, num_steps=20, **kw)
        mean, var = IterativeGP(spec=spec, device="cpu").fit(x, y).predict(x[:5])
        assert mean.shape == var.shape == (5,)
        assert bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
    with pytest.raises(RuntimeError, match="fit"):
        IterativeGP(device="cpu").predict(x)


def test_divergence_warning_names_the_flags():
    x, y, xt = _toy(n=80)
    y = y.copy()
    y[5] = np.nan
    gp = IterativeGP(device="cpu").fit(x, y)
    with pytest.warns(RuntimeWarning, match="nonfinite"):
        gp.predict(xt)


@pytest.mark.parametrize("name,n_cut", [("pol", None), ("protein", None), ("3droad", 2000)])
def test_regression_dataset_is_bit_identical(name, n_cut):
    ref = jregression_dataset(name, seed=0)
    out = regression_dataset(name, seed=0)
    assert (out["n"], out["d"]) == UCI_SHAPES[name] == (ref["n"], ref["d"])
    for k in ("x", "y", "x_test", "y_test"):
        a, b = out[k], np.asarray(ref[k])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a[:n_cut], b[:n_cut])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), mod) for f in files for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
    ]
    assert bad == []


def test_chip_smoke_refuses_without_a_card(tmp_path):
    # Here there is no card: the script must exit non-zero and print no result,
    # both from the checkout and from a directory holding only the script.
    script = ROOT / "chip_smoke.py"
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(script.read_text())
    for path in (script, lone):
        proc = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                              cwd=path.parent, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
