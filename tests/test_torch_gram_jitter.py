"""The Gram kernel's in-kernel signal and jitter (``gram_matvec_scaled``, the
twin of ``gram_matvec_pallas(..., signal=, jitter=)``) on the CPU: its plain
version against the Pallas kernel in interpret mode at the reference's
tolerance, the defaults giving the unscaled core bit for bit, and the jitter
refused where z is not x, as the reference refuses it. The kernel itself runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gram_matvec import gram_matvec_pallas
from repro_torch.kernels.gram_matvec import gram_matvec, gram_matvec_scaled

KINDS = ["se", "matern12", "matern32", "matern52"]
#: the reference's fused-vs-dense Gram tolerance (tests/test_kernels_pallas.py:
#: 23) and the bf16 kernels' against their plain versions (the cast points
#: exactly, fp32 sums; tests/test_torch_precision.py), of max(1, scale)
TOLS = {"fp32": 2e-4, "bf16": 2e-3}


def _points(rng, n, d):
    # a 1/8 grid: Matérn-1/2's diagonal d² is exactly 0 in both packages
    return (np.round(rng.uniform(-2.0, 2.0, size=(n, d)) * 8) / 8).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, err


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("signal,jitter", [(1.7, 0.3), (0.45, 1e-2), (1.0, 0.5), (2.5, 0.0)])
def test_square_signal_and_jitter_match_pallas(kind, precision, signal, jitter):
    rng = np.random.default_rng(len(kind) + int(10 * signal))
    x, v = _points(rng, 256, 3), rng.normal(size=(256, 5)).astype(np.float32)
    want = gram_matvec_pallas(jnp.asarray(x), jnp.asarray(x), jnp.asarray(v), kind=kind,
                              signal=signal, jitter=jitter, block_m=128, block_n=128,
                              interpret=True, precision=precision)
    before = (gram_matvec.launches, gram_matvec.bf16_launches)
    got = gram_matvec_scaled(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(v),
                             kind=kind, signal=signal, jitter=jitter, precision=precision)
    assert (gram_matvec.launches, gram_matvec.bf16_launches) == before  # the plain version
    _close(got.numpy(), want, TOLS[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["se", "matern32"])
def test_cross_signal_matches_pallas(kind, precision):
    rng = np.random.default_rng(7)
    x, z = _points(rng, 128, 4), _points(rng, 384, 4)
    v = rng.normal(size=(384, 2)).astype(np.float32)
    want = gram_matvec_pallas(jnp.asarray(x), jnp.asarray(z), jnp.asarray(v), kind=kind,
                              signal=0.8, block_m=128, block_n=128, interpret=True,
                              precision=precision)
    got = gram_matvec_scaled(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(v),
                             kind=kind, signal=0.8, precision=precision, block=128)
    _close(got.numpy(), want, TOLS[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_defaults_are_the_unscaled_core_bit_for_bit(precision):
    rng = np.random.default_rng(3)
    x, z = torch.from_numpy(_points(rng, 70, 3)), torch.from_numpy(_points(rng, 50, 3))
    v = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    got = gram_matvec_scaled(x, z, v, kind="matern52", precision=precision)
    torch.testing.assert_close(got, gram_matvec(x, z, v, kind="matern52", precision=precision),
                               rtol=0, atol=0)


def test_jitter_needs_the_square_operator():
    rng = np.random.default_rng(4)
    x, z = torch.from_numpy(_points(rng, 64, 2)), torch.from_numpy(_points(rng, 96, 2))
    v = torch.zeros((96, 1))
    with pytest.raises(ValueError, match="z = x"):
        gram_matvec_scaled(x, z, v, kind="se", jitter=0.1)
    # the reference asserts the same square blocking
    with pytest.raises(AssertionError):
        gram_matvec_pallas(jnp.asarray(x.numpy()), jnp.asarray(z.numpy()),
                           jnp.asarray(v.numpy()), kind="se", jitter=0.1, block_m=32,
                           block_n=32, interpret=True)
    with pytest.raises(ValueError, match="kind"):
        gram_matvec_scaled(x, x, torch.zeros((64, 1)), kind="tanimoto")
