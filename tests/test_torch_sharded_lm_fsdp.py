"""The sharded LM on a 2 × 2 gloo mesh under the "fsdp" profile (batch
and every weight's d_model dim over all four ranks), against the unsharded
port on the same numpy-drawn weights: one reduced config a family, with the
tolerances of ``tests/test_torch_sharded_lm.py`` (``testing/sharded_lm.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing.sharded_lm import FAMILIES, assert_case  # noqa: E402

SHAPE, PROFILE = (2, 2), "fsdp"


@pytest.mark.parametrize("check", ["forward", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_fsdp_on_a_2x2_mesh_matches_the_unsharded_port(arch, check):
    assert_case(SHAPE, PROFILE, arch, check)
