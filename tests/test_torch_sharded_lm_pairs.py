"""The sharded LM on two-rank gloo meshes: 1 × 2 under "tp" (tensor
parallel only: heads, MLP, experts and vocab over "model") and 2 × 1 under
"fsdp" (data parallel, the weights' d_model dim over "data"), against the
unsharded port on the same numpy-drawn weights: one reduced config a family,
with the tolerances of ``tests/test_torch_sharded_lm.py``. Both meshes'
ranks run at once.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing.sharded_lm import FAMILIES, assert_case, prefetch  # noqa: E402

MESHES = {"1x2-tp": ((1, 2), "tp"), "2x1-fsdp": ((2, 1), "fsdp")}


@pytest.fixture(scope="module", autouse=True)
def _both_meshes_at_once():
    prefetch(*MESHES.values())


@pytest.mark.parametrize("check", ["forward", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_rank_meshes_match_the_unsharded_port(mesh, arch, check):
    assert_case(*MESHES[mesh], arch, check)
