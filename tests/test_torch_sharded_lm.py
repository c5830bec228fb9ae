"""The sharded LM (``models/sharding_ctx``, ``launch/sharding``) on a 2 × 2
gloo mesh under the "tp" profile, against the unsharded port on the same
numpy-drawn weights: one reduced config a family (llama3-8b, dbrx-132b,
deepseek-v2-236b, mamba2-130m, jamba, whisper-tiny, qwen2-vl-7b).

Each family's ``forward_train`` logits, a prefill and two greedy decode
steps within 1e-5 of the unsharded logits' scale; one train step's loss
within 1e-5, its gradients and the updated parameters within 1e-4 of each
leaf's scale (the parameters where Adam's first step is well posed:
``testing/sharded_lm.py``). MoE cases first check the router's top-k margin
over every routing of the unsharded runs. The four ranks run once for the
module (``testing/sharded_lm.run_cases``), ~2 min on one worker.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing.sharded_lm import FAMILIES, assert_case  # noqa: E402

SHAPE, PROFILE = (2, 2), "tp"


@pytest.mark.parametrize("check", ["forward", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_on_a_2x2_mesh_matches_the_unsharded_port(arch, check):
    assert_case(SHAPE, PROFILE, arch, check)
