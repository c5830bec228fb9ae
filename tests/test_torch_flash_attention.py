"""The port's attention entry point (repro_torch.kernels.ops.flash_attention)
against the reference's Pallas flash kernel in interpret mode, on the CPU.

On CPU tensors the port takes the kernel's plain version (materialised logits,
``ref.flash_attention_ref``); the CUDA kernel itself is held against that
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ops import flash_attention as jflash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import BLOCKS, _FlashAttentionFn, query_blocks
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.kernels.ref import flash_attention_ref

#: both sides in fp32 with the same softmax: measured ~1e-6; the reference's
#: own kernel-vs-ref tolerance is 2e-3 (tests/test_kernels_pallas.py:72)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 130, 2, 1, 32),  # the reference's cases
    (1, 130, 8, 2, 128),  # llama3-8b's head geometry (GQA 4, d 128), s padded to 192
])
def test_flash_attention_matches_pallas_kernel(causal, b, s, hq, hkv, d):
    q, k, v = _qkv(s + hq, b, s, hq, hkv, d)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            block_q=64, block_k=64, interpret=True))
    ops.reset_attention_trace_counts()
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": 0, "plain": 1}
    assert out.shape == (b, s, hq, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(0, 2, 70, 4, 2, 64))
    launches = flash_kernel.launches
    ref = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(flash_kernel(q, k, v, causal=True), ref, rtol=0, atol=0)
    # "cuda" on CPU tensors is the wrapper's plain route too, counted as asked
    ops.reset_attention_trace_counts()
    torch.testing.assert_close(ops.flash_attention(q, k, v, backend="cuda"), ref,
                               rtol=0, atol=0)
    assert ops.ATTENTION_TRACE_COUNTS == {"cuda": 1, "plain": 0}
    assert flash_kernel.launches == launches


def test_plain_version_is_causal_and_maps_the_heads():
    # GQA: query head h reads key/value head h // group; causal: row r sees
    # only keys 0..r (a change at key r moves no output row before r)
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 40, 4, 2, 64))
    out = flash_attention_ref(q, k, v, causal=True)
    dense = flash_attention_ref(q, k[:, :, [0, 0, 1, 1]], v[:, :, [0, 0, 1, 1]], causal=True)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)
    k2 = k.clone()
    k2[:, 20] += 1.0
    out2 = flash_attention_ref(q, k2, v, causal=True)
    torch.testing.assert_close(out2[:, :20], out[:, :20], rtol=0, atol=0)
    assert not torch.allclose(out2[:, 20:], out[:, 20:])


def test_bf16_and_pallas_raise():
    # bf16 inputs run (the plain version on CPU tensors, with the kernel's
    # casts: a bf16 output within the reference's 3e-2 of fp32,
    # tests/test_kernels_pallas.py:84); a mix of dtypes and the reference's
    # backend names raise
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 64, 2, 2, 64))
    out = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = flash_attention_ref(q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float())
    torch.testing.assert_close(out.float(), ref, rtol=3e-2, atol=3e-2)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.flash_attention(q.bfloat16(), k, v.bfloat16())
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.flash_attention(q, k, v, backend="chunked")


@pytest.mark.parametrize("precision,block", [("fp32", 64), ("bf16", 128)])
def test_query_blocks_at_each_precisions_block(precision, block):
    # a block of query rows is 64 rows in the fp32 kernel, 128 in the bf16
    # one; a launch past 65,535 blocks is refused before any kernel is
    # reached, naming its own block
    assert BLOCKS[precision] == block
    assert [query_blocks(s, precision) for s in (1, block - 1, block, block + 1, 1000)] == [
        1, 1, 1, 2, -(-1000 // block)]
    assert query_blocks(65535 * block, precision) == 65535
    with pytest.raises(ValueError, match=f"65536 query blocks of {block} rows exceed"):
        query_blocks(65535 * block + 1, precision)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("wrt", [(0, 1, 2), (0,), (1, 2)])
def test_function_gives_the_plain_versions_gradients(causal, wrt):
    # the Function that wraps the kernel's launch, given the plain version as
    # its forward: its output and the gradients its backward recomputes
    # equal autograd's through the plain version, for whichever inputs ask
    q, k, v = map(torch.from_numpy, _qkv(3, 2, 70, 4, 2, 32))
    gbar = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    results = []
    for fn in (lambda *a: _FlashAttentionFn.apply(*a, causal, flash_attention_ref),
               lambda *a: flash_attention_ref(*a, causal=causal)):
        ins = [t.clone().requires_grad_(i in wrt) for i, t in enumerate((q, k, v))]
        out = fn(*ins)
        grads = torch.autograd.grad(torch.sum(gbar * out), [ins[i] for i in wrt])
        results.append((out.detach(), grads))
    (out_f, grads_f), (out_p, grads_p) = results
    torch.testing.assert_close(out_f, out_p, rtol=0, atol=0)
    for a, b in zip(grads_f, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
