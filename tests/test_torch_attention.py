"""Port attention (tclight_torch/ops/attention.py) against the JAX package:
the plain online-softmax version against `_flash_attention_xla` and against
the Pallas kernel run in interpret mode, and the plain short-KV attention
against `dot_product_attention`. f32 inputs made with numpy from a seed;
tolerances as in tests/test_ops_attention.py (f32 summation order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import attention as jattn
from tclight_torch.ops import attention as tattn

torch.set_num_threads(2)


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d))]


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 100, 600, 4, 40),     # one ragged kv chunk
    (1, 33, 1500, 2, 16),     # two kv chunks, the second ragged
    (2, 64, 2048, 2, 8),      # kv an exact multiple of the chunk
])
def test_flash_plain_matches_xla(b, sq, skv, h, d):
    q, k, v = _qkv(0, b, sq, skv, h, d)
    scale = 1.0 / np.sqrt(d)
    ref = jattn._flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale)
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 300, 300, 2, 40),     # one block, ragged
    (1, 130, 1500, 1, 24),    # two kv blocks, the last ragged
])
def test_flash_plain_matches_pallas_interpret(b, sq, skv, h, d, monkeypatch):
    from jax.experimental import pallas as pl

    q, k, v = _qkv(1, b, sq, skv, h, d)
    scale = 1.0 / np.sqrt(d)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    ref = jattn._flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), scale)
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("sq,skv", [(50, 77), (300, 512)])
def test_dot_product_attention_matches(sq, skv):
    q, k, v = _qkv(2, 2, sq, skv, 4, 40)
    ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_flash_scale_is_a_runtime_argument():
    q, k, v = _qkv(4, 1, 16, 700, 1, 8)
    ref = jattn._flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 0.5)
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale=0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 8, 8, 1, 8))
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        tattn.flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), 1.0)
