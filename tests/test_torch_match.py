"""Port matcher (tclight_torch/ops/match_kernel.py, plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode and its
dense XLA version: node_max within f32 rounding, node_idx equal, including
the all-ties case (b-major first occurrence)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops.match_kernel import (online_argmax_scores,
                                          online_argmax_scores_xla)
from tclight_torch.ops import match_kernel as tmatch

torch.set_num_threads(2)


@pytest.mark.parametrize("b,s,d,c", [(2, 300, 500, 64), (1, 130, 257, 40),
                                     (3, 200, 777, 32)])
def test_plain_matches_kernel_and_dense(b, s, d, c):
    rng = np.random.default_rng(s)
    a = rng.standard_normal((b, s, c)).astype(np.float32)
    bt = rng.standard_normal((b, d, c)).astype(np.float32)
    m_ref, i_ref = online_argmax_scores(jnp.asarray(a), jnp.asarray(bt),
                                        interpret=True)
    m_xla, i_xla = online_argmax_scores_xla(jnp.asarray(a), jnp.asarray(bt))
    m, i = tmatch.online_argmax_scores(torch.from_numpy(a), torch.from_numpy(bt))
    assert m.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_xla))


def test_all_ties_pick_first_b_major():
    a = np.ones((2, 8, 16), np.float32)
    bt = np.ones((2, 32, 16), np.float32)
    _, i_ref = online_argmax_scores(jnp.asarray(a), jnp.asarray(bt), interpret=True)
    _, i = tmatch.online_argmax_scores(torch.from_numpy(a), torch.from_numpy(bt))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (i.numpy() == 0).all()


def test_ties_across_batches_keep_the_first_batch():
    # the max is reached at d=5 of batch 0 and at d=2 of batch 1: b-major
    # order puts batch 0 first, whatever the dst position
    a = np.ones((2, 4, 8), np.float32)
    bt = np.zeros((2, 16, 8), np.float32)
    bt[0, 5] = 1.0
    bt[1, 2] = 1.0
    _, i_ref = online_argmax_scores_xla(jnp.asarray(a), jnp.asarray(bt))
    _, i = tmatch.online_argmax_scores(torch.from_numpy(a), torch.from_numpy(bt))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (i.numpy() == 5).all()


def test_cuda_wrapper_rejects_cpu_tensors():
    a = torch.zeros(1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        tmatch.online_argmax_scores_cuda(a, a)
