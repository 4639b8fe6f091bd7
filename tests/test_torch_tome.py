"""Port ToMe ops (tclight_torch/ops/tome.py) against the JAX package's
tclight_tpu/ops/tome.py on the same continuous random tokens (no ties) and
the same randf / flip / bank: merge indices equal, merged and unmerged
tokens within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import tome as jtome
from tclight_torch.ops import tome as ttome

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=0)


def _assert_indices_equal(mi_t, mi_j):
    for field in ("a_idx", "b_idx", "unm_idx", "src_idx", "dst_idx"):
        np.testing.assert_array_equal(getattr(mi_t, field).numpy(),
                                      np.asarray(getattr(mi_j, field)), err_msg=field)
    assert mi_t.n_total == mi_j.n_total


@pytest.mark.parametrize("f,tnum,ratio,stride", [(4, 48, 0.6, 4), (8, 20, 0.5, 2)])
def test_plan_local_levels_matches(f, tnum, ratio, stride):
    assert [tuple(s) for s in ttome.plan_local_levels(f, tnum, ratio, stride)] == \
        [tuple(s) for s in jtome.plan_local_levels(f, tnum, ratio, stride)]


@pytest.mark.parametrize("align_batch", [True, False])
@pytest.mark.parametrize("randf,f,stride", [(1, 4, 4), (3, 8, 2)])
def test_local_chain_matches(align_batch, randf, f, stride):
    rng = np.random.default_rng(10 + randf)
    b, tnum, c = 2, 30, 16
    x = rng.standard_normal((b, f * tnum, c)).astype(np.float32)
    levels_j = jtome.plan_local_levels(f, tnum, 0.6, stride)
    levels_t = ttome.plan_local_levels(f, tnum, 0.6, stride)
    merge_j = jax.jit(jtome.local_merge_sequence, static_argnums=(2, 4))
    merged_j, infos_j = merge_j(jnp.asarray(x), jnp.asarray(x), tuple(levels_j),
                                jnp.int32(randf), align_batch)
    infos_j = [mi._replace(n_total=int(mi.n_total)) for mi in infos_j]
    merged_t, infos_t = ttome.local_merge_sequence(
        torch.from_numpy(x), torch.from_numpy(x), levels_t, randf, align_batch)
    assert len(infos_t) == len(infos_j) == len(levels_j)
    for mi_t, mi_j in zip(infos_t, infos_j):
        _assert_indices_equal(mi_t, mi_j)
    np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j), **TOL)

    rows_j = jtome.local_unmerge_rows(infos_j)
    rows_t = ttome.local_unmerge_rows(infos_t)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    y = rng.standard_normal(merged_t.shape).astype(np.float32)
    np.testing.assert_allclose(
        ttome.gather_rows(torch.from_numpy(y), rows_t).numpy(),
        np.asarray(jtome.gather_rows(jnp.asarray(y), rows_j)), **TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_global_merge_matches(flip):
    rng = np.random.default_rng(20 + flip)
    b, n, c = 2, 150, 16
    local = rng.standard_normal((b, n, c)).astype(np.float32)
    bank = rng.standard_normal((b, n, c)).astype(np.float32)
    merged_j, mi_j, _ = jax.jit(jtome.global_merge, static_argnums=(4,))(
        jnp.asarray(local), jnp.asarray(bank), jnp.asarray(local),
        jnp.asarray(bank), 0.5, jnp.bool_(flip))
    mi_j = mi_j._replace(n_total=int(mi_j.n_total))
    merged_t, mi_t, _ = ttome.global_merge(
        torch.from_numpy(local), torch.from_numpy(bank), torch.from_numpy(local),
        torch.from_numpy(bank), 0.5, flip)
    _assert_indices_equal(mi_t, mi_j)
    np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j), **TOL)

    rows_j = jtome.global_unmerge_rows(mi_j, jnp.bool_(flip), n)
    rows_t = ttome.global_unmerge_rows(mi_t, flip, n)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    # the bank the block carries on, and a composed unmerge
    np.testing.assert_allclose(
        ttome.gather_rows(merged_t, rows_t).numpy(),
        np.asarray(jtome.gather_rows(merged_j, rows_j)), **TOL)
    inner = rng.integers(0, n, size=(1, 3 * n))
    np.testing.assert_array_equal(
        ttome.compose_rows(rows_t, torch.from_numpy(inner)).numpy(),
        np.asarray(jtome.compose_rows(rows_j, jnp.asarray(inner))))
