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


def _units(plan: dict, b: int, d: int):
    """The units of `plan` in the kernel's order (`match_argmax_wgmma_kernel`
    walks u = (batch * chunks + chunk) * src_tiles + src tile): (src tile,
    batch, first dst row, end dst row)."""
    n_st, nc, tpc = plan["src_tiles"], plan["chunks"], plan["tiles_per_chunk"]
    for u in range(plan["units"]):
        st, ch, bb = u % n_st, (u // n_st) % nc, u // n_st // nc
        d0 = ch * tpc * tmatch.DST_TILE
        yield st, bb, d0, min(d0 + tpc * tmatch.DST_TILE, d)


@pytest.mark.parametrize("b,s,d,c", [
    (2, 23760, 23760, 320),   # level-0 global merge
    (2, 32400, 10800, 320),   # level-0 local merge
    (2, 5940, 5940, 640),     # level-1 global merge
    (2, 8100, 2700, 640),     # level-1 local merge
    (3, 300, 1000, 456),      # B = 3, ragged, 128-row src tiles
    (1, 1, 1, 8),             # D smaller than one tile
    (2, 257, 129, 40),        # one row past a src tile and a dst tile
])
def test_match_plan_covers_every_dst_row_once(b, s, d, c):
    """K2's split (`match_plan`, as the kernel walks it): for every src
    tile the units cover each (batch, dst row) exactly once, every unit
    holds whole 128-row dst tiles and at least one, the grid is at most
    the SM count, and at the main path's shapes the busiest block has at
    most 12% more work than an even share."""
    n_sm = 132
    plan = tmatch.match_plan(b, s, d, c, n_sm)
    assert plan["src_rows"] == (256 if -(-c // 64) <= 6 else 128)
    assert plan["src_tiles"] == -(-s // plan["src_rows"])
    assert plan["grid"] == min(n_sm, plan["units"])
    seen = np.zeros((plan["src_tiles"], b, d), np.int32)
    for st, bb, d0, d1 in _units(plan, b, d):
        assert d0 % tmatch.DST_TILE == 0 and d0 < d1 <= d
        seen[st, bb, d0:d1] += 1
    assert (seen == 1).all()
    cost = [-(-(d1 - d0) // tmatch.DST_TILE) + 1 for _, _, d0, d1 in _units(plan, b, d)]
    busiest = np.bincount(np.arange(len(cost)) % plan["grid"], weights=cost).max()
    assert busiest == plan["busiest_tiles"]
    if s > 5000:
        assert busiest <= 1.12 * sum(cost) / plan["grid"]


def _merge_by_keys(scores: np.ndarray, n_chunks: int):
    """The kernel's merge: each (batch, dst chunk) finds its first maximiser
    per src row with the strictly-greater rule, packs (max, b * D + d)
    into a key, and the keys merge by max, in an arbitrary order."""
    s, b, d = scores.shape
    edges = np.linspace(0, d, n_chunks + 1).astype(int)
    keys = []
    for bb in range(b):
        for c0, c1 in zip(edges[:-1], edges[1:]):
            if c1 == c0:
                continue
            part = torch.from_numpy(scores[:, bb, c0:c1])
            m, i = part.max(dim=1)  # the first maximiser within the chunk
            keys.append(tmatch.pack_match_keys(m, (bb * d + c0 + i).to(torch.int32)))
    rng = np.random.default_rng(n_chunks)
    order = rng.permutation(len(keys))
    merged = keys[order[0]]
    for j in order[1:]:
        merged = torch.maximum(merged, keys[j])
    return tmatch.unpack_match_keys(merged)


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
def test_packed_key_merge_matches_the_dense_argmax(n_chunks):
    """Ties of the max in different dst chunks and different batches, equal
    maxima of +0.0 and -0.0, negative maxima: the max over the packed keys
    of the chunks' partial results gives the dense argmax's first b-major
    maximiser, and its value."""
    rng = np.random.default_rng(0)
    s, b, d = 64, 3, 50
    scores = rng.integers(-4, 3, (s, b, d)).astype(np.float32) * 0.5
    scores[0] = -1.0
    scores[0, 1, 3] = -0.0                 # -0.0 first in b-major order
    scores[0, 2, 7] = 0.0
    scores[1] = -1.0
    scores[1, 2, 40] = -0.0
    scores[1, 0, 45] = 0.0                 # +0.0 first: equal maxima
    scores[2] = -3.0                       # all negative, ties everywhere
    scores[3, :, :] = 1.0                  # every pair ties
    m, i = _merge_by_keys(scores, n_chunks)
    flat = scores.reshape(s, b * d)
    np.testing.assert_array_equal(i.numpy(), flat.argmax(axis=1))
    np.testing.assert_array_equal(m.numpy(), flat.max(axis=1))
    assert i[0] == 1 * d + 3 and i[1] == 45 and i[3] == 0
    # and the plain version on the same scores (a[b] holds them, bt is the
    # identity)
    _, ir = tmatch.online_argmax_scores_plain(
        torch.from_numpy(scores).permute(1, 0, 2).contiguous(),
        torch.eye(d)[None].repeat(b, 1, 1))
    np.testing.assert_array_equal(i.numpy(), ir.numpy())


def test_packed_keys_order_as_floats_then_first_index():
    vals = torch.tensor([-np.inf, -2.5, -1e-30, -0.0, 0.0, 1e-30, 1.0, 3.0e38])
    keys = tmatch.pack_match_keys(vals, torch.zeros(len(vals), dtype=torch.int32))
    assert keys[3] == keys[4]  # -0.0 and +0.0
    assert (keys[1:3] > keys[:2]).all() and (keys[5:] > keys[4:-1]).all()
    idx = torch.tensor([0, 1, 2**31 - 1], dtype=torch.int32)
    k = tmatch.pack_match_keys(torch.ones(3), idx)
    assert k[0] > k[1] > k[2]
    m, i = tmatch.unpack_match_keys(tmatch.pack_match_keys(vals, torch.arange(8, dtype=torch.int32)))
    np.testing.assert_array_equal(m.numpy(), np.where(vals.numpy() == 0, 0.0, vals.numpy()))
    np.testing.assert_array_equal(i.numpy(), np.arange(8))


def test_k2_argtypes_match_the_c_entry_point():
    """ctypes passes what `argtypes` says: one type per C parameter."""
    import re
    from pathlib import Path

    text = (Path(tmatch.__file__).resolve().parent.parent / "csrc" / "match_argmax.cu").read_text()
    m = re.search(r'extern "C" int tclight_match_argmax_bf16\(([^)]*)\)', text)
    assert m and len(m.group(1).split(",")) == len(tmatch.K2_ARGTYPES)
    for rule in ("nkc <= 6 ? 2 : 1", "constexpr int BN = 128;", "constexpr int KC = 64;",
                 "const int st = u % n_st;", "const int c = (u / n_st) % nc;",
                 "const int b = u / n_st / nc;"):
        assert rule in text, rule
