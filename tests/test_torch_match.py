"""Port matcher (tclight_torch/ops/match_kernel.py, plain version on the
CPU) against the JAX package's Pallas kernel in interpret mode and its
dense XLA version: node_max within f32 rounding, node_idx equal, including
the all-ties case (b-major first occurrence)."""

import re
from pathlib import Path

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


def _tiles(plan: dict, b: int):
    """Each CTA's tiles in the kernel's order (`match_argmax_wgmma_kernel`
    walks w = (src tile * B + batch) * dst_tiles + dst tile over its range
    [cta * tiles_per_cta, ...)): (cta, src tile, batch, dst tile)."""
    n_dt, per = plan["dst_tiles"], plan["tiles_per_cta"]
    for cta in range(plan["ctas"]):
        for w in range(cta * per, min(cta * per + per, plan["tiles"])):
            yield cta, w // n_dt // b, (w // n_dt) % b, w % n_dt


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
    """K2's split (`match_plan`, as the kernel walks it): every src row of
    every batch meets each dst row of its batch exactly once, in one CTA;
    no CTA is empty, the busiest holds an even share of the tiles rounded
    up, the grid is at most one CTA an SM, and a CTA loads at most
    `src_loads` src tiles (three at the main path's shapes)."""
    n_sm = 132
    plan = tmatch.match_plan(b, s, d, c, n_sm)
    g = tmatch.match_geometry(b, s, d, c)
    assert plan["src_rows"] == g["src_rows"] == (256 if -(-c // 64) <= 6 else 128)
    assert plan["src_tiles"] == -(-s // plan["src_rows"])
    assert plan["ctas"] <= n_sm
    seen = np.zeros((b, plan["src_tiles"] * plan["src_rows"], plan["dst_tiles"] * 128), np.int32)
    count = np.zeros(plan["ctas"], np.int64)
    loads = np.zeros(plan["ctas"], np.int64)
    prev = {}
    for cta, st, bb, dt in _tiles(plan, b):
        count[cta] += 1
        if prev.get(cta) != (st, bb):
            loads[cta] += 1
            prev[cta] = (st, bb)
        r0 = st * plan["src_rows"]
        seen[bb, r0:r0 + plan["src_rows"], dt * 128:dt * 128 + 128] += 1
    assert (seen[:, :s, :d] == 1).all()
    # every CTA works, and the busiest holds no more than an even share of
    # the tiles over one CTA an SM, rounded up
    assert (count > 0).all()
    assert count.max() == -(-plan["tiles"] // min(n_sm, plan["tiles"]))
    assert count.max() == plan["tiles_per_cta"] and count.sum() == plan["tiles"]
    assert loads.max() == plan["src_loads"]
    if s > 5000:
        assert plan["src_loads"] <= 3 and plan["ctas"] >= 0.95 * n_sm


def _merge_by_keys(scores: np.ndarray, n_ranges: int):
    """The kernel's merge: the (batch, dst) pairs in b-major order are cut
    into contiguous ranges, as `match_plan` cuts the tiles (a range may
    cross a batch); each range's part of each batch finds its first
    maximiser per src row with the strictly-greater rule, packs (max, b * D
    + d) into a key, and the keys merge by max, in an arbitrary order."""
    s, b, d = scores.shape
    edges = np.linspace(0, b * d, n_ranges + 1).astype(int)
    keys = []
    for r0, r1 in zip(edges[:-1], edges[1:]):
        for bb in range(r0 // d, -(-r1 // d)):
            c0, c1 = max(r0 - bb * d, 0), min(r1 - bb * d, d)
            if c1 <= c0:
                continue
            part = torch.from_numpy(scores[:, bb, c0:c1])
            m, i = part.max(dim=1)  # the first maximiser within the range
            keys.append(tmatch.pack_match_keys(m, (bb * d + c0 + i).to(torch.int32)))
    rng = np.random.default_rng(n_ranges)
    order = rng.permutation(len(keys))
    merged = keys[order[0]]
    for j in order[1:]:
        merged = torch.maximum(merged, keys[j])
    return tmatch.unpack_match_keys(merged)


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
def test_packed_key_merge_matches_the_dense_argmax(n_chunks):
    """Ties of the max in different ranges and different batches, equal
    maxima of +0.0 and -0.0, negative maxima: the max over the packed keys
    of the ranges' partial results gives the dense argmax's first b-major
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


def _kernel_source() -> str:
    return (Path(tmatch.__file__).resolve().parent.parent / "csrc" / "match_argmax.cu").read_text()


def test_k2_argtypes_match_the_c_entry_point():
    """ctypes passes what `argtypes` says: one type per C parameter."""
    text = _kernel_source()
    m = re.search(r'extern "C" int tclight_match_argmax_bf16\(([^)]*)\)', text)
    assert m and len(m.group(1).split(",")) == len(tmatch.K2_ARGTYPES)


def test_match_geometry_matches_the_kernel_source():
    """The rules `match_geometry` and `match_plan` mirror, read from the
    CUDA source and hopper.cuh."""
    src = _kernel_source()
    hopper = (Path(tmatch.__file__).resolve().parent.parent / "csrc" / "hopper.cuh").read_text()
    for rule in ("constexpr int BN = 128;", "constexpr int SLAB = 64;",
                 "constexpr int MAX_C = 768;", "constexpr size_t SMEM_LIMIT = 232448;",
                 "row_blocks(int nkc) { return nkc <= 6 ? 2 : 1; }",
                 "return 1024 + src_bytes(mb, nkc) + nst * STAGE_BYTES + 8 * (nkc + 1 + 2 * nst);",
                 "return (size_t)128 * mb * nkc * SLAB * 2;",
                 "constexpr int BW = BN * MB / 2;",
                 "tensor_map_bshd_slabs(&ta, a, B, S, 1, C, bs)",
                 "tensor_map_bshd_slabs(&tb, bt, B, D, 1, C, BN)",
                 "mbar_init(&empty[s], 2 * 4);",
                 "const int w0 = blockIdx.x * per;",
                 "const int dt = w % n_dt;", "const int b = (w / n_dt) % B;",
                 "const int row0 = w / n_dt / B * BS;",
                 "int ctas = (int)std::min<long>(grid, n_tiles);",
                 "const int per = (int)((n_tiles + ctas - 1) / ctas);",
                 "ctas = (int)((n_tiles + per - 1) / per);",
                 "setmaxnreg_dec<24>();", "setmaxnreg_inc<240>();",
                 "int depth_slabs(int C) { return std::max((C + SLAB - 1) / SLAB, 2); }"):
        assert rule in src, rule
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in hopper and "(1ull << 62)" in hopper
    for c, (mb, stages) in ((8, (2, 8)), (40, (2, 8)), (72, (2, 8)), (320, (2, 4)),
                            (384, (2, 2)), (456, (1, 6)), (640, (1, 4)), (768, (1, 2))):
        g = tmatch.match_geometry(2, 1000, 1000, c)
        assert (g["row_blocks"], g["stages"]) == (mb, stages), c
        nkc = max(-(-c // 64), 2)  # C <= 64 reads a second slab of zeros
        assert g["smem"] == (1024 + 128 * mb * nkc * 128 + stages * 16384
                             + 8 * (nkc + 1 + 2 * stages))
        assert g["smem"] <= tmatch.SMEM_PER_CTA
        assert stages == 8 or g["smem"] + 16384 + 16 > tmatch.SMEM_PER_CTA  # as many as fit
        assert g["acc_rows"] == (128 if mb == 2 else 64)


@pytest.mark.parametrize("c", [8, 40, 72, 320, 456, 640, 768])
def test_match_geometry_tensor_maps(c):
    """K2's TMA geometry: a and bt read in place from (B, R, C) as 4-d (C,
    1, R, B) maps with strides (2C, 2C, 2CR) (multiples of 16, rising),
    boxes of 64 channels (one 128-byte swizzle row) by the src tile's rows
    or the 128 dst rows of a stage, ceil(C / 64) a row (at least two),
    channels past C zero-filled; each box a whole number of 1,024-byte
    swizzle atoms; no copies."""
    b, s, d = 2, 5940, 2700
    g = tmatch.match_geometry(b, s, d, c)
    assert g["copies"] is False
    assert g["slabs"] == max(-(-c // 64), 2) and g["zero_channels"] == 64 * g["slabs"] - c
    for name, rows, box_rows in (("a", s, g["src_rows"]), ("bt", d, 128)):
        m = g["maps"][name]
        assert m["dims"] == (c, 1, rows, b) and m["box"] == (64, 1, box_rows, 1)
        assert m["box"][0] * 2 == m["swizzle"] == 128
        assert m["strides"] == (2 * c, 2 * c, 2 * c * rows)
        assert all(st % 16 == 0 for st in m["strides"])
        assert list(m["strides"]) == sorted(m["strides"])
        assert max(m["box"]) <= 256 and (box_rows * 128) % 1024 == 0
    assert g["tx_src_slab"] == g["src_rows"] * 128 and g["tx_stage"] == 128 * 128


def _tma_box(x: torch.Tensor, m: dict, coords: tuple) -> torch.Tensor:
    """What a TMA load of map `m` at `coords` (innermost first) puts in
    shared memory before the swizzle: the box's elements in row-major
    order (outermost first), zero where a coordinate lies outside dims."""
    flat = x.reshape(-1)
    esize = x.element_size()
    box = tuple(reversed(m["box"]))
    out = torch.zeros(box, dtype=x.dtype)
    strides = (esize,) + tuple(m["strides"])
    for idx in np.ndindex(*box):
        pos = [co + i for co, i in zip(coords, reversed(idx))]
        if all(0 <= p < n for p, n in zip(pos, m["dims"])):
            out[idx] = flat[sum(p * st for p, st in zip(pos, strides)) // esize]
    return out


@pytest.mark.parametrize("c", [40, 72, 136])
def test_match_maps_read_rows_in_place_with_zero_fill(c):
    """The boxes of K2's bt map, read as TMA reads them: a stage's slabs
    hold each dst row's c channels, channels past c and rows past D read
    as zeros, and nothing of the next row or batch leaks in."""
    b, d = 2, 19
    g = tmatch.match_geometry(b, 1, d, c)
    m = dict(g["maps"]["bt"], box=(64, 1, 8, 1))  # 8 of a stage's rows, for speed
    bt = torch.arange(1, b * d * c + 1, dtype=torch.int16).reshape(b, d, c)  # 2-byte, distinct
    for bi, r0 in ((0, 0), (1, 16), (1, 8)):
        tile = torch.cat([_tma_box(bt, m, (64 * k, 0, r0, bi))[0, :, 0, :]
                          for k in range(g["slabs"])], dim=1)  # (8 rows, slabs * 64)
        want = torch.zeros(8, 64 * g["slabs"], dtype=bt.dtype)
        rows = bt[bi, r0:r0 + 8]
        want[:rows.shape[0], :c] = rows
        assert torch.equal(tile, want), (bi, r0)


def test_match_wrapper_hands_the_kernel_a_and_bt_in_place(monkeypatch):
    """K2's wrapper makes no copy: the pointers the C entry point gets are
    a's and bt's own, and the module holds no contiguous() transpose."""
    import inspect

    got = {}

    def entry(*args):
        got["args"] = args
        return 0

    monkeypatch.setattr(tmatch.kernels, "function", lambda *a, **k: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    a = torch.zeros(2, 40, 64, dtype=torch.bfloat16)
    bt = torch.zeros(2, 50, 64, dtype=torch.bfloat16)
    tmatch._launch(a, bt, 132)
    assert got["args"][:2] == (a.data_ptr(), bt.data_ptr())
    assert got["args"][5:10] == (2, 40, 50, 64, 132)
    assert all(x is y for x, y in zip(tmatch.match_operands(a, bt), (a, bt)))
    assert ".contiguous()" not in inspect.getsource(tmatch)


def test_match_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_match` builds each variant of K2 by
    text substitution: every replaced text is still in the source, each
    variant differs from the kernel (the base variant excepted), and the
    same holds for this checkout laid out as another (`--tree`)."""
    from tclight_torch import ablate_match

    texts = ablate_match.variant_sources()
    assert set(texts) == set(ablate_match.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "match_argmax_wgmma_kernel" in text
    root = Path(tmatch.__file__).resolve().parents[2]
    assert ablate_match.variant_sources(root) == texts
    assert ablate_match.SHAPES["global-L0"] == (2, 23760, 23760, 320)
    assert ablate_match.SHAPES["local-L1"] == (2, 8100, 2700, 640)
