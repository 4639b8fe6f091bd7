"""Port attention (tclight_torch/ops/attention.py) against the JAX package:
the plain online-softmax version against `_flash_attention_xla` and against
the Pallas kernel run in interpret mode, and the plain short-KV attention
against `dot_product_attention`. f32 inputs made with numpy from a seed;
tolerances as in tests/test_ops_attention.py (f32 summation order)."""

import functools
from pathlib import Path

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


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 80, 96, 128, 144, 160])
def test_flash_geometry_tensor_maps(d):
    """K1's TMA geometry: q, k and v read in place from (B, S, H, D) at
    every head dim, as 4-d (D, H, S, B) maps with strides (2D, 2DH, 2DHS)
    (multiples of 16, rising), boxes of 64 dims (one 128-byte swizzle row)
    by a tile's rows, ceil(dp / 64) of them a row, dims past d zero-filled;
    no copies. Three consumer warpgroups (192 q rows) up to dp 64, else
    two (128); 128-key tiles up to dp 128, 64 above; 4 stages up to dp 64,
    else 3; the p.v width dp; the row sums on the tensor cores at d = dp -
    8 up to dp 64; a ring that fits the block's shared memory in whole
    1,024-byte swizzle atoms."""
    b, sq, skv, h = 2, 35640, 1031, 8
    g = tattn.flash_geometry(b, sq, skv, h, d)
    assert g["dp"] % 16 == 0 and d <= g["dp"] < d + 16
    assert g["slabs"] == -(-g["dp"] // 64) and g["zero_dims"] == 64 * g["slabs"] - d
    assert g["kv_copies"] is False
    assert g["consumers"] == (3 if g["dp"] <= 64 else 2) and g["row_blocks"] == 1
    assert g["q_rows"] == 64 * g["consumers"] and g["threads"] == 128 * (1 + g["consumers"])
    # a consumer's registers: 65,536 a block less the producer's 24 a thread
    assert g["registers"] * 128 * g["consumers"] + 24 * 128 <= 65536
    assert g["kv_rows"] == (128 if g["dp"] <= 128 else 64)
    assert g["stages"] == (4 if g["dp"] <= 64 else 3)
    assert g["pv_width"] == g["dp"]
    assert g["registers"] == {2: 240, 3: 160}[g["consumers"]]
    # the row sums on the tensor cores where dim d is the p.v width's last
    # 8-dim block, zero-filled, set to 1: up to dp 64
    assert g["sums_on_tc"] == (d in (8, 24, 40))
    assert g["chains"] == (2 if g["dp"] <= 96 else 1)  # one at head dim 128
    assert g["smem"] <= tattn.SMEM_PER_BLOCK
    assert g["grid"] == (-(-sq // g["q_rows"]), b * h)
    assert g["kv_tiles"] == -(-skv // g["kv_rows"])
    assert g["tx_q"] == g["slabs"] * 128 * g["q_rows"]
    assert g["tx_kv"] == 2 * g["slabs"] * 128 * g["kv_rows"]
    for name, s, rows in (("q", sq, g["q_rows"]), ("k", skv, g["kv_rows"]),
                          ("v", skv, g["kv_rows"])):
        m = g["maps"][name]
        assert m["dims"] == (d, h, s, b) and m["box"] == (64, 1, rows, 1)
        assert m["box"][0] * 2 == m["swizzle"] == 128  # one swizzle row a box row
        assert m["strides"] == (2 * d, 2 * d * h, 2 * d * h * s)
        assert all(st % 16 == 0 for st in m["strides"])
        assert list(m["strides"]) == sorted(m["strides"])
        assert max(m["box"]) <= 256
        # each slab of the tile a whole number of 1,024-byte swizzle atoms
        assert (rows * 128) % 1024 == 0


def _tma_box(x: torch.Tensor, m: dict, coords: tuple) -> torch.Tensor:
    """What a TMA load of map `m` at `coords` (innermost first) puts in
    shared memory, read from the flat storage of `x` by the map's dims and
    byte strides, before the swizzle: the box's elements in row-major
    order (outermost first), zero where a coordinate lies outside dims."""
    flat = x.reshape(-1)
    esize = x.element_size()
    box = tuple(reversed(m["box"]))
    out = torch.zeros(box, dtype=x.dtype)
    strides = (esize,) + tuple(m["strides"])
    for idx in np.ndindex(*box):
        pos = [c + i for c, i in zip(coords, reversed(idx))]
        if all(0 <= p < n for p, n in zip(pos, m["dims"])):
            out[idx] = flat[sum(p * s for p, s in zip(pos, strides)) // esize]
    return out


@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_maps_cover_the_head_dim_with_zero_fill(d):
    """The boxes of K1's k map, read as TMA reads them: a tile's slabs hold
    each key's d dims of one head, the dims past d and the keys past Skv
    read as zeros, and nothing of the next head or token leaks in."""
    b, skv, h = 2, 19, 3
    g = tattn.flash_geometry(b, 1, skv, h, d)
    m = dict(g["maps"]["k"], box=(64, 1, 8, 1))  # 8 of a tile's rows, for speed
    # 2-byte elements, as bf16, each distinct
    k = torch.arange(1, b * skv * h * d + 1, dtype=torch.int16).reshape(b, skv, h, d)
    for bi, hi, s0 in ((0, 0, 0), (1, 2, 16), (1, 1, 8)):
        tile = torch.cat([_tma_box(k, m, (64 * c, hi, s0, bi))[0, :, 0, :]
                          for c in range(g["slabs"])], dim=1)  # (8 keys, slabs * 64)
        want = torch.zeros(8, 64 * g["slabs"], dtype=k.dtype)
        rows = k[bi, s0:s0 + 8, hi, :]
        want[:rows.shape[0], :d] = rows
        assert torch.equal(tile, want), (bi, hi, s0)
    assert g["zero_dims"] == {40: 24, 80: 48, 160: 32}[d]


def test_flash_geometry_matches_the_kernel_source():
    """The rules `flash_geometry` mirrors, read from the CUDA source."""
    csrc = Path(tattn.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    for rule in ("constexpr int SLAB = 64;",
                 "slabs(int dp) { return (dp + SLAB - 1) / SLAB; }",
                 "consumers(int dp) { return dp <= 64 ? 3 : 2; }",
                 "row_blocks(int dp) { return 1; }",
                 "q_rows(int dp) { return 64 * row_blocks(dp) * consumers(dp); }",
                 "kv_rows(int dp) { return dp <= 128 ? 128 : 64; }",
                 "n_stages(int dp) { return dp <= 64 ? 4 : 3; }",
                 "pv_width(int dp) { return dp; }",
                 "n_threads(int dp) { return 128 * (1 + consumers(dp)); }",
                 "return (size_t)(q_rows(dp) + 2 * n_stages(dp) * kv_rows(dp)) * slabs(dp) * "
                 "SLAB * 2 +\n         8 * (1 + 2 * n_stages(dp)) + 1024;",
                 "constexpr int REGS = consumer_regs(NWG);",
                 "return ((65536 / (128 * (nwg + 1))) / 8 * 8 * (nwg + 1) - 24) / nwg / 8 * 8;",
                 "sums_on_tc(int dp) { return dp <= 64; }",
                 "chains(int dp) { return dp <= 96 ? 2 : 1; }",
                 "if (D == DP - 8) return launch<DP, true>(",
                 "setmaxnreg_dec<24>();",
                 "tensor_map_bshd_slabs(&tk, k, B, Skv, H, D, kv_rows(DP))",
                 "tensor_map_bshd_slabs(&tq, q, B, Sq, H, D, q_rows(DP))"):
        assert rule in src, rule
    for rule in ("const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, "
                 "(cuuint64_t)B};",
                 "const cuuint64_t strides[3] = {row, (cuuint64_t)H * row, (cuuint64_t)S * H * "
                 "row};",
                 "const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};",
                 "CU_TENSOR_MAP_SWIZZLE_128B", "(1ull << 62)"):
        assert rule in hopper, rule
    for d, (nwg, bk, stages) in ((16, (3, 128, 4)), (40, (3, 128, 4)), (64, (3, 128, 4)),
                                 (80, (2, 128, 3)), (120, (2, 128, 3)), (128, (2, 128, 3)),
                                 (144, (2, 64, 3)), (160, (2, 64, 3))):
        g = tattn.flash_geometry(1, 1, 1, 1, d)
        assert (g["consumers"], g["kv_rows"], g["stages"]) == (nwg, bk, stages), d
        assert g["smem"] == ((64 * nwg + 2 * stages * bk) * g["slabs"] * 128
                             + 8 * (1 + 2 * stages) + 1024)
    # head dim 128 keeps its tiles: one 64-row q block per warpgroup, two
    # warpgroups, 128-key tiles in 3 stages, two slabs a row
    g = tattn.flash_geometry(1, 1, 1, 1, 128)
    assert (g["q_rows"], g["kv_rows"], g["stages"], g["slabs"]) == (128, 128, 3, 2)
    assert g["smem"] == (128 + 2 * 3 * 128) * 128 * 2 + 8 * (1 + 2 * 3) + 1024


@pytest.mark.parametrize("d", [40, 80, 112, 120, 128, 160])
def test_flash_kv_operands_copy_all_but_head_dim_128(d):
    """The wrapper hands K1 k and v as they lie, at every head dim: the
    UNet's 40 / 80 / 160, the 112 / 120 next to 128 and the DiTs' 128 (no
    head dim keeps a copy)."""
    import inspect

    assert "kc, vc = flash_kv_operands(k, v)" in inspect.getsource(tattn.flash_attention_cuda)
    b, s, h = 2, 7, 3
    k = torch.arange(b * s * h * d, dtype=torch.float32).reshape(b, s, h, d)
    v = -k
    kc, vc = tattn.flash_kv_operands(k, v)
    assert kc is k and vc is v
    assert not tattn.flash_geometry(b, s, s, h, d)["kv_copies"]


def test_k1_argtypes_match_the_c_entry_point():
    """ctypes passes what `argtypes` says: one type per C parameter."""
    import re

    text = (Path(tattn.__file__).resolve().parent.parent / "csrc"
            / "flash_attention.cu").read_text()
    m = re.search(r'extern "C" int tclight_flash_attention_bf16\(([^)]*)\)', text)
    assert m and len(m.group(1).split(",")) == len(tattn.K1_ARGTYPES)


def test_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_flash` builds each variant of K1 by
    text substitution: every replaced text is still in the source, and each
    variant differs from the kernel (the base variant excepted)."""
    from tclight_torch import ablate_flash

    texts = ablate_flash.variant_sources()
    assert set(texts) == set(ablate_flash.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "flash_fwd_wgmma_kernel" in text
    # another checkout's kernel (`--tree`): here this one's, laid out as a
    # checkout; every variant applies
    root = Path(tattn.__file__).resolve().parents[2]
    assert set(ablate_flash.variant_sources(root)) == set(texts)
    assert ("L2", 8, 660, 660, 8, 160) in ablate_flash.SHAPES["unet"]
    assert ("yt-L1", 2, 2228, 2228, 8, 80) in ablate_flash.SHAPES["unet"]
