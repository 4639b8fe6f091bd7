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
    """K1's TMA geometry: q read in place from (B, S, H, D) in boxes of one
    16-byte core-matrix row of head dims by a block's q rows; k and v from
    the chunk-major copies, one box a tile; strides TMA takes (multiples of
    16, rising); the q.k^T depth padded to 16 by chunks that lie past the
    maps' chunk extent (zero-filled, never the next head); a ring that fits
    the block's shared memory; two q row blocks per warpgroup up to dp 96.
    At d = 128, q, k and v all in place in the 128-byte swizzle: boxes of
    64 dims (128 bytes) by a tile's rows, two per row, 128-key tiles in 3
    stages, one 64-row q block per warpgroup, no copies."""
    b, sq, skv, h = 2, 35640, 1031, 8
    g = tattn.flash_geometry(b, sq, skv, h, d)
    assert g["dp"] % 16 == 0 and d <= g["dp"] < d + 16
    assert g["chunks"] * 8 == g["dp"]
    assert g["zero_chunks"] * 8 == g["dp"] - d
    assert g["row_blocks"] == (2 if g["dp"] <= 96 else 1)
    assert g["q_rows"] == 2 * 64 * g["row_blocks"]  # two consumer warpgroups
    assert g["kv_rows"] in (64, 128)
    assert g["stages"] >= 2 and g["smem"] <= tattn.SMEM_PER_BLOCK
    assert g["grid"] == (-(-sq // g["q_rows"]), b * h)
    assert g["kv_tiles"] == -(-skv // g["kv_rows"])
    assert g["tx_q"] == g["chunks"] * 16 * g["q_rows"]
    assert g["tx_kv"] == 2 * g["chunks"] * 16 * g["kv_rows"]
    assert g["kv_copies"] == (d != 128)
    if d == 128:
        assert (g["q_rows"], g["kv_rows"], g["stages"]) == (128, 128, 3)
        for name, s, rows in (("q", sq, 128), ("k", skv, 128), ("v", skv, 128)):
            m = g["maps"][name]
            assert m["dims"] == (d, h, s, b) and m["box"] == (64, 1, rows, 1)
            assert m["box"][0] * 2 == m["swizzle"] == 128  # one swizzle row a box row
            assert g["dp"] // m["box"][0] == 2  # two boxes a row of D
            assert m["strides"] == (2 * d, 2 * d * h, 2 * d * h * s)
            assert all(st % 16 == 0 for st in m["strides"])
        # 1,024-byte swizzle atoms: the q tile and each k/v slab a whole number of them
        assert (g["q_rows"] * 128) % 1024 == 0 and (g["kv_rows"] * 128) % 1024 == 0
        return
    q, k = g["maps"]["q"], g["maps"]["k"]
    assert q["swizzle"] == k["swizzle"] == 0
    assert q["dims"] == (d, h, sq, b) and q["box"] == (8, 1, g["q_rows"], 1)
    assert q["strides"][0] == 2 * d  # the next head starts past dim 0
    assert k == g["maps"]["v"]
    assert k["dims"] == (8, skv, d // 8, b * h)
    assert k["box"] == (8, g["kv_rows"], g["chunks"], 1)
    for m in (q, k):
        assert m["box"][0] * 2 == 16
        assert max(m["box"]) <= 256
        assert all(st % 16 == 0 for st in m["strides"])
        assert list(m["strides"]) == sorted(m["strides"])


def test_flash_kv_copies_are_chunk_major():
    """The wrapper's k/v copy: element (b, s, h, 8c + e) of (B, S, H, D) at
    (b * H + h, c, s, e), the order the kernel's k/v tensor map reads."""
    b, s, h, d = 2, 5, 3, 24
    k = torch.arange(b * s * h * d).reshape(b, s, h, d)
    kc = k.view(b, s, h, d // 8, 8).permute(0, 2, 3, 1, 4).contiguous()
    flat = kc.reshape(b * h, d // 8, s, 8)
    for bi, si, hi, di in ((0, 0, 0, 0), (1, 4, 2, 23), (0, 3, 1, 9), (1, 2, 0, 16)):
        assert flat[bi * h + hi, di // 8, si, di % 8] == k[bi, si, hi, di]
    src = (Path(tattn.__file__).resolve().parent.parent / "csrc" / "flash_attention.cu").read_text()
    wrapper = Path(tattn.__file__).read_text()
    assert "t.view(b, skv, h, d // 8, 8).permute(0, 2, 3, 1, 4).contiguous()" in wrapper
    assert "const cuuint64_t dims[4] = {8, (cuuint64_t)S, (cuuint64_t)(D / 8), (cuuint64_t)BH};" in src


def test_flash_geometry_matches_the_kernel_source():
    """The rules `flash_geometry` mirrors, read from the CUDA source."""
    src = (Path(tattn.__file__).resolve().parent.parent / "csrc" / "flash_attention.cu").read_text()
    for rule in ("row_blocks(int dp) { return dp <= 96 ? 2 : 1; }",
                 "q_rows(int dp) { return 128 * row_blocks(dp); }",
                 "kv_rows(int dp) { return row_blocks(dp) == 2 ? 64 : 128; }",
                 "return row_blocks(dp) == 2 ? 4 : (dp <= 128 ? 3 : 2);",
                 "(size_t)(q_rows(dp) + 2 * n_stages(dp) * kv_rows(dp)) * dp * 2 +\n"
                 "         8 * (1 + 2 * n_stages(dp)) + 128;",
                 "const cuuint32_t box[4] = {8, 1, (cuuint32_t)rows, 1};",
                 "const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)(DP / 8), 1};"):
        assert rule in src, rule
    for d, stages in ((16, 4), (96, 4), (112, 3), (120, 3), (144, 2)):
        assert tattn.flash_geometry(1, 1, 1, 1, d)["stages"] == stages
    # head dim 128: in place, swizzled, its own geometry; the swizzled tensor
    # map is hopper.cuh's, shared with K6 and K7
    hopper = (Path(tattn.__file__).resolve().parent.parent / "csrc" / "hopper.cuh").read_text()
    for rule in ("constexpr int SW_D = 128;", "constexpr int SW_BQ = 128;",
                 f"constexpr int SW_BK = {tattn.SW_KV_ROWS};",
                 f"constexpr int SW_NST = {tattn.SW_STAGES};",
                 "constexpr size_t SW_SMEM = (size_t)(SW_BQ + 2 * SW_NST * SW_BK) * SW_D * 2 +\n"
                 "                           8 * (1 + 2 * SW_NST) + 1024;",
                 "const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};",
                 "return tensor_map_4d_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, "
                 "strides, box);",
                 "if (D == SW_D) return launch<SW_D, true>(",
                 "tensor_map_bshd_sw128(&tv, v, B, Skv, H, SW_BK)"):
        assert rule in src + hopper, rule
    g = tattn.flash_geometry(1, 1, 1, 1, 128)
    assert (g["q_rows"], g["kv_rows"], g["stages"]) == (128, tattn.SW_KV_ROWS, tattn.SW_STAGES)
    assert g["smem"] == (128 + 2 * 3 * 128) * 128 * 2 + 8 * (1 + 2 * 3) + 1024
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in hopper and "(1ull << 62)" in hopper


@pytest.mark.parametrize("d", [40, 80, 112, 120, 128, 160])
def test_flash_kv_operands_copy_all_but_head_dim_128(d):
    """The wrapper hands K1 k and v as they lie at d = 128 (no copy) and as
    chunk-major copies at every other head dim, the UNet's 40 / 80 / 160
    and the 112 / 120 next to 128 included."""
    import inspect

    assert "kc, vc = flash_kv_operands(k, v)" in inspect.getsource(tattn.flash_attention_cuda)
    b, s, h = 2, 7, 3
    k = torch.arange(b * s * h * d, dtype=torch.float32).reshape(b, s, h, d)
    v = -k
    kc, vc = tattn.flash_kv_operands(k, v)
    if d == 128:
        assert kc is k and vc is v
        return
    assert kc.data_ptr() != k.data_ptr() and vc.data_ptr() != v.data_ptr()
    assert kc.shape == (b, h, d // 8, s, 8) and kc.is_contiguous()
    assert torch.equal(kc, k.view(b, s, h, d // 8, 8).permute(0, 2, 3, 1, 4))
    assert torch.equal(vc, -kc)


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
