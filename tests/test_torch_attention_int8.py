"""The port's int8 attention (tclight_torch/ops/attention.py, backends "int8"
and "int8pv") against the JAX package's "pallas_int8" / "pallas_int8pv",
which off the TPU run `_flash_attention_int8_xla`: the quantizers bit for
bit, the plain int8 attention, the pre-pass that lays out the operands of
the kernels K6 / K7, and the tiny UNet with int8 attention. Inputs are made
with numpy from a seed; every tolerance is stated at its test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.models import unet as junet
from tclight_tpu.ops import attention as jattn
from tclight_torch.models import bridge
from tclight_torch.models import unet as tunet
from tclight_torch.ops import attention as tattn
from tclight_torch.pipeline.iclight import init_like_flax

torch.set_num_threads(2)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    if dtype == "bf16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantizers_are_bit_equal(dtype):
    """Rows, 1024-row blocks (three, the last ragged before padding) and
    channels: the same int8 values and the same f32 scales."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2100, 40)).astype(np.float32) * rng.uniform(0.1, 3, (3, 1, 40))
    x[:, 2100 - 37:] *= 0.01  # a block whose amax is far below the others'
    jx, tx = _pair(x, dtype)
    for jfn, tfn in ((jattn._quantize_rows, tattn.quantize_rows),
                     (jattn._quantize_channels, tattn.quantize_channels)):
        jq, js = jfn(jx)
        tq, ts = tfn(tx)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jpad = jnp.pad(jx, ((0, 0), (0, 3072 - 2100), (0, 0)))
    tpad = torch.nn.functional.pad(tx, (0, 0, 0, 3072 - 2100))
    jq, js = jattn._quantize_blocks(jpad, 1024)
    tq, ts = tattn.quantize_blocks(tpad, 1024)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.shape == (3, 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k_smoothing_matches(dtype):
    """K minus its token mean, then per-token quantization, over 1100
    tokens. In bf16 (the full-width stack) the smoothed K and its int8
    values are bit-equal: both packages accumulate the mean in f32 and
    round it to bf16, then round the difference to bf16. In f32 the mean
    is a sum of 1100 terms that the packages add in another order, so the
    smoothed K agrees within an ulp (2.4e-7 for these values), and the int8
    values of these inputs are still equal."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 1100, 2, 40)).astype(np.float32) + 0.7
    jk, tk = _pair(k, dtype)
    jkt = jk.transpose(0, 2, 1, 3).reshape(4, 1100, 40)
    j_s = jkt - jnp.mean(jkt, axis=1, keepdims=True)
    t_s = tattn.smooth_k(tattn._heads_first(tk))
    assert t_s.dtype == tk.dtype
    j_np = np.asarray(j_s.astype(jnp.float32))
    if dtype == "bf16":
        np.testing.assert_array_equal(t_s.float().numpy(), j_np)
    else:
        np.testing.assert_allclose(t_s.numpy(), j_np, rtol=0, atol=2.4e-7)
    jq, js = jattn._quantize_rows(j_s)
    tq, ts = tattn.quantize_rows(t_s)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1100, 1300, 2, 40),   # both lengths past one 1024 block, ragged
    (2, 300, 700, 2, 16),     # one block each, B*H = 4
    (1, 2100, 1030, 1, 24),   # three Q-scale blocks, a 6-key last P block
])
@pytest.mark.parametrize("pv_int8", [False, True])
def test_int8_plain_matches_jax_f32(b, sq, skv, h, d, pv_int8):
    """f32 inputs. "int8": the same int8 operands and exact dots, so only
    the f32 softmax and p.v sums differ in order (atol 2e-6 of outputs of
    order 0.3). "int8pv": a p8 value sits at a rounding tie when
    127 * p / sp is within f32 noise of k + 0.5; the two softmaxes round
    p differently there, and one such p8 moves the output by 1/127 of that
    block's p max times v: held at 2e-3 of the largest output (the worst
    seen is 4e-4 relative)."""
    q, k, v = _qkv(0, b, sq, skv, h, d)
    backend = "int8pv" if pv_int8 else "int8"
    ref = np.asarray(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           backend="pallas_" + backend))
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), backend=backend).numpy()
    tol = 2e-3 * np.abs(ref).max() if pv_int8 else 2e-6
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    # and the quantization error against the fp attention is of the
    # order the JAX package records (~1e-2 relative for QK, more for PV)
    fp = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert np.abs(out - fp).max() <= 0.1 * np.abs(fp).max()


@pytest.mark.parametrize("pv_int8", [False, True])
def test_int8_plain_matches_jax_bf16(pv_int8):
    """bf16 inputs, as on the full-width stack: the output is bf16, so the
    two packages may round a value to neighbouring bf16 numbers: within
    one bf16 ulp (2^-8 relative) of the largest output."""
    q, k, v = _qkv(2, 1, 1100, 1300, 2, 40)
    backend = "int8pv" if pv_int8 else "int8"
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    jv, tv = _pair(v, "bf16")
    ref = np.asarray(jattn.flash_attention(jq, jk, jv, backend="pallas_" + backend)
                     .astype(jnp.float32))
    out = tattn.flash_attention(tq, tk, tv, backend=backend)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -8 * np.abs(ref).max())


def test_int8_prepass_lays_out_the_kernel_operands():
    """The plain pre-pass of K6 / K7: contiguous (a B = 1 head-major view is
    not), head dim padded with zeros to the int8 MMA depth, keys to 64, the
    Q scale per 1024-row block; with pv_int8 V quantized per channel, (BH,
    Skv, D), which `int8pv_operands_plain` lays out for K7 (see
    `test_int8pv_operands_match_jax_quantizers`)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(3, 1, 1030, 200, 2, 80))
    ops = tattn.int8_prepass(q, k, v, pv_int8=True)
    assert all(t.is_contiguous() for t in ops.values() if torch.is_tensor(t))
    assert ops["q8"].shape == (2, 2048, 96) and ops["q8"].dtype == torch.int8
    assert ops["k8"].shape == (2, 256, 96) and ops["sk"].shape == (2, 256)
    assert ops["sq"].shape == (2, 2) and ops["bq"] == 1024
    assert ops["v8"].shape == (2, 200, 80) and ops["sv"].shape == (2, 80)
    assert (ops["q8"][:, :, 80:] == 0).all() and (ops["k8"][:, 200:] == 0).all()
    q8, sqs = tattn.quantize_blocks(torch.nn.functional.pad(
        tattn._heads_first(q), (0, 0, 0, 2048 - 1030)), 1024)
    assert torch.equal(ops["q8"][:, :, :80], q8) and torch.equal(ops["sq"], sqs)
    v8, sv = tattn.quantize_channels(tattn._heads_first(v))
    assert torch.equal(ops["v8"], v8) and torch.equal(ops["sv"], sv)


def test_int8_prepass_lays_out_head_dim_128():
    """The plain pre-pass at head dim 128 (no head-dim padding: 128 is the
    int8 MMA depth's multiple) and the kernels' D = 128 layout made from it:
    q8 and k8 its real rows, row-major (BH, S, 128), one 128-byte row a
    token; K6's v the input itself; K7's v8 channel-major (`v8_channels`)
    and no bf16 copies."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(3, 1, 1030, 200, 2, 128))
    ops = tattn.int8_prepass(q, k, v, pv_int8=True)
    assert ops["q8"].shape == (2, 2048, 128) and ops["k8"].shape == (2, 256, 128)
    assert ops["v8"].shape == (2, 200, 128) and ops["sv"].shape == (2, 128)
    k6, k7 = tattn.qk_int8_operands_plain(q, k, v), tattn.int8pv_operands_plain(q, k, v)
    for o in (k6, k7):
        assert o["q8"].shape == (2, 1030, 128) and o["k8"].shape == (2, 200, 128)
        assert o["q8"].is_contiguous() and o["k8"].is_contiguous()
        assert torch.equal(o["q8"], ops["q8"][:, :1030]) and torch.equal(o["k8"], ops["k8"][:, :200])
    assert k6["v"] is v and "qb" not in k7 and "kb" not in k7
    assert torch.equal(k7["v8"], tattn.v8_channels(ops["v8"])) and k7["v8"].shape == (2, 128, 256)


def _from_v8_chunks(v8c: torch.Tensor, skv: int) -> torch.Tensor:
    """Inverse of `v8_chunks` (and of `v8_channels`, the channel-major
    layout of head dim 128): byte 4t + 2a + c of a chunk is key 8a + 2t + c."""
    if v8c.dim() == 3:  # (bh, d, keys) -> (bh, keys / 16, d, 16)
        bh, d, n = v8c.shape
        v8c = v8c.reshape(bh, d, n // 16, 16).transpose(1, 2)
    bh, n_vc, d, _ = v8c.shape
    x = v8c.reshape(bh, n_vc, d, 4, 2, 2).permute(0, 1, 4, 3, 5, 2)  # (bh, chunk, a, t, c, d)
    return x.reshape(bh, n_vc * 16, d)[:, :skv], x.reshape(bh, n_vc * 16, d)[:, skv:]


def test_v8_chunks_key_order():
    """Each 16 keys of a channel: byte 4t + 2a + c holds key 8a + 2t + c, the
    order in which a thread's int32 score fragment (keys 2t, 2t + 1 of each
    8) packs into the s8 A fragment (bytes 4t..4t+3 of each 16)."""
    keys = torch.arange(40, dtype=torch.int8)[None, :, None].repeat(1, 1, 3)
    c = tattn.v8_chunks(keys)
    assert c.shape == (1, 3, 3, 16)
    for t in range(4):
        for a in range(2):
            for cc in range(2):
                assert c[0, 1, 2, 4 * t + 2 * a + cc] == 16 + 8 * a + 2 * t + cc
    back, pad = _from_v8_chunks(c, 40)
    assert torch.equal(back, keys) and (pad == 0).all()


def test_v8_channels_key_order():
    """Head dim 128's channel-major v8 (BH, D, ceil128(Skv)): each channel's
    keys contiguous, padded with zeros to 128, in `v8_chunks`' order within
    each 16, which is the k32 A fragment's: bytes 4t..4t+3 of each 16 keys
    hold a thread's keys 2t, 2t + 1, 8 + 2t, 9 + 2t (the score fragment's
    keys of two 8-key blocks, packed as they lie)."""
    keys = torch.arange(40, dtype=torch.int8)[None, :, None].repeat(1, 1, 3)
    keys[..., 1] += 50
    c = tattn.v8_channels(keys)
    assert c.shape == (1, 3, 128) and c.is_contiguous()
    for t in range(4):
        assert c[0, 1, 16 + 4 * t:16 + 4 * t + 4].tolist() == [
            66 + 2 * t, 67 + 2 * t, 74 + 2 * t, 75 + 2 * t]
    back, pad = _from_v8_chunks(c, 40)
    assert torch.equal(back, keys) and (pad == 0).all() and pad.shape[1] == 128 - 40


def test_backend_dispatch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 40, 600, 1, 8))
    with pytest.raises(ValueError, match="backend"):
        tattn.flash_attention(q, k, v, backend="pallas_int8")
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        tattn.flash_attention_int8_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), 1.0)
    np.testing.assert_array_equal(
        tattn.flash_attention(q, k, v, backend="int8pv").numpy(),
        tattn.flash_attention_int8_plain(q, k, v, 8 ** -0.5, pv_int8=True).numpy())


@pytest.fixture(scope="module")
def tiny_unet():
    model = tunet.UNet2DCondition(tunet.UNetConfig.tiny(8))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return bridge.module_to_flax(model), model.eval()


@pytest.mark.parametrize("backend", ["int8", "int8pv"])
def test_tiny_unet_with_int8_attention_matches_jax(tiny_unet, backend, monkeypatch):
    """The tiny UNet at a 32x32 latent: the level-0 self-attention has 1024
    keys (> 512), so it goes to the int8 attention in both packages; the
    call count shows the port reached it. Held at 1e-3 of the largest
    output (the worst seen is 3.6e-4; the fp backend agrees to 1.6e-6):
    the two packages' f32 activations differ by ulps, and where an
    activation sits at a rounding tie of its quantization grid the int8
    value differs by one step, 1/127 of its row's or block's scale."""
    params, model = tiny_unet
    calls = []
    plain = tattn.flash_attention_int8_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_int8_plain", counted)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    unet_j = junet.UNet2DCondition(junet.UNetConfig.tiny(8), attn_backend="pallas_" + backend)
    ref, _ = jax.jit(unet_j.apply)(params, jnp.asarray(x), jnp.asarray(500.0), jnp.asarray(ctx))
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x), 500.0, torch.from_numpy(ctx), attn_backend=backend)
    ref = np.asarray(ref)
    # level 0 has one attention block on the way down and two on the way up
    assert len(calls) == 3 and all(s[1] == 1024 for s in calls)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1030, 200, 2, 40),    # two Q-scale blocks, D padded 40 -> 64
    (2, 300, 1100, 1, 80),    # one Q block of 384 rows, a ragged last k slice
    (1, 129, 65, 2, 8),       # the smallest head dim
    (1, 64, 130, 1, 160),     # the largest
    (1, 1030, 200, 2, 128),   # head dim 128: q8 and k8 row-major, v in place
    (2, 300, 1100, 1, 128),
])
def test_qk_int8_operands_match_jax_quantizers(b, sq, skv, h, d):
    """K6's operands in the layout its pre-pass kernels write
    (`qk_int8_operands`, the plain version on the CPU), read back into
    (B * H, S, D): q8 and the Q scales equal JAX's `_quantize_blocks` of the
    zero-padded queries, k8 and the K scales JAX's `_quantize_rows` of K
    minus its token mean (bf16 inputs: bit-equal, see
    `test_k_smoothing_matches`), v the heads-first v (at d = 128 v as it
    lies); the head dim's padding and the padded keys' scales are zeros."""
    q, k, v = _qkv(5, b, sq, skv, h, d)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    _, tv = _pair(v, "bf16")
    g = tattn.qk_int8_geometry(b, sq, skv, h, d)
    ops = tattn.qk_int8_operands(tq, tk, tv)
    for name in ("q8", "k8", "v", "sq", "sk"):
        assert tuple(ops[name].shape) == g["shapes"][name], name
        assert ops[name].is_contiguous()
    assert ops["q8"].dtype == ops["k8"].dtype == torch.int8 and ops["bq"] == g["bq"]
    q8 = tattn.operand_rows(ops["q8"])
    k8 = tattn.operand_rows(ops["k8"])
    assert (q8[:, :, d:] == 0).all() and (k8[:, :, d:] == 0).all()
    bq, sq_pad = g["bq"], g["n_qb"] * g["bq"]
    jqt = jq.transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    jq8, jsq = jattn._quantize_blocks(jnp.pad(jqt, ((0, 0), (0, sq_pad - sq), (0, 0))), bq)
    np.testing.assert_array_equal(q8[:, :, :d].numpy(), np.asarray(jq8)[:, :sq])
    np.testing.assert_array_equal(ops["sq"].numpy(), np.asarray(jsq))
    jkt = jk.transpose(0, 2, 1, 3).reshape(b * h, skv, d)
    jk8, jsk = jattn._quantize_rows(jkt - jnp.mean(jkt, axis=1, keepdims=True))
    np.testing.assert_array_equal(k8[:, :, :d].numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(ops["sk"][:, :skv].numpy(), np.asarray(jsk))
    assert (ops["sk"][:, skv:] == 0).all()
    if d == 128:
        assert ops["v"] is tv
    else:
        assert torch.equal(tattn.from_chunk_major(ops["v"]), tattn._heads_first(tv))


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 80, 96, 128, 144, 160])
def test_qk_int8_geometry_matches_the_kernel_source(d):
    """K6 keeps the tiles (q rows, keys, stages) of K1's design before K1
    read every head dim in place, for the p.v width dp: two 64-row q blocks
    a warpgroup and 64-key tiles in 4 stages up to dp 96, else one block
    and 128 keys in 3 stages up to dp 128, 2 above; at d = 128 they are
    K1's; its q.k^T depth dk is d padded to 32; its shared memory fits a
    block; the rules are those of `csrc/flash_attention_qk_int8.cu`."""
    from pathlib import Path

    g = tattn.qk_int8_geometry(2, 35640, 35640, 8, d)
    k1 = tattn.flash_geometry(2, 35640, 35640, 8, d)
    assert g["dk"] % 32 == 0 and d <= g["dk"] < d + 32 and g["dp"] == k1["dp"]
    mb = 2 if g["dp"] <= 96 else 1
    assert (g["row_blocks"], g["q_rows"], g["kv_rows"], g["stages"]) == (
        mb, 128 * mb, 64 if mb == 2 else 128, 4 if mb == 2 else (3 if g["dp"] <= 128 else 2))
    if d == 128:
        for key in ("row_blocks", "q_rows", "kv_rows", "stages"):
            assert g[key] == k1[key], key
    smem = (g["q_rows"] * g["dk"] + g["stages"] * g["kv_rows"] * (g["dk"] + 2 * g["dp"] + 4)
            + 8 * (1 + 2 * g["stages"]) + 128)
    assert smem <= tattn.SMEM_PER_BLOCK
    assert g["bq"] == 1024 and g["n_qb"] == 35 and g["skv_pad"] % 128 == 0
    assert g["q_rows"] <= g["bq"] and g["bq"] % g["q_rows"] == 0  # a q tile reads one sq
    src = (Path(tattn.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_qk_int8.cu").read_text()
    for rule in ("row_blocks(int dp) { return dp <= 96 ? 2 : 1; }",
                 "return (size_t)q_rows(dp) * dk + (size_t)n_stages(dp) * kv_rows(dp) * "
                 "(dk + 2 * dp + 4) +",
                 "constexpr int SLICE = 256;",
                 "constexpr int CH8 = (D + 31) / 32 * 2;",
                 "const cuuint32_t box[4] = {16, (cuuint32_t)rows, (cuuint32_t)(DK / 16), 1};"):
        assert rule in src, rule
    if d != 128:
        assert g["v_copy"] and g["swizzle"] == 0
        return
    # head dim 128: q8, k8 row-major and v in place, read by 128-byte-swizzled
    # tensor maps (hopper.cuh's, K1's for v), with K1's D = 128 tiles
    hopper = (Path(tattn.__file__).resolve().parent.parent / "csrc" / "hopper.cuh").read_text()
    assert not g["v_copy"] and g["swizzle"] == 128
    assert g["shapes"]["q8"] == (16, 35640, 128) and g["shapes"]["v"] == (2, 35640, 8, 128)
    for name in ("q8", "k8"):
        assert g["maps"][name] == {"dims": (128, 35640, 16, 1),
                                   "strides": (128, 128 * 35640, 128 * 35640 * 16),
                                   "box": (128, 128, 1, 1), "swizzle": 128}
    assert g["maps"]["v"] == k1["maps"]["v"] and k1["maps"]["v"]["swizzle"] == 128
    assert g["smem"] == 128 * 128 + 3 * 128 * (3 * 128 + 4) + 56 + 1024 <= tattn.SMEM_PER_BLOCK
    for rule in ("constexpr int SW_D = 128;", "constexpr int SW_BQ = 128;",
                 "constexpr int SW_BK = 128;", "constexpr int SW_NST = 3;",
                 "constexpr size_t SW_SMEM = (size_t)SW_BQ * SW_D + (size_t)SW_NST * SW_BK * "
                 "(3 * SW_D + 4) +\n                           8 * (1 + 2 * SW_NST) + 1024;",
                 "tensor_map_rows_sw128(&tq, q8, B * H, Sq, SW_D, SW_BQ)",
                 "tensor_map_bshd_sw128(&tv, vc, B, Skv, H, SW_BK);",
                 "return launch<SW_D, SW_D, true>(q8, k8, vc, sq, sk, o, B, H, Sq, Skv, D, bq,",
                 "return SW ? ((long)bh * S + r) * CH8 + c16 : ((long)bh * CH8 + c16) * S + r;"):
        assert rule in src + hopper, rule
    for rule in ("const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)N, 1};",
                 "const cuuint32_t box[4] = {128, (cuuint32_t)rows, 1, 1};",
                 "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert rule in hopper, rule


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1030, 200, 2, 40),    # two Q-scale blocks, 200 keys: a ragged 16-key chunk
    (2, 300, 1100, 1, 80),    # a ragged last k slice and P block
    (1, 129, 65, 2, 8),       # the smallest head dim
    (1, 64, 130, 1, 160),     # the largest
    (1, 1030, 200, 2, 128),   # head dim 128: v8 channel-major, no bf16 copies
    (2, 300, 1100, 1, 128),
])
def test_int8pv_operands_match_jax_quantizers(b, sq, skv, h, d):
    """K7's operands in the layout its pre-pass kernels write
    (`int8pv_operands`, the plain version on the CPU), read back: q8, k8
    and their scales as for K6 (`test_qk_int8_operands_match_jax_quantizers`),
    v8 and sv equal to JAX's `_quantize_channels` of the heads-first V
    (bf16 inputs: bit-equal), the keys past Skv zero (at d = 128 the keys
    up to ceil128(Skv), and there are no bf16 copies)."""
    q, k, v = _qkv(6, b, sq, skv, h, d)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    jv, tv = _pair(v, "bf16")
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    ops = tattn.int8pv_operands(tq, tk, tv)
    names = ("q8", "k8", "v8", "sq", "sk", "sv") + (("qb", "kb") if d != 128 else ())
    assert set(names) | {"bq"} == set(ops)
    for name in names:
        assert tuple(ops[name].shape) == g["shapes"][name], name
        assert ops[name].is_contiguous()
    assert ops["v8"].dtype == torch.int8 and ops["bq"] == g["bq"]
    # the max pass's bf16 copies hold q8's and k8's values exactly, the head
    # dim padded to 16 with zeros
    dp = g["dp"]
    for bf, i8 in (("qb", "q8"), ("kb", "k8")) if d != 128 else ():
        assert ops[bf].dtype == torch.bfloat16
        vals = tattn.from_chunk_major(ops[bf])
        assert torch.equal(vals.float(), tattn.from_chunk_major(ops[i8])[..., :dp].float())
    bq, sq_pad = g["bq"], g["n_qb"] * g["bq"]
    jqt = jq.transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    jq8, jsq = jattn._quantize_blocks(jnp.pad(jqt, ((0, 0), (0, sq_pad - sq), (0, 0))), bq)
    np.testing.assert_array_equal(tattn.operand_rows(ops["q8"])[:, :, :d].numpy(),
                                  np.asarray(jq8)[:, :sq])
    np.testing.assert_array_equal(ops["sq"].numpy(), np.asarray(jsq))
    jkt = jk.transpose(0, 2, 1, 3).reshape(b * h, skv, d)
    jk8, jsk = jattn._quantize_rows(jkt - jnp.mean(jkt, axis=1, keepdims=True))
    np.testing.assert_array_equal(tattn.operand_rows(ops["k8"])[:, :, :d].numpy(),
                                  np.asarray(jk8))
    np.testing.assert_array_equal(ops["sk"][:, :skv].numpy(), np.asarray(jsk))
    jv8, jsv = jattn._quantize_channels(jv.transpose(0, 2, 1, 3).reshape(b * h, skv, d))
    v8, pad = _from_v8_chunks(ops["v8"], skv)
    np.testing.assert_array_equal(v8.numpy(), np.asarray(jv8))
    np.testing.assert_array_equal(ops["sv"].numpy(), np.asarray(jsv))
    assert (pad == 0).all()


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1100, 1300, 2, 40),   # two P blocks, the second ragged (276 keys)
    (2, 300, 700, 1, 80),     # one P block of 768 keys, 68 of them padding
    (1, 2100, 1030, 1, 24),   # three Q-scale blocks, a 6-key last P block
    (1, 1100, 1300, 2, 128),  # head dim 128: q8 and k8 row-major
    (2, 300, 700, 1, 128),
])
def test_int8_block_rowmax_plain_matches_jax(b, sq, skv, h, d):
    """K7's max pass, plain: each (query, P block)'s logit max, against the
    block maxes of the logits that `_flash_attention_int8_xla` forms from
    JAX's quantized operands (times log2(e): the kernel works in log2
    units), the padded keys left out. The two multiply the same exact dots
    by the same scales in another order: within 4 f32 ulps."""
    q, k, v = _qkv(7, b, sq, skv, h, d)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    _, tv = _pair(v, "bf16")
    scale = d ** -0.5
    ops = tattn.int8pv_operands(tq, tk, tv)
    bm = tattn.int8_block_rowmax(ops, b, h, sq, skv, d, scale)
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    assert tuple(bm.shape) == g["shapes"]["blockmax"]
    bh, bq, pb = b * h, g["bq"], g["pb"]
    jqt = jq.transpose(0, 2, 1, 3).reshape(bh, sq, d)
    jkt = jk.transpose(0, 2, 1, 3).reshape(bh, skv, d)
    q8, sqs = jattn._quantize_blocks(jnp.pad(jqt, ((0, 0), (0, g["n_qb"] * bq - sq), (0, 0))), bq)
    k8, sks = jattn._quantize_rows(jkt - jnp.mean(jkt, axis=1, keepdims=True))
    dots = jax.lax.dot_general(q8, k8, (((2,), (2,)), ((0,), (0,))),
                               preferred_element_type=jnp.int32)
    logits = (dots.astype(jnp.float32)[:, :sq] * (scale * jnp.repeat(sqs, bq, axis=1)[:, :sq, None])
              * sks[:, None, :])
    logits = jnp.pad(logits, ((0, 0), (0, 0), (0, g["n_kb"] * pb - skv)),
                     constant_values=-jnp.inf)
    ref = np.asarray(logits.reshape(bh, sq, g["n_kb"], pb).max(axis=-1)) * np.log2(np.e)
    np.testing.assert_allclose(bm.numpy(), ref, rtol=4 * 2.0 ** -23, atol=0)


def _k7_order(q, k, v, scale):
    """K7's arithmetic in its own order, on the CPU: the operands of
    `int8pv_operands`, the block maxes of the max pass, the row max m from
    them, p = exp2(w - bm), p8 = round(127 p), each P block's exact
    p8 . v8 dequantized with sp / 127 (sp = exp2(bm - m)), l the sum of
    sp * p, out = acc * sv / l."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ops = tattn.int8pv_operands(q, k, v)
    bm = tattn.int8_block_rowmax(ops, b, h, sq, skv, d, scale)
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    q8, k8 = tattn.operand_rows(ops["q8"]).double(), tattn.operand_rows(ops["k8"]).double()
    v8 = _from_v8_chunks(ops["v8"], skv)[0].double()
    c = scale * np.log2(np.e) * ops["sq"].double().repeat_interleave(g["bq"], 1)[:, :sq, None]
    w = torch.matmul(q8, k8.transpose(1, 2)) * ops["sk"][:, None, :skv].double() * c
    m = bm.double().amax(dim=-1, keepdim=True)
    acc = torch.zeros(b * h, sq, d, dtype=torch.float64)
    l = torch.zeros(b * h, sq, 1, dtype=torch.float64)
    for kb in range(g["n_kb"]):
        sl = slice(kb * g["pb"], min(skv, (kb + 1) * g["pb"]))
        p = torch.exp2(w[:, :, sl] - bm[:, :, kb, None].double())
        sp = torch.exp2(bm[:, :, kb, None].double() - m)
        acc += sp / 127 * torch.matmul(torch.round(127 * p), v8[:, sl])
        l += sp * p.sum(dim=-1, keepdim=True)
    out = acc * ops["sv"].double()[:, None, :] / l
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).float()


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 300, 1300, 2, 40),    # a ragged second P block
    (1, 200, 700, 1, 80),     # one P block with padding
    (2, 130, 1030, 1, 24),    # a 6-key last P block
    (1, 300, 1300, 2, 128),   # head dim 128's layout: channel-major v8
])
def test_k7_order_matches_the_plain_int8pv(b, sq, skv, h, d):
    """The kernel's order (max pass first, alpha 1 throughout, P quantized
    against each block's own max, l of the exact p) gives the dense plain
    version's output: p8 is a ratio to its block's max, so only f32
    rounding differs, and a p8 at a rounding tie may move by one step:
    held to 2e-3 of the largest output, as the plain pair with JAX."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(8, b, sq, skv, h, d))
    scale = d ** -0.5
    ref = tattn.flash_attention_int8_plain(q, k, v, scale, pv_int8=True).float()
    out = _k7_order(q, k, v, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=2e-3 * ref.abs().max().item() + 2.0 ** -8 * ref.abs().max().item())


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 80, 96, 128, 144, 160])
def test_int8pv_geometry_matches_the_kernel_source(d):
    """K7's tiles: two 64-row blocks per consumer warpgroup up to DP = 48,
    one above, with 128-key tiles up to DP = 96; 4 stages (at D = 128 3,
    of 128-key tiles); a P block a
    whole number of tiles; the shared memory of both kernels fits a block;
    the rules are those of `csrc/flash_attention_int8.cu` and its pre-pass
    of `csrc/flash_attention_qk_int8.cu`."""
    from pathlib import Path

    g = tattn.int8pv_geometry(2, 35640, 35640, 8, d)
    assert g["dk"] == tattn.qk_int8_geometry(2, 35640, 35640, 8, d)["dk"]
    assert g["row_blocks"] == (2 if g["dp"] <= 48 else 1)
    assert g["pb"] == 1024 and g["n_kb"] == 35 and g["pb"] % g["kv_rows"] == 0
    assert g["tiles_per_block"] * g["kv_rows"] == g["pb"]
    assert max(g["smem"], g["smem_maxpass"]) <= tattn.SMEM_PER_BLOCK
    assert g["q_rows"] <= g["bq"] and g["bq"] % g["q_rows"] == 0
    # registers a consumer thread keeps live: scores, int32 p.v sums, the
    # f32 accumulator and p8's A fragments
    mb, bk, dp = g["row_blocks"], g["kv_rows"], g["dp"]
    # (at head dim 128, 128-key tiles: 208, under 240 less what the rows'
    # maxes, sums, scales and the loop keep)
    assert mb * (bk // 2 + dp + bk // 8) <= (208 if d == 128 else 200)
    assert tattn.int8pv_geometry(1, 100, 300, 1, d)["pb"] == 384
    csrc = Path(tattn.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_attention_int8.cu").read_text()
    for rule in ("row_blocks(int dp) { return dp <= 48 ? 2 : 1; }",
                 "return row_blocks(dp) == 2 ? 64 : (dp <= 96 ? 128 : 64);",
                 "constexpr int NST = 4;", "constexpr int PBLOCK = 1024;",
                 "return (size_t)q_rows(dp) * dk + (size_t)NST * kv_rows(dp) * (dk + dp + 4) +",
                 "return (size_t)q_rows(dp) * dp * 2 + (size_t)NST * kv_rows(dp) * (dp * 2 + 4) +",
                 "const cuuint64_t dims[4] = {16, (cuuint64_t)D, (cuuint64_t)n_vc, (cuuint64_t)BH};"):
        assert rule in src, rule
    pre = (csrc / "flash_attention_qk_int8.cu").read_text()
    assert "const int perm = 4 * ((kp % 8) / 2) + 2 * (kp / 8) + kp % 2;" in pre
    if d != 128:
        assert g["bf16_copies"] and g["swizzle"] == 0 and "qb" in g["shapes"]
        return
    # head dim 128: q8 and k8 row-major, v8 channel-major, all in the
    # 128-byte swizzle; 128-key tiles; the max pass on q8 and k8 by s8 wgmma
    assert not g["bf16_copies"] and g["swizzle"] == 128 and "qb" not in g["shapes"]
    assert (g["row_blocks"], g["q_rows"], g["kv_rows"], g["tiles_per_block"]) == (1, 128, 128, 8)
    assert g["shapes"]["v8"] == (16, 128, 35712)
    assert g["maps"]["v8"] == {"dims": (35712, 128, 16, 1),
                               "strides": (35712, 35712 * 128, 35712 * 128 * 16),
                               "box": (128, 128, 1, 1), "swizzle": 128}
    assert g["maps"]["q8"]["box"] == (128, 128, 1, 1)
    assert g["stages"] == 3
    assert g["smem"] == 128 * 128 + 3 * 128 * 260 + 56 + 1024
    assert g["smem_maxpass"] == 128 * 128 + 3 * 128 * 132 + 56 + 1024
    for rule in ("constexpr int SW_D = 128;", "constexpr int SW_BQ = 128;",
                 "constexpr int SW_BK = 128;", "constexpr int SW_NST = 3;",
                 "constexpr size_t SW_SMEM = (size_t)SW_BQ * SW_D + (size_t)SW_NST * SW_BK * "
                 "(2 * SW_D + 4) +",
                 "constexpr int NS = SW ? SW_NST : NST;",
                 "tensor_map_rows_sw128(&tv, v8, B * H, SW_D, skv_pad, SW_D);",
                 "tensor_map_rows_sw128(&tq, qb, B * H, Sq, SW_D, bq_rows)",
                 "return launch_blockmax<SW_D, true>(qb, kb, sq, sk, blockmax, B, H, Sq, Skv, bq,"):
        assert rule in src, rule
    assert "reinterpret_cast<uint4*>(v8 + ((long)bh * D + c) * skv_pad + k0)[u] =" in pre


@pytest.mark.parametrize("d", [40, 80, 112, 120, 128, 160])
def test_int8_wrappers_copy_all_but_head_dim_128(d):
    """At head dim 128 K6's operands hold v itself (the kernel reads it in
    place, the pre-pass writes no copy) and K7's hold no bf16 copies of q8
    and k8 (the max pass reads q8 and k8); at every other head dim, the
    UNet's 40 / 80 / 160 and 112 / 120 near 128 included, the chunk-major v
    copy and the bf16 copies are made as before."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(9, 1, 130, 200, 2, d))
    g6, g7 = tattn.qk_int8_geometry(1, 130, 200, 2, d), tattn.int8pv_geometry(1, 130, 200, 2, d)
    ops6, ops7 = tattn.qk_int8_operands(q, k, v), tattn.int8pv_operands(q, k, v)
    assert g6["v_copy"] == g7["bf16_copies"] == (d != 128)
    assert (ops6["v"] is v) == (d == 128)
    assert ("qb" in ops7) == ("kb" in ops7) == (d != 128)
    assert ops6["q8"].dim() == ops7["q8"].dim() == (3 if d == 128 else 4)
    if d != 128:
        assert tuple(ops6["v"].shape) == (2, d // 8, 200, 8)
        assert ops7["qb"].dtype == torch.bfloat16


def test_chunk_major_round_trip():
    x = torch.arange(2 * 5 * 48).reshape(2, 5, 48)
    c = tattn.chunk_major(x, 16)
    assert c.shape == (2, 3, 5, 16) and c[1, 2, 4, 3] == x[1, 4, 2 * 16 + 3]
    assert torch.equal(tattn.from_chunk_major(c), x)


def test_k6_argtypes_match_the_c_entry_points():
    """ctypes passes what `argtypes` says: one type per C parameter."""
    import re
    from pathlib import Path

    text = (Path(tattn.__file__).resolve().parent.parent / "csrc"
            / "flash_attention_qk_int8.cu").read_text()
    text += (Path(tattn.__file__).resolve().parent.parent / "csrc"
             / "flash_attention_int8.cu").read_text()
    for entry, types in (("tclight_qk_int8_prepass", tattn.PREPASS_ARGTYPES),
                         ("tclight_flash_attention_qk_int8", tattn.K6_ARGTYPES),
                         ("tclight_int8pv_prepass", tattn.PV_PREPASS_ARGTYPES),
                         ("tclight_int8pv_blockmax", tattn.MAXPASS_ARGTYPES),
                         ("tclight_flash_attention_int8pv", tattn.K7_ARGTYPES)):
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
        assert m and len(m.group(1).split(",")) == len(types), entry


def test_k6_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_qk_int8` builds each variant of K6 by
    text substitution: every replaced text is still in the source, and each
    variant differs from the kernel (the base variant excepted)."""
    from tclight_torch import ablate_qk_int8

    texts = ablate_qk_int8.variant_sources()
    assert set(texts) == set(ablate_qk_int8.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "flash_int8_wgmma_kernel" in text


def test_k7_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_int8pv` builds each variant of K7's
    kernels by text substitution: every replaced text is still in the
    source, and each variant differs from the kernels (base excepted)."""
    from tclight_torch import ablate_int8pv

    texts = ablate_int8pv.variant_sources()
    assert set(texts) == set(ablate_int8pv.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "flash_int8pv_wgmma_kernel" in text and "flash_int8_blockmax_kernel" in text
