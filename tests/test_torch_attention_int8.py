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


@pytest.mark.parametrize("d", [40, 80, 160])
def test_int8_prepass_lays_out_the_kernel_operands(d):
    """The plain pre-pass of K6 / K7: contiguous (a B = 1 head-major view is
    not), head dim padded with zeros to the int8 MMA depth, keys to 64, the
    Q scale per 1024-row block; with pv_int8 V quantized per channel, (BH,
    Skv, D). The kernels' layout made from it (`qk_int8_operands_plain`,
    `int8pv_operands_plain`) copies nothing at any head dim: q8 and k8 its
    real rows, row-major, ceil16(D) bytes a row; K6's v the input itself;
    K7's v8 channel-major (`v8_channels`) and no copy of q8 or k8."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(3, 1, 1030, 200, 2, d))
    dk, dr = -(-d // 32) * 32, -(-d // 16) * 16
    ops = tattn.int8_prepass(q, k, v, pv_int8=True)
    assert all(t.is_contiguous() for t in ops.values() if torch.is_tensor(t))
    assert ops["q8"].shape == (2, 2048, dk) and ops["q8"].dtype == torch.int8
    assert ops["k8"].shape == (2, 256, dk) and ops["sk"].shape == (2, 256)
    assert ops["sq"].shape == (2, 2) and ops["bq"] == 1024
    assert ops["v8"].shape == (2, 200, d) and ops["sv"].shape == (2, d)
    assert (ops["q8"][:, :, d:] == 0).all() and (ops["k8"][:, 200:] == 0).all()
    q8, sqs = tattn.quantize_blocks(torch.nn.functional.pad(
        tattn._heads_first(q), (0, 0, 0, 2048 - 1030)), 1024)
    assert torch.equal(ops["q8"][:, :, :d], q8) and torch.equal(ops["sq"], sqs)
    v8, sv = tattn.quantize_channels(tattn._heads_first(v))
    assert torch.equal(ops["v8"], v8) and torch.equal(ops["sv"], sv)
    k6, k7 = tattn.qk_int8_operands_plain(q, k, v), tattn.int8pv_operands_plain(q, k, v)
    for o in (k6, k7):
        assert o["q8"].shape == (2, 1030, dr) and o["k8"].shape == (2, 200, dr)
        assert o["q8"].is_contiguous() and o["k8"].is_contiguous()
        assert torch.equal(o["q8"], ops["q8"][:, :1030, :dr])
        assert torch.equal(o["k8"], ops["k8"][:, :200, :dr])
    assert k6["v"] is v and set(k7) == {"q8", "k8", "v8", "sq", "sk", "sv", "bq"}
    assert torch.equal(k7["v8"], tattn.v8_channels(ops["v8"])) and k7["v8"].shape == (2, d, 256)


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


def _from_v8_channels(v8c: torch.Tensor, skv: int):
    """Inverse of `v8_channels`: (BH, D, keys) -> (BH, keys, D), byte 4t +
    2a + c of each 16 keys being key 8a + 2t + c; the real keys and the
    padding."""
    bh, d, n = v8c.shape
    x = v8c.reshape(bh, d, n // 16, 4, 2, 2).permute(0, 2, 4, 3, 5, 1)  # (bh, chunk, a, t, c, d)
    return x.reshape(bh, n, d)[:, :skv], x.reshape(bh, n, d)[:, skv:]


def test_v8_channels_key_order():
    """K7's channel-major v8 (BH, D, ceil128(Skv)): each channel's keys
    contiguous, padded with zeros to 128, and within each 16 byte 4t + 2a +
    c holding key 8a + 2t + c, the k32 A fragment's order: bytes 4t..4t+3
    of each 16 keys hold a thread's keys 2t, 2t + 1, 8 + 2t, 9 + 2t (the
    score fragment's keys of two 8-key blocks, packed as they lie)."""
    keys = torch.arange(40, dtype=torch.int8)[None, :, None].repeat(1, 1, 3)
    keys[..., 1] += 50
    c = tattn.v8_channels(keys)
    assert c.shape == (1, 3, 128) and c.is_contiguous()
    for t in range(4):
        assert c[0, 1, 16 + 4 * t:16 + 4 * t + 4].tolist() == [
            66 + 2 * t, 67 + 2 * t, 74 + 2 * t, 75 + 2 * t]
    back, pad = _from_v8_channels(c, 40)
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


def _kernel_k_scales_of(jsk) -> np.ndarray:
    """JAX's K scales as the kernels take them: the two lowest significand
    bits cleared (`kernel_k_scales`)."""
    return (np.asarray(jsk, dtype=np.float32).view(np.int32) & ~3).view(np.float32)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1030, 200, 2, 40),    # two Q-scale blocks, rows of 48 bytes, depth 64
    (2, 300, 1100, 1, 80),    # one Q block of 384 rows, a ragged last k slice
    (1, 129, 65, 2, 8),       # the smallest head dim
    (1, 64, 130, 1, 160),     # the largest
    (1, 1030, 200, 2, 128),   # head dim 128
    (2, 300, 1100, 1, 128),
    (2, 130, 65, 1, 40),      # B = 2, a ragged 128-key tile
    (1, 300, 1100, 2, 160),   # two heads, ragged 64-key tiles
])
def test_qk_int8_operands_match_jax_quantizers(b, sq, skv, h, d):
    """K6's operands in the layout its pre-pass kernels write
    (`qk_int8_operands`, the plain version on the CPU): q8 and the Q scales
    equal JAX's `_quantize_blocks` of the zero-padded queries, k8 and the K
    scales JAX's `_quantize_rows` of K minus its token mean (bf16 inputs:
    bit-equal, see `test_k_smoothing_matches`), v the input itself at every
    head dim; q8 and k8 row-major, ceil16(D) bytes a row, the dims past D
    and the padded keys' scales zeros."""
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
    assert ops["v"] is tv and g["row_bytes"] == ops["q8"].shape[-1] == -(-d // 16) * 16
    q8, k8 = ops["q8"], ops["k8"]
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


def test_kernel_k_scales_make_the_products_exact():
    """The K scales' pair makes a score as fma(float(1.5 * 2^23 + x), sk', -1.5 *
    2^23 * sk') (`kernel_k_scales`), x * sk' rounded once for every int32
    dot |x| < 2^22: the pair's second term is exact, and sk' is within 3
    units in the last place of sk (two significand bits cleared)."""
    rng = np.random.default_rng(11)
    sk = torch.from_numpy((rng.uniform(1e-8, 1e-1, 4096)).astype(np.float32))[None]
    pair = tattn.kernel_k_scales(sk)[0].double()
    assert pair.shape == (2, 4096) and torch.equal(pair[0] * -12582912.0, pair[1])
    assert ((pair[0] - sk[0].double()).abs() <= 3 * 2.0 ** -23 * sk[0].double()).all()
    x = torch.from_numpy(rng.integers(-2 ** 22 + 1, 2 ** 22, 4096)).double()
    # (M + x) * sk' is exact in f64 (24 + 23 bits), so the f64 sum rounded
    # once to f32 is the FMA's result
    fma = ((12582912.0 + x) * pair[0] + pair[1]).float()
    assert torch.equal(fma, x.float() * pair[0].float())


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 80, 96, 128, 144, 160])
def test_qk_int8_geometry_matches_the_kernel_source(d):
    """K6 takes K1's tiles at every head dim (consumer warpgroups, q rows,
    keys a tile, stages, the row sums on the tensor cores at d = dp - 8 up
    to dp 64); its q.k^T depth dk is d padded to 32, a q8 or k8 row is
    ceil16(d) bytes, read in boxes of 64 bytes in the 64-byte swizzle where
    dk <= 64, else of 128 bytes in the 128-byte swizzle (ceil(dk / box) a
    row), by a tile's rows, v in place through K1's map;
    a warpgroup's 64 rows lie in one Q-scale block; its shared memory fits
    a block; the rules are those of `csrc/flash_attention_qk_int8.cu` and
    `csrc/hopper.cuh`."""
    from pathlib import Path

    g = tattn.qk_int8_geometry(2, 35640, 35640, 8, d)
    k1 = tattn.flash_geometry(2, 35640, 35640, 8, d)
    assert g["dk"] % 32 == 0 and d <= g["dk"] < d + 32 and g["dp"] == k1["dp"] == g["row_bytes"]
    for key in ("consumers", "q_rows", "kv_rows", "stages", "sums_on_tc", "threads", "grid"):
        assert g[key] == k1[key], key
    row8 = 64 if g["dk"] <= 64 else 128
    assert g["row8"] == row8 and g["slabs8"] == -(-g["dk"] // row8)
    bk, dp = g["kv_rows"], g["dp"]
    smem = (g["q_rows"] * g["slabs8"] * row8 + g["stages"] * bk * (g["slabs8"] * row8
                                                                   + k1["slabs"] * 128 + 4)
            + 8 * (1 + 2 * g["stages"]) + 1024)
    assert g["smem"] == smem <= tattn.SMEM_PER_BLOCK
    assert g["bq"] == 1024 and g["n_qb"] == 35 and g["skv_pad"] % 128 == 0
    assert g["bq"] % 64 == 0  # a warpgroup's 64 rows read one sq
    assert g["shapes"]["q8"] == (16, 35640, dp) and g["shapes"]["k8"] == (16, 35640, dp)
    assert g["shapes"]["v"] == (2, 35640, 8, d) and g["shapes"]["sk"] == (16, 35712)
    for name, rows in (("q8", g["q_rows"]), ("k8", bk)):
        assert g["maps"][name] == {"dims": (dp, 35640, 16, 1),
                                   "strides": (dp, dp * 35640, dp * 35640 * 16),
                                   "box": (row8, rows, 1, 1), "swizzle": row8}
    assert g["maps"]["v"] == k1["maps"]["v"] and k1["maps"]["v"]["swizzle"] == 128
    csrc = Path(tattn.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_attention_qk_int8.cu").read_text()
    k1_src = (csrc / "flash_attention.cu").read_text()
    hopper = (csrc / "hopper.cuh").read_text()
    for rule in ("consumers(int dp) { return dp <= 64 ? 3 : 2; }",
                 "kv_rows(int dp) { return dp <= 128 ? 128 : 64; }",
                 "n_stages(int dp) { return dp <= 64 ? 4 : 3; }",
                 "sums_on_tc(int dp) { return dp <= 64; }"):
        assert rule in src and rule in k1_src, rule
    for rule in ("depth8(int dp) { return (dp + 31) / 32 * 32; }",
                 "row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }",
                 "return kv_rows(dp) * (slabs8(dp) * row8(dp) + slabs(dp) * SLAB * 2 + 4);",
                 "constexpr int SLICE = 256;",
                 "constexpr int W16 = (D + 15) / 16;",
                 "tensor_map_rows_sw(&tq, q8, B * H, Sq, DP, row8(DP), q_rows(DP))",
                 "tensor_map_bshd_slabs(&tv, v, B, Skv, H, D, kv_rows(DP))",
                 "min((q0 + cw * 64) / bq, n_qb - 1)"):
        assert rule in src, rule
    for rule in ("const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)N, 1};",
                 "const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)rows, 1, 1};",
                 "swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B",
                 "return row == 64 ? wgmma_desc_sw64(p, 16, 512) : wgmma_desc_sw128(p, 16, 1024);"):
        assert rule in hopper, rule


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1030, 200, 2, 40),    # two Q-scale blocks, 200 keys: a ragged 16-key chunk
    (2, 300, 1100, 1, 80),    # a ragged last k slice and P block
    (1, 129, 65, 2, 8),       # the smallest head dim
    (1, 64, 130, 1, 160),     # the largest
    (1, 1030, 200, 2, 128),   # head dim 128
    (2, 300, 1100, 1, 128),
])
def test_int8pv_operands_match_jax_quantizers(b, sq, skv, h, d):
    """K7's operands in the layout its pre-pass kernels write
    (`int8pv_operands`, the plain version on the CPU), read back: q8, k8
    and their scales as for K6 (`test_qk_int8_operands_match_jax_quantizers`),
    v8 and sv equal to JAX's `_quantize_channels` of the heads-first V
    (bf16 inputs: bit-equal), v8 channel-major with the keys up to
    ceil128(Skv) past Skv zero; no copy of q8 or k8 at any head dim."""
    q, k, v = _qkv(6, b, sq, skv, h, d)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    jv, tv = _pair(v, "bf16")
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    ops = tattn.int8pv_operands(tq, tk, tv)
    names = ("q8", "k8", "v8", "sq", "sk", "sv")
    assert set(names) | {"bq"} == set(ops)
    for name in names:
        assert tuple(ops[name].shape) == g["shapes"][name], name
        assert ops[name].is_contiguous()
    assert ops["v8"].dtype == torch.int8 and ops["bq"] == g["bq"]
    bq, sq_pad = g["bq"], g["n_qb"] * g["bq"]
    jqt = jq.transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    jq8, jsq = jattn._quantize_blocks(jnp.pad(jqt, ((0, 0), (0, sq_pad - sq), (0, 0))), bq)
    np.testing.assert_array_equal(ops["q8"][:, :, :d].numpy(), np.asarray(jq8)[:, :sq])
    np.testing.assert_array_equal(ops["sq"].numpy(), np.asarray(jsq))
    jkt = jk.transpose(0, 2, 1, 3).reshape(b * h, skv, d)
    jk8, jsk = jattn._quantize_rows(jkt - jnp.mean(jkt, axis=1, keepdims=True))
    np.testing.assert_array_equal(ops["k8"][:, :, :d].numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(ops["sk"][:, 0, :skv].numpy(), _kernel_k_scales_of(jsk))
    np.testing.assert_array_equal(ops["sk"][:, 1, :skv].numpy(),
                                  _kernel_k_scales_of(jsk) * np.float32(-12582912.0))
    assert (ops["sk"][:, :, skv:] == 0).all()
    jv8, jsv = jattn._quantize_channels(jv.transpose(0, 2, 1, 3).reshape(b * h, skv, d))
    v8, pad = _from_v8_channels(ops["v8"], skv)
    np.testing.assert_array_equal(v8.numpy(), np.asarray(jv8))
    np.testing.assert_array_equal(ops["sv"].numpy(), np.asarray(jsv))
    assert (pad == 0).all() and pad.shape[1] == g["skv_pad"] - skv


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 1100, 1300, 2, 40),   # two P blocks, the second ragged (276 keys)
    (2, 300, 700, 1, 80),     # one P block of 768 keys, 68 of them padding
    (1, 2100, 1030, 1, 24),   # three Q-scale blocks, a 6-key last P block
    (1, 1100, 1300, 2, 128),  # head dim 128
    (2, 300, 700, 1, 128),
    (1, 300, 1300, 1, 160),   # head dim 160: 64-key tiles
])
def test_int8_block_rowmax_plain_matches_jax(b, sq, skv, h, d):
    """K7's first sweep, plain: each (query, P block)'s logit max, against the
    block maxes of the logits that `_flash_attention_int8_xla` forms from
    JAX's quantized operands with the kernels' K scales (JAX's, two
    significand bits cleared: `kernel_k_scales`), times log2(e) (the kernel
    works in log2 units), the padded keys left out. The two multiply the
    same exact dots by the same scales in another order: within 4 f32
    ulps."""
    q, k, v = _qkv(7, b, sq, skv, h, d)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    _, tv = _pair(v, "bf16")
    scale = d ** -0.5
    ops = tattn.int8pv_operands(tq, tk, tv)
    bm = tattn.int8_block_rowmax_plain(ops, sq, skv, scale)
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    assert tuple(bm.shape) == (b * h, sq, g["n_kb"])
    bh, bq, pb = b * h, g["bq"], g["pb"]
    jqt = jq.transpose(0, 2, 1, 3).reshape(bh, sq, d)
    jkt = jk.transpose(0, 2, 1, 3).reshape(bh, skv, d)
    q8, sqs = jattn._quantize_blocks(jnp.pad(jqt, ((0, 0), (0, g["n_qb"] * bq - sq), (0, 0))), bq)
    k8, sks = jattn._quantize_rows(jkt - jnp.mean(jkt, axis=1, keepdims=True))
    dots = jax.lax.dot_general(q8, k8, (((2,), (2,)), ((0,), (0,))),
                               preferred_element_type=jnp.int32)
    logits = (dots.astype(jnp.float32)[:, :sq] * (scale * jnp.repeat(sqs, bq, axis=1)[:, :sq, None])
              * jnp.asarray(_kernel_k_scales_of(sks))[:, None, :])
    logits = jnp.pad(logits, ((0, 0), (0, 0), (0, g["n_kb"] * pb - skv)),
                     constant_values=-jnp.inf)
    ref = np.asarray(logits.reshape(bh, sq, g["n_kb"], pb).max(axis=-1)) * np.log2(np.e)
    np.testing.assert_allclose(bm.numpy(), ref, rtol=4 * 2.0 ** -23, atol=0)


def _k7_operands(q, k, v, scale):
    """K7's operands (`int8pv_operands`), each P block's logit max (its
    first sweep, plain), the exact dots x, the K scales sk', the row factor
    c = scale * log2(e) * sq and v8 as (BH, Skv, D)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ops = tattn.int8pv_operands(q, k, v)
    g = tattn.int8pv_geometry(b, sq, skv, h, d)
    bm = tattn.int8_block_rowmax_plain(ops, sq, skv, scale)
    x = torch.matmul(ops["q8"].double(), ops["k8"].double().transpose(1, 2))
    c = (scale * np.log2(np.e)
         * ops["sq"].double().repeat_interleave(g["bq"], 1)[:, :sq, None])
    v8 = _from_v8_channels(ops["v8"], skv)[0]
    return ops, g, bm, x, ops["sk"][:, 0, None, :skv], c, v8


def _k7_order(q, k, v, scale):
    """K7's arithmetic in the order of the kernel before the online max,
    on the CPU: the row max m from every P block's max first, p = exp2(w -
    bm), p8 = round(127 p), each P block's exact p8 . v8 dequantized with sp
    / 127 (sp = exp2(bm - m)), l the sum of sp * p, out = acc * sv / l; in
    f64."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ops, g, bm, x, sk, c, v8 = _k7_operands(q, k, v, scale)
    w = x * sk.double() * c
    v8 = v8.double()
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


def _k7_online_order(q, k, v, scale):
    """K7's arithmetic in the fused kernel's order, on the CPU, in f32 as
    the kernel computes it: P blocks in turn, each block's max bm from its
    first sweep; at the block's start the running row max m moves to m_new
    = max(m, bm), l and acc take alpha = exp2(m - m_new) and sp = exp2(bm -
    m_new); p = exp2(x * sk' * c - bm), p8 = round(127 p) (half to even),
    the block's p8 . v8 exact in int32 and dequantized with sp / 127, l +=
    sp * sum(p); out = acc * sv / max(l, 1e-30). Also returns the smallest
    alpha of a block start after the first, per row."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    ops, g, bm, x, sk, c, v8 = _k7_operands(q, k, v, scale)
    u = x.float() * sk  # exact dots times sk', rounded once
    c, v8 = c.float(), v8.to(torch.int64)
    m = torch.full((b * h, sq, 1), -np.inf)
    acc = torch.zeros(b * h, sq, d)
    l = torch.zeros(b * h, sq, 1)
    alpha_min = torch.ones(b * h, sq, 1)
    for kb in range(g["n_kb"]):
        sl = slice(kb * g["pb"], min(skv, (kb + 1) * g["pb"]))
        bmk = bm[:, :, kb, None]
        m_new = torch.maximum(m, bmk)
        alpha = torch.exp2(m - m_new)
        sp = torch.exp2(bmk - m_new)
        if kb:
            alpha_min = torch.minimum(alpha_min, alpha)
        p = torch.exp2(u[:, :, sl] * c - bmk)
        pv = torch.matmul(torch.round(127 * p).to(torch.int64), v8[:, sl]).float()
        acc = acc * alpha + pv * (sp / 127)
        l = l * alpha + sp * p.sum(dim=-1, keepdim=True)
        m = m_new
    out = acc * ops["sv"][:, None, :] / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3), alpha_min


def _rising_qkv(seed, b, sq, skv, h, d):
    """Inputs whose logits rise from P block to P block: q leans on a
    direction u and k's part along u grows with the key, ~3 nats a
    1024-key block beside noise of ~1."""
    q, k, v = _qkv(seed, b, sq, skv, h, d)
    u = np.ones(d, np.float32) / np.sqrt(d)
    ramp = np.linspace(-1.0, 1.0, skv, dtype=np.float32)[None, :, None, None]
    return q + 3 * u, k + 2 * np.sqrt(d) * ramp * u, v


@pytest.mark.parametrize("order", ["max_first", "online"])
@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 300, 1300, 2, 40),    # a ragged second P block
    (1, 200, 700, 1, 80),     # one P block with padding
    (2, 130, 1030, 1, 24),    # a 6-key last P block
    (1, 300, 1300, 2, 128),   # head dim 128
    (1, 200, 700, 2, 160),    # head dim 160: 64-key tiles
    (1, 70, 3300, 2, 40),     # four P blocks whose logits rise: alpha < 1
])
def test_k7_order_matches_the_plain_int8pv(order, b, sq, skv, h, d):
    """The kernel's order gives the dense plain version's output: the order
    of the kernel before (`max_first`: every block max first, alpha 1
    throughout) and the fused kernel's (`online`: the row max kept online
    across P blocks, acc and l rescaled by alpha once a block), P quantized
    against each block's own max and l of the exact p in both: p8 is a
    ratio to its block's max, so only f32 rounding differs, and a p8 at a
    rounding tie may move by one step: held to 2e-3 of the largest output,
    as the plain pair with JAX. The last shape's logits rise from block to
    block, so the online order's alpha is below 1 at every block start."""
    make = _rising_qkv if skv == 3300 else _qkv
    q, k, v = (torch.from_numpy(a).bfloat16() for a in make(8, b, sq, skv, h, d))
    scale = d ** -0.5
    ref = tattn.flash_attention_int8_plain(q, k, v, scale, pv_int8=True).float()
    if order == "online":
        out, alpha_min = _k7_online_order(q, k, v, scale)
        if skv == 3300:
            assert (alpha_min < 0.5).float().mean().item() >= 0.9
    else:
        out = _k7_order(q, k, v, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=2e-3 * ref.abs().max().item() + 2.0 ** -8 * ref.abs().max().item())


def test_k7_online_order_matches_jax():
    """The fused kernel's order against JAX's `_flash_attention_int8_xla`
    (what "pallas_int8pv" runs off the TPU) on the same bf16 inputs, whose
    logits rise over three P blocks: as the plain pair, 2e-3 of the largest
    output and a bf16 step."""
    q, k, v = _rising_qkv(12, 1, 130, 2500, 2, 40)
    jq, tq = _pair(q, "bf16")
    jk, tk = _pair(k, "bf16")
    jv, tv = _pair(v, "bf16")
    scale = 40 ** -0.5
    ref = np.asarray(jattn._flash_attention_int8_xla(jq, jk, jv, scale, pv_int8=True)
                     .astype(jnp.float32))
    out, alpha_min = _k7_online_order(tq, tk, tv, scale)
    assert (alpha_min < 0.5).float().mean().item() >= 0.9
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max() + 2.0 ** -8 * np.abs(ref).max())


@pytest.mark.parametrize("d", [8, 16, 24, 40, 64, 80, 96, 128, 144, 160])
def test_int8pv_geometry_matches_the_kernel_source(d):
    """K7's tiles are K6's (K1's) at every head dim but for the consumer
    warpgroups: three up to dp 48, two above; 128-key tiles up to dp 128,
    64 above, a v8 ring of 4 stages up to dp 64, 3 above; a P block a whole
    number of tiles; v8 channel-major (BH, D, ceil128(Skv)) in boxes of a
    tile's keys by dp channels, in the 128-byte swizzle at 128 keys and the
    64-byte one at 64; a k8 ring of a P block's tiles and two or four more
    (sweep 1 runs a block ahead of sweep 2), each tile loaded once, where it
    fits the block's shared memory (up to dp 112: the UNet's 40 and 80), else
    four slots, each tile loaded twice (the DiTs' 128, the UNet's 160); the
    shared memory fits a block; the registers a consumer keeps live fit its
    share; the rules are those of `csrc/flash_attention_int8.cu`, its
    pre-pass's of `csrc/flash_attention_qk_int8.cu` and `csrc/hopper.cuh`."""
    from pathlib import Path

    g = tattn.int8pv_geometry(2, 35640, 35640, 8, d)
    g6 = tattn.qk_int8_geometry(2, 35640, 35640, 8, d)
    for key in ("dk", "dp", "kv_rows", "stages", "row8", "slabs8"):
        assert g[key] == g6[key], key
    assert g["consumers"] == (3 if g["dp"] <= 48 else 2) and g["q_rows"] == 64 * g["consumers"]
    bk, dp, row8 = g["kv_rows"], g["dp"], g["row8"]
    assert g["pb"] == 1024 and g["n_kb"] == 35 and g["pb"] % bk == 0
    assert g["tiles_per_block"] * bk == g["pb"]
    assert g["smem"] <= tattn.SMEM_PER_BLOCK
    assert g["resident"] == (dp <= 112)
    assert g["k_slots"] == (g["tiles_per_block"] + (4 if dp <= 64 else 2) if g["resident"] else 4)
    assert g["q_rows"] <= 256 and g["bq"] % 64 == 0
    # registers a consumer thread keeps live: scores, int32 p.v sums, the
    # f32 accumulator and p8's A fragments, under its share (160 with three
    # consumers, 240 with two) less what the rows' maxes, sums, scales,
    # sweep 1's running maxes and the loop keep
    live = bk // 2 + dp + bk // 8
    assert live <= (136 if g["consumers"] == 3 else 208)
    assert tattn.int8pv_geometry(1, 100, 300, 1, d)["pb"] == 384
    assert g["shapes"]["v8"] == (16, d, 35712) and "qb" not in g["shapes"]
    assert g["shapes"]["sk"] == (16, 2, 35712)
    assert g["maps"]["v8"] == {"dims": (35712, d, 16, 1),
                               "strides": (35712, 35712 * d, 35712 * d * 16),
                               "box": (bk, dp, 1, 1), "swizzle": bk}
    assert g["maps"]["k8"] == g6["maps"]["k8"]
    assert g["maps"]["q8"] == {**g6["maps"]["q8"], "box": (row8, g["q_rows"], 1, 1)}
    q_tile, k_tile = g["q_rows"] * g["slabs8"] * row8, bk * g["slabs8"] * row8
    slots, stages = g["k_slots"], g["stages"]
    bars = 8 * (1 + 2 * slots + 2 * stages) + 1024
    assert g["smem"] == q_tile + slots * (k_tile + 4 * bk) + stages * dp * bk + bars
    if not g["resident"]:  # the ring of a P block's tiles and two more does not fit
        n = g["tiles_per_block"] + 2
        big = q_tile + n * (k_tile + 4 * bk) + stages * dp * bk + 8 * (1 + 2 * n + 2 * stages)
        assert big + 1024 > tattn.SMEM_PER_BLOCK
    csrc = Path(tattn.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_attention_int8.cu").read_text()
    for rule in ("consumers(int dp) { return dp <= 48 ? 3 : 2; }",
                 "kv_rows(int dp) { return dp <= 128 ? 128 : 64; }",
                 "n_stages(int dp) { return dp <= 64 ? 4 : 3; }",
                 "row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }",
                 "constexpr int PBLOCK = 1024;",
                 "constexpr size_t SMEM_MAX = 232448;",
                 "return kv_rows(dp) * (slabs8(dp) * row8(dp) + 4);",
                 "return res ? PBLOCK / kv_rows(dp) + (dp <= 64 ? 4 : 2) : 4;",
                 "resident(int dp) { return smem_bytes(dp, true) <= SMEM_MAX; }",
                 "tensor_map_rows_sw(&tv, v8, B * H, D, skv_pad, bk, DP)",
                 "tensor_map_rows_sw(&tq, q8, B * H, Sq, DP, row8(DP), bq_rows)",
                 "wgmma_desc_sw64(tV + kk * 32, 16, 8 * BK)"):
        assert rule in src, rule
    pre = (csrc / "flash_attention_qk_int8.cu").read_text()
    assert "const int perm = 4 * ((kp % 8) / 2) + 2 * (kp / 8) + kp % 2;" in pre
    assert "reinterpret_cast<uint4*>(v8 + ((long)bh * D + c) * skv_pad + k0)[u] =" in pre
    assert "const float s_kern = __uint_as_float(__float_as_uint(s) & ~3u);" in pre


@pytest.mark.parametrize("d", [40, 80, 112, 120, 128, 160])
def test_int8_wrappers_copy_no_head_dim(d):
    """At every head dim, the UNet's 40 / 80 / 160, the DiTs' 128 and 112 /
    120 near it, K6's operands hold v itself (the kernel reads it in place,
    the pre-pass writes no copy), q8 and k8 are row-major (BH, S,
    ceil16(D)), and K7's operands hold no copy of q8 or k8 (the kernel
    reads q8 and k8) and a channel-major v8."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(9, 1, 130, 200, 2, d))
    ops6, ops7 = tattn.qk_int8_operands(q, k, v), tattn.int8pv_operands(q, k, v)
    assert ops6["v"] is v and "qb" not in ops7 and "kb" not in ops7
    for ops in (ops6, ops7):
        assert ops["q8"].shape == (2, 130, -(-d // 16) * 16) and ops["k8"].shape[:2] == (2, 200)
    assert ops7["v8"].shape == (2, d, 256)


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
                         ("tclight_flash_attention_int8pv", tattn.K7_ARGTYPES)):
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
        assert m and len(m.group(1).split(",")) == len(types), entry


def test_k6_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_qk_int8` builds each variant of K6 by
    text substitution: every replaced text is still in the source, and each
    variant differs from the kernel (the base variant excepted)."""
    from tclight_torch import ablate_qk_int8

    texts = ablate_qk_int8.variant_sources(ablate_qk_int8.VARIANTS, "flash_attention_qk_int8.cu")
    assert set(texts) == set(ablate_qk_int8.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "flash_int8_wgmma_kernel" in text


def test_k7_ablation_variants_apply_to_the_kernel_source():
    """`python -m tclight_torch.ablate_int8pv` builds each variant of K7 by
    text substitution: every replaced text is still in the source, and
    each variant differs from the kernel (base excepted). K7 is one kernel:
    no max pass of its own."""
    from tclight_torch import ablate_int8pv, ablate_qk_int8

    texts = ablate_qk_int8.variant_sources(ablate_int8pv.VARIANTS, "flash_attention_int8.cu")
    assert set(texts) == set(ablate_int8pv.VARIANTS)
    for name, text in texts.items():
        assert (text == texts["base"]) == (name == "base"), name
        assert "flash_int8pv_wgmma_kernel" in text and "blockmax_kernel" not in text
        assert "tclight_int8pv_blockmax" not in text


@pytest.mark.parametrize("kernel", ["K6", "K7", "K6-prepass", "K7-prepass"])
def test_turns_time_the_int8_parts_at_every_attention_shape(kernel, tmp_path):
    """`python -m tclight_torch.turns OTHER K6 K7 K6-prepass K7-prepass`
    times each int8 part at the UNet's five shapes and the DiTs' three,
    through the wrappers both checkouts have (K7's includes a checkout's
    max pass where it launches one); its leg program compiles."""
    import ast
    import inspect

    from tclight_torch import turns

    shapes = [sh for sh in turns.SHAPES if sh[0] == kernel]
    assert [sh[1] for sh in shapes] == ["L0", "L1", "L2", "yt-L0", "yt-L1", "dd", "t2w",
                                        "t2w-704"]
    ast.parse(turns.leg_code(tmp_path, shapes, tmp_path / "f.npy", tmp_path / "p.pt"))
    src = inspect.getsource(turns.leg)
    for name in ("qk_int8_operands", "int8pv_operands", "flash_attention_int8_cuda"):
        assert name in src, name


def test_turns_steps_are_chip_smokes_int8_runs(monkeypatch, tmp_path):
    """`python -m tclight_torch.turns OTHER steps` runs chip_smoke's
    `[yt-int8]`, `[int8]` and `[int8pv]` runs through each checkout's CLI:
    the navsim config for the yt pass and the main config for the others,
    the int8 flags as chip_smoke sets them, the post-optimization off, the
    prompt before the overrides (the CLI takes those as one list), on
    chip_smoke's videos; its leg program compiles."""
    import ast
    import sys
    from pathlib import Path

    from tclight_torch import turns

    root = Path(turns.__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "make_video", lambda path, n, h, w: None)
    runs = turns.step_runs(root)
    assert str(root) in sys.path
    assert [(k, label) for k, label, _ in runs] == [("steps", "yt-int8"), ("steps", "int8"),
                                                  ("steps", "int8pv")]
    for _, label, (config, video, overrides) in runs:
        assert (root / config).is_file()
        assert "post_opt.apply_opt=false" in overrides
        assert "generation.attn_qk_int8=true" in overrides
        assert ("generation.attn_pv_int8=true" in overrides) == (label == "int8pv")
        assert f"generation.n_timesteps={chip_smoke.STEPS}" in overrides
        frames = chip_smoke.YT_FRAMES if label == "yt-int8" else chip_smoke.FRAMES
        assert Path(video) == root / "build" / "turns" / f"vid{frames}"
        if label == "yt-int8":
            assert config == "configs/examples/tclight_navsim.yaml" and "-p" not in overrides
        else:
            assert config == "configs/tclight_default.yaml"
            assert overrides[:2] == ("-p", chip_smoke.PROMPT)
            assert all(not o.startswith("-") for o in overrides[2:])
    ast.parse(turns.leg_code(tmp_path, runs, tmp_path / "f.npy", tmp_path / "p.pt"))
    assert 'kernel == "steps"' in turns.leg_code(tmp_path, runs, None, None)
