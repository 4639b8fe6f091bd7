"""The port's hand-written CUDA kernels against their plain versions, on the
card, at small and ragged shapes: head dims that need padding to the MMA
depth, kv and q lengths that end inside a tile, dst counts that end inside
a tile, channel counts on every shared-memory path of the matcher (C =
40 and 72 read zero-filled channels), exact ties across ranges, batches,
64-channel slabs and the halves of a dst tile, and -0.0 / +0.0 maxima;
K1, which reads q, k and v in place in 64-dim swizzled boxes at every
head dim, at the UNet's 40 / 80 / 160 (660 and 2,228 tokens), at
every head dim that stops inside a 64-dim slab (zero-filled dims, a p.v
width inside a slab), with fewer keys than a tile, and at head dim 128
with ragged lengths, Sq != Skv, B > 1, 32 heads and a masked kv tail,
beside D = 120 and 112; libcuda's tensor-map encoder taking a 64-dim box
over fewer dims; K6 and K7, which read q8 and k8 row-major in 128-byte
swizzled boxes and v in place (K6) or v8 channel-major (K7) at every head
dim, and their pre-pass, at the UNet's 40 / 80 / 160, at 128 and at 8,
24, 112, 120 and 144, with ragged lengths, Sq != Skv both ways, B = 2, one
query and a kv tail inside a tile, and K7 (its P blocks' maxes made in a
first sweep, the row max kept online) with logits that rise from P block
to P block; for the window warp (K3) frames that end inside a tile, flows that
leave the frame, flow ranges up to 100 px, every channel count and both
kernels, frames under one wave of the card, smooth flows (the adjoint's one-limb tiles) and NaN cotangents
there; for the banded gathers (K4, K5) masked entries, int16 and int32 offsets, windows that run
past the table's end and K = 2, 3 windows; K4 on render-like and
adjoint-like plans at every channel count and at windows 1024-8192, and
with the plan's rows' blocks run together on a padded batch. Every
test here needs a CUDA device and skips without one; on the card run them
with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not need). Tolerances: K1's output is bf16 (2^-8 relative)
and its p.v product takes p in bf16, so it is held to 2e-2 of the largest
output, and so are the int8 kernels K6 and K7 (see their test); K6's
pre-pass kernels agree with the plain pre-pass bit for bit but where K's
token mean rounds otherwise (see their test), and so do K7's pre-pass
kernels, whose V operands are bit-equal; K2 sums exact bf16 products
in f32 in another order than the plain version, so its maxima agree to
1e-4 and an index may differ only where the best two scores are that
close, and exact ties go to the first b-major index under every split. K3 sums the same f32 taps in
another order (and with fused multiply-adds; its adjoint's atomic adds in
no fixed order), within 1e-5 of values of order 1 per unit of window
taps; K4 and K5 copy rows and agree exactly."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tclight_torch.ops import attention, banded_gather, kernels, match_kernel, warp_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 200, 200, 2, 40),     # D padded 40 -> 48, both lengths ragged
    (1, 130, 1500, 1, 24),
    (2, 77, 600, 3, 8),       # the smallest head dim
    (1, 300, 513, 2, 16),     # one key past a whole tile
    (1, 129, 65, 1, 144),     # one kv row in the last tile
    (2, 700, 900, 2, 80),
    (1, 260, 700, 2, 160),    # the largest head dim (level 2)
    (1, 40, 30, 1, 64),       # fewer keys than one tile
])
def test_flash_kernel_matches_plain(cuda, b, sq, skv, h, d):
    q = torch.randn(b, sq, h, d, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    scale = 0.7 * d ** -0.5
    before = kernels.STATS["flash_attention"].launches
    out = attention.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert kernels.STATS["flash_attention"].launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("d", [8, 40, 64, 80, 128, 160])
@pytest.mark.parametrize("sq,skv", [
    (1, 1),        # one query, one key
    (63, 129),     # one key past a whole 128-key tile
    (65, 63),      # fewer keys than one tile; one q row past a warpgroup's 64
    (129, 1031),   # one q row past a 128-row block; an odd kv length over 1000
    (1031, 65),
])
def test_flash_kernel_ragged_lengths_and_head_dims(cuda, d, sq, skv):
    """Every head dim the UNet and the tests use, with lengths that end on
    each side of the kernel's 64-row, 128-row and 128-key boundaries."""
    q = torch.randn(1, sq, 2, d, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(1, skv, 2, d, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(1, skv, 2, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    out = attention.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def test_flash_kernel_many_heads(cuda):
    """B * H over 1000: the grid's second axis."""
    b, h, sq, skv, d = 3, 350, 70, 200, 40
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=cuda).bfloat16()
               for s in (sq, skv, skv))
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    assert (out.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 200, 333, 2, 128),    # both lengths end inside a tile
    (2, 129, 1031, 2, 128),   # B > 1; one q row past a block, an odd kv length
    (1, 300, 2500, 2, 128),   # Sq != Skv: the context-parallel DiT's gathered k, v
    (1, 2500, 300, 2, 128),
    (2, 257, 700, 32, 128),   # the DiTs' 32 heads
    (1, 260, 700, 2, 120),    # D = 120 and 112: the p.v width stops inside a slab
    (1, 260, 700, 2, 112),
])
def test_flash_kernel_head_dim_128(cuda, b, sq, skv, h, d):
    """Head dim 128 reads q, k and v in place in the 128-byte swizzle, two
    slabs a row, as the head dims next to it do (their second slab part
    zero-filled). Against the plain version, with the launch counted once
    and its shape key recorded."""
    q = torch.randn(b, sq, h, d, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    stats = kernels.STATS["flash_attention"]
    before, keyed = stats.launches, stats.shapes[(b, sq, skv, h, d)]
    out = attention.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert stats.launches == before + 1 and stats.shapes[(b, sq, skv, h, d)] == keyed + 1
    assert not attention.flash_geometry(b, sq, skv, h, d)["kv_copies"]
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def _flash_against_plain(gen, b, sq, skv, h, d, scale):
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(b, skv, h, d, device="cuda", generator=gen).bfloat16()
    v = torch.randn(b, skv, h, d, device="cuda", generator=gen).bfloat16()
    k_ptr = k.data_ptr()
    assert attention.flash_kv_operands(k, v)[0].data_ptr() == k_ptr  # read in place
    out = attention.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    return (out.float() - ref).abs().max().item(), 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("s", [660, 2228])
def test_flash_kernel_unet_head_dims_in_place(cuda, d, s):
    """The UNet's head dims at its small shapes' token counts (level 2's
    660 and the yt pass's level-1 2,228): q, k and v read in place, one
    64-dim box a slab (D = 40 one box with 24 zero-filled dims, 80 two,
    160 three), p.v widths 48, 80 and 160."""
    err, tol = _flash_against_plain(cuda, 2, s, s, 8, d, d ** -0.5)
    assert err <= tol, err


@pytest.mark.parametrize("d", [8, 24, 40, 56, 72, 88, 120, 152])
@pytest.mark.parametrize("sq,skv", [(200, 37), (333, 700)])
def test_flash_kernel_head_dims_that_stop_inside_a_slab(cuda, d, sq, skv):
    """Every head dim that is a multiple of 8 and not of 16: the dims past
    D read as TMA's zeros, the q.k^T depth ceil16(D) ends inside a slab,
    the p.v width ceil16(D) (16 to 160) stops inside one; with fewer keys
    than one tile (37) and with a ragged last tile (700)."""
    err, tol = _flash_against_plain(cuda, 1, sq, skv, 2, d, 0.9 * d ** -0.5)
    assert err <= tol, err


@pytest.mark.parametrize("d", [8, 40, 80, 160])
def test_tensor_map_takes_a_64_dim_box_over_fewer_dims(cuda, d):
    """libcuda's cuTensorMapEncodeTiled, called as K1's
    `tensor_map_bshd_slabs` calls it (bf16, 4-d (D, H, S, B), boxes of 64
    x 1 x 128 x 1, the 128-byte swizzle, zero fill), takes a box whose 64
    dims reach past a row of D: at D < 64 the whole row is shorter than
    the box."""
    import ctypes

    b, s, h = 2, 300, 3
    x = torch.zeros(b, s, h, d, device="cuda", dtype=torch.bfloat16)
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuTensorMapEncodeTiled
    u64x4, u64x3, u32x4 = ctypes.c_uint64 * 4, ctypes.c_uint64 * 3, ctypes.c_uint32 * 4
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
                   u64x4, u64x3, u32x4, u32x4, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    tmap = (ctypes.c_uint8 * (128 + 64))()  # a CUtensorMap is 128 bytes, 64-byte aligned
    addr = (ctypes.addressof(tmap) + 63) // 64 * 64
    bf16, swizzle_128b, l2_128b = 9, 3, 2
    rc = fn(addr, bf16, 4, x.data_ptr(), u64x4(d, h, s, b), u64x3(2 * d, 2 * d * h, 2 * d * h * s),
            u32x4(64, 1, 128, 1), u32x4(1, 1, 1, 1), 0, swizzle_128b, l2_128b, 0)
    assert rc == 0, f"cuTensorMapEncodeTiled refused a 64-dim box over D = {d}: CUresult {rc}"


@pytest.mark.parametrize("d,skv", [(40, 130), (80, 1031), (160, 65), (128, 130), (128, 1031)])
def test_flash_kernel_masks_the_kv_tail_before_the_max(cuda, d, skv):
    """Logits of large magnitude, all far below zero, with a ragged kv
    tail: a zero-filled key that joined the row max as a zero logit would
    drive every exponential to 0 and the output to 0."""
    sq, h = 100, 2
    q = (8 + torch.rand(1, sq, h, d, device="cuda", generator=cuda)).bfloat16()
    k = -(8 + torch.rand(1, skv, h, d, device="cuda", generator=cuda)).bfloat16()
    v = torch.randn(1, skv, h, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    out = attention.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    assert ref.abs().max().item() > 0.1
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("pv_int8", [False, True])
@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 200, 300, 2, 40),     # D padded 40 -> 64 (q.k^T) and 48 (p.v), ragged
    (2, 1100, 1300, 2, 40),   # sq and skv past one 1024 block, B*H = 4
    (1, 1030, 2100, 3, 80),   # two Q-scale blocks, a third ragged P block
    (1, 700, 1024, 2, 160),   # the largest head dim, exactly one P block
    (2, 300, 1025, 1, 80),    # one key past a whole P block
    (1, 129, 600, 2, 8),      # the smallest head dim, one row past a tile
    (1, 2500, 700, 2, 40),    # three Q-scale blocks, the last ragged
    (2, 100, 37, 1, 80),      # fewer keys than one tile
    (1, 257, 129, 2, 160),    # one row past a 128-row tile, one key past a tile
    (1, 1, 1, 1, 40),         # one query, one key
    (1, 200, 300, 2, 128),    # head dim 128, both lengths ragged
    (1, 1030, 2100, 3, 128),  # Sq < Skv, two Q-scale blocks, a ragged third P block
    (2, 1100, 700, 2, 128),   # Sq > Skv, B = 2
    (1, 300, 1025, 32, 128),  # 32 heads, one key past a whole P block
    (1, 1, 1, 1, 128),
    (1, 129, 600, 2, 120),    # next to 128: a row of 128 bytes, depth 128
    (1, 257, 129, 2, 112),    # a row of 112 bytes, depth 128
    (2, 1100, 700, 2, 40),    # Sq > Skv, B = 2, a kv tail inside a 128-key tile
    (1, 1, 300, 2, 80),       # one query against a ragged kv
    (1, 700, 200, 2, 160),    # Sq > Skv at 64-key tiles
    (1, 1, 1, 1, 160),
    (2, 333, 1500, 1, 144),   # 64-key tiles, a row of 144 bytes (two slabs)
    (1, 300, 130, 2, 24),     # a row of 32 bytes, the row sums on the tensor cores
    (2, 65, 700, 2, 40),      # one row past a 64-row warpgroup block, B = 2
])
def test_int8_flash_kernels_match_plain(cuda, pv_int8, b, sq, skv, h, d):
    """K6 (pv_int8 False) and K7 against the plain version on the same
    bf16 inputs: the same int8 operands (one pre-pass) and exact int32
    dots. K6 differs by exp2 rounding and p in bf16 in the p.v product, as
    K1 (2e-2 of the largest output); K7 by p8 values that a rounding tie
    moves by one step of 1/127 of their block's max, which the same
    bound covers."""
    q = torch.randn(b, sq, h, d, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    name = "flash_attention_int8pv" if pv_int8 else "flash_attention_int8"
    before = kernels.STATS[name].launches
    out = attention.flash_attention(q, k, v, scale=scale,
                                    backend="int8pv" if pv_int8 else "int8")
    torch.cuda.synchronize()
    assert kernels.STATS[name].launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention.flash_attention_int8_plain(q, k, v, scale, pv_int8).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err
    fp = attention.flash_attention_plain(q.float(), k.float(), v.float(), scale)
    # the quantization itself stays within a few percent of the fp attention
    assert (ref - fp).abs().max().item() <= 0.1 * fp.abs().max().item()


@pytest.mark.parametrize("d", [40, 80, 160, 128])
@pytest.mark.parametrize("sq,skv", [
    (300, 100),     # one P block of 128 keys, 28 of them padding
    (257, 1000),    # Skv < 1024: one P block of 1024 keys, 24 padding
    (130, 2500),    # three P blocks, the last of 452 keys
    (1100, 3073),   # two Q-scale blocks; a last P block of one key
])
def test_k7_p_blocks_and_tiles(cuda, d, sq, skv):
    """K7 at the head dims of the three UNet levels (three consumer
    warpgroups and 128-key tiles at D = 40, two with 128-key tiles at D =
    80 and 128, two with 64-key tiles, v8 in the 64-byte swizzle, at D =
    160) with P blocks that end inside a tile, a last
    P block shorter than one tile, and Skv below one P block: against the
    plain version, as `test_int8_flash_kernels_match_plain`. The wrapper
    launched its pre-pass and the kernel once each, and no max pass of its
    own (the kernel makes the P blocks' maxes)."""
    q, k, v = (torch.randn(1, s, 2, d, device="cuda", generator=cuda).bfloat16()
               for s in (sq, skv, skv))
    names = ("flash_attention_int8pv", "flash_attention_int8pv_prepass")
    before = [kernels.STATS[n].launches for n in names]
    out = attention.flash_attention(q, k, v, backend="int8pv")
    torch.cuda.synchronize()
    assert [kernels.STATS[n].launches - b for n, b in zip(names, before)] == [1, 1]
    assert not any("maxpass" in n for n in kernels.STATS)
    ref = attention.flash_attention_int8_plain(q, k, v, d ** -0.5, True).float()
    assert (out.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 2500, 1030, 2, 40),   # three Q-scale blocks; two P blocks, a 6-key last
    (2, 300, 513, 1, 80),
    (1, 129, 65, 3, 160),
    (1, 64, 3000, 2, 8),
    (1, 2500, 1030, 2, 128),  # head dim 128
    (2, 300, 513, 32, 128),
    (1, 700, 1300, 2, 24),
    (2, 129, 700, 1, 112),
    (1, 300, 130, 2, 144),
    (1, 1, 200, 1, 120),
])
def test_int8pv_prepass_kernels_match_plain(cuda, b, sq, skv, h, d):
    """K7's pre-pass kernels (the PV variant of K6's) against the plain
    pre-pass in K7's layout: q8, the Q scales, v8 (keys permuted within
    each 16, padding zero) and the V scales bit-equal; k8 and the K scales
    as for K6 (`test_int8_prepass_kernels_match_plain`). No head dim has
    copies of q8 or k8."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=cuda).bfloat16()
               for s in (sq, skv, skv))
    before = kernels.STATS["flash_attention_int8pv_prepass"].launches
    ops = attention.int8pv_operands(q, k, v)
    torch.cuda.synchronize()
    assert kernels.STATS["flash_attention_int8pv_prepass"].launches == before + 1
    ref = attention.int8pv_operands_plain(q, k, v)
    g = attention.int8pv_geometry(b, sq, skv, h, d)
    assert set(ops) == set(ref) == {"q8", "k8", "v8", "sq", "sk", "sv", "bq"}
    for name in ("q8", "k8", "v8", "sq", "sk", "sv"):
        assert tuple(ops[name].shape) == g["shapes"][name] == tuple(ref[name].shape), name
        assert ops[name].dtype == ref[name].dtype, name
    for name in ("q8", "sq", "v8", "sv"):
        assert torch.equal(ops[name], ref[name]), name
    dk8 = (ops["k8"].int() - ref["k8"].int()).abs()
    assert dk8.max().item() <= 1 and (dk8 > 0).float().mean().item() <= 0.01
    assert ((ops["sk"] - ref["sk"]).abs() <= ref["sk"].abs() * 2.0 ** -7).all()
    assert torch.equal(ops["sk"][:, 1], ops["sk"][:, 0] * -12582912.0)


@pytest.mark.parametrize("d", [40, 80, 128, 160])
@pytest.mark.parametrize("sq,skv", [
    (300, 3500),    # four P blocks, the last of 428 keys
    (130, 2049),    # three, the last of one key
])
def test_k7_row_max_moves_between_p_blocks(cuda, d, sq, skv):
    """K7 keeps the row max online across P blocks (acc and l rescaled by
    alpha = exp2(m - m_new) at each block's start, sp against the running
    max): here the logits rise from block to block, so alpha < 1 at every
    block start of most rows, at the head dims of the three UNet levels
    (D = 40 three warpgroups with the k8 tiles kept for both sweeps, 80 two
    with them kept, 160 two with 64-key tiles loaded twice) and the DiTs'
    128 (loaded twice). Against the plain version, as
    `test_int8_flash_kernels_match_plain`; the plain block maxes of the
    kernel's operands show the rise."""
    # q leans on u, and k's part along u rises with the key: the logits of
    # a row rise by ~3 nats a P block beside noise of ~1
    u = torch.ones(d, device="cuda") / d ** 0.5
    ramp = torch.linspace(-1.0, 1.0, skv, device="cuda")[None, :, None, None]
    q = (torch.randn(1, sq, 2, d, device="cuda", generator=cuda) + 3 * u).bfloat16()
    k = (torch.randn(1, skv, 2, d, device="cuda", generator=cuda)
         + 2 * d ** 0.5 * ramp * u).bfloat16()
    v = torch.randn(1, skv, 2, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    bm = attention.int8_block_rowmax_plain(attention.int8pv_operands(q, k, v), sq, skv, scale)
    full = skv // 1024  # the whole P blocks (the ragged last one may hold one key)
    rises = (bm[:, :, 1:full] > bm[:, :, :full - 1]).float().mean().item()
    assert bm.shape[-1] == -(-skv // 1024) and rises >= 0.9, rises
    out = attention.flash_attention(q, k, v, scale=scale, backend="int8pv")
    torch.cuda.synchronize()
    ref = attention.flash_attention_int8_plain(q, k, v, scale, True).float()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("pv_int8", [False, True])
@pytest.mark.parametrize("d,skv", [(40, 130), (80, 1031), (160, 65), (128, 130), (128, 1031)])
def test_int8_flash_kernel_masks_the_kv_tail_before_the_max(cuda, pv_int8, d, skv):
    """K6 and K7 with logits of large magnitude, all far below zero, and a
    ragged kv tail: a zero-filled key that joined the row max (or K7's
    block max) would drive every exponential to 0."""
    sq, h = 100, 2
    q = (8 + torch.rand(1, sq, h, d, device="cuda", generator=cuda)).bfloat16()
    k = -(8 + torch.rand(1, skv, h, d, device="cuda", generator=cuda)).bfloat16()
    k[:, ::3] *= 1.5  # the token mean differs from every key
    v = torch.randn(1, skv, h, d, device="cuda", generator=cuda).bfloat16()
    scale = d ** -0.5
    out = attention.flash_attention(q, k, v, scale=scale, backend="int8pv" if pv_int8 else "int8")
    torch.cuda.synchronize()
    ref = attention.flash_attention_int8_plain(q, k, v, scale, pv_int8).float()
    assert ref.abs().max().item() > 0.1
    assert (out.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 2500, 1030, 2, 40),   # three Q-scale blocks; two splits of the k sums
    (2, 300, 513, 1, 80),     # one Q block of 384 rows
    (1, 129, 65, 3, 160),
    (1, 64, 3000, 2, 8),
    (1, 2500, 1030, 2, 128),  # head dim 128
    (2, 300, 513, 32, 128),
    (1, 700, 1300, 2, 24),
    (2, 129, 700, 1, 112),
    (1, 300, 130, 2, 144),
    (1, 1, 200, 1, 120),
])
def test_int8_prepass_kernels_match_plain(cuda, b, sq, skv, h, d):
    """K6's pre-pass kernels against the plain pre-pass on the same bf16
    inputs, in K6's layout. q8 and the Q scales are bit-equal, and v is
    the input itself at every head dim (the pre-pass copies nothing).
    k8 and the K scales depend on K's token mean, an f32 sum over the keys
    that the kernel adds in another order than torch: where the f32 means
    differ by an ulp, their bf16 rounding can differ, which moves k - mean
    by one bf16 step in that channel, so a k8 value by at most 1 and a K
    scale by at most a bf16 step (2^-8 relative); such entries are rare
    (held at 1% of k8)."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=cuda).bfloat16()
               for s in (sq, skv, skv))
    before = kernels.STATS["flash_attention_int8_prepass"].launches
    ops = attention.qk_int8_operands(q, k, v)
    torch.cuda.synchronize()
    assert kernels.STATS["flash_attention_int8_prepass"].launches == before + 1
    ref = attention.qk_int8_operands_plain(q, k, v)
    g = attention.qk_int8_geometry(b, sq, skv, h, d)
    for name in ("q8", "k8", "v", "sq", "sk"):
        assert tuple(ops[name].shape) == g["shapes"][name] == tuple(ref[name].shape), name
        assert ops[name].dtype == ref[name].dtype, name
    assert torch.equal(ops["q8"], ref["q8"]) and torch.equal(ops["sq"], ref["sq"])
    assert ops["v"] is v and ref["v"] is v
    dk8 = (ops["k8"].int() - ref["k8"].int()).abs()
    assert dk8.max().item() <= 1 and (dk8 > 0).float().mean().item() <= 0.01
    assert ((ops["sk"] - ref["sk"]).abs() <= ref["sk"] * 2.0 ** -7).all()
    assert (ops["sk"][:, skv:] == 0).all()


def test_int8_prepass_kernels_exact_on_exact_means(cuda):
    """With a power-of-two key count and keys on a 1/8 grid, every order of
    the f32 sums is exact, and so is the mean: k8 and the K scales are
    bit-equal too."""
    b, sq, skv, h, d = 1, 700, 2048, 2, 40
    q = torch.randn(b, sq, h, d, device="cuda", generator=cuda).bfloat16()
    k = (torch.randint(-32, 33, (b, skv, h, d), device="cuda", generator=cuda) / 8).bfloat16()
    v = torch.randn(b, skv, h, d, device="cuda", generator=cuda).bfloat16()
    ops = attention.qk_int8_operands(q, k, v)
    ref = attention.qk_int8_operands_plain(q, k, v)
    for name in ("q8", "k8", "v", "sq", "sk"):
        assert torch.equal(ops[name], ref[name]), name


def test_int8_flash_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 1, 12, device="cuda", dtype=torch.bfloat16)
    for backend in ("int8", "int8pv"):
        with pytest.raises(ValueError, match="head dim"):
            attention.flash_attention(q, q, q, backend=backend)
        with pytest.raises(ValueError, match="bf16"):
            attention.flash_attention(q.float(), q.float(), q.float(), backend=backend)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 1, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        attention.flash_attention(q.float(), q.float(), q.float())


def _unit(gen, *shape):
    return F.normalize(torch.randn(*shape, device="cuda", generator=gen), dim=-1).bfloat16()


def _hold_match(a, bt, m, i):
    """K2's result against the plain version, as chip_smoke holds it:
    maxima within 1e-4, and no index mismatch where the best two scores
    differ by more than 1e-4."""
    b, s, _ = a.shape
    d = bt.shape[1]
    assert m.dtype == torch.float32 and i.dtype == torch.int32 and m.shape == (s,)
    mr, ir = match_kernel.online_argmax_scores_plain(a, bt)
    assert (m - mr).abs().max().item() <= 1e-4
    scores = torch.einsum("bsc,bdc->sbd", a.float(), bt.float()).reshape(s, b * d)
    best = scores.max(dim=-1)
    second = scores.scatter(1, best.indices[:, None], -float("inf")).amax(dim=-1)
    clear = best.values - second > 1e-4
    assert ((i != ir) & clear).sum().item() == 0


@pytest.mark.parametrize("b,s,d,c", [
    (2, 300, 500, 64),
    (2, 1000, 777, 320),      # 256-row src tiles, 5 slabs of depth (level 0)
    (1, 130, 257, 40),        # C = 40: one 64-channel box, 24 channels zero-filled
    (3, 100, 70, 32),         # B = 3, D smaller than one dst tile
    (2, 129, 200, 448),       # 128-row src tiles, 7 slabs of depth
    (2, 300, 64, 456),        # 128-row src tiles, a ragged last slab
    (2, 200, 300, 640),       # level 1's channels, 4 stages in the ring
    (2, 65, 129, 768),        # the widest, 2 stages in the ring
    (2, 3000, 5000, 320),     # every CTA a range of many tiles
    (1, 1, 1, 8),
    (1, 700, 1000, 72),       # B = 1, C = 72: two slabs, the second 8 wide
    (3, 1100, 1300, 320),     # B = 3, S and D not multiples of the tiles
    (3, 600, 450, 640),       # B = 3 at level 1's channels, an odd src group
    (1, 513, 129, 768),
])
def test_match_kernel_matches_plain(cuda, b, s, d, c):
    a, bt = _unit(cuda, b, s, c), _unit(cuda, b, d, c)
    before = kernels.STATS["online_argmax_scores"].launches
    m, i = match_kernel.online_argmax_scores(a, bt)
    torch.cuda.synchronize()
    assert kernels.STATS["online_argmax_scores"].launches == before + 1
    _hold_match(a, bt, m, i)


@pytest.mark.parametrize("c", [40, 72, 320, 456, 640, 768])
@pytest.mark.parametrize("b,s,d,grid", [
    (1, 300, 1000, 5),        # B = 1, five CTAs, each a range of many tiles
    (3, 257, 700, 132),       # B = 3, ranges that cross batches, ragged S and D
    (2, 513, 129, 1),         # one CTA walks every tile
    (2, 900, 2000, 18),       # ranges that start and end inside a (src group, batch)
])
def test_match_kernel_every_split(cuda, c, b, s, d, grid):
    """K2 with the split forced: any grid (one contiguous range of tiles a
    CTA, ranges that start and end anywhere) gives the plain version's
    maxima and (up to near ties) indices, at every channel count of both
    src tile sizes, C = 40 and 72 reading zero-filled channels."""
    a, bt = _unit(cuda, b, s, c), _unit(cuda, b, d, c)
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    _hold_match(a, bt, m, i)


@pytest.mark.parametrize("grid", [2, 8, 132, 1])
def test_match_kernel_ties_across_chunks_and_batches(cuda, grid):
    """Equal maxima in different ranges and different batches, and equal
    maxima of +0.0 and -0.0: the b-major first index wins whatever range
    found it first. Exact scores: every product is 0 or +-1."""
    b, s, d, c = 3, 40, 1100, 64
    a = torch.zeros(b, s, c, device="cuda", dtype=torch.bfloat16)
    a[:, :, 0] = 1.0
    bt = torch.full((b, d, c), 0.0, device="cuda", dtype=torch.bfloat16)
    bt[:, :, 0] = -1.0
    bt[2, 30, 0] = 1.0     # ties of the max 1.0 in batch 2 (an early tile),
    bt[1, 900, 0] = 1.0    # batch 1 (a late tile)
    bt[1, 1050, 0] = 1.0   # and a later tile of batch 1: batch 1, d 900 wins
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    assert (m == 1.0).all() and (i == 1 * d + 900).all()
    # maxima of zero made of +0.0 and -0.0 products (which sign each sum
    # takes is the hardware's): the dense argmax treats them as equal, so
    # the first zero in b-major order wins
    a[:, :, 1] = -1.0
    bt[:, :, 0] = -1.0
    bt[1, 5, 0] = 0.0       # 1 * 0 + -1 * 0
    bt[0, 700, 0] = -0.0    # 1 * -0 + -1 * 0
    bt[0, 200, 0] = -0.0
    bt[0, 200, 1] = -0.0    # 1 * -0 + -1 * -0
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    assert (m == 0.0).all() and (i == 200).all()


@pytest.mark.parametrize("grid", [1, 4, 132])
@pytest.mark.parametrize("c", [136, 320, 640])
def test_match_kernel_ties_across_slabs_halves_and_ranges(cuda, c, grid):
    """Exact ties whose scores come from different 64-channel slabs, from
    the two halves of a dst tile (level 1's two 64-row accumulators), from
    different dst tiles and from different batches, for src rows in
    different src tiles (row 299 lies in the second at level 0's 256-row
    tiles and in the third at level 1's 128), under splits that put them
    in different ranges: the first b-major index wins; and -0.0 / +0.0
    maxima from products in different slabs."""
    b, s, d = 2, 300, 700
    a = torch.zeros(b, s, c, device="cuda", dtype=torch.bfloat16)
    a[:, :, 0] = 1.0          # slab 0
    a[:, :, c - 8] = 1.0      # the last slab
    bt = torch.zeros(b, d, c, device="cuda", dtype=torch.bfloat16)
    bt[:, :, 0] = -1.0
    bt[0, 520, c - 8] = 2.0   # 2 - 1 = 1 from the last slab (dst tile 4, first half)
    bt[0, 500, c - 8] = 1.0   # 1 - 1 + ... = 0: not a max
    bt[0, 90, 0] = 1.0        # 1 + 0 = 1 from slab 0 (dst tile 0, second half): wins
    bt[1, 3, 0] = 1.0         # batch 1 ties later in b-major order
    bt[0, 700 - 1, 0] = 1.0   # the last dst row ties too
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    assert (m == 1.0).all() and (i == 90).all()
    # a tie within one dst tile across its halves: dst 70 (second half of
    # tile 0) against dst 10 (first half)
    bt[0, 90, 0] = -1.0
    bt[0, 70, c - 8] = 2.0
    bt[0, 10, c - 8] = 2.0
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    assert (m == 1.0).all() and (i == 10).all()
    # maxima of zero: -1 * 0 + 1 * -0 in one slab pair, 1 * 0 + 1 * -0 in another
    bt.fill_(0.0)
    bt[:, :, 0] = -1.0
    bt[:, :, c - 8] = -1.0
    bt[1, 2, 0] = -0.0
    bt[1, 2, c - 8] = 0.0
    bt[0, 650, 0] = 0.0
    bt[0, 650, c - 8] = -0.0
    m, i = match_kernel._launch(a, bt, grid)
    torch.cuda.synchronize()
    assert (m == 0.0).all() and (i == 650).all()


def test_match_kernel_ties_pick_first_b_major(cuda):
    a = torch.ones(2, 8, 16, device="cuda", dtype=torch.bfloat16)
    bt = torch.ones(2, 300, 16, device="cuda", dtype=torch.bfloat16)
    _, i = match_kernel.online_argmax_scores(a, bt)
    assert (i == 0).all()
    bt = torch.zeros(2, 300, 16, device="cuda", dtype=torch.bfloat16)
    bt[0, 200] = 1.0
    bt[1, 5] = 1.0
    _, i = match_kernel.online_argmax_scores(a, bt)
    np.testing.assert_array_equal(i.cpu().numpy(), 200)


@pytest.mark.parametrize("n,h,w,c,radius,fmax,mode", [
    (2, 37, 70, 3, 4, 3.5, "bicubic"),     # tiles ragged in both axes
    (1, 64, 96, 3, 24, 24.0, "bicubic"),   # the adjoint's sources span the whole halo
    (3, 33, 40, 2, 8, 12.0, "bicubic"),    # flows beyond the radius: taps dropped
    (1, 50, 45, 1, 4, 4.0, "bilinear"),
    (2, 32, 32, 4, 0, 0.4, "bicubic"),     # radius 0
    (2, 160, 192, 3, 100, 100.0, "bicubic"),  # the widest range: sources beyond the frame
    (1, 100, 130, 4, 12, 14.0, "bilinear"),
])
@pytest.mark.parametrize("adjoint", [False, True])
def test_window_warp_kernel_matches_plain(cuda, n, h, w, c, radius, fmax, mode, adjoint):
    x = torch.rand(n, h, w, c, device="cuda", generator=cuda)
    f = (torch.rand(n, h, w, 2, device="cuda", generator=cuda) * 2 - 1) * fmax
    before = kernels.STATS["window_warp"].launches
    out = warp_kernel.window_warp(x, f, radius, mode, adjoint)
    torch.cuda.synchronize()
    assert kernels.STATS["window_warp"].launches == before + 1
    ref = warp_kernel.window_warp_plain(x, f, radius, mode, adjoint)
    assert out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5 * (2 * radius + 5)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_window_warp_kernel_channels_and_frame_edges(cuda, c, mode, adjoint):
    """K3 at every channel count and both kernels, on a frame whose last
    tiles are 1 row and 3 columns wide, with a smooth flow (as the post-
    optimization's) that carries the edge pixels' taps out of the frame."""
    n, h, w, radius = 2, 65, 131, 8
    x = torch.rand(n, h, w, c, device="cuda", generator=cuda)
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    f = torch.stack([6 * torch.sin(xx / 17.0) + 1.5, 5 * torch.cos(yy / 13.0 + xx / 40.0)], -1)
    f = f.expand(n, h, w, 2).contiguous()
    out = warp_kernel.window_warp(x, f, radius, mode, adjoint)
    torch.cuda.synchronize()
    ref = warp_kernel.window_warp_plain(x, f, radius, mode, adjoint)
    assert (out - ref).abs().max().item() <= 1e-5 * (2 * radius + 5)


@pytest.mark.parametrize("radius,fmax,mode", [(24, 24.0, "bicubic"), (4, 3.0, "bilinear")])
def test_window_warp_adjoint_repeats_bit_for_bit(cuda, radius, fmax, mode):
    """K3's adjoint adds into its tile accumulators in no fixed order, in
    fixed point: three runs on the same inputs give the same bits,
    with random flows that send many sources to each output."""
    x = torch.randn(2, 96, 200, 3, device="cuda", generator=cuda)
    f = (torch.rand(2, 96, 200, 2, device="cuda", generator=cuda) * 2 - 1) * fmax
    runs = [warp_kernel.window_warp(x, f, radius, mode, adjoint=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = warp_kernel.window_warp_plain(x, f, radius, mode, adjoint=True)
    assert (runs[0] - ref).abs().max().item() <= 1e-5 * (2 * radius + 5)


def test_window_warp_adjoint_nonfinite_cotangent_fills_its_tiles(cuda):
    """A non-finite cotangent makes NaN the outputs of every tile whose halo
    holds it, and leaves the other tiles as the plain version has them."""
    radius = 4
    x = torch.rand(1, 64, 256, 1, device="cuda", generator=cuda)
    f = (torch.rand(1, 64, 256, 2, device="cuda", generator=cuda) * 2 - 1) * 3
    x[0, 10, 20, 0] = float("inf")
    out = warp_kernel.window_warp(x, f, radius, adjoint=True)
    torch.cuda.synchronize()
    # halo rh = 6: the inf at (10, 20) lies in the halos of tiles (0, 0) only
    assert out[0, :32, :64].isnan().all()
    ref = warp_kernel.window_warp_plain(x[:, :, 64:].clone(), f[:, :, 64:].clone(), radius,
                                        adjoint=True)
    rest = out[:, :, 64 + 6:]
    assert torch.isfinite(rest).all()
    assert (rest - ref[:, :, 6:]).abs().max().item() <= 1e-5 * (2 * radius + 5)


def test_window_warp_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.rand(1, 8, 8, 5, device="cuda", generator=cuda)
    f = torch.zeros(1, 8, 8, 2, device="cuda")
    with pytest.raises(ValueError, match="channels"):
        warp_kernel.window_warp_cuda(x, f, 4)
    with pytest.raises(ValueError, match="f32"):
        warp_kernel.window_warp_cuda(x[..., :3].contiguous().double(), f, 4)
    with pytest.raises(ValueError, match="mode"):
        warp_kernel.window_warp_cuda(x[..., :3].contiguous(), f, 4, mode="nearest")
    # past 16000 the adjoint's tap count could overflow its high limb
    with pytest.raises(RuntimeError, match="cudaError"):
        warp_kernel.window_warp_cuda(x[..., :3].contiguous(), f, 16001, adjoint=True)


def test_window_warp_autograd_runs_the_adjoint_kernel(cuda):
    x = torch.rand(2, 40, 50, 3, device="cuda", generator=cuda, requires_grad=True)
    f = torch.randn(2, 40, 50, 2, device="cuda", generator=cuda) * 2
    before = kernels.STATS["window_warp"].launches
    warp_kernel.warp_flow_window(x, f, 8).square().sum().backward()
    assert kernels.STATS["window_warp"].launches == before + 2
    ref = warp_kernel.window_warp_plain(
        2 * warp_kernel.window_warp_plain(x.detach(), f, 8), f, 8, adjoint=True)
    assert (x.grad - ref).abs().max().item() <= 1e-4


def _smooth_flow(n, h, w, amp):
    """A smooth flow, as the post-optimization's: under a pixel's range per
    halo at amp <= 1.5 (K3's adjoint then takes one limb at every tile)."""
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                            indexing="ij")
    f = torch.stack([-amp * (0.6 + 0.4 * torch.sin(xx / 90.0)), amp * 0.3 * torch.cos(yy / 70.0)],
                    -1)
    return f.expand(n, h, w, 2).contiguous()


@pytest.mark.parametrize("radius,flow", [(0, "smooth"), (4, "smooth"), (4, "random"),
                                         (24, "smooth"), (24, "random"), (100, "random")])
@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_window_warp_kernel_small_frames(cuda, radius, flow, mode, adjoint):
    """K3 on frames under one wave of the card and not a multiple of its
    tiles (2 x 45 x 150: the forward's 4 x 64 tiles, the adjoint's 32 x
    64), at r = 0, 4, 24 and 100, with smooth flows (the adjoint's one-limb
    tiles) and random ones (two limbs); the adjoint repeats bit for bit."""
    n, h, w, c = 2, 45, 150, 3
    x = torch.randn(n, h, w, c, device="cuda", generator=cuda)
    if flow == "smooth":
        f = _smooth_flow(n, h, w, min(1.5, radius))
    else:
        f = (torch.rand(n, h, w, 2, device="cuda", generator=cuda) * 2 - 1) * radius
    out = warp_kernel.window_warp(x, f, radius, mode, adjoint)
    torch.cuda.synchronize()
    ref = warp_kernel.window_warp_plain(x, f, radius, mode, adjoint)
    assert (out - ref).abs().max().item() <= 1e-5 * (2 * radius + 5)
    if adjoint:
        assert torch.equal(out, warp_kernel.window_warp(x, f, radius, mode, adjoint))


def test_window_warp_adjoint_one_limb_nonfinite_cotangent_fills_its_tiles(cuda):
    """With smooth flows (one limb a tile) a non-finite cotangent makes NaN
    the outputs of the tiles whose halos hold it, and no others."""
    radius = 4
    x = torch.rand(1, 64, 256, 1, device="cuda", generator=cuda)
    f = _smooth_flow(1, 64, 256, 1.0)
    x[0, 40, 150, 0] = float("nan")
    out = warp_kernel.window_warp(x, f, radius, adjoint=True)
    torch.cuda.synchronize()
    # halo rh = 6: (40, 150) lies in the halos of tile (1, 2) only
    assert out[0, 32:64, 128:192].isnan().all()
    rest = torch.cat([out[0, :26].reshape(-1), out[0, :, :122].reshape(-1),
                      out[0, :, 198:].reshape(-1)])
    assert torch.isfinite(rest).all()


def _ids(n, h, w, shift=3):
    base = np.arange(h * w).reshape(h, w)
    return np.stack([np.roll(base, -shift * t, axis=1) for t in range(n)]).reshape(n, h * w)


@pytest.mark.parametrize("offs_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_banded_gather_kernel_matches_plain(cuda, offs_dtype, c):
    ids = _ids(3, 8, 700).copy()
    ids[1, ::37] += 5000  # window misses: overflow entries, offs -1
    ids[0, 20:90] = -1    # masked entries
    seg, st, offs, _, _, ok = banded_gather.plan_banded_gather_rows_robust(ids)
    assert ok
    p = int(ids.max()) + 1  # the last windows run past the table's end
    table = torch.randn(p, c, device="cuda", generator=cuda)
    st_t = torch.from_numpy(st.reshape(-1)).cuda()
    offs_t = torch.from_numpy(offs.reshape(-1, 512).astype(offs_dtype)).cuda()
    before = kernels.STATS["banded_gather"].launches
    out = banded_gather.banded_gather(table, st_t, offs_t, 2048)
    torch.cuda.synchronize()
    assert kernels.STATS["banded_gather"].launches == before + 1
    assert torch.equal(out, banded_gather.banded_gather_plain(table, st_t, offs_t))


def _band_plan(rng, window, bl=512, nb=40):
    """A synthetic single-window plan of the density `banded_geometry`
    gives each window: render-like (several table rows per output, nearly
    every entry live) above 2048, adjoint-like (most entries masked, the
    live ones sparse) at 2048 and below. Some live entries lie past the
    window, block 2 is wholly masked, and the table ends at the last row
    any entry selects."""
    dens = {1024: 0.5, 2048: 0.14, 4096: 4.0, 8192: 6.95}[window]
    p_live = 0.97 if dens > 2 else 0.15
    step = max(1, int(bl * dens))
    span = min(window, step + 128)
    starts = np.arange(nb, dtype=np.int64) * step
    offs = np.sort(rng.integers(0, span, (nb, bl)), axis=1)
    offs = np.where(rng.random((nb, bl)) < p_live, offs, -1)
    past = rng.random((nb, bl)) < 0.02
    offs = np.where(past, window + rng.integers(0, 500, (nb, bl)), offs)
    offs[2] = -1
    n_rows = int((starts[:, None] + offs)[offs >= 0].max()) + 1
    return starts.astype(np.int32), offs, n_rows


@pytest.mark.parametrize("window", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("offs_dtype", [torch.int16, torch.int32])
def test_banded_gather_kernel_matches_plain_on_synthetic_plans(cuda, window, c, offs_dtype):
    """K4 on render-like and adjoint-like plans at windows 1024-8192, every
    channel count, both offset types; spans that reach the table's end,
    masked blocks and offsets past the window. Exact."""
    rng = np.random.default_rng(window + c)
    starts, offs, n_rows = _band_plan(rng, window)
    table = torch.randn(n_rows, c, device="cuda", generator=cuda)
    st_t = torch.from_numpy(starts).cuda()
    offs_t = torch.from_numpy(offs).to(offs_dtype).cuda()
    stats = kernels.STATS["banded_gather"]
    before = stats.launches
    out = banded_gather.banded_gather(table, st_t, offs_t, window)
    torch.cuda.synchronize()
    assert stats.launches == before + 1
    assert stats.shapes[(40, 512, c, window)] >= 1
    assert torch.equal(out, banded_gather.banded_gather_plain(table, st_t, offs_t))
    assert (out[2] == 0).all()


@pytest.mark.parametrize("offs_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("bl", [512, 510])
def test_banded_gather_kernel_runs_the_rows_blocks_together(cuda, offs_dtype, c, bl):
    """K4 with the plan's rows (CTA j gathers block j of every row) on a
    padded batch, as the render's: four frames' render-like plans and
    four repeats of the first (blocks that repeat), at every channel count,
    both offset types and a block length not a multiple of 4. Exact, and a
    row count that does not divide the blocks is refused."""
    rng = np.random.default_rng(c + bl)
    frames = [_band_plan(rng, 8192, bl=bl, nb=9) for _ in range(4)]
    batch = [0, 1, 2, 3, 0, 0, 0, 0]
    starts = np.concatenate([frames[i][0] for i in batch])
    offs = np.concatenate([frames[i][1] for i in batch])
    table = torch.randn(max(fr[2] for fr in frames), c, device="cuda", generator=cuda)
    st_t = torch.from_numpy(starts).cuda()
    offs_t = torch.from_numpy(offs).to(offs_dtype).cuda()
    before = kernels.STATS["banded_gather"].launches
    out = banded_gather.banded_gather(table, st_t, offs_t, 8192, rows=len(batch))
    torch.cuda.synchronize()
    assert kernels.STATS["banded_gather"].launches == before + 1
    assert torch.equal(out, banded_gather.banded_gather_plain(table, st_t, offs_t))
    with pytest.raises(ValueError, match="rows"):
        banded_gather.banded_gather(table, st_t, offs_t, 8192, rows=5)


@pytest.mark.parametrize("k", [2, 3])
def test_banded_gather_multi_kernel_matches_plain(cuda, k):
    n, h, w = 3, 8, 512
    hw = h * w
    ids = _ids(n, h, w).copy()
    for g in range(1, k):
        m = np.zeros(hw, bool)
        m[g::k] = True
        gen = np.arange(m.sum()) + g * (hw + 40_000) + 177
        for t in range(1, n):
            ids[t, np.roll(m, 3 * t * g)] = gen
    ids[0, 40:50] = -1
    seg, st, offs, _, _, ok = banded_gather.plan_banded_gather_rows_multi(ids, n_windows=k)
    assert ok
    table = torch.randn(int(ids.max()) + 1, 3, device="cuda", generator=cuda)
    st_t = torch.from_numpy(st.reshape(-1, k)).cuda()
    offs_t = torch.from_numpy(offs.reshape(-1, 512)).cuda()
    before = kernels.STATS["banded_gather_multi"].launches
    out = banded_gather.banded_gather_multi(table, st_t, offs_t, 2048)
    torch.cuda.synchronize()
    assert kernels.STATS["banded_gather_multi"].launches == before + 1
    assert torch.equal(out, banded_gather.banded_gather_plain_multi(table, st_t, offs_t, 2048))


def _k5_plan(rng, k, window, bl=512, nb=24):
    """A synthetic K-window plan: window w of block b starts at b * bl + w *
    band + 1 (bands far apart), each (block, window) selects a random span of
    1..window rows, 5% of the entries are masked, 2% lie at or past
    K * window (not in the last block). Block 1 selects no entry of its last window, block 3's
    first window spans the whole window, and the table ends at the last
    row of the last block's last window (a span that ends at the table's
    last row, whose last floats no 16-byte copy reaches unless C = 4)."""
    band = nb * bl + 4 * window + 1000
    # odd starts: the table's row count is odd, so at C < 4 its last floats
    # end off a 16-byte boundary
    starts = (np.arange(nb)[:, None] * bl + np.arange(k)[None, :] * band + 1).astype(np.int32)
    span = rng.integers(1, window + 1, (nb, k))
    kk = rng.integers(0, k, (nb, bl))
    ll = (rng.random((nb, bl)) * span[np.arange(nb)[:, None], kk]).astype(np.int64)
    if k > 1:
        kk[1] = np.where(kk[1] == k - 1, 0, kk[1])
        ll[1] = np.minimum(ll[1], span[1, 0] - 1)
    offs = kk * window + ll
    offs[3, :2] = [0, window - 1]
    offs = np.where(rng.random((nb, bl)) < 0.05, -1, offs)
    past = rng.random((nb, bl)) < 0.02
    past[-1] = False  # the plain version reads them (then drops them) at the last window
    offs = np.where(past, k * window + rng.integers(0, 300, (nb, bl)), offs)
    offs[-1, 0] = k * window - 1
    n_rows = int(starts[-1, -1]) + window
    return starts, offs, n_rows


def _k5_launch(table, starts, offs, window):
    stats = kernels.STATS["banded_gather_multi"]
    before = stats.launches
    out = banded_gather.banded_gather_multi_cuda(table, starts, offs, window)
    torch.cuda.synchronize()
    assert stats.launches == before + 1
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("offs_dtype", [torch.int16, torch.int32])
def test_banded_gather_multi_kernel_matches_plain_on_synthetic_plans(cuda, k, c, offs_dtype):
    """K5 against its plain version at K = 1..4 windows, every channel
    count, both offset types: spans from one row to the whole window, a
    block with no entry of a window, the table's last row, masked entries
    and offsets at or past K * window. Exact."""
    window = 8192 // k if offs_dtype == torch.int16 else 2048
    rng = np.random.default_rng(100 * k + 10 * c + (offs_dtype == torch.int16))
    starts, offs, n_rows = _k5_plan(rng, k, window)
    table = torch.randn(n_rows, c, device="cuda", generator=cuda)
    st_t = torch.from_numpy(starts).cuda()
    offs_t = torch.from_numpy(offs).to(offs_dtype).cuda()
    out = _k5_launch(table, st_t, offs_t, window)
    ref = banded_gather.banded_gather_plain_multi(table, st_t, offs_t, window)
    assert torch.equal(out, ref)
    assert (ref[offs_t.long() >= k * window] == 0).all()


@pytest.mark.parametrize("bl", [333, 1001])
@pytest.mark.parametrize("c", [1, 3])
def test_banded_gather_multi_kernel_takes_an_odd_block_length(cuda, bl, c):
    """Odd block lengths: the offsets take no vector loads, at C = 1 or 3
    every other block's output starts off a 16-byte boundary (scalar
    stores), and at 1001 a thread gathers two runs of entries."""
    rng = np.random.default_rng(c + bl)
    starts, offs, n_rows = _k5_plan(rng, 2, 1024, bl=bl, nb=10)
    table = torch.randn(n_rows, c, device="cuda", generator=cuda)
    st_t, offs_t = torch.from_numpy(starts).cuda(), torch.from_numpy(offs).to(torch.int32).cuda()
    out = _k5_launch(table, st_t, offs_t, 1024)
    assert torch.equal(out, banded_gather.banded_gather_plain_multi(table, st_t, offs_t, 1024))


def test_banded_gather_multi_kernel_repeats_bit_for_bit(cuda):
    """Two launches on one plan give the same bits (a gather: no sums)."""
    rng = np.random.default_rng(7)
    starts, offs, n_rows = _k5_plan(rng, 3, 2048, nb=300)
    table = torch.randn(n_rows, 3, device="cuda", generator=cuda)
    st_t, offs_t = torch.from_numpy(starts).cuda(), torch.from_numpy(offs).to(torch.int16).cuda()
    first = _k5_launch(table, st_t, offs_t, 2048)
    assert torch.equal(first, _k5_launch(table, st_t, offs_t, 2048))


@pytest.mark.parametrize("nwin", [1, 2])
def test_banded_gather_kernels_write_rows_past_their_windows(cuda, nwin):
    """Offsets no staged window holds: K4 reads them from the table, as the
    plain version does, and K5 gives zero rows. The output's memory held
    NaNs before, so a row left unwritten would show."""
    window, nb = 256, 6
    table = torch.randn(nb * 300 + 4 * window, 3, device="cuda", generator=cuda)
    starts = torch.arange(0, nb * 256, 256, dtype=torch.int32, device="cuda")
    if nwin > 1:
        starts = torch.stack([starts, starts + 1000], dim=1)
    offs = torch.randint(-1, nwin * window, (nb, 512), device="cuda", generator=cuda)
    offs[:, ::5] = nwin * window + torch.arange(0, 103, device="cuda")[: offs[:, ::5].shape[1]]
    offs = offs.to(torch.int32)
    # a freed block of NaNs of the output's size, which the caching
    # allocator hands to the kernel's output
    nan = torch.full((nb, 512, 3), float("nan"), device="cuda")
    del nan
    if nwin == 1:
        out = banded_gather.banded_gather(table, starts, offs, window)
        ref = banded_gather.banded_gather_plain(table, starts, offs)
    else:
        out = banded_gather.banded_gather_multi(table, starts, offs, window)
        ref = banded_gather.banded_gather_plain_multi(table, starts, offs, window)
        assert (ref[:, ::5] == 0).all()
    assert torch.equal(out, ref)


def test_banded_gather_refuses_a_misaligned_table(cuda):
    table = torch.randn(4097, 3, device="cuda", generator=cuda)[1:]
    assert table.is_contiguous() and table.data_ptr() % 16
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    offs = torch.zeros(1, 512, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        banded_gather.banded_gather(table, starts, offs, 2048)
    with pytest.raises(ValueError, match="aligned"):
        banded_gather.banded_gather_multi(table, starts[:, None], offs, 2048)
