"""The port's hand-written CUDA kernels against their plain versions, on the
card, at small and ragged shapes: head dims that need padding to the MMA
depth, kv and q lengths that end inside a tile, dst counts that end inside
a tile, channel counts on every shared-memory path of the matcher, and
exact ties. Every test here needs a CUDA device and skips without one; on
the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not need). Tolerances: K1's output is bf16 (2^-8 relative)
and its p.v product takes p in bf16, so it is held to 2e-2 of the largest
output; K2 sums exact bf16 products in f32 in another order than the
plain version, so its maxima agree to 1e-4 and an index may differ only
where the best two scores are that close."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tclight_torch.ops import attention, kernels, match_kernel


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


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 1, 12, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        attention.flash_attention(q.float(), q.float(), q.float())


def _unit(gen, *shape):
    return F.normalize(torch.randn(*shape, device="cuda", generator=gen), dim=-1).bfloat16()


@pytest.mark.parametrize("b,s,d,c", [
    (2, 300, 500, 64),
    (2, 1000, 777, 320),      # 8 warps, double buffered
    (1, 130, 257, 40),        # C padded 40 -> 48
    (3, 100, 70, 32),
    (2, 129, 200, 448),       # the widest 8-warp channel count
    (2, 300, 64, 456),        # 4 warps, double buffered
    (2, 200, 300, 640),       # 4 warps, single buffered (level 1)
    (2, 65, 129, 768),
    (1, 1, 1, 8),
])
def test_match_kernel_matches_plain(cuda, b, s, d, c):
    a, bt = _unit(cuda, b, s, c), _unit(cuda, b, d, c)
    before = kernels.STATS["online_argmax_scores"].launches
    m, i = match_kernel.online_argmax_scores(a, bt)
    torch.cuda.synchronize()
    assert kernels.STATS["online_argmax_scores"].launches == before + 1
    assert m.dtype == torch.float32 and i.dtype == torch.int32 and m.shape == (s,)
    mr, ir = match_kernel.online_argmax_scores_plain(a, bt)
    assert (m - mr).abs().max().item() <= 1e-4
    scores = torch.einsum("bsc,bdc->sbd", a.float(), bt.float()).reshape(s, b * d)
    best = scores.max(dim=-1)
    second = scores.scatter(1, best.indices[:, None], -float("inf")).amax(dim=-1)
    clear = best.values - second > 1e-4
    assert ((i != ir) & clear).sum().item() == 0


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
