"""The Cosmos DiT and the multi-device code on the card. Every test needs a
CUDA device and skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cosmos_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX).

- chip_smoke's `check_cosmos_small`: a 2-block DiT of head dim 128 (256
  wide, 2 heads) with non-zero adaLN gates over 2,048 tokens, on the card
  in bf16 (its self-attention through K1) against the CPU in f32: the
  relative RMS within 1.5 times the CPU's own bf16 error, that limit at
  most half of what zeroing every self-attention's output moves the
  prediction, and K1 launched.
- The same DiT's forward with the int8 attention backends (K6, K7) stays
  within 5 times the fp forward's error against the f32 reference.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_cosmos_small_on_card_matches_cpu(cuda):
    from chip_smoke import check_cosmos_small

    result = check_cosmos_small()
    assert result["card_rel_rms"] <= result["tol"], result
    assert result["no_attention_rel_rms"] >= 2 * result["tol"], result
    assert result["k1_launches"] > 0, result


@pytest.mark.parametrize("backend,name", [("int8", "flash_attention_int8"),
                                          ("int8pv", "flash_attention_int8pv")])
def test_cosmos_small_int8_backends(cuda, backend, name):
    from chip_smoke import rel_rms, small_dit
    from tclight_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 8, 32, 32, 16, generator=gen)
    ctx = torch.randn(1, 16, 128, generator=gen)
    cn = torch.tensor([0.4])
    ref_model = small_dit(torch.float32, "cpu")
    with torch.inference_mode():
        ref = ref_model(x, cn, ctx)
        card = small_dit(torch.bfloat16, "cuda", ref_model.state_dict())
        fp = card(x.cuda(), cn.cuda(), ctx.cuda()).cpu()
        card.attn_backend = backend
        kernels.reset_stats()
        q8 = card(x.cuda(), cn.cuda(), ctx.cuda()).cpu()
    assert kernels.STATS[name].launches > 0
    assert torch.isfinite(q8).all()
    assert rel_rms(q8, ref) <= 5 * rel_rms(fp, ref) + 1e-3
