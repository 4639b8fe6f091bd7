"""The AR world stack and the guardrail models on the card. Every test
needs a CUDA device and skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ar_world_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX).

- K1 against its plain version at the diffusion decoder's self-attention
  shapes: the 7B decoder DiT's (1, 5,120, 32, 128) of a 57-frame 320 x 512
  window, and the 2-block check's (1, 2,048, 2, 128); bf16 inputs, the
  error within 2e-2 of max |plain| (bf16 output rounding and bf16 p in
  p.v).
- chip_smoke's `check_ar_small`: a 2-layer AR at the cosmos-4b widths, a
  2-block decoder DiT (K1), the tiny DV tokenizer, T5, SigLIP and
  RetinaFace, the card against the CPU, each within its stated limit.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("b,s,h,d", [(1, 5120, 32, 128), (1, 2048, 2, 128)])
def test_k1_at_the_decoder_shapes(cuda, b, s, h, d):
    from tclight_torch.ops import kernels
    from tclight_torch.ops.attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
               for _ in range(3))
    kernels.reset_stats()
    out = flash_attention(q, k, v)
    assert kernels.STATS["flash_attention"].launches == 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    err = (out.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def test_ar_small_on_card_matches_cpu(cuda):
    from chip_smoke import check_ar_small

    result = check_ar_small()
    assert result["ar_card_rel_rms"] <= result["ar_tol"], result
    assert result["ar_no_attention_rel_rms"] >= 2 * result["ar_tol"], result
    assert result["ar_tokens_equal"], result
    assert result["dd_card_rel_rms"] <= result["dd_tol"], result
    assert result["dd_no_attention_rel_rms"] >= 2 * result["dd_tol"], result
    assert result["dd_k1_launches"] > 0, result
    assert result["dv_ok"] and result["small_models_ok"], result
