"""The prompt upsampler on the card against the CPU. Every test needs a
CUDA device and skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upsampler_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX).

chip_smoke's `check_small_upsampler`: Pixtral-12B's decoder and ViT at
their published widths and 2 layers each, on random weights. The bf16
decoder's prompt logits on the card agree with the f32 model's on the
CPU within 1.5 times what bf16 costs on the CPU (relative RMS); in f32 on
the card, 16 greedy tokens decoded against the static cache equal those
of recomputing the sequence without it; the model written as a
cosmos-native `model.pt` and as HF-keyed safetensors loads back through
`load_vlm` with the same parameters and logits.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_small_upsampler_on_card_matches_cpu(cuda, tmp_path):
    from chip_smoke import check_small_upsampler

    result = check_small_upsampler(tmp_path)
    assert result["small_logits_rel_err"] <= result["small_tol"], result
    assert result["small_cache_equals_recompute"], result
    assert result["load_params_equal"], result
    assert all(v == 0.0 for v in result["load_logits_max_abs_diff"].values()), result
