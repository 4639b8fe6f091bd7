"""The editing path, the annotators, the sd-depth stack and BriaRMBG on
the card against the CPU, on the same random weights and inputs. Every
test needs a CUDA device and skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_editing_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX).

PnP, ControlNet (canny, and softedge with a random full-width HED's
control images) and the sd-depth stack (its fifth channel a tiny DPT's
depth maps): chip_smoke's `check_small_editing`, one noise
prediction of the editing path on a three-level tiny SD stack over 4
frames of 64 x 64 (1,024 tokens a frame at level 0, so the self-attentions
reach the flash kernel K1, and ToMe's matcher K2 runs), on the CPU in f32
(the reference), on the CPU in bf16 (the plain versions) and on the card
in bf16 (the kernels take bf16). The merge ratios are 0, so no merge
choice can flip between precisions. The card may differ from the
reference by 1.5 times what bf16 costs on the CPU (relative RMS), that
limit must be at most half of what turning the Q/K injection (the
ControlNet's residuals, the depth channel) off moves the prediction, and
the card must have launched K1 and K2. BriaRMBG (`random_rmbg`, whose
mattes spread over (0, 1)) runs in f32 (full f32 on the card) and its
mattes agree within 1e-4. The annotators (DPT tiny-hybrid, HED, the
lineart U-Net, the OpenPose body net, at reduced widths) run in f32 (full
f32 on the card): their maps agree within 1e-4 of their largest
magnitude.
"""

import numpy as np
import pytest
import torch

from tclight_torch.models import briarmbg, dpt, hed, lineart, openpose

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("control", ["pnp", "canny", "softedge", "sd-depth"])
def test_editing_on_card_matches_cpu(cuda, control):
    from chip_smoke import check_small_editing

    result = check_small_editing(control)
    assert result["small_eps_rel_err"] <= result["small_tol"], result
    assert result["small_fault_rel"] >= 2 * result["small_tol"], result
    assert result["small_launches"]["flash_attention"] > 0, result
    assert result["small_launches"]["online_argmax_scores"] > 0, result


def test_rmbg_on_card_matches_cpu(cuda):
    model = briarmbg.random_rmbg(0, "cpu")
    frames = np.random.default_rng(1).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    cpu = briarmbg.compute_alpha_mattes(model, frames)
    card = briarmbg.compute_alpha_mattes(model.cuda(), frames)
    assert card.shape == cpu.shape == (2, 48, 64)
    assert ((cpu > 0.01) & (cpu < 0.99)).mean() >= 0.5
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)


def test_annotators_on_card_match_cpu(cuda):
    from chip_smoke import random_annotator

    frames = np.random.default_rng(2).uniform(0, 1, (2, 64, 80, 3)).astype(np.float32)

    def close(card, cpu):
        np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4 * float(np.abs(cpu).max()))

    net = dpt.random_dpt(dpt.DPTConfig.tiny_hybrid(), 1, "cpu")
    cpu = dpt.prepare_depth_maps(net, frames, (8, 10), input_size=64)
    close(dpt.prepare_depth_maps(net.cuda(), frames, (8, 10), input_size=64), cpu)
    net = random_annotator(hed.ControlNetHED(), 2)
    cpu = hed.hed_edges(net, frames)
    close(hed.hed_edges(net.cuda(), frames), cpu)
    net = random_annotator(lineart.LineartAnimeUNet(16, 8), 3)
    cpu = lineart.lineart_anime_map(net, frames)
    close(lineart.lineart_anime_map(net.cuda(), frames), cpu)
    net = random_annotator(openpose.BodyPoseNet(0.25), 4)
    cpu = np.concatenate(openpose.body_maps(net, frames[0]), -1)
    close(np.concatenate(openpose.body_maps(net.cuda(), frames[0]), -1), cpu)
