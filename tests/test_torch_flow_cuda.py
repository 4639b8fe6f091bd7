"""The flow networks and the evaluate CLI on the card against the CPU, on
the same random weights and inputs. Every test needs a CUDA device and
skips without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flow_cuda.py -q

(`--noconftest`: the suite's conftest imports JAX).

No hand-written kernel runs here: the networks are PyTorch convolutions,
matmuls and gathers. The flow models set their own precision for their
calls, whatever the global flags (full f32, on PyTorch's convolution
kernels); the evaluate CLI runs in f32. Random-weight RAFT and MemFlow
amplify rounding: on the CPU, perturbing every weight by 1e-6 moves a
128x160 flow by up to 1e-3 px. So the card's flows are held against the
CPU's to a max / mean end-point error of 1e-3 / 1e-4 px, and the evaluate
CLI's result.txt rows to 1.5 units of their last printed digit.
"""

import numpy as np
import pytest
import torch

from tclight_torch.models import clip_vision, memflow_sk, raft, vgg_lpips

pytestmark = pytest.mark.cuda

EPE_MAX, EPE_MEAN = 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # global flags other than PyTorch's defaults: the models set their own
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _frames(n, h, w, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32), (0, 0), 2)
    return np.stack([np.roll(base, 3 * t, axis=1) for t in range(n)]).astype(np.float32)


def _assert_flows_close(card, cpu):
    assert card.shape == cpu.shape and np.isfinite(card).all()
    epe = np.linalg.norm(card - cpu, axis=-1)
    assert epe.max() <= EPE_MAX and epe.mean() <= EPE_MEAN, (epe.max(), epe.mean())


@pytest.mark.parametrize("size,h,w", [("tiny", 64, 96), ("full", 128, 160)])
def test_raft_on_card_matches_cpu(cuda, size, h, w):
    torch.manual_seed(0)
    cfg = raft.RAFTConfig.tiny() if size == "tiny" else raft.RAFTConfig()
    sd = raft.RAFT(cfg).state_dict()
    frames = _frames(3, h, w)
    card = raft.RAFTFlowModel(sd, cfg).batched_flow(frames[:2], frames[1:])
    cpu = raft.RAFTFlowModel(sd, cfg, device="cpu").batched_flow(frames[:2], frames[1:])
    _assert_flows_close(card, cpu)
    # the global flags are restored
    assert torch.backends.cudnn.enabled and not torch.backends.cudnn.allow_tf32


def test_memflow_sk_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    model = memflow_sk.MemFlowNetSK()
    with torch.no_grad():
        model.gamma.fill_(0.5)
    sd = model.state_dict()
    cpu_model = memflow_sk.MemFlowNetSK()
    cpu_model.load_state_dict(sd)
    card, cpu = (memflow_sk.InferenceCoreSK(model),
                 memflow_sk.InferenceCoreSK(cpu_model, device="cpu"))
    frames = _frames(4, 128, 160, seed=1)
    for i in range(3):
        _assert_flows_close(card.step(frames[i], frames[i + 1]),
                            cpu.step(frames[i], frames[i + 1]))
        assert card.mem.count == cpu.mem.count == 320
        assert card.mem.keys.is_cuda


def _rows(path):
    lines = path.read_text().splitlines()
    return dict(line.split(": ", 1) for line in lines[1:])


def _write_run(out_dir, h, w):
    """A run directory: a rolling texture as the source, a brightness edit
    of it as the output."""
    import yaml

    from tclight_torch.utils.video_io import save_video

    run_dir = out_dir / "run"
    run_dir.mkdir(parents=True)
    source = _frames(5, h, w, seed=2)
    save_video(np.clip(source * 0.9 + 0.05, 0, 1), run_dir / "output.mp4", fps=8)
    save_video(source, run_dir / "output_gt.mp4", fps=8)
    (run_dir / "config.yaml").write_text(yaml.safe_dump({"generation": {"prompt": {"x": "a"}}}))
    return run_dir


def _assert_rows_close(card, cpu):
    assert card.keys() == cpu.keys()
    for k, v in cpu.items():
        if k.startswith("zz"):
            assert card[k] == v
        else:
            unit = 10.0 ** -len(v.split(".")[1])
            assert abs(float(card[k]) - float(v)) <= 1.5 * unit, (k, card[k], v)


def test_evaluate_on_card_matches_cpu(cuda, tmp_path):
    """Tiny RAFT and CLIP checkpoints and a random full-size VGG16 with lpips
    heads, written in the reference layouts; one run directory."""
    from tclight_torch import evaluate

    torch.manual_seed(0)
    torch.save(raft.reference_state_dict(raft.RAFT(raft.RAFTConfig.tiny())),
               tmp_path / "raft.pth")
    (tmp_path / "clip").mkdir()
    vision = clip_vision.CLIPVisionModel(clip_vision.CLIPVisionConfig.tiny())
    for p in vision.parameters():
        torch.nn.init.normal_(p, 0.0, 0.2)
    torch.save(clip_vision.reference_state_dict(vision), tmp_path / "clip" / "vision.pth")
    (tmp_path / "lpips").mkdir()
    torch.save(vgg_lpips.reference_state_dict(vgg_lpips.VGG16Features()),
               tmp_path / "lpips" / "vgg16.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                for i, c in enumerate((64, 128, 256, 512, 512))},
               tmp_path / "lpips" / "lpips_vgg.pth")
    run_dir = _write_run(tmp_path / "out", 64, 96)
    args = ["--output_dir", str(tmp_path / "out"), "--flow_model", "raft", "--flow_ckpt",
            str(tmp_path / "raft.pth"), "--clip_ckpt", str(tmp_path / "clip"),
            "--lpips_ckpt", str(tmp_path / "lpips")]
    assert evaluate.main(args, device="cpu") == 0
    cpu = _rows(run_dir / "result.txt")
    assert evaluate.main(args) == 0
    card = _rows(run_dir / "result.txt")
    assert {"warp-error-ssim", "clip-frame", "frame-lpips"} <= card.keys()
    _assert_rows_close(card, cpu)


def test_evaluate_farneback_on_card_matches_cpu(cuda, tmp_path):
    """The random RAFT's forward and backward flows disagree, so the
    consistency mask keeps no pixel and warp-error-ssim reads 100.00 above.
    Farneback's flows of the rolling texture agree: the mask keeps most
    pixels, so the card's masks and bilinear warp reach the metric."""
    from tclight_torch import evaluate
    from tclight_torch.data.flow_backends import compute_flow_pairs
    from tclight_torch.ops.flow import compute_fwdbwd_mask
    from tclight_torch.utils.video_io import load_video

    run_dir = _write_run(tmp_path / "out", 128, 160)
    source = load_video(run_dir / "output_gt.mp4")
    fwd = compute_flow_pairs(source, "future")[:-1]
    bwd = compute_flow_pairs(source, "past")[1:]
    _, mask = compute_fwdbwd_mask(torch.from_numpy(fwd).cuda(), torch.from_numpy(bwd).cuda())
    assert mask.float().mean() >= 0.5
    args = ["--output_dir", str(tmp_path / "out"), "--flow_model", "farneback"]
    assert evaluate.main(args, device="cpu") == 0
    cpu = _rows(run_dir / "result.txt")
    assert evaluate.main(args) == 0
    card = _rows(run_dir / "result.txt")
    assert card["zz_flow_backend"] == "farneback" and float(card["warp-error-ssim"]) < 100.0
    _assert_rows_close(card, cpu)
