"""The port stands alone: importing every module of tclight_torch (the
post-optimization's, the checkpoint loaders', the flow networks', the
evaluation's, the editing path's, the background and single-image
relighting's, the demos', the prompt upsampler's (RoPE, the AR decoder,
its converters, Pixtral), the annotators' (DPT, HED, lineart, OpenPose)
and the AR world stack's and guardrail models' (the FSQ tokenizer, T5,
the diffusion decoder, Aegis, SigLIP, RetinaFace, the lazy config) and
the host tools included) loads neither
JAX, optax nor the JAX package, nor `safetensors` (which the card's
machine lacks: the port reads the files itself) or `transformers` (only a
tokenizer directory needs it), and its entry points refuse to run on the
CPU unless asked to."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tclight_torch
names = [m.name for m in pkgutil.walk_packages(tclight_torch.__path__, "tclight_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tclight_tpu"))
print(len(names), "modules")
assert not bad, bad
# the post-optimization slice's modules are among those imported
slice2 = {"tclight_torch.ops." + m for m in (
    "color", "schedules", "resample", "warp_kernel", "flow", "banded_gather", "losses")}
slice2 |= {"tclight_torch.native", "tclight_torch.data.flow_backends",
           "tclight_torch.data.dataparsers", "tclight_torch.pipeline.postopt"}
assert slice2 <= set(names), sorted(slice2 - set(names))
# the checkpoint loaders' modules, and the packages they must not need
loaders = {"tclight_torch.models.convert", "tclight_torch.pipeline.iclight"}
assert loaders <= set(names), sorted(loaders - set(names))
extra = sorted(m for m in sys.modules if m.split(".")[0] in ("safetensors", "transformers"))
assert not extra, extra
# the flow networks, the synthetic scenes and the evaluation
slice8 = {"tclight_torch.models." + m for m in (
    "raft", "memflow_sk", "memflow", "clip_vision", "vgg_lpips")}
slice8 |= {"tclight_torch.data.formats", "tclight_torch.data.synthetic",
           "tclight_torch.eval", "tclight_torch.eval.metrics", "tclight_torch.eval.loaders",
           "tclight_torch.evaluate"}
assert slice8 <= set(names), sorted(slice8 - set(names))
# the editing path, background conditioning and single-image relighting;
# the demos import gradio only under --serve
slice9 = {"tclight_torch.models.controlnet", "tclight_torch.models.briarmbg",
          "tclight_torch.data.controlnet_utils", "tclight_torch.pipeline.invert",
          "tclight_torch.pipeline.single_image", "tclight_torch.gradio_demo_iclight",
          "tclight_torch.gradio_demo_bg_iclight"}
assert slice9 <= set(names), sorted(slice9 - set(names))
assert "gradio" not in sys.modules
# the prompt upsampler and the annotators
slice10 = {"tclight_torch.models." + m for m in (
    "rope", "ar_transformer", "convert_ar", "pixtral", "dpt", "hed", "lineart", "openpose")}
assert slice10 <= set(names), sorted(slice10 - set(names))
# the AR world stack, the guardrail models and the lazy config
slice12 = {"tclight_torch.cosmos." + m for m in (
    "fsq", "t5", "diffusion_decoder", "aegis", "aegis_data")}
slice12 |= {"tclight_torch.models." + m for m in (
    "ar_configs", "t5_encoder", "siglip", "retinaface")} | {"tclight_torch.config_lazy"}
assert slice12 <= set(names), sorted(slice12 - set(names))
# the host tools
slice13 = {"tclight_torch.tools", "tclight_torch.tools.img2video",
           "tclight_torch.tools.video2img"}
assert slice13 <= set(names), sorted(slice13 - set(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 57


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _require_no_cuda()
    from tclight_torch.config import ConfigDict
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import (build_full_width_random,
                                               build_tiny_iclight, load_iclight)
    from tclight_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tiny_iclight()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_full_width_random()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_iclight(REPO / "no_such_model_dir")
    models = build_tiny_iclight(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(models, ConfigDict({"post_opt": {"apply_opt": False}}))
    # the flow networks and the metric models
    from tclight_torch.models.memflow_sk import InferenceCoreSK, MemFlowNetSK, MemFlowSKConfig
    from tclight_torch.models.raft import RAFT, RAFTConfig, RAFTFlowModel

    sd = RAFT(RAFTConfig.tiny()).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        RAFTFlowModel(sd, RAFTConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceCoreSK(MemFlowNetSK(MemFlowSKConfig(decoder_depth=1)))
    from tclight_torch.eval import loaders

    with pytest.raises(RuntimeError, match="CUDA"):
        loaders.load_lpips(REPO / "no_such_dir")
    # the editing path, background conditioning and single-image relighting
    from tclight_torch.gradio_demo_bg_iclight import build_relighter as build_fbc
    from tclight_torch.gradio_demo_iclight import build_relighter as build_fc
    from tclight_torch.models.briarmbg import load_rmbg
    from tclight_torch.models.controlnet import load_controlnet
    from tclight_torch.models.unet import UNetConfig
    from tclight_torch.pipeline.iclight import (build_full_width_random_sd, build_tiny_sd,
                                               load_sd)
    from tclight_torch.pipeline.invert import Inverter

    # the prompt upsampler and the annotators
    from tclight_torch.models import dpt, hed, lineart, openpose, pixtral

    for call in (pixtral.build_tiny_vlm, lambda: pixtral.load_vlm(REPO / "no_such_dir"),
                 lambda: dpt.random_dpt(dpt.DPTConfig.tiny()),
                 lambda: dpt.load_dpt(REPO / "no_such.pth"),
                 lambda: hed.load_hed(REPO / "no_such.pth"),
                 lambda: lineart.load_lineart(REPO / "no_such.pth"),
                 lambda: openpose.load_bodypose(REPO / "no_such.pth")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for call in (build_tiny_sd, build_full_width_random_sd, build_fc, build_fbc,
                 lambda: load_sd(REPO / "no_such_model_dir"),
                 lambda: load_controlnet(REPO / "no_such.safetensors", UNetConfig.tiny()),
                 lambda: load_rmbg(REPO / "no_such.pth"),
                 lambda: Inverter(build_tiny_sd(device="cpu"), {"inversion": {}})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _require_no_cuda()
    from tclight_torch.run import main

    monkeypatch.chdir(REPO)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", "configs/tclight_default.yaml", "-i", "unused.mp4",
              "-p", "x", "post_opt.apply_opt=false", "work_dir=workdir/unused"])
    from tclight_torch import evaluate

    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--output_dir", "workdir/unused", "--flow_model", "farneback"])
    monkeypatch.delenv("ICLIGHT_MODEL_DIR", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", "configs/tclight_default.yaml", "-i", "unused.mp4", "-p", "x",
              "sd_version=1.5", "post_opt.apply_opt=false", "work_dir=workdir/unused"])
    from tclight_torch import gradio_demo_bg_iclight, gradio_demo_iclight

    png = REPO / "configs" / "no_such.png"
    for demo, args in ((gradio_demo_iclight, ["--input", str(png)]),
                       (gradio_demo_bg_iclight, ["--fg", str(png), "--bg", str(png)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main(args)
