"""TC-Light CLI for the PyTorch port (counterpart of run.py).

Usage:
    python -m tclight_torch.run --config configs/tclight_default.yaml \\
        -i video.mp4 -p "prompt" data.flow_model=farneback --full-width-random

Runs on the CUDA device; `main(argv, device="cpu")` runs the plain CPU
path (the tests do). With `post_opt.apply_opt` (the default) the relit
frames go through the exposure alignment and the UVT refinement, on the
flows of `data.flow_model`: Farneback flows are computed; RAFT and MemFlow
flows are read from the flow cache next to the video
(`<stem>_{future,past}_flow_<backend>/NNNNN.npy`, as the JAX package writes
it), and a frame that misses the cache raises ValueError, since the CLI
loads no flow network (as the JAX package's run.py loads none). The
synthetic scenes (`data.scene_type` sceneflow, carla, interiornet) bring
their own flows (data/synthetic.py). Weights: from the checkpoint files in
`model_dir` when it names an existing directory (layout in
tclight_torch/pipeline/iclight.py; IC-Light's `fbc` offsets and 12-channel
UNet when `generation.background_cond` is set, else `fc`); else, with
`--full-width-random`, the SD1.5 stack on random weights; with
TCLIGHT_TINY=1, the tiny random stack.

`sd_version` other than `iclight` (1.5, 2.0, 2.1, depth) runs the
generic-SD editing path: the 4-channel stack (`load_sd`, with the
ControlNet of `generation.control` when it is a ControlNet type; a
model-backed type reads `generation.annotator_ckpt`, depth the DPT of
`generation.depth_ckpt`), the DDIM inversion of the frames into
`inversion.save_path`, then the Generator from those latents
(`generation.latents_path`), with PnP or the ControlNet as
`generation.control` says. `sd_version: depth` is the sd-depth stack: a
5-channel UNet whose fifth channel is the frames' DPT depth maps
(`generation.depth_ckpt`, a transformers DPT checkpoint).

`parallel.n_devices=N` (N > 1) runs on N processes, one per card:
launched by `torchrun --nproc_per_node N -m tclight_torch.run ...`, each
rank joins the process group from torchrun's environment (NCCL on the
card of its LOCAL_RANK, gloo on the CPU) before the Generator builds its
mesh (pipeline/generator.py); rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch


def main(argv=None, device: str = "cuda") -> int:
    from tclight_torch.config import load_config
    from tclight_torch.data.dataparsers import make_data_parser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import (build_full_width_random,
                                               build_full_width_random_sd,
                                               build_tiny_iclight, build_tiny_sd,
                                               load_iclight, load_sd)
    from tclight_torch.pipeline.invert import Inverter
    from tclight_torch.utils.device import resolve_device
    from tclight_torch.utils.logging import get_logger
    from tclight_torch.utils.video_io import count_frames, get_frame_ids

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--full-width-random", action="store_true")
    known, rest = pre.parse_known_args(argv)
    log = get_logger()
    config = load_config(rest)
    dev = resolve_device(device)
    if int(config.get_path("parallel.n_devices", 0) or 0) > 1 and "WORLD_SIZE" in os.environ:
        from tclight_torch.parallel.mesh import init_distributed

        init_distributed(device=dev)

    sd_version = str(config.get("sd_version", "iclight"))
    editing = sd_version != "iclight"
    steps = config.get_path("generation.n_timesteps", 50 if editing else 25) or 25
    fbc = bool(config.get_path("generation.background_cond"))
    model_dir = config.get("model_dir")
    if model_dir and Path(str(model_dir)).exists() and editing:
        control = str(config.get_path("generation.control", "none") or "none")
        log.info("loading SD %s (control %s) from %s", sd_version, control, model_dir)
        models = load_sd(model_dir, sd_version, steps, control=control, device=dev)
    elif model_dir and Path(str(model_dir)).exists():
        mode = "fbc" if fbc else "fc"
        log.info("loading IC-Light (%s) from %s", mode, model_dir)
        models = load_iclight(model_dir, mode=mode, num_inference_steps=steps, device=dev)
    elif known.full_width_random and editing:
        models = build_full_width_random_sd(num_inference_steps=steps, device=dev,
                                            sd_version=sd_version)
    elif known.full_width_random:
        models = build_full_width_random(num_inference_steps=steps, device=dev,
                                         in_channels=12 if fbc else 8)
    elif os.environ.get("TCLIGHT_TINY"):
        log.warning("using tiny random-weight models (TCLIGHT_TINY)")
        # the CUDA kernels take bf16
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        if editing:
            models = build_tiny_sd(num_inference_steps=steps, dtype=dtype, device=dev,
                                   sd_version=sd_version)
        else:
            models = build_tiny_iclight(num_inference_steps=steps, dtype=dtype, device=dev)
    else:
        log.error("no weights: set model_dir to a local checkpoint directory, pass "
                  "--full-width-random or export TCLIGHT_TINY=1")
        return 2

    parser = make_data_parser(config.data)
    frame_ids = get_frame_ids(config.get_path("generation.frame_range"),
                              config.get_path("generation.frame_ids"),
                              n_total=count_frames(config.data.rgb_path))
    generator = Generator(models, config, data_parser=parser, device=dev)
    if editing:
        inverter = Inverter(models, config, data_parser=parser, device=dev)
        inverter(config.get_path("inversion.save_path"), frame_ids)
        # the run's config.yaml lists the inversion beside the Generator's stages
        generator.stage_times.update(inverter.stage_times)
    generator(config.get_path("generation.latents_path"),
              config.get_path("generation.output_path") or config.get("work_dir"),
              frame_ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
