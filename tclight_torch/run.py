"""TC-Light CLI for the PyTorch port (counterpart of run.py), IC-Light path.

Usage:
    python -m tclight_torch.run --config configs/tclight_default.yaml \\
        -i video.mp4 -p "prompt" data.flow_model=farneback --full-width-random

Runs on the CUDA device; `main(argv, device="cpu")` runs the plain CPU
path (the tests do). With `post_opt.apply_opt` (the default) the relit
frames go through the exposure alignment and the UVT refinement, on the
flows of `data.flow_model`: Farneback flows are computed; RAFT and MemFlow
flows are read from the flow cache next to the video
(`<stem>_{future,past}_flow_<backend>/NNNNN.npy`, as the JAX package writes
it), and a frame that misses the cache raises, since those networks are
not ported (ROADMAP A9). Weights: from the checkpoint files in
`model_dir` when it names an existing directory (layout in
tclight_torch/pipeline/iclight.py; IC-Light's `fbc` offsets and 12-channel
UNet when `generation.background_cond` is set, else `fc`); else, with
`--full-width-random`, the SD1.5 IC-Light stack on random weights; with
TCLIGHT_TINY=1, the tiny random stack.
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
                                               build_tiny_iclight, load_iclight)
    from tclight_torch.utils.device import resolve_device
    from tclight_torch.utils.logging import get_logger
    from tclight_torch.utils.video_io import count_frames, get_frame_ids

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--full-width-random", action="store_true")
    known, rest = pre.parse_known_args(argv)
    log = get_logger()
    config = load_config(rest)
    dev = resolve_device(device)

    if config.get("sd_version", "iclight") != "iclight":
        raise NotImplementedError("only sd_version: iclight is ported")
    if str(config.get_path("data.scene_type", "video")).lower() != "video":
        raise NotImplementedError("only data.scene_type: video is ported")
    steps = config.get_path("generation.n_timesteps", 25) or 25
    model_dir = config.get("model_dir")
    if model_dir and Path(str(model_dir)).exists():
        mode = "fbc" if config.get_path("generation.background_cond") else "fc"
        log.info("loading IC-Light (%s) from %s", mode, model_dir)
        models = load_iclight(model_dir, mode=mode, num_inference_steps=steps, device=dev)
    elif known.full_width_random:
        models = build_full_width_random(num_inference_steps=steps, device=dev)
    elif os.environ.get("TCLIGHT_TINY"):
        log.warning("using tiny random-weight models (TCLIGHT_TINY)")
        # the CUDA kernels take bf16
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        models = build_tiny_iclight(num_inference_steps=steps, dtype=dtype,
                                    device=dev)
    else:
        log.error("no weights: set model_dir to a local checkpoint directory, pass "
                  "--full-width-random or export TCLIGHT_TINY=1")
        return 2

    parser = make_data_parser(config.data)
    frame_ids = get_frame_ids(config.get_path("generation.frame_range"),
                              config.get_path("generation.frame_ids"),
                              n_total=count_frames(config.data.rgb_path))
    generator = Generator(models, config, data_parser=parser, device=dev)
    generator(config.get_path("generation.latents_path"),
              config.get_path("generation.output_path") or config.get("work_dir"),
              frame_ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
