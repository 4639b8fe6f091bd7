"""Video2World: a conditioning image or video and a prompt -> guardrail
-> EDM sampling with the condition latent clamped -> chunked tokenizer
decode -> mp4 (the port's counterpart of tools/video2world.py, same
arguments). On the card, tiny random-weight models:

    python -m tclight_torch.cosmos.video2world --input_image_or_video_path in.png \\
        --prompt "the camera pans right" --height 64 --width 64 \\
        --num_video_frames 5 --num_steps 8 --video_save_folder outputs/v2w

`main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_arguments(argv=None):
    from tclight_torch.cosmos.inference_cli import add_common_arguments

    p = argparse.ArgumentParser(description="Video to world generation")
    add_common_arguments(p)
    p.add_argument("--diffusion_transformer_dir", type=str,
                   default="Cosmos-1.0-Diffusion-7B-Video2World")
    p.add_argument("--prompt_upsampler_dir", type=str, default="Pixtral-12B")
    p.add_argument("--input_image_or_video_path", type=str, required=True)
    p.add_argument("--num_input_frames", type=int, default=1, choices=(1, 9),
                   help="frames to condition on")
    return p.parse_args(argv)


def load_condition(path: str, h: int, w: int, n: int) -> np.ndarray:
    """The conditioning image or video, resized to the target size, in
    [-1, 1], shaped (1, n, H, W, 3): the last n frames, the first one
    repeated in front when there are fewer."""
    from tclight_torch.utils.video_io import load_video

    frames = np.asarray(load_video(path, height=h, width=w), np.float32)
    if frames.max() > 1.5:
        frames = frames / 255.0
    if frames.shape[0] < n:
        frames = np.concatenate([frames[:1]] * (n - frames.shape[0]) + [frames], axis=0)
    return frames[None, -n:] * 2.0 - 1.0


def main(argv=None, device="cuda") -> int:
    from tclight_torch.cosmos.inference_cli import build_pipeline, run_generation

    args = parse_arguments(argv)
    pipeline, tokenizer = build_pipeline(args, video2world=True, device=device)
    cond = load_condition(args.input_image_or_video_path, args.height, args.width,
                          tokenizer.pixel_chunk_duration)
    return run_generation(args, pipeline, tokenizer, condition_video=cond)


if __name__ == "__main__":
    sys.exit(main())
