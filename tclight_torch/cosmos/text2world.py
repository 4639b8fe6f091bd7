"""Text2World: prompt -> guardrail -> EDM-sampled DiT -> chunked
tokenizer decode -> mp4, with per-component offloading (the port's
counterpart of tools/text2world.py, same arguments). On the card, tiny
random-weight models:

    python -m tclight_torch.cosmos.text2world --prompt "a corgi on a beach" \\
        --height 64 --width 64 --num_video_frames 5 --num_steps 8 \\
        --offload_diffusion_transformer --video_save_folder outputs/t2w

`--model_size 7b` builds the 7B DiT and the CV8x8x8 tokenizer at their
published widths on random weights (or loads `model.pt` state dicts from
--checkpoint_dir). `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None):
    from tclight_torch.cosmos.inference_cli import add_common_arguments

    p = argparse.ArgumentParser(description="Text to world generation")
    add_common_arguments(p)
    p.add_argument("--diffusion_transformer_dir", type=str,
                   default="Cosmos-1.0-Diffusion-7B-Text2World")
    p.add_argument("--prompt_upsampler_dir", type=str,
                   default="Cosmos-1.0-Prompt-Upsampler-12B-Text2World")
    p.add_argument("--word_limit_to_skip_upsampler", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> int:
    from tclight_torch.cosmos.inference_cli import build_pipeline, run_generation

    args = parse_arguments(argv)
    pipeline, tokenizer = build_pipeline(args, video2world=False, device=device)
    return run_generation(args, pipeline, tokenizer)


if __name__ == "__main__":
    sys.exit(main())
