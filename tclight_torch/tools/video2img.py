"""mp4/gif -> numbered image frames (counterpart of tools/video2img.py):

    python -m tclight_torch.tools.video2img --input clip.mp4 --output_dir frames/ \
        [--ext png] [--frame_range START END STEP]
"""

from __future__ import annotations

import argparse
import sys

from tclight_torch.utils.video_io import get_frame_ids, load_video, save_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ext", default="png")
    p.add_argument("--frame_range", type=int, nargs=3, default=None,
                   metavar=("START", "END", "STEP"))
    args = p.parse_args(argv)

    ids = get_frame_ids(args.frame_range) if args.frame_range else None
    frames = load_video(args.input, frame_ids=ids)
    save_frames(frames, args.output_dir, ext=args.ext)
    print(f"wrote {len(frames)} frames -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
