"""Image sequence -> mp4/gif with an optional crop (counterpart of
tools/img2video.py):

    python -m tclight_torch.tools.img2video --input_dir frames/ --output out.mp4 \
        [--fps 25] [--crop Y0 Y1 X0 X1]
"""

from __future__ import annotations

import argparse
import sys

from tclight_torch.utils.video_io import load_video, save_video


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True, help="directory of frames")
    p.add_argument("--output", required=True, help="output .mp4/.gif")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--crop", type=int, nargs=4, metavar=("Y0", "Y1", "X0", "X1"),
                   default=None)
    args = p.parse_args(argv)

    frames = load_video(args.input_dir)
    if args.crop:
        y0, y1, x0, x1 = args.crop
        frames = frames[:, y0:y1, x0:x1]
    save_video(frames, args.output, fps=args.fps)
    print(f"wrote {len(frames)} frames -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
