"""K2 (the ToMe matcher), K6 and K7 (the int8 attentions, their pre-pass
and max pass included) and K3 (the window warp, both directions) of two
checkouts of this repository, timed in turns on one card at chip_smoke's
shapes: this checkout, the other, the other, this. Each leg is a process
of its own that imports the `tclight_torch` of its checkout and calls only
the wrappers both have, `online_argmax_scores_cuda`,
`flash_attention_int8_cuda` and `window_warp_cuda`, on the same inputs
made from a seed; K3's farneback case uses the Farneback flows of
chip_smoke's 8-frame video (rolling texture, 960x720), computed once by
this checkout into build/turns/.

    python -m tclight_torch.turns OTHER_CHECKOUT [K2 K6 K7 K3]

Prints the card's name and power limit, then one line per leg and shape:
milliseconds (CUDA events over a few calls, after a warm-up). Needs a
CUDA card and nvcc; each checkout builds its kernels into its own build/.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
from pathlib import Path

# (kernel, shape label, shape): chip_smoke's K2 merges at levels 0 and 1,
# its K6 / K7 attention shapes (xy levels 0-2, the yt pass's levels 0, 1)
# and its K3 cases (N, H, W, radius, adjoint)
ATTENTION = [("L0", (2, 35640, 40)), ("L1", (2, 8910, 80)), ("L2", (8, 660, 160)),
             ("yt-L0", (2, 8910, 40)), ("yt-L1", (2, 2228, 80))]
SHAPES = ([("K2", "global L0", (2, 23760, 23760, 320)), ("K2", "local L0", (2, 32400, 10800, 320)),
           ("K2", "global L1", (2, 5940, 5940, 640)), ("K2", "local L1", (2, 8100, 2700, 640))]
          + [("K6", label, shape) for label, shape in ATTENTION]
          + [("K7", label, shape) for label, shape in ATTENTION]
          + [("K3", f"{d} {case}", (16, 720, 960, r, d == "adjoint"))
             for case, r in (("farneback", 4), ("random", 24)) for d in ("forward", "adjoint")])
FRAMES = 8  # chip_smoke's main video; its post-opt batch pads it to 16 with frame 0


def farneback_flows(path) -> None:
    """The past-direction Farneback flows of chip_smoke's video, in its
    post-opt batch order, saved to `path` (16, 720, 960, 2)."""
    import cv2
    import numpy as np

    from tclight_torch.data.flow_backends import compute_flow_pairs

    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.uniform(0.15, 0.85, (720, 960, 3)).astype(np.float32), (0, 0), 3)
    frames = np.stack([np.roll(base, 2 * t, axis=1) for t in range(FRAMES)])
    past = compute_flow_pairs(frames, "past", "farneback")
    np.save(path, past[list(range(FRAMES)) + [0] * (16 - FRAMES)])


def leg(shapes, flows_path) -> None:
    """One checkout's times; runs with that checkout first on sys.path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tclight_torch.ops.attention import flash_attention_int8_cuda
    from tclight_torch.ops.match_kernel import online_argmax_scores_cuda
    from tclight_torch.ops.warp_kernel import window_warp_cuda

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, label, shape in shapes:
        if kernel == "K2":
            b, s, d, c = shape
            a = F.normalize(torch.randn(b, s, c, device="cuda", generator=gen), dim=-1).bfloat16()
            bt = F.normalize(torch.randn(b, d, c, device="cuda", generator=gen), dim=-1).bfloat16()
            t = ms(lambda: online_argmax_scores_cuda(a, bt), 5)
        elif kernel == "K3":
            n, h, w, r, adjoint = shape
            x = torch.rand(n, h, w, 3, device="cuda", generator=gen)
            if "farneback" in label:
                f = torch.from_numpy(np.load(flows_path)).cuda()
            else:
                f = (torch.rand(n, h, w, 2, device="cuda", generator=gen) * 2 - 1) * r
            t = ms(lambda: window_warp_cuda(x, f, r, adjoint=adjoint), 5 if r < 20 or not adjoint
                   else 2)
        else:
            b, s, d = shape
            q, k, v = (torch.randn(b, s, 8, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                       for _ in range(3))
            t = ms(lambda: flash_attention_int8_cuda(q, k, v, d ** -0.5, kernel == "K7"),
                   3 if s > 20000 else 10)
        print(f"{kernel} {label} {shape} ms={t:.4f}", flush=True)


def main(argv: list[str]) -> int:
    kernels = set(argv[1:]) or {"K2", "K6", "K7", "K3"}
    if not argv or not kernels <= {"K2", "K6", "K7", "K3"}:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[1]
    other = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    flows_path = here / "build" / "turns" / "farneback_past.npy"
    if "K3" in kernels and not flows_path.exists():
        flows_path.parent.mkdir(parents=True, exist_ok=True)
        farneback_flows(flows_path)
    shapes = [sh for sh in SHAPES if sh[0] in kernels]
    code = inspect.getsource(leg) + f"\nleg({shapes!r}, {str(flows_path)!r})\n"
    for name, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        print(f"[turn] {name} {root}", flush=True)
        r = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})\n"
                            + code], cwd=root, text=True)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
