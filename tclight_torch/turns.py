"""K2 (the ToMe matcher) and K6 (int8 q.k^T attention, its pre-pass
included) of two checkouts of this repository, timed in turns on one
card at chip_smoke's shapes: this checkout, the other, the other, this.
Each leg is a process of its own that imports the `tclight_torch` of its
checkout and calls only the wrappers both have, `online_argmax_scores_cuda`
and `flash_attention_int8_cuda`, on the same inputs made from a seed.

    python -m tclight_torch.turns OTHER_CHECKOUT

Prints the card's name and power limit, then one line per leg and shape:
milliseconds (CUDA events over a few calls, after a warm-up). Needs a
CUDA card and nvcc; each checkout builds its kernels into its own build/.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
from pathlib import Path

# (kernel, shape label, shape): chip_smoke's K2 merges at levels 0 and 1
# and its K6 attention shapes (xy levels 0-2, the yt pass's levels 0, 1)
SHAPES = [("K2", "global L0", (2, 23760, 23760, 320)), ("K2", "local L0", (2, 32400, 10800, 320)),
          ("K2", "global L1", (2, 5940, 5940, 640)), ("K2", "local L1", (2, 8100, 2700, 640)),
          ("K6", "L0", (2, 35640, 40)), ("K6", "L1", (2, 8910, 80)), ("K6", "L2", (8, 660, 160)),
          ("K6", "yt-L0", (2, 8910, 40)), ("K6", "yt-L1", (2, 2228, 80))]


def leg(shapes) -> None:
    """One checkout's times; runs with that checkout first on sys.path."""
    import torch
    import torch.nn.functional as F

    from tclight_torch.ops.attention import flash_attention_int8_cuda
    from tclight_torch.ops.match_kernel import online_argmax_scores_cuda

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
        else:
            b, s, d = shape
            q, k, v = (torch.randn(b, s, 8, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                       for _ in range(3))
            t = ms(lambda: flash_attention_int8_cuda(q, k, v, d ** -0.5), 3 if s > 20000 else 10)
        print(f"{kernel} {label} {shape} ms={t:.4f}", flush=True)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[1]
    other = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    code = inspect.getsource(leg) + f"\nleg({SHAPES!r})\n"
    for name, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        print(f"[turn] {name} {root}", flush=True)
        r = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})\n"
                            + code], cwd=root, text=True)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
