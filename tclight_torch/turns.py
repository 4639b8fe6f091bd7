"""K1 (the bf16 flash attention), K2 (the ToMe matcher), K6 and K7 (the
int8 attentions, their pre-pass included), K3 (the window
warp, both directions), K4 (the banded gather, render and adjoint) and K5
(the K-window gather, both directions) of two checkouts of this
repository, timed in turns on one card at chip_smoke's shapes: this
checkout, the other, the other, this. Each leg is a process of its own
that imports the `tclight_torch` of its checkout and calls only the
wrappers both have, `flash_attention_cuda`, `online_argmax_scores_cuda`,
`flash_attention_int8_cuda`, `window_warp_cuda`, `banded_gather_cuda`
(with the plan's rows where a checkout's takes them) and
`banded_gather_multi_cuda`, on the same inputs made from a seed; K3's
farneback case uses the Farneback flows of chip_smoke's 8-frame video
(rolling texture, 960x720), its random and wide cases chip_smoke's r = 24
and 2 x 160 x 192 at r = 100; K4 the main path's plans (`k4_plans`: the
padded batch of chip_smoke's 8-frame video and 16 distinct frames of a
16-frame one); K5 the K = 2 plans of chip_smoke's turnover ids (8 frames
at 960x720, its post-opt batch of 16), all computed once by this checkout
into build/turns/.

    python -m tclight_torch.turns OTHER_CHECKOUT [K1 K2 K6 K7 K6-prepass K7-prepass
        K3 K4 K5 K5-path steps]

K2 runs at every shape chip_smoke's paths launch it at (`K2_SHAPES`).
K1, K6 and K7 run at the UNet's xy levels 0-2 and yt levels 0-1 and at
the Cosmos DiTs' self-attention (32 heads of 128: 5,120, 14,080 and 56,320
tokens); K1 through `flash_attention_cuda` (the wrapper's k/v copies
included where a checkout makes them), K6 and K7 through
`flash_attention_int8_cuda` (`attn_backend="int8"` / `"int8pv"`, the
pre-pass included, and a max pass where a checkout launches one); K6-prepass
and K7-prepass through `qk_int8_operands` / `int8pv_operands`, all at the
same shapes.

K5-path is chip_smoke's K5 path: `run_uvt` on the turnover ids for 5
epochs; its ms is the median epoch past the first (the first plans and
warms up).

steps are chip_smoke's int8 runs through each checkout's CLI
(`tclight_torch.run`, random full-width weights, 4 sampling steps, the
post-optimization off): `yt-int8` (configs/examples/tclight_navsim.yaml,
30 frames at 960x720, int8 q.k^T), `int8` and `int8pv` (the main config, 8
frames, int8 q.k^T, and p.v too); the videos are chip_smoke's, made once
by this checkout into build/turns/. Its ms is the steady step, the mean of
the steps past the first (`stage_times`), each step beside it.

Prints the card's name and power limit, then one line per leg and shape:
milliseconds (`cuda_event_ms`: CUDA events over a few calls, after a
warm-up; all but K5's the median of three such runs, with their
spread). Needs a CUDA card and nvcc; each checkout builds its
kernels into its own build/.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
from pathlib import Path

from tclight_torch.utils.logging import cuda_event_ms

# (kernel, shape label, shape): chip_smoke's K2 merges at levels 0 and 1,
# its K6 / K7 attention shapes (B, S, H, D: xy levels 0-2, the yt pass's
# levels 0, 1, and the DiTs' self-attention) and its K3 cases (N, H, W,
# radius, adjoint)
ATTENTION = [("L0", (2, 35640, 8, 40)), ("L1", (2, 8910, 8, 80)), ("L2", (8, 660, 8, 160)),
             ("yt-L0", (2, 8910, 8, 40)), ("yt-L1", (2, 2228, 8, 80))]
DIT = [("dd", (1, 5120, 32, 128)), ("t2w", (1, 14080, 32, 128)),
       ("t2w-704", (1, 56320, 32, 128))]
# K1's (B, S, H, D): the UNet's xy and yt levels and the DiTs' self-attention
K1_SHAPES = ATTENTION + DIT
# K2's (B, S, D, C): chip_smoke's merges at levels 0 and 1, then every other
# shape its paths launch K2 at (the main run's CFG-shared batch of one, the
# yt pass's, the editing paths' batch of three, the parallel check's tiny
# UNet)
K2_SHAPES = [("global L0", (2, 23760, 23760, 320)), ("local L0", (2, 32400, 10800, 320)),
             ("global L1", (2, 5940, 5940, 640)), ("local L1", (2, 8100, 2700, 640)),
             ("main global L0", (1, 23760, 23760, 320)), ("main local L0", (1, 32400, 10800, 320)),
             ("yt global L0", (1, 5940, 5940, 320)), ("yt local L0", (1, 8100, 2700, 320)),
             ("yt global L0 B2", (2, 5940, 5940, 320)), ("yt local L0 B2", (2, 8100, 2700, 320)),
             ("yt global L1", (2, 1485, 1485, 640)), ("yt local L1", (2, 2025, 675, 640)),
             ("pnp global L0", (3, 23760, 23760, 320)), ("pnp local L0", (3, 32400, 10800, 320)),
             ("pnp global L1", (3, 5940, 5940, 640)), ("pnp local L1", (3, 8100, 2700, 640)),
             ("parallel global L0", (2, 1440, 1440, 64)), ("parallel local L0", (2, 1728, 576, 64)),
             ("parallel global L1", (2, 5760, 5760, 32)),
             ("parallel local L1", (2, 6912, 2304, 32))]
SHAPES = ([("K1", label, shape) for label, shape in K1_SHAPES]
          + [("K2", label, shape) for label, shape in K2_SHAPES]
          + [(kernel, label, shape) for kernel in ("K6", "K7", "K6-prepass", "K7-prepass")
             for label, shape in ATTENTION + DIT]
          + [("K3", f"{d} {case}", shape[:4] + (d == "adjoint",))
             for case, shape in (("farneback", (16, 720, 960, 4)), ("random", (16, 720, 960, 24)),
                                 ("wide", (2, 160, 192, 100)))
             for d in ("forward", "adjoint")]
          + [("K4", f"{d} {tag}", f"{d} {tag}") for tag in ("padded", "distinct")
             for d in ("render", "adjoint")]
          + [("K5", d, d) for d in ("render", "adjoint")]
          + [("K5-path", "run_uvt", (8, 720, 960, 5))])
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


def k5_plans(path) -> None:
    """chip_smoke's turnover ids, and the render's and the adjoint's K = 2
    plans of them for its post-opt batch, saved to `path` (as chip_smoke's
    K5 rows take them)."""
    import numpy as np
    import torch

    from chip_smoke import HEIGHT, WIDTH, post_batch, turnover_ids
    from tclight_torch.ops import banded_gather as bg
    from tclight_torch.ops.flow import voxelization
    from tclight_torch.pipeline import postopt

    hw = HEIGHT * WIDTH
    unq_inv = voxelization(turnover_ids(FRAMES, HEIGHT, WIDTH).reshape(-1))
    p_pad = max(128, -(-(int(unq_inv.max()) + 1) // 128) * 128)
    tables, _ = postopt.build_uvt_tables(unq_inv, FRAMES, HEIGHT, WIDTH, p_pad,
                                         allow_banded=True)
    idx = torch.from_numpy(post_batch())
    wf, wb = postopt._banded_windows(hw, p_pad)
    base = torch.arange(len(idx), dtype=torch.int32) * (bg.frame_tiles(hw) * 128)
    k = tables[1].shape[-1]
    torch.save({"ids": (unq_inv, int(unq_inv.max()) + 1),
                "render": (p_pad, tables[1][idx].reshape(-1, k), tables[2][idx].reshape(-1, 512),
                           wf),
                "adjoint": (len(idx) * bg.frame_tiles(hw) * 128,
                            (tables[6][idx] + base[:, None, None]).reshape(-1, k),
                            tables[7][idx].reshape(-1, 512), wb)}, path)


def k4_plans(path) -> None:
    """The main path's K4 plans, saved to `path`: the render's and the
    adjoint's single-window plans of the Farneback tracks of chip_smoke's
    video (its data layer: flows, soft masks, tracks), for its post-opt
    batch (the 8 frames padded with frame 0, as chip_smoke's K4 rows take
    them) and for 16 distinct frames of a 16-frame video made the same
    way. Each entry: (table rows, starts (NB,), offs (NB, 512), window,
    plan rows)."""
    import numpy as np
    import torch

    from chip_smoke import HEIGHT, WIDTH, make_video, post_batch
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.ops import banded_gather as bg
    from tclight_torch.pipeline import postopt

    hw = HEIGHT * WIDTH
    plans = {}
    for n, batch, tag in ((FRAMES, post_batch(), "padded"), (16, np.arange(16), "distinct")):
        vid = Path(path).parent / f"vid{n}"
        make_video(vid, n, HEIGHT, WIDTH)
        parser = VideoDataParser({"rgb_path": str(vid), "height": HEIGHT, "width": WIDTH,
                                  "flow_model": "farneback"})
        parser.load_data(list(range(n)), device="cuda")
        p_pad = max(128, -(-parser.n_unique // 128) * 128)
        tables, _ = postopt.build_uvt_tables(parser.unq_inv, n, HEIGHT, WIDTH, p_pad,
                                             allow_banded=True)
        if len(tables) != 10 or tables[1].dim() != 2:
            print(f"[k4_plans] the {n}-frame video's ids took no single-window plans: "
                  f"no {tag} entries", flush=True)
            continue
        idx = torch.from_numpy(batch)
        wf, wb = postopt._banded_windows(hw, p_pad)
        base = torch.arange(len(idx), dtype=torch.int32) * (bg.frame_tiles(hw) * 128)
        plans[f"render {tag}"] = (p_pad, tables[1][idx].reshape(-1),
                                  tables[2][idx].reshape(-1, 512), wf, len(idx))
        plans[f"adjoint {tag}"] = (len(idx) * bg.frame_tiles(hw) * 128,
                                   (tables[6][idx] + base[:, None]).reshape(-1),
                                   tables[7][idx].reshape(-1, 512), wb, len(idx))
    torch.save(plans, path)


def step_runs(root: Path) -> list:
    """The `steps` entries: (kernel, label, (config, video, overrides)) of
    chip_smoke's yt-int8, int8 and int8pv runs, on its videos made under
    build/turns/ of `root` if missing (with `root`'s chip_smoke)."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from chip_smoke import CHUNK, HEIGHT, PROMPT, STEPS, WIDTH, YT_FRAMES, make_video

    vids = {}
    for n in (FRAMES, YT_FRAMES):
        vids[n] = root / "build" / "turns" / f"vid{n}"
        if not vids[n].exists():
            make_video(vids[n], n, HEIGHT, WIDTH)
    common = ("post_opt.apply_opt=false", f"generation.n_timesteps={STEPS}",
              "generation.attn_qk_int8=true")
    # the prompt option before the overrides: the CLI takes those as one list
    main = ("-p", PROMPT) + common + (
        "data.flow_model=farneback", f"generation.chunk_size={CHUNK}",
        "generation.chunk_ord=mix-4", f"generation.frame_range=[0,{FRAMES},1]",
        f"data.height={HEIGHT}", f"data.width={WIDTH}")
    return [("steps", "yt-int8", ("configs/examples/tclight_navsim.yaml", str(vids[YT_FRAMES]),
                                  common)),
            ("steps", "int8", ("configs/tclight_default.yaml", str(vids[FRAMES]), main)),
            ("steps", "int8pv", ("configs/tclight_default.yaml", str(vids[FRAMES]),
                                 main + ("generation.attn_pv_int8=true",)))]


def farneback_path(root: Path) -> Path:
    """build/turns/farneback_past.npy under `root`, made if missing."""
    path = root / "build" / "turns" / "farneback_past.npy"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        farneback_flows(path)
    return path


def plan_paths(root: Path) -> tuple[Path, Path]:
    """build/turns/k4_plans.pt and k5_plans.pt under `root`, made if
    missing (they read chip_smoke's helpers from `root`)."""
    k4, k5 = root / "build" / "turns" / "k4_plans.pt", root / "build" / "turns" / "k5_plans.pt"
    k4.parent.mkdir(parents=True, exist_ok=True)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    if not k4.exists():
        k4_plans(k4)
    if not k5.exists():
        k5_plans(k5)
    return k4, k5


def leg(shapes, flows_path, plans_path, k4_path=None) -> None:
    """One checkout's times; runs with that checkout first on sys.path."""
    import inspect

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tclight_torch.ops.attention import (flash_attention_cuda, flash_attention_int8_cuda,
                                             int8pv_operands, qk_int8_operands)
    from tclight_torch.ops.banded_gather import banded_gather_cuda, banded_gather_multi_cuda
    from tclight_torch.ops.match_kernel import online_argmax_scores_cuda
    from tclight_torch.ops.warp_kernel import window_warp_cuda

    def ms(fn, reps):
        return cuda_event_ms(fn, reps)[0]

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, label, shape in shapes:
        if kernel == "K1":
            b, s, h, d = shape
            q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                       for _ in range(3))
            t, spread = cuda_event_ms(lambda: flash_attention_cuda(q, k, v, d ** -0.5),
                                      3 if s > 20000 else 10, 3)
            label += f" spread_ms={spread:.4f}"
        elif kernel == "K2":
            b, s, d, c = shape
            a = F.normalize(torch.randn(b, s, c, device="cuda", generator=gen), dim=-1).bfloat16()
            bt = F.normalize(torch.randn(b, d, c, device="cuda", generator=gen), dim=-1).bfloat16()
            t, spread = cuda_event_ms(lambda: online_argmax_scores_cuda(a, bt),
                                      5 if s * d > 1e8 else 20, 3)
            label += f" spread_ms={spread:.4f}"
        elif kernel == "K5":
            n_rows, starts, offs, window = torch.load(plans_path, weights_only=False)[shape]
            table = torch.randn(n_rows, 3, device="cuda", generator=gen)
            starts, offs = starts.cuda(), offs.cuda()
            t = ms(lambda: banded_gather_multi_cuda(table, starts, offs, window), 20)
        elif kernel == "K4":
            # as the main path launches it: the render's plan rows go to a
            # checkout whose K4 takes them, the adjoint keeps plan order
            n_rows, starts, offs, window, rows = torch.load(k4_path, weights_only=False)[shape]
            table = torch.randn(n_rows, 3, device="cuda", generator=gen)
            starts, offs = starts.cuda(), offs.cuda()
            kw = ({"rows": rows} if shape.startswith("render")
                  and "rows" in inspect.signature(banded_gather_cuda).parameters else {})
            t, spread = cuda_event_ms(lambda: banded_gather_cuda(table, starts, offs, window, **kw),
                                      20, 3)
            label += f" spread_ms={spread:.4f}"
        elif kernel == "K5-path":
            # chip_smoke's K5-path phase: run_uvt on the turnover ids
            from tclight_torch.pipeline import postopt

            n, h, w, epochs = shape
            unq_inv, n_unique = torch.load(plans_path, weights_only=False)["ids"]
            frames = torch.rand(n, h, w, 3, device="cuda", generator=gen)
            flows = torch.zeros(n, h, w, 2, device="cuda")
            masks = torch.ones(n, h, w, device="cuda")
            _, _, times = postopt.run_uvt(frames, flows, masks, unq_inv, n_unique,
                                          postopt.PostOptConfig(epochs=epochs),
                                          warp_radius=postopt.flow_radius(flows.cpu().numpy()))
            label += " epoch_s=" + ",".join(f"{x:.4f}" for x in times)
            t = float(np.median(times[1:])) * 1e3
        elif kernel == "steps":
            # the checkout's CLI (cwd: the checkout); ms the steady step
            import shutil
            from pathlib import Path

            import yaml

            from tclight_torch.run import main as run_main

            config, video, overrides = shape
            work = Path("build") / "turns_steps" / label
            shutil.rmtree(work, ignore_errors=True)
            rc = run_main(["--config", config, "-i", video, "--full-width-random", *overrides,
                           f"work_dir={work}"])
            if rc != 0:
                raise SystemExit(f"{label} run exited {rc}")
            out_dir = next(work.rglob("output.mp4")).parent
            steps = yaml.safe_load((out_dir / "config.yaml").read_text())["stage_times"]
            steps = steps["step_times"]
            label += " step_s=" + ",".join(f"{x:.4f}" for x in steps)
            t = float(np.mean(steps[1:])) * 1e3
            shape = config
        elif kernel == "K3":
            n, h, w, r, adjoint = shape
            x = torch.rand(n, h, w, 3, device="cuda", generator=gen)
            if "farneback" in label:
                f = torch.from_numpy(np.load(flows_path)).cuda()
            else:
                f = (torch.rand(n, h, w, 2, device="cuda", generator=gen) * 2 - 1) * r
            t, spread = cuda_event_ms(lambda: window_warp_cuda(x, f, r, adjoint=adjoint),
                                      5 if r < 20 or not adjoint else 2, 3)
            label += f" spread_ms={spread:.4f}"
        else:
            b, s, h, d = shape
            q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                       for _ in range(3))
            if kernel.endswith("prepass"):
                make = qk_int8_operands if kernel == "K6-prepass" else int8pv_operands
                fn = lambda: make(q, k, v)  # noqa: E731
            else:
                fn = lambda: flash_attention_int8_cuda(q, k, v, d ** -0.5,  # noqa: E731
                                                       kernel == "K7")
            t, spread = cuda_event_ms(fn, 3 if s > 20000 else 10, 3)
            label += f" spread_ms={spread:.4f}"
        print(f"{kernel} {label} {shape} ms={t:.4f}", flush=True)


def leg_code(root, shapes, flows_path, plans_path, k4_path=None) -> str:
    """The program of one leg: `leg` with the checkout at `root` first on
    sys.path, and this checkout's timer beside it (the other may lack it)."""
    return ("from __future__ import annotations\n"
            f"import sys; sys.path.insert(0, {str(root)!r})\n"
            "from typing import Any, Callable\nimport torch\n"
            + inspect.getsource(cuda_event_ms) + inspect.getsource(leg)
            + f"\nleg({shapes!r}, {str(flows_path)!r}, {str(plans_path)!r}, {str(k4_path)!r})\n")


def main(argv: list[str]) -> int:
    every = {"K1", "K2", "K6", "K7", "K6-prepass", "K7-prepass", "K3", "K4", "K5", "K5-path",
             "steps"}
    kernels = set(argv[1:]) or every
    if not argv or not kernels <= every:
        print(__doc__, file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[1]
    other = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    flows_path = farneback_path(here) if "K3" in kernels else None
    k4_path, plans_path = (plan_paths(here) if kernels & {"K4", "K5", "K5-path"}
                           else (None, None))
    shapes = [sh for sh in SHAPES if sh[0] in kernels]
    if "steps" in kernels:
        shapes += step_runs(here)
    for name, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        print(f"[turn] {name} {root}", flush=True)
        r = subprocess.run([sys.executable, "-c",
                            leg_code(root, shapes, flows_path, plans_path, k4_path)],
                           cwd=root, text=True)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
