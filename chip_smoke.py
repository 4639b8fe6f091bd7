"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card, its name and power limit (nvidia-smi); TF32 off for
     the plain f32 references;
  2. build: the port's CUDA kernels from tclight_torch/csrc with nvcc;
  3. K1 flash attention against its plain version at the UNet's
     self-attention shapes of a 960x720 run (levels 0, 1 and 2);
  4. K2 ToMe matcher against its plain version at the level-0 merge shapes;
  5. reference: the tiny stack end to end on a small input, on the card in
     bf16 against the CPU in f32 (`check_small_reference`);
  6. the main path: `python -m tclight_torch.run` on the full-width random
     SD1.5 IC-Light stack, 8 frames of a synthetic rolling video at
     960x720, 4 DPM++ steps, post-optimization off; checks the mp4 and
     that the path launched both kernels; then a traced run of 2 sampling
     steps gives the device time per kernel group (torch.profiler);
  7. one JSON line with every kernel's launches, error and times.
The last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero. Needs the repository around it and a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"  # videos and run outputs (ignored by git)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

WIDTH, HEIGHT, FRAMES, STEPS, CHUNK = 960, 720, 8, 4, 4
LOCAL_RATIO, GLOBAL_RATIO, HEADS = 0.6, 0.5, 8
PROMPT = "warm golden hour sunlight, photoreal"


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the device (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_shapes() -> list[tuple[str, int, int, int]]:
    """(level, batch, tokens, head dim) of the UNet self-attentions that go
    to K1 at 960x720: levels 0 and 1 merged (local chain + global bank),
    level 2 unmerged per frame (skv > 512)."""
    from tclight_torch.ops.tome import plan_local_levels

    lat_h, lat_w = HEIGHT // 8, WIDTH // 8
    out = []
    h, w = lat_h, lat_w
    for level, dim in enumerate((320, 640, 1280)):
        tnum = h * w
        if level < 2:  # merging is active up to downsample 2
            last = plan_local_levels(CHUNK, tnum, LOCAL_RATIO)[-1]
            local = last.unm_pre + (last.n_src - last.r) + last.n_dst_frames * tnum
            tokens = local + local - min(local, int(local * GLOBAL_RATIO))
            out.append((f"L{level}", 2, tokens, dim // HEADS))
        else:
            out.append((f"L{level}", 2 * CHUNK, tnum, dim // HEADS))
        h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    return out


def check_flash(gen: torch.Generator) -> dict:
    from tclight_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    rows = []
    for level, b, s, d in attention_shapes():
        q, k, v = (torch.randn(b, s, HEADS, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        # bf16 output rounding (2^-8 relative) plus bf16 p in the p.v product
        tol = 2e-2 * ref.abs().max().item()
        ok = math.isfinite(err) and err <= tol
        reps = 3 if s > 20000 else 10
        k_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, scale), reps)
        p_ms = cuda_ms(lambda: flash_attention_plain(q.float(), k.float(), v.float(), scale), 1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps)
        flops = 4.0 * b * HEADS * s * s * d
        b_ms, by = bound_ms(4 * q.numel() * 2, flops)
        row = dict(shape=f"{level} B={b} S={s} H={HEADS} D={d}", max_abs_err=err,
                   tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=b_ms, bound_by=by)
        phase("K1", ok=ok, **row)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at {row['shape']}")
        rows.append(row)
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return {"rows": rows}


def match_shapes() -> list[tuple[str, int, int, int, int]]:
    """(merge, B, S, D, C) at level 0: the local merge of a 4-frame chunk
    (3 src frames against 1 dst frame), the global merge against the bank,
    and the (2, 23760, 24576, 320) shape the TPU notes were tuned at."""
    tnum = (HEIGHT // 8) * (WIDTH // 8)
    from tclight_torch.ops.tome import plan_local_levels

    last = plan_local_levels(CHUNK, tnum, LOCAL_RATIO)[-1]
    local = last.unm_pre + (last.n_src - last.r) + last.n_dst_frames * tnum
    return [("global", 2, local, local, 320),
            ("local", 2, last.n_src, last.n_dst, 320),
            ("tpu-notes", 2, 23760, 24576, 320)]


def check_match(gen: torch.Generator) -> dict:
    from tclight_torch.ops.match_kernel import (online_argmax_scores_cuda,
                                                online_argmax_scores_plain)

    rows = []
    for name, b, s, d, c in match_shapes():
        # unit-norm rows, as the matcher's cosine metric gives it
        a = F.normalize(torch.randn(b, s, c, device="cuda", generator=gen), dim=-1).bfloat16()
        bt = F.normalize(torch.randn(b, d, c, device="cuda", generator=gen), dim=-1).bfloat16()
        m, i = online_argmax_scores_cuda(a, bt)
        torch.cuda.synchronize()
        mr, ir = online_argmax_scores_plain(a, bt)
        err = (m - mr).abs().max().item()
        # f32 sums of exact bf16 products in another order: ~1e-6; an index
        # may differ only where the best two scores are that close
        tol = 1e-4
        scores = torch.einsum("bsc,bdc->bsd", a.float(), bt.float())
        top2 = scores.transpose(0, 1).reshape(s, b * d).topk(2, dim=-1).values
        del scores
        clear = (top2[:, 0] - top2[:, 1]) > tol
        mismatch = int(((i != ir) & clear).sum().item())
        near_ties = int((~clear).sum().item())
        ok = math.isfinite(err) and err <= tol and mismatch == 0
        reps = 3
        k_ms = cuda_ms(lambda: online_argmax_scores_cuda(a, bt), reps)
        p_ms = cuda_ms(lambda: online_argmax_scores_plain(a, bt), 1)

        def library():
            sc = torch.bmm(a, bt.transpose(1, 2)).transpose(0, 1).reshape(s, b * d)
            return sc.max(dim=-1)

        l_ms = cuda_ms(library, reps)
        flops = 2.0 * b * s * d * c
        b_ms, by = bound_ms(2 * (a.numel() + bt.numel()) + 8 * s, flops)
        row = dict(shape=f"{name} B={b} S={s} D={d} C={c}", max_abs_err=err, tol=tol,
                   idx_mismatch=mismatch, near_ties=near_ties, ms=k_ms,
                   plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by)
        phase("K2", ok=ok, **row)
        if not ok:
            raise SystemExit(f"K2 disagrees with its plain version at {row['shape']}")
        rows.append(row)
        del a, bt, m, i, mr, ir, top2
        torch.cuda.empty_cache()
    return {"rows": rows}


def make_video(path: Path, frames: int = FRAMES, height: int = HEIGHT,
               width: int = WIDTH) -> None:
    """Rolling smooth texture (bench.py's synthetic video), saved as frames."""
    import cv2

    from tclight_torch.utils.video_io import save_frames

    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.uniform(0.15, 0.85, (height, width, 3)).astype(np.float32),
                            (0, 0), 3)
    save_frames(np.stack([np.roll(base, 2 * t, axis=1) for t in range(frames)]), path)


def check_small_reference() -> tuple[float, float]:
    """The pipeline on a small input, against a reference: the tiny IC-Light
    stack relights 8 frames of 32x32 through `Generator.__call__` three
    times, with the same weights and the same injected noise: on the CPU in
    f32 (the reference), on the CPU in bf16 (the plain versions), and on
    the card in bf16 (through both kernels). The merge ratios
    are 0, so every ToMe stage runs but no merge choice can flip between
    precisions. Returns the max abs difference of the output frames from
    the reference's, of the CPU bf16 run and of the device run."""
    from tclight_torch.config import ConfigDict
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_tiny_iclight

    n, size, steps = 8, 32, 2
    vid = OUT / "small" / "vid"
    make_video(vid, n, size, size)
    ref_models = build_tiny_iclight(num_inference_steps=steps, device="cpu")
    lat = size // 2 ** (len(ref_models.vae.config.block_out_channels) - 1)
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.standard_normal((1, lat, lat, 4), np.float32))
    init = init.repeat(n, 1, 1, 1)
    step_noises = [rng.standard_normal((n, lat, lat, 4), np.float32) for _ in range(steps)]
    weights = {name: getattr(ref_models, name).state_dict()
               for name in ("unet", "vae", "text_encoder")}
    outs = []
    for dev, dt in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                    ("cuda", torch.bfloat16)):
        cfg = ConfigDict({
            "work_dir": str(OUT / "small" / "wd"),
            "data": {"scene_type": "video", "rgb_path": str(vid), "height": size,
                     "width": size, "fps": 8},
            "generation": {"n_timesteps": steps, "chunk_size": 4, "chunk_ord": "mix-4",
                           "local_merge_ratio": 0.0, "global_merge_ratio": 0.0,
                           "prompt": {"small": PROMPT}, "save_frame": False},
            "post_opt": {"apply_opt": False}, "seed": 0})
        models = build_tiny_iclight(num_inference_steps=steps, dtype=dt,
                                    state_dicts=weights, device=dev)
        gen = Generator(models, cfg, data_parser=VideoDataParser(cfg.data), device=dev)
        outs.append(gen(None, OUT / "small" / f"out_{len(outs)}", list(range(n)),
                        init_noise=init, step_noises=step_noises)["small"])
    ref, plain, out = outs
    if out.shape != (n, size, size, 3) or not np.isfinite(out).all():
        raise SystemExit(f"small reference run: bad output {out.shape}")
    return float(np.abs(plain - ref).max()), float(np.abs(out - ref).max())


def run_main_path() -> dict:
    import cv2
    import yaml

    from tclight_torch.ops import kernels
    from tclight_torch.run import main

    vid = OUT / "vid"
    make_video(vid)
    work = OUT / "wd"
    args = ["--config", str(REPO / "configs" / "tclight_default.yaml"),
            "-i", str(vid), "-p", PROMPT,
            "--full-width-random", "post_opt.apply_opt=false",
            f"generation.n_timesteps={STEPS}", f"generation.chunk_size={CHUNK}",
            "generation.chunk_ord=mix-4", f"generation.frame_range=[0,{FRAMES},1]",
            f"data.height={HEIGHT}", f"data.width={WIDTH}",
            "generation.save_frame=false", f"work_dir={work}"]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: (v.launches, dict(v.shapes)) for k, v in kernels.STATS.items()}
    if rc != 0:
        raise SystemExit(f"main path exited {rc}")
    mp4s = sorted(work.rglob("output.mp4"))
    if len(mp4s) != 1:
        raise SystemExit(f"expected one output.mp4, found {mp4s}")
    cap = cv2.VideoCapture(str(mp4s[0]))
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape
    cap.release()
    cfg = yaml.safe_load((mp4s[0].parent / "config.yaml").read_text())
    st = cfg["stage_times"]
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    flash_dims = sorted(flash[1])
    merges = {"global" if s == d else "local" for s, d in match[1]}
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and flash[0] > 0
          and {40, 80, 160} <= set(flash_dims) and match[0] > 0
          and merges == {"global", "local"})
    phase("main", ok=ok, frames=n, frame_shape=shape, wall_s=wall,
          sampling_s=st["sampling"], step_s=st["step_times"], encode_s=st["encode"],
          decode_s=st["decode"], peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          flash_launches=flash[0], flash_head_dims=flash_dims,
          match_launches=match[0], match_merges=sorted(merges),
          match_shapes=sorted(match[1]))
    if not ok:
        raise SystemExit("main path check failed")
    profile_sampling(args)
    return {"flash_attention": flash[0], "online_argmax_scores": match[0]}


KERNEL_GROUPS = (("K1 flash_attention", ("flash_fwd_kernel",)),
                 ("K2 match_argmax", ("match_argmax_kernel",)),
                 ("convolution", ("conv", "fprop", "winograd")),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_sampling(args: list[str]) -> None:
    """A traced run of 2 sampling steps (torch.profiler) on the main path's
    config and inputs: device time per kernel group per step, the top
    kernels, and the device's busy share of the traced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tclight_torch.config import load_config
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_full_width_random

    steps = 2
    config = load_config([a for a in args if a != "--full-width-random"])
    config.set_path("generation.n_timesteps", steps)
    gen = Generator(build_full_width_random(num_inference_steps=steps), config,
                    data_parser=VideoDataParser(config.data))
    frames = gen.data_parser.load_video(frame_ids=list(range(FRAMES)))
    conds = gen.encode_imgs_batch(frames)
    cond, uncond = gen.encode_prompt_pair(PROMPT, gen.negative_prompt)
    x = gen.prepare_init_noise(FRAMES, HEIGHT, WIDTH,
                               torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.ddim_sample(x, (uncond, cond), conds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:70]))
    busy = sum(groups.values())
    if busy == 0:
        phase("profile", ok=True, note="the profiler saw no device time")
        return
    phase("profile", ok=True, steps=steps, traced_wall_ms=wall_ms, device_busy_ms=busy,
          busy_share=busy / wall_ms,
          ms_per_step={g: round(ms / steps, 3)
                       for g, ms in sorted(groups.items(), key=lambda x: -x[1])})
    for ms, count, key in sorted(kernels, reverse=True)[:10]:
        phase("profile-top", ms_per_step=round(ms / steps, 3), calls_per_step=count / steps,
              kernel=key)


def kernel_entry(name, source, replaces, launches, rows) -> dict:
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "per_shape": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from tclight_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32="off (plain f32 references run in full f32)")
    print(f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    phase("build", seconds=time.perf_counter() - t0, libs=sorted(kernels.SOURCES),
          arch="sm_90a")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(gen)
    match = check_match(gen)
    plain_err, dev_err = check_small_reference()
    # the CPU's bf16 run measures the error that bf16 weights and
    # activations give this stack; the card rounds its bf16 convolutions,
    # norms and kernels at other places, so it is allowed three times that
    tol = 3.0 * plain_err
    phase("reference", ok=dev_err <= tol, frames_max_abs_err=dev_err,
          cpu_bf16_max_abs_err=plain_err, tol=tol)
    if not dev_err <= tol:
        raise SystemExit("the card's small run disagrees with the f32 reference")
    launches = run_main_path()

    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", "tclight_torch/csrc/flash_attention.cu",
                     "tclight_tpu/ops/attention.py:135", launches["flash_attention"],
                     flash["rows"]),
        kernel_entry("online_argmax_scores", "tclight_torch/csrc/match_argmax.cu",
                     "tclight_tpu/ops/match_kernel.py:34",
                     launches["online_argmax_scores"], match["rows"]),
    ]}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
