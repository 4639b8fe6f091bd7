"""Evaluation CLI of the PyTorch port (counterpart of the root evaluate.py).

    python -m tclight_torch.evaluate --output_dir workdir [--flow_model raft \
        --flow_ckpt raft-things.pth] [--clip_ckpt DIR] [--pick_ckpt DIR] \
        [--lpips_ckpt DIR] [--eval_cost]

Walks an output dir (the Generator's per-prompt run folders) and writes
`result.txt` in the reference format (the warp errors' scaling rules).
The models run on the CUDA device in full f32 (the flow networks on
PyTorch's own convolution kernels, models/raft.py); `main(argv,
device="cpu")` runs them on the CPU (the tests do). Checkpoint
layouts: tclight_torch/eval/loaders.py.
Emits the full reference metric set when the checkpoint-gated models are
configured:

  warp-error-ssim        always (flows per --flow_model; reference uses RAFT)
  psnr / ssim            always (weight-free, edited vs source)
  clip-frame, clip-text  with --clip_ckpt (local CLIP ViT-B/32 dir)
  pick-score             with --pick_ckpt (local PickScore/CLIP-H dir)
  frame-lpips            with --lpips_ckpt (local VGG16 + lpips lin dir)
  z_* cost rows          with --eval_cost (from the saved run config)
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import yaml


def find_run_dirs(output_dir: Path):
    if (output_dir / "config.yaml").exists():
        return [output_dir]
    return sorted(
        p for p in output_dir.rglob("*") if p.is_dir() and (p / "config.yaml").exists()
    )


def evaluate_run(run_dir: Path, eval_cost: bool, clip_embed=None,
                 pick_embed=None, lpips_obj=None, flow=("farneback", None),
                 device="cuda", timings: dict | None = None) -> dict:
    """The run's scores; `timings`, when given, gathers the wall seconds of
    each metric group."""
    from tclight_torch.data.flow_backends import compute_flow_pairs
    from tclight_torch.eval.metrics import (
        clip_frame_score, clip_text_score, frame_lpips, pick_score, psnr,
        ssim_gaussian, warp_error_ssim)
    from tclight_torch.utils.video_io import load_video

    timings = {} if timings is None else timings
    clock = [time.perf_counter()]

    def lap(group: str) -> None:
        now = time.perf_counter()
        timings[group] = timings.get(group, 0.0) + now - clock[0]
        clock[0] = now

    cfg = yaml.safe_load((run_dir / "config.yaml").read_text()) or {}
    video_path = run_dir / (
        "output_opt.mp4" if (run_dir / "output_opt.mp4").exists() else "output.mp4"
    )
    source_path = run_dir / "output_gt.mp4"
    scores: dict = {}
    if not video_path.exists():
        return scores

    edited = load_video(video_path)
    source = load_video(source_path) if source_path.exists() else edited
    if source.shape[1:3] != edited.shape[1:3]:
        import cv2

        source = np.stack([
            cv2.resize(f, (edited.shape[2], edited.shape[1])) for f in source
        ])
    n = min(len(edited), len(source))
    edited, source = edited[:n], source[:n]
    lap("load")

    backend, flow_model = flow
    flow_fwd = compute_flow_pairs(source, "future", backend=backend,
                                  raft=flow_model)[:-1]
    flow_bwd = compute_flow_pairs(source, "past", backend=backend,
                                  raft=flow_model)[1:]
    lap("flows")
    scores["warp-error-ssim"] = warp_error_ssim(
        edited, source, flow_fwd=flow_fwd, flow_bwd=flow_bwd, device=device
    )
    lap("warp-error")
    # record the flow backend in result.txt: farneback-based warp-error is
    # not comparable to the reference's RAFT-based numbers
    scores["zz_flow_backend"] = backend
    scores["psnr"] = psnr(edited, source)
    scores["ssim"] = ssim_gaussian(edited, source)
    lap("psnr-ssim")

    prompts = (cfg.get("generation", {}) or {}).get("prompt", {}) or {}
    prompt = next(iter(prompts.values()), "") or ""

    if clip_embed is not None:
        embs, temb = clip_embed(edited, prompt)
        scores["clip-frame"] = clip_frame_score(embs)
        if prompt and temb is not None:
            try:
                scores["clip-text"] = clip_text_score(embs, temb)
            except Exception:
                # reference fallback: split long prompts by sentence
                parts = [p for p in prompt.split(".") if p.strip()]
                vals = [clip_text_score(embs, clip_embed(edited, p)[1])
                        for p in parts]
                scores["clip-text"] = float(np.mean(vals))
        lap("clip")

    if pick_embed is not None and prompt:
        embs, temb = pick_embed(edited, prompt)
        if temb is not None:
            scores["pick-score"] = pick_score(embs, temb)
        lap("pick-score")

    if lpips_obj is not None:
        scores["frame-lpips"] = frame_lpips(edited, source, lpips_obj)
        lap("frame-lpips")

    # record which checkpoint-gated metric groups did NOT run, so a
    # reference-vs-repo comparison can't silently mix metric sets
    skipped = [name for name, on in (
        ("clip", clip_embed is not None), ("pick-score", pick_embed is not None),
        ("frame-lpips", lpips_obj is not None)) if not on]
    if skipped:
        scores["zz_skipped_metrics"] = ",".join(skipped)

    if eval_cost:
        spf = cfg.get("sec_per_frame")
        if spf:
            scores["z_fps"] = 1.0 / spf
        scores["z_max_memory_allocated(M)"] = cfg.get("max_memory_allocated", 0.0)
        scores["z_resolution"] = float(np.sqrt(edited.shape[1] * edited.shape[2]))
        scores["z_total_frames"] = edited.shape[0]
        scores["z_total_time(s)"] = cfg.get("total_time", 0.0)
    return scores


def print_and_save_results(run_dir: Path, scores: dict) -> None:
    lines = [f"{run_dir.name}"]
    for metric, score in sorted(scores.items()):
        if isinstance(score, str):
            lines.append(f"{metric}: {score}")
        elif "warp-error-l1" in metric:
            lines.append(f"{metric}: {score * 1e5:.2f}")
        elif "warp-error-l2" in metric or "warp-error-ssim" in metric:
            lines.append(f"{metric}: {score * 100:.2f}")
        else:
            lines.append(f"{metric}: {score:.4f}")
    text = "\n".join(lines) + "\n"
    print(text)
    (run_dir / "result.txt").write_text(text)


def main(argv=None, device: str = "cuda", timings: dict | None = None) -> int:
    """`timings`, when given, gathers each metric group's wall seconds over
    the runs evaluated."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, default="workdir")
    parser.add_argument("--eval_cost", action="store_true")
    parser.add_argument("--clip_ckpt", type=str, default=None,
                        help="local CLIP ViT-B/32 checkpoint dir")
    parser.add_argument("--pick_ckpt", type=str, default=None,
                        help="local PickScore (CLIP-H) checkpoint dir")
    parser.add_argument("--lpips_ckpt", type=str, default=None,
                        help="local VGG16 + lpips lin-head checkpoint dir")
    parser.add_argument("--flow_model", type=str, default=None,
                        choices=["farneback", "raft", "memflow"],
                        help="flow backend for warp-error (reference: raft). "
                             "Default: raft when a checkpoint is found at "
                             "--flow_ckpt or a conventional path, else "
                             "farneback (loudly warned — numbers are then "
                             "NOT comparable to published TC-Light evals)")
    parser.add_argument("--flow_ckpt", type=str, default=None)
    args = parser.parse_args(argv)

    from tclight_torch.utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    with full_f32():  # the flow networks also turn cuDNN off for their calls
        return _evaluate(args, dev, timings)


def _evaluate(args, dev, timings: dict | None) -> int:
    from tclight_torch.eval import loaders

    t_models = time.perf_counter()
    clip_embed = (loaders.load_clip_embed(args.clip_ckpt, device=dev)
                  if args.clip_ckpt else None)
    pick_embed = (loaders.load_clip_embed(args.pick_ckpt, variant="h14", device=dev)
                  if args.pick_ckpt else None)
    lpips_obj = loaders.load_lpips(args.lpips_ckpt, device=dev) if args.lpips_ckpt else None

    flow_model, flow_ckpt = args.flow_model, args.flow_ckpt
    if flow_model is None:
        # reference warp-error-ssim is defined on RAFT flows
        # (utils/evaluation/eval_utils.py:178): auto-select RAFT when a
        # checkpoint is available, never silently default to farneback
        if flow_ckpt is None:
            conventional = [Path("models/raft/raft-things.pth"),
                            Path("models/raft/raft-things.safetensors")]
            flow_ckpt = next((str(p) for p in conventional if p.exists()), None)
        if flow_ckpt is not None:
            flow_model = "raft"
        else:
            flow_model = "farneback"
            print("[WARN] no RAFT checkpoint found (looked for --flow_ckpt "
                  "and models/raft/raft-things.pth): falling back to "
                  "farneback flow. warp-error numbers are NOT comparable "
                  "to published TC-Light (RAFT-based) evaluations.",
                  file=sys.stderr)
    flow = loaders.load_flow_backend(flow_model, flow_ckpt, device=dev)
    if timings is not None:
        timings["models"] = time.perf_counter() - t_models

    run_dirs = find_run_dirs(Path(args.output_dir))
    if not run_dirs:
        print(f"no runs under {args.output_dir}")
        return 1
    for run_dir in run_dirs:
        scores = evaluate_run(run_dir, args.eval_cost, clip_embed=clip_embed,
                              pick_embed=pick_embed, lpips_obj=lpips_obj,
                              flow=flow, device=dev, timings=timings)
        if scores:
            print_and_save_results(run_dir, scores)
    return 0


if __name__ == "__main__":
    sys.exit(main())
