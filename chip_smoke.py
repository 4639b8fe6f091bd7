"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card, its name and power limit (nvidia-smi); TF32 off for
     the plain f32 references;
  2. build: the port's CUDA kernels from tclight_torch/csrc with nvcc;
  3. K1 flash attention against its plain version at the UNet's
     self-attention shapes of a 960x720 run (levels 0, 1 and 2, and the
     30-frame yt pass's levels 0 and 1), beside SDPA, the byte and
     tensor-core bound and the exponentials' bound;
  4. K2 ToMe matcher against its plain version at the level-0 and level-1
     merge shapes (C = 320 and 640), beside bmm + max;
  5. K6 and K7, the int8 flash attentions (int8 q.k^T; K7 also int8 p.v),
     against their plain version on the same inputs at the xy shapes of
     phase 3 and at the yt pass's level-0 and level-1 shapes of a 30-frame
     960x720 run, beside K1 and SDPA at the same shapes and the
     quantization error against the fp attention; K6's pre-pass kernels,
     and K7's pre-pass kernels and max pass, against their plain versions
     at the same shapes;
  6. reference: the tiny stack end to end on a small input, post-
     optimization included (3 + 3 epochs), on the card in bf16 against the
     CPU in f32 (`check_small_reference`);
  7. the main path: `python -m tclight_torch.run` on the full-width random
     SD1.5 IC-Light stack, 8 frames of a synthetic rolling video at
     960x720, 4 DPM++ steps, then the post-optimization on Farneback flows
     (35 exposure + 70 UVT epochs); checks the mp4, that the path launched
     K1-K4, finite loss histories, the banded UVT route, and that the
     output's warp L1 under the known roll flow is below the same path's
     with the post-optimization off;
  8. K3 window warp (forward and adjoint) against its plain version at the
     post-opt batch (16, 720, 960, 3), with the main video's flows and with
     random flows, and on a (2, 160, 192, 3) batch with random flows of up
     to 100 px (each tile's halo, +- 102 px, covers the whole frame: the
     adjoint's sources span it); the adjoint also repeats bit for bit; K4
     banded gather against its plain version on the main path's UVT
     plans, both directions;
  9. K5: the K-window gather against its plain version on synthetic
     turnover-heavy track ids (K = 2 plans, both directions), and its own
     path: `run_uvt` on those ids, its launches counted by direction;
 10. yt-int8: `tclight_torch.run.main` on configs/examples/tclight_navsim.yaml's
     settings (alpha_t 0.4, 30 frames at 960x720, of the synthetic video)
     with generation.attn_qk_int8=true, 4 steps, post-optimization off:
     a 30-frame mp4, K6 (and its pre-pass kernels, once per K6 launch)
     launched at xy and at yt shapes, K1 never, K2 yes;
 11. int8 / int8pv: the 8-frame main config with the post-optimization
     off and attn_qk_int8 (then attn_pv_int8 too): K6 (then K7, with its
     pre-pass and max pass once a launch) launched, K1 never, and the frames against the fp run's (max abs difference,
     PSNR);
 12. traced runs of 2 sampling steps (fp, then int8 q.k^T), of one step
     of the yt-int8 config and of 2 + 2 post-opt epochs give the device
     time per kernel group (torch.profiler);
 13. one JSON line with every kernel's launches, error and times.
The last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero. Needs the repository around it and a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"  # videos and run outputs (ignored by git)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the special-function units' exp2 rate of the H100 SXM, as the
# FlashAttention-3 paper quotes it: a floor for the softmax's exponentials
PEAK_EXP2 = 3.9e12

WIDTH, HEIGHT, FRAMES, STEPS, CHUNK = 960, 720, 8, 4, 4
YT_FRAMES = 30  # configs/examples/tclight_navsim.yaml: frame_range [0, 30, 1]
POST_BATCH = 16  # the post-opt batch: the 8 frames padded to batch_size
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


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS
             ) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_once(fn) -> tuple[object, float]:
    """(fn(), its milliseconds on the device): one call between CUDA
    events, for the plain versions, which are slow and need no warm-up."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def merged_tokens(tnum: int) -> tuple[int, int]:
    """Tokens of a merged self-attention of a chunk of CHUNK frames of
    `tnum` tokens each: after the local merge chain alone (a plan's first
    slot), and with the global bank merged in (every later slot)."""
    from tclight_torch.ops.tome import plan_local_levels

    last = plan_local_levels(CHUNK, tnum, LOCAL_RATIO)[-1]
    local = last.unm_pre + (last.n_src - last.r) + last.n_dst_frames * tnum
    return local, local + local - min(local, int(local * GLOBAL_RATIO))


def attention_shapes(lat_h: int = HEIGHT // 8, lat_w: int = WIDTH // 8,
                     prefix: str = "") -> list[tuple[str, int, int, int]]:
    """(level, batch, tokens, head dim) of the UNet self-attentions that go
    to the flash kernels (skv > 512) for latent images of lat_h x lat_w:
    levels 0 and 1 merged (local chain + global bank), level 2 unmerged per
    frame. The xy pass of a 960x720 run has 90 x 120 latent images; its yt
    pass has (frames x 90) ones, one per latent column."""
    out = []
    h, w = lat_h, lat_w
    for level, dim in enumerate((320, 640, 1280)):
        tnum = h * w
        if level < 2:  # merging is active up to downsample 2
            out.append((f"{prefix}L{level}", 2, merged_tokens(tnum)[1], dim // HEADS))
        elif tnum > 512:
            out.append((f"{prefix}L{level}", 2 * CHUNK, tnum, dim // HEADS))
        h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    return out


def check_flash(gen: torch.Generator) -> dict:
    from tclight_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    rows = []
    for level, b, s, d in attention_shapes() + attention_shapes(YT_FRAMES, HEIGHT // 8, "yt-"):
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
        # one exponential per score: the softmax's floor on the special-
        # function units, beside the tensor-core and byte bound
        exp_ms = b * HEADS * s * s / PEAK_EXP2 * 1e3
        row = dict(shape=f"{level} B={b} S={s} H={HEADS} D={d}", max_abs_err=err,
                   tol=tol, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=b_ms, bound_by=by, exp_bound_ms=exp_ms)
        phase("K1", ok=ok, **row)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at {row['shape']}")
        rows.append(row)
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return {"rows": rows}


def check_int8(gen: torch.Generator, pv_int8: bool) -> dict:
    """K6 (pv_int8 False) or K7 against the plain int8 version on the same
    bf16 inputs, at the xy shapes and the 30-frame yt pass's shapes. `ms`
    is the wrapper's (the quantization pre-pass and the kernel; for K7 its
    max pass too), `prepass_ms` the pre-pass kernels alone, with the plain
    pre-pass's time beside it (`prepass_plain_ms`); for K7 also
    `maxpass_ms`, its max pass alone, beside its plain version's
    (`maxpass_plain_ms`). Beside them K1 and SDPA at the same shape (the
    library has no call for the quantized function), and the quantization
    error of the plain version against the fp attention. Also the rows of
    the pre-pass kernels against the plain pre-pass, in the kernel's
    operand layout (`prepass_rows`), and for K7 those of the max pass
    against its plain version (`maxpass_rows`)."""
    from tclight_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_int8_cuda,
                                             flash_attention_int8_plain,
                                             flash_attention_plain, int8_block_rowmax,
                                             int8pv_operands, int8pv_operands_plain,
                                             qk_int8_operands, qk_int8_operands_plain)

    tag = "K7" if pv_int8 else "K6"
    operands, operands_plain = ((int8pv_operands, int8pv_operands_plain) if pv_int8
                                else (qk_int8_operands, qk_int8_operands_plain))
    rows, prepass_rows, maxpass_rows = [], [], []
    shapes = attention_shapes() + attention_shapes(YT_FRAMES, HEIGHT // 8, "yt-")
    for level, b, s, d in shapes:
        q, k, v = (torch.randn(b, s, HEADS, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention_int8_cuda(q, k, v, scale, pv_int8)
        torch.cuda.synchronize()
        ref, p_ms = timed_once(lambda: flash_attention_int8_plain(q, k, v, scale, pv_int8))
        ref = ref.float()
        fp = flash_attention_plain(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        # bf16 output rounding and exp2 rounding, as K1; K6 also takes p in
        # bf16 for p.v, and a K7 p8 at a rounding tie moves by one step
        # (1/127 of its block's max)
        tol = 2e-2 * ref.abs().max().item()
        quant_err = (ref - fp).abs().max().item() / fp.abs().max().item()
        kernel_fp_err = (out.float() - fp).abs().max().item() / fp.abs().max().item()
        ok = math.isfinite(err) and err <= tol
        reps = 3 if s > 20000 else 10
        k_ms = cuda_ms(lambda: flash_attention_int8_cuda(q, k, v, scale, pv_int8), reps)
        plain_pre_ms = cuda_ms(lambda: operands_plain(q, k, v), reps)
        pre_ms = cuda_ms(lambda: operands(q, k, v), reps)
        prepass_rows.append(check_prepass(tag, level, q, k, v, operands, operands_plain,
                                          pre_ms))
        extra = {}
        if pv_int8:
            maxpass_rows.append(check_maxpass(level, q, k, v, scale, reps))
            extra = {"maxpass_ms": maxpass_rows[-1]["ms"],
                     "maxpass_plain_ms": maxpass_rows[-1]["plain_ms"]}
        k1_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, scale), reps)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps)
        # the kernel's operands cross memory once: q8, k8 (head dim padded
        # to 32) and v8 (to 16) or v in bf16, the scales, the bf16 output;
        # q.k^T at the int8 peak, p.v at the int8 (K7) or bf16 (K6) peak
        dk, dv, bh = -(-d // 32) * 32, -(-d // 16) * 16, b * HEADS
        n_bytes = (bh * s * dk * 2 + (bh * s * dv if pv_int8 else 2 * v.numel())
                   + 2 * q.numel() + 4 * bh * (s + -(-s // 1024) + (dv if pv_int8 else 0)))
        prod = 2.0 * bh * s * s * d
        t_ops = (prod / PEAK_INT8_OPS + prod / (PEAK_INT8_OPS if pv_int8 else PEAK_BF16_FLOPS)) * 1e3
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        row = dict(shape=f"{level} B={b} S={s} H={HEADS} D={d}", max_abs_err=err, tol=tol,
                   quant_rel_err_plain_vs_fp=quant_err, rel_err_kernel_vs_fp=kernel_fp_err,
                   ms=k_ms, prepass_ms=pre_ms, prepass_plain_ms=plain_pre_ms, **extra,
                   plain_ms=p_ms, library_ms=None, k1_ms=k1_ms, sdpa_ms=sdpa_ms, bound_ms=b_ms,
                   bound_by=by)
        phase(tag, ok=ok, **row)
        if not ok:
            raise SystemExit(f"{tag} disagrees with its plain version at {row['shape']}")
        rows.append(row)
        del q, k, v, out, ref, fp, qt, kt, vt
        torch.cuda.empty_cache()
    return {"rows": rows, "prepass_rows": prepass_rows, "maxpass_rows": maxpass_rows}


def check_prepass(tag: str, level: str, q, k, v, kernel, plain, k_ms: float) -> dict:
    """K6's (or K7's) pre-pass kernels against the plain pre-pass in the
    kernel's layout: q8, the Q scales and the v copy (K7: v8, the V scales
    and q8's bf16 copy) bit-equal; k8 within 1 and the K scales within a bf16 step,
    where K's token mean (an f32 sum in another order) rounds to another
    bf16 value (`max_abs_err` is k8's largest difference, `k8_differ` the
    share of k8 values that differ). Bound: q, k and v read once, the
    operands written once."""
    ops = kernel(q, k, v)
    torch.cuda.synchronize()
    ref, p_ms = timed_once(lambda: plain(q, k, v))
    exact_names = ("q8", "sq", "v8", "sv", "qb") if tag == "K7" else ("q8", "sq", "v")
    exact = all(torch.equal(ops[n], ref[n]) for n in exact_names)
    dk8 = (ops["k8"].int() - ref["k8"].int()).abs()
    sk_ok = bool(((ops["sk"] - ref["sk"]).abs() <= ref["sk"] * 2.0 ** -7).all())
    err, share = float(dk8.max().item()), float((dk8 > 0).float().mean().item())
    ok = exact and err <= 1 and share <= 0.01 and sk_ok
    # K7's bf16 copies qb / kb serve only its max pass's design: the
    # function's bound leaves them out
    n_bytes = 2 * 3 * q.numel() + sum(ops[n].numel() * ops[n].element_size()
                                      for n in ("k8", "sk") + exact_names if n != "qb")
    b_ms, by = bound_ms(n_bytes, 0.0)
    b, s, h, d = q.shape
    row = dict(shape=f"{level} B={b} S={s} H={h} D={d}", max_abs_err=err, tol=1.0,
               k8_differ=share, exact=f"{'/'.join(exact_names)} {exact}", ms=k_ms,
               plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=by)
    phase(f"{tag}-prepass", ok=ok, **row)
    if not ok:
        raise SystemExit(f"{tag}'s pre-pass disagrees with the plain pre-pass at {row['shape']}")
    return row


def check_maxpass(level: str, q, k, v, scale: float, reps: int) -> dict:
    """K7's max pass against its plain version on the same operands (the
    pre-pass kernels'): exact dots times the same two f32 scales, so equal
    but for f32 rounding (held at 1e-6 relative). Bound: that of the
    function, an int8 q.k^T times scales and a max: the larger of q8, k8
    and their scales read once with the block maxes written once, and
    q.k^T at the int8 peak (the kernel runs it on bf16 copies, which the
    bound does not price)."""
    from tclight_torch.ops.attention import int8_block_rowmax, int8_block_rowmax_plain, int8pv_operands

    b, s, h, d = q.shape
    ops = int8pv_operands(q, k, v)
    bm = int8_block_rowmax(ops, b, h, s, s, d, scale)
    torch.cuda.synchronize()
    ref, p_ms = timed_once(lambda: int8_block_rowmax_plain(ops, s, s, scale))
    err = float(((bm - ref).abs() / ref.abs().clamp(min=1e-30)).max().item())
    ok = bool(torch.isfinite(bm).all()) and err <= 1e-6
    k_ms = cuda_ms(lambda: int8_block_rowmax(ops, b, h, s, s, d, scale), reps)
    n_bytes = sum(ops[n].numel() * ops[n].element_size() for n in ("q8", "k8", "sq", "sk")) \
        + bm.numel() * 4
    b_ms, by = bound_ms(n_bytes, 2.0 * b * h * s * s * d, PEAK_INT8_OPS)
    row = dict(shape=f"{level} B={b} S={s} H={h} D={d}", max_abs_err=err, tol=1e-6,
               err_is="relative", n_kb=bm.shape[-1], ms=k_ms, plain_ms=p_ms, library_ms=None,
               bound_ms=b_ms, bound_by=by)
    phase("K7-maxpass", ok=ok, **row)
    if not ok:
        raise SystemExit(f"K7's max pass disagrees with its plain version at {row['shape']}")
    del ops, bm, ref
    return row


def match_shapes() -> list[tuple[str, int, int, int, int]]:
    """(merge, B, S, D, C) at levels 0 and 1 (C = 320 and 640): the global
    merge against the bank and the local merge of a 4-frame chunk (3 src
    frames against 1 dst frame); and the (2, 23760, 24576, 320) shape the
    TPU notes were tuned at."""
    from tclight_torch.ops.tome import plan_local_levels

    out = []
    tnum = (HEIGHT // 8) * (WIDTH // 8)
    for level, c in ((0, 320), (1, 640)):
        last = plan_local_levels(CHUNK, tnum, LOCAL_RATIO)[-1]
        local = last.unm_pre + (last.n_src - last.r) + last.n_dst_frames * tnum
        out += [(f"global L{level}", 2, local, local, c),
                (f"local L{level}", 2, last.n_src, last.n_dst, c)]
        tnum = ((HEIGHT // 8 - 2) // 2 + 1) * ((WIDTH // 8 - 2) // 2 + 1)
    return out + [("tpu-notes", 2, 23760, 24576, 320)]


def check_match(gen: torch.Generator) -> dict:
    from tclight_torch.ops.match_kernel import (match_plan, online_argmax_scores_cuda,
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
        plan = match_plan(b, s, d, c, torch.cuda.get_device_properties(0).multi_processor_count)
        row = dict(shape=f"{name} B={b} S={s} D={d} C={c}", max_abs_err=err, tol=tol,
                   idx_mismatch=mismatch, near_ties=near_ties, ms=k_ms,
                   plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by,
                   src_rows=plan["src_rows"], chunks=plan["chunks"], units=plan["units"])
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


SMALL_POSTOPT = {"apply_opt": True, "epochs_exposure": 3, "epochs": 3, "batch_size": 4,
                 "ms_ssim_levels": 2}


def check_small_reference() -> tuple[float, float]:
    """The pipeline on a small input, against a reference: the tiny IC-Light
    stack relights 8 frames of 32x32 through `Generator.__call__`, the
    post-optimization included (3 + 3 epochs on Farneback flows), three
    times, with the same weights and the same injected noise: on the CPU in
    f32 (the reference), on the CPU in bf16 (the plain versions, gather
    warps and the dense palette route), and on the card in bf16 (K1-K4:
    window warps and the banded route). The merge ratios are 0, so every
    ToMe stage runs but no merge choice can flip between precisions.
    Returns the max abs difference of the output frames from the
    reference's, of the CPU bf16 run and of the device run."""
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
                     "width": size, "fps": 8, "flow_model": "farneback"},
            "generation": {"n_timesteps": steps, "chunk_size": 4, "chunk_ord": "mix-4",
                           "local_merge_ratio": 0.0, "global_merge_ratio": 0.0,
                           "prompt": {"small": PROMPT}, "save_frame": False},
            "post_opt": dict(SMALL_POSTOPT), "seed": 0})
        models = build_tiny_iclight(num_inference_steps=steps, dtype=dt,
                                    state_dicts=weights, device=dev)
        gen = Generator(models, cfg, data_parser=VideoDataParser(cfg.data), device=dev)
        outs.append(gen(None, OUT / "small" / f"out_{len(outs)}", list(range(n)),
                        init_noise=init, step_noises=step_noises)["small"])
        if not all(np.isfinite(h).all() and h.size for h in gen.last_postopt_losses.values()):
            raise SystemExit(f"small reference run on {dev}: bad loss histories")
    ref, plain, out = outs
    if out.shape != (n, size, size, 3) or not np.isfinite(out).all():
        raise SystemExit(f"small reference run: bad output {out.shape}")
    return float(np.abs(plain - ref).max()), float(np.abs(out - ref).max())


def warp_l1(frames_dir: Path) -> float:
    """Warp consistency under the video's known flow (a roll of 2 px per
    frame), as tests/test_golden_regression.py measures it: fully static
    content would give 0."""
    import cv2

    files = sorted(frames_dir.glob("*.png"))
    out = np.stack([cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in files])
    out = out.astype(np.float32) / 255.0
    rolled = np.stack([np.roll(out[t], 2, axis=1) for t in range(len(out) - 1)])
    return float(np.abs(rolled - out[1:]).mean())


def main_args(work: Path, apply_opt: bool) -> list[str]:
    return ["--config", str(REPO / "configs" / "tclight_default.yaml"),
            "-i", str(OUT / "vid"), "-p", PROMPT, "--full-width-random",
            f"post_opt.apply_opt={str(apply_opt).lower()}", "data.flow_model=farneback",
            f"generation.n_timesteps={STEPS}", f"generation.chunk_size={CHUNK}",
            "generation.chunk_ord=mix-4", f"generation.frame_range=[0,{FRAMES},1]",
            f"data.height={HEIGHT}", f"data.width={WIDTH}",
            "generation.save_frame=true", f"work_dir={work}"]


def read_mp4(path: Path) -> tuple[int, tuple | None]:
    import cv2

    cap = cv2.VideoCapture(str(path))
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape
    cap.release()
    return n, shape


def run_main_path() -> dict:
    import yaml

    from tclight_torch.ops import kernels
    from tclight_torch.pipeline import postopt
    from tclight_torch.run import main

    make_video(OUT / "vid")
    work = OUT / "wd"
    args = main_args(work, True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: (v.launches, dict(v.shapes)) for k, v in kernels.STATS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if rc != 0:
        raise SystemExit(f"main path exited {rc}")
    mp4s = sorted(work.rglob("output.mp4"))
    if len(mp4s) != 1:
        raise SystemExit(f"expected one output.mp4, found {mp4s}")
    out_dir = mp4s[0].parent
    n, shape = read_mp4(mp4s[0])
    cfg = yaml.safe_load((out_dir / "config.yaml").read_text())
    st = cfg["stage_times"]
    losses = {k: np.load(out_dir / f"loss_{k}.npy") for k in ("exposure", "unique_tensor")}
    cached = postopt._UVT_TABLE_CACHE.get("slot")
    route = ("banded" if cached is not None and len(cached[1]) == 10 else "dense/sorted")
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    warp, band = stats["window_warp"], stats["banded_gather"]
    flash_dims = sorted(flash[1])
    # K4's launches by direction: the render's plans and the adjoint's
    # have their own windows (the last item of the shape key)
    wf, wb = postopt._banded_windows(HEIGHT * WIDTH, postopt._UVT_TABLE_CACHE["slot"][0][4])
    directions = {name: sum(n for key, n in band[1].items() if key[-1] == w)
                  for name, w in (("render", wf), ("adjoint", wb))}
    merges = {"global" if s == d else "local" for s, d, _ in match[1]}
    warp_on = warp_l1(out_dir / "frames")

    # the same path with the post-optimization off, for the warp L1
    work_off = OUT / "wd_off"
    if main(main_args(work_off, False)) != 0:
        raise SystemExit("main path with apply_opt=false failed")
    warp_off = warp_l1(next(work_off.rglob("output.mp4")).parent / "frames")

    finite = all(h.size and np.isfinite(h).all() for h in losses.values())
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and flash[0] > 0
          and {40, 80, 160} <= set(flash_dims) and match[0] > 0
          and merges == {"global", "local"} and warp[0] > 0 and band[0] > 0
          and wf != wb and directions["render"] > 0 and directions["adjoint"] > 0
          and finite and route == "banded" and warp_on < warp_off)
    steady = lambda xs: float(np.mean(xs[1:])) if len(xs) > 1 else float("nan")
    phase("main", ok=ok, frames=n, frame_shape=shape, wall_s=wall,
          sampling_s=st["sampling"], step_s=st["step_times"], encode_s=st["encode"],
          decode_s=st["decode"], flow_data_s=st["flow_data"],
          exposure_s=st["exposure"], exposure_epochs=len(st["exposure_epochs"]),
          exposure_epoch_first_s=st["exposure_epochs"][0],
          exposure_epoch_steady_s=steady(st["exposure_epochs"]),
          uvt_s=st["uvt"], uvt_epochs=len(st["uvt_epochs"]),
          uvt_epoch_first_s=st["uvt_epochs"][0], uvt_epoch_steady_s=steady(st["uvt_epochs"]),
          output_save_s=st["output_save"], peak_mem_gb=peak,
          flash_launches=flash[0], flash_head_dims=flash_dims,
          match_launches=match[0], match_merges=sorted(merges),
          match_shapes=sorted(match[1].items()),
          warp_launches=warp[0], warp_shapes=sorted(warp[1].items()),
          banded_launches=band[0], banded_directions=directions,
          banded_multi_launches=stats["banded_gather_multi"][0],
          uvt_route=route, exposure_loss=[float(losses["exposure"][0]),
                                          float(losses["exposure"][-1])],
          uvt_loss=[float(losses["unique_tensor"][0]), float(losses["unique_tensor"][-1])],
          warp_l1_postopt=warp_on, warp_l1_no_postopt=warp_off)
    if not ok:
        raise SystemExit("main path check failed")
    return {"flash_attention": flash[0], "online_argmax_scores": match[0],
            "window_warp": warp[0], "banded_gather": band[0],
            "banded_gather:render": directions["render"],
            "banded_gather:adjoint": directions["adjoint"]}


def read_frames(frames_dir: Path) -> np.ndarray:
    """The run's saved PNG frames, (N, H, W, 3) in [0, 1]."""
    import cv2

    files = sorted(frames_dir.glob("*.png"))
    out = np.stack([cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in files])
    return out.astype(np.float32) / 255.0


def run_yt_int8() -> dict:
    """The yt pass with int8 attention: configs/examples/tclight_navsim.yaml
    (alpha_t 0.4, 30 frames at 960x720) on a 30-frame synthetic video, with
    attn_qk_int8, 4 steps and the post-optimization off. The launch counts
    are set to 0 just before and read just after."""
    import yaml

    from tclight_torch.ops import kernels
    from tclight_torch.run import main

    make_video(OUT / "vid30", YT_FRAMES)
    work = OUT / "wd_yt"
    args = ["--config", str(REPO / "configs" / "examples" / "tclight_navsim.yaml"),
            "-i", str(OUT / "vid30"), "--full-width-random", "post_opt.apply_opt=false",
            "generation.attn_qk_int8=true", f"generation.n_timesteps={STEPS}",
            "generation.save_frame=true", f"work_dir={work}"]
    kernels.reset_stats()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: (v.launches, dict(v.shapes)) for k, v in kernels.STATS.items()}
    if rc != 0:
        raise SystemExit(f"yt-int8 run exited {rc}")
    mp4s = sorted(work.rglob("output.mp4"))
    if len(mp4s) != 1:
        raise SystemExit(f"expected one output.mp4, found {mp4s}")
    n, shape = read_mp4(mp4s[0])
    cfg = yaml.safe_load((mp4s[0].parent / "config.yaml").read_text())
    frames = read_frames(mp4s[0].parent / "frames")
    k6, k7 = stats["flash_attention_int8"], stats["flash_attention_int8pv"]
    pre = stats["flash_attention_int8_prepass"]
    sq_seen = {key[0] for key in k6[1]}
    xy_l0 = set(merged_tokens((HEIGHT // 8) * (WIDTH // 8)))
    yt_l0 = set(merged_tokens(YT_FRAMES * (HEIGHT // 8)))
    ok = (n == YT_FRAMES and shape == (HEIGHT, WIDTH, 3) and cfg["generation"]["alpha_t"] > 0
          and k6[0] > 0 and bool(sq_seen & xy_l0) and bool(sq_seen & yt_l0)
          and stats["flash_attention"][0] == 0 and k7[0] == 0 and pre[0] == k6[0]
          and stats["online_argmax_scores"][0] > 0
          and frames.shape == (YT_FRAMES, HEIGHT, WIDTH, 3) and float(frames.std()) > 0)
    st = cfg["stage_times"]
    phase("yt-int8", ok=ok, frames=n, frame_shape=shape, alpha_t=cfg["generation"]["alpha_t"],
          wall_s=wall, sampling_s=st["sampling"], step_s=st["step_times"],
          encode_s=st["encode"], decode_s=st["decode"], k6_launches=k6[0],
          k6_xy_l0=sorted(sq_seen & xy_l0), k6_yt_l0=sorted(sq_seen & yt_l0),
          k6_shapes=sorted(k6[1].items()), k6_prepass_launches=pre[0],
          k1_launches=stats["flash_attention"][0],
          k2_launches=stats["online_argmax_scores"][0],
          k2_shapes=sorted(stats["online_argmax_scores"][1].items()))
    if not ok:
        raise SystemExit("yt-int8 run check failed")
    return {"flash_attention_int8": k6[0], "flash_attention_int8_prepass": pre[0]}


def run_int8_variants() -> dict:
    """The 8-frame main config with the post-optimization off, with int8
    q.k^T (K6), then with int8 q.k^T and p.v (K7); each frame set against
    the fp run's (`wd_off` of the main path: same seed, same noise). The
    launch counts are set to 0 before each run and read after it."""
    import yaml

    from tclight_torch.ops import kernels
    from tclight_torch.run import main

    fp_frames = read_frames(next((OUT / "wd_off").rglob("output.mp4")).parent / "frames")
    launches = {}
    for tag, flags, name in (("int8", ["generation.attn_qk_int8=true"], "flash_attention_int8"),
                             ("int8pv", ["generation.attn_qk_int8=true",
                                         "generation.attn_pv_int8=true"],
                              "flash_attention_int8pv")):
        work = OUT / f"wd_{tag}"
        kernels.reset_stats()
        t0 = time.perf_counter()
        rc = main(main_args(work, False) + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {k: v.launches for k, v in kernels.STATS.items()}
        if rc != 0:
            raise SystemExit(f"{tag} run exited {rc}")
        out_dir = next(work.rglob("output.mp4")).parent
        n, _ = read_mp4(out_dir / "output.mp4")
        frames = read_frames(out_dir / "frames")
        st = yaml.safe_load((out_dir / "config.yaml").read_text())["stage_times"]
        diff = np.abs(frames - fp_frames)
        psnr = 10 * math.log10(1.0 / max(float((diff ** 2).mean()), 1e-12))
        others = [k for k in ("flash_attention", "flash_attention_int8", "flash_attention_int8pv")
                  if k != name]
        # K7 runs its pre-pass kernels and its max pass once a launch
        parts = ([f"{name}_prepass", f"{name}_maxpass"] if tag == "int8pv"
                 else [f"{name}_prepass"])
        ok = (n == FRAMES and stats[name] > 0 and all(stats[k] == 0 for k in others)
              and all(stats[k] == stats[name] for k in parts)
              and frames.shape == fp_frames.shape and float(frames.std()) > 0)
        steady = float(np.mean(st["step_times"][1:]))
        phase(tag, ok=ok, frames=n, wall_s=wall, step_s=st["step_times"],
              step_steady_s=steady, launches=stats[name],
              part_launches={k: stats[k] for k in parts},
              other_flash_launches={k: stats[k] for k in others},
              frames_max_abs_diff_vs_fp=float(diff.max()),
              frames_mean_abs_diff_vs_fp=float(diff.mean()), psnr_vs_fp_db=psnr,
              note="frames are the saved 8-bit PNGs of both runs")
        if not ok:
            raise SystemExit(f"{tag} run check failed")
        launches[name] = stats[name]
        launches.update({k: stats[k] for k in parts})
    return launches


def post_batch() -> np.ndarray:
    """Frame indices of the main path's post-opt batch: its 8 frames, padded
    to the batch size with frame 0 as the epochs pad them."""
    return np.array(list(range(FRAMES)) + [0] * (POST_BATCH - FRAMES))


def check_warp(gen: torch.Generator) -> dict:
    from tclight_torch.ops.warp_kernel import window_warp_cuda, window_warp_plain
    from tclight_torch.pipeline.postopt import flow_radius

    cache = OUT / "vid_past_flow_farneback"
    past = np.stack([np.load(cache / f"{i:05d}.npy") for i in range(FRAMES)])
    radius = flow_radius(past)
    if radius is None:
        raise SystemExit("the main video's flows exceed the window-warp cap")
    shape = (POST_BATCH, HEIGHT, WIDTH)
    x = torch.rand(*shape, 3, device="cuda", generator=gen)
    wide = (2, 160, 192)
    x_wide = torch.rand(*wide, 3, device="cuda", generator=gen)
    cases = (("farneback", x, torch.from_numpy(past[post_batch()]).cuda(), radius),
             ("random", x, (torch.rand(*shape, 2, device="cuda", generator=gen) * 2 - 1) * 24, 24),
             ("wide", x_wide, (torch.rand(*wide, 2, device="cuda", generator=gen) * 2 - 1) * 100,
              100))
    rows = []
    for label, x, f, r in cases:
        n, height, width, _ = x.shape
        xt = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
        grid = torch.stack([2 * (torch.arange(width, device="cuda") + f[..., 0]) / (width - 1) - 1,
                            2 * (torch.arange(height, device="cuda")[:, None] + f[..., 1])
                            / (height - 1) - 1], dim=-1)
        lib_out = F.grid_sample(xt, grid, mode="bicubic", padding_mode="zeros",
                                align_corners=True)
        g = torch.randn_like(lib_out)
        for adjoint in (False, True):
            out = window_warp_cuda(x, f, r, adjoint=adjoint)
            torch.cuda.synchronize()
            ref, p_ms = timed_once(lambda: window_warp_plain(x, f, r, adjoint=adjoint))
            err = (out - ref).abs().max().item()
            # the same f32 taps summed in another order, with fused
            # multiply-adds: ~1e-6 of values of order 1 per window
            tol = 1e-5 * (2 * r + 5)
            # the adjoint's fixed-point sums do not depend on the order of
            # its adds: a second run gives the same bits
            repeats = not adjoint or torch.equal(out, window_warp_cuda(x, f, r, adjoint=True))
            ok = math.isfinite(err) and err <= tol and repeats
            k_ms = cuda_ms(lambda: window_warp_cuda(x, f, r, adjoint=adjoint), 5)
            if adjoint:
                l_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, xt, g, retain_graph=True), 5)
            else:
                l_ms = cuda_ms(lambda: F.grid_sample(xt, grid, mode="bicubic",
                                                     padding_mode="zeros",
                                                     align_corners=True), 5)
            n_px = x.numel() // 3
            # x, flows and out cross memory once; 16 taps carry weight per
            # (source or output) pixel: 3 multiply-adds and 2 weights each
            b_ms, by = bound_ms(4 * (x.numel() + f.numel() + out.numel()),
                                n_px * 16 * (2 * 3 + 2 * 10), PEAK_F32_FLOPS)
            row = dict(shape=f"{'adjoint' if adjoint else 'forward'} {label} "
                       f"N={n} {height}x{width}x3 radius={r}",
                       max_abs_err=err, tol=tol, repeats=repeats, ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=by)
            phase("K3", ok=ok, **row)
            if not ok:
                raise SystemExit(f"K3 disagrees with its plain version at {row['shape']}")
            rows.append(row)
            del out, ref
        del xt, grid, lib_out, g
        torch.cuda.empty_cache()
    return {"rows": rows}


def _banded_rows(tag: str, gen, tables, hw: int, p_pad: int, batch: np.ndarray) -> list:
    """Both gather directions of a UVT batch through the kernel (K4 for
    single-window plans, K5 for K-window ones) against the plain versions,
    on the planner's real plans."""
    from tclight_torch.ops import banded_gather as bg
    from tclight_torch.pipeline.postopt import _banded_windows

    multi = tables[1].dim() == 3
    kern = bg.banded_gather_multi_cuda if multi else bg.banded_gather_cuda
    plain = ((lambda t, s_, o, w: bg.banded_gather_plain_multi(t, s_, o, w)) if multi
             else (lambda t, s_, o, w: bg.banded_gather_plain(t, s_, o)))
    idx = torch.from_numpy(batch).cuda()
    b = len(batch)
    wf, wb = _banded_windows(hw, p_pad)
    base = torch.arange(b, dtype=torch.int32, device="cuda") * (bg.frame_tiles(hw) * 128)
    fst, foff, bst, boff = (tables[i][idx] for i in (1, 2, 6, 7))
    k = fst.shape[-1] if multi else 1
    feats = torch.randn(p_pad, 3, device="cuda", generator=gen)
    cot = bg.pack_frames(torch.randn(b, hw, 3, device="cuda", generator=gen))
    bst = bst + (base[:, None, None] if multi else base[:, None])
    cases = (("render", feats, fst.reshape(-1, k) if multi else fst.reshape(-1),
              foff.reshape(-1, 512), wf),
             ("adjoint", cot, bst.reshape(-1, k) if multi else bst.reshape(-1),
              boff.reshape(-1, 512), wb))
    rows = []
    for label, table, starts, offs, window in cases:
        starts, offs = starts.contiguous(), offs.contiguous()
        out = kern(table, starts, offs, window)
        torch.cuda.synchronize()
        ref, p_ms = timed_once(lambda: plain(table, starts, offs, window))
        err = (out - ref).abs().max().item()
        ok = err == 0.0  # a gather: exact
        k_ms = cuda_ms(lambda: kern(table, starts, offs, window), 10)
        if multi:
            o = offs.long().clamp(min=0)
            kk = o // window
            lib_idx = torch.take_along_dim(starts.long(), kk, 1) + o - kk * window
        else:
            lib_idx = starts[:, None].long() + offs.long()
        l_ms = cuda_ms(lambda: table[lib_idx], 10)
        # the output written once, the plan read once, and each table row
        # that a live entry selects read once
        rows_read = torch.unique(lib_idx[offs >= 0]).numel()
        b_ms, by = bound_ms(4 * out.numel() + offs.numel() * offs.element_size()
                            + starts.numel() * 4 + rows_read * table.shape[1] * 4, 0.0)
        # both kernels read each selected row straight from the table (a
        # staged K5 measured slower, csrc/banded_gather.cu)
        row = dict(shape=f"{label} B={b} hw={hw} p_pad={p_pad} NB={offs.shape[0]} "
                   f"window={window} K={k} offs={str(offs.dtype)[6:]}", body="direct gather",
                   live_entries=int((offs >= 0).sum().item()), rows_read=rows_read,
                   max_abs_err=err, tol=0.0, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=b_ms, bound_by=by)
        phase(tag, ok=ok, **row)
        if not ok:
            raise SystemExit(f"{tag} disagrees with its plain version at {row['shape']}")
        rows.append(row)
        del out, ref, lib_idx
    return rows


def check_banded(gen: torch.Generator) -> dict:
    from tclight_torch.pipeline import postopt

    key, tables, _ = postopt._UVT_TABLE_CACHE["slot"]
    if len(tables) != 10 or tables[1].dim() != 2:
        raise SystemExit("the main path's UVT tables are not single-window banded plans")
    return {"rows": _banded_rows("K4", gen, tables, HEIGHT * WIDTH, key[4], post_batch())}


def turnover_ids(n: int, h: int, w: int, bands: int = 2) -> np.ndarray:
    """Per-frame track ids that mix `bands` creation generations in every
    scanline block (each generation in scanline order), in the style of
    tests/test_banded_gather.py: no single window covers a block."""
    hw = h * w
    base = np.arange(hw).reshape(h, w)
    ids = np.stack([np.roll(base, -3 * t, axis=1) for t in range(n)]).reshape(n, hw)
    for g in range(1, bands):
        m = np.zeros(hw, bool)
        m[g::bands] = True
        fresh = np.arange(m.sum()) + g * (hw + 40_000) + 177
        for t in range(1, n):
            ids[t, np.roll(m, 3 * t * g)] = fresh
    return ids


def check_turnover(gen: torch.Generator) -> dict:
    """K5 on the planner's K = 2 plans of turnover-heavy ids, then its own
    path: `run_uvt` on those ids for 3 epochs, the launch counts set to 0
    just before it and read just after."""
    from tclight_torch.ops import banded_gather as bg
    from tclight_torch.ops import kernels
    from tclight_torch.ops.flow import voxelization
    from tclight_torch.pipeline import postopt

    ids = turnover_ids(FRAMES, HEIGHT, WIDTH)
    unq_inv = voxelization(ids.reshape(-1))
    n_unique = int(unq_inv.max()) + 1
    p_pad = max(128, -(-n_unique // 128) * 128)
    tables, _ = postopt.build_uvt_tables(unq_inv, FRAMES, HEIGHT, WIDTH, p_pad, device="cuda")
    if len(tables) != 10 or tables[1].dim() != 3 or tables[1].shape[-1] != 2:
        raise SystemExit("the turnover ids did not take K = 2 banded plans")
    rows = _banded_rows("K5", gen, tables, HEIGHT * WIDTH, p_pad, post_batch())
    frames = torch.rand(FRAMES, HEIGHT, WIDTH, 3, device="cuda", generator=gen)
    flows = torch.zeros(FRAMES, HEIGHT, WIDTH, 2, device="cuda")
    masks = torch.ones(FRAMES, HEIGHT, WIDTH, device="cuda")
    cfg = postopt.PostOptConfig(epochs=3)
    kernels.reset_stats()
    t0 = time.perf_counter()
    out, hist, times = postopt.run_uvt(frames, flows, masks, unq_inv, n_unique, cfg,
                                       warp_radius=postopt.flow_radius(flows.cpu().numpy()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernels.STATS["banded_gather_multi"]
    # K5's launches by direction: a batch of B frames is B * row_blocks(hw)
    # plan blocks in the render and B * row_blocks(p_pad) in the adjoint
    per_dir = {"render": bg.row_blocks(HEIGHT * WIDTH), "adjoint": bg.row_blocks(p_pad)}
    directions = {name: sum(n for key, n in stats.shapes.items() if key[0] % rb == 0)
                  for name, rb in per_dir.items()}
    ok = (stats.launches > 0 and sum(directions.values()) == stats.launches
          and min(directions.values()) > 0 and out.shape == frames.shape
          and np.isfinite(hist).all() and bool(torch.isfinite(out).all()))
    phase("K5-path", ok=ok, ids=f"{FRAMES}x{HEIGHT}x{WIDTH} tracks={n_unique} K=2",
          run_uvt_s=wall, epoch_s=times.tolist(), loss=hist.tolist(),
          k5_launches=stats.launches, k5_directions=directions,
          k3_launches=kernels.STATS["window_warp"].launches)
    if not ok:
        raise SystemExit("run_uvt on turnover ids did not run through K5 in both directions")
    return {"rows": rows, "launches": directions}


KERNEL_GROUPS = (("K6/K7 flash_attention_int8 (pre-passes and max pass included)",
                  ("flash_int8",)),
                 ("K1 flash_attention", ("flash_fwd_wgmma_kernel",)),
                 ("K2 match_argmax", ("match_argmax",)),
                 ("K3 window_warp", ("window_warp_fwd_kernel", "window_warp_adj_kernel")),
                 ("K5 banded_gather_multi", ("banded_gather_multi_kernel",)),
                 ("K4 banded_gather", ("banded_gather_kernel",)),
                 ("convolution", ("conv", "fprop", "winograd", "dgrad", "wgrad")),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_window(tag: str, fn, units: int, unit: str) -> None:
    """Trace fn() with torch.profiler: device time per kernel group per
    unit of work, the top kernels, and the device's busy share of the
    traced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    top = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, evt.count, evt.key[:70]))
    busy = sum(groups.values())
    if busy == 0:
        phase(tag, ok=True, note="the profiler saw no device time")
        return
    phase(tag, ok=True, **{unit + "s": units}, traced_wall_ms=wall_ms, device_busy_ms=busy,
          busy_share=busy / wall_ms,
          **{f"ms_per_{unit}": {g: round(ms / units, 3)
                                for g, ms in sorted(groups.items(), key=lambda x: -x[1])}})
    for ms, count, key in sorted(top, reverse=True)[:10]:
        phase(tag + "-top", **{f"ms_per_{unit}": round(ms / units, 3),
                               f"calls_per_{unit}": count / units}, kernel=key)


def profile_main_path() -> None:
    """Traced runs on the main path's config and inputs: 2 sampling steps,
    the same 2 steps with int8 q.k^T (K6), one step of the yt-int8 run's
    config (30 frames, the yt pass, K6), then 2 exposure and 2 UVT epochs
    (one batch of 16 each) on the main video's flows, masks and tracks."""
    from tclight_torch.config import load_config
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline import postopt
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_full_width_random

    steps = 2
    config = load_config([a for a in main_args(OUT / "wd_prof", True)
                          if a != "--full-width-random"])
    config.set_path("generation.n_timesteps", steps)
    models = build_full_width_random(num_inference_steps=steps)
    gen = Generator(models, config, data_parser=VideoDataParser(config.data))
    frames = gen.data_parser.load_video(frame_ids=list(range(FRAMES)))
    conds = gen.encode_imgs_batch(frames)
    cond, uncond = gen.encode_prompt_pair(PROMPT, gen.negative_prompt)
    x = gen.prepare_init_noise(FRAMES, HEIGHT, WIDTH,
                               torch.Generator(device="cuda").manual_seed(0))
    profile_window("profile", lambda: gen.ddim_sample(x, (uncond, cond), conds), steps, "step")
    config.set_path("generation.attn_qk_int8", True)
    gen8 = Generator(models, config)
    profile_window("profile-int8", lambda: gen8.ddim_sample(x, (uncond, cond), conds), steps,
                   "step")
    yt_cfg = load_config(["--config", str(REPO / "configs" / "examples" / "tclight_navsim.yaml"),
                          "-i", str(OUT / "vid30"), "generation.attn_qk_int8=true",
                          "generation.n_timesteps=1", "post_opt.apply_opt=false"])
    gen_yt = Generator(models, yt_cfg, data_parser=VideoDataParser(yt_cfg.data))
    conds_yt = gen_yt.encode_imgs_batch(gen_yt.data_parser.load_video(
        frame_ids=list(range(YT_FRAMES))))
    embeds = tuple(reversed(gen_yt.encode_prompt_pair(PROMPT, gen_yt.negative_prompt)))
    embeds_t = tuple(reversed(gen_yt.encode_prompt_pair(gen_yt.prompt_t,
                                                        gen_yt.negative_prompt_t)))
    x_yt = gen_yt.prepare_init_noise(YT_FRAMES, HEIGHT, WIDTH,
                                     torch.Generator(device="cuda").manual_seed(0))
    profile_window("profile-yt-int8", lambda: gen_yt.ddim_sample(x_yt, embeds, conds_yt,
                                                                 embeds_t=embeds_t), 1, "step")
    del gen8, gen_yt, conds_yt, x_yt, models

    rgbs, _, _, _, past, masks = gen.data_parser.load_data(list(range(FRAMES)), device="cuda")
    parser = gen.data_parser
    del gen, conds, x
    torch.cuda.empty_cache()
    f_d, p_d, m_d = (torch.from_numpy(a).cuda() for a in (rgbs, past, masks))
    radius = postopt.flow_radius(past)
    cfg = postopt.PostOptConfig(epochs_exposure=2, epochs=2)

    def post():
        aligned, _, _, _ = postopt.run_exposure_align(f_d, p_d, m_d, cfg, warp_radius=radius)
        postopt.run_uvt(aligned, p_d, m_d, parser.unq_inv, parser.n_unique, cfg,
                        warp_radius=radius)

    post()  # warm-up: cuDNN's algorithm search for the MS-SSIM convolutions
    profile_window("profile-postopt", post, 4, "epoch")


def kernel_entry(name, source, replaces, launches, rows, path="main") -> dict:
    head = rows[0]
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "launches_path": path,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": head["library_ms"],
             "shape": head["shape"], "per_shape": rows}
    if "exp_bound_ms" in head:
        entry["exp_bound_ms"] = head["exp_bound_ms"]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)  # the example configs name their base config from the root
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
    int8 = {pv: check_int8(gen, pv) for pv in (False, True)}
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
    warp = check_warp(gen)
    banded = check_banded(gen)
    turnover = check_turnover(gen)
    launches.update(run_yt_int8())
    int8_launches = run_int8_variants()
    for name in ("flash_attention_int8pv", "flash_attention_int8pv_prepass",
                 "flash_attention_int8pv_maxpass"):
        launches[name] = int8_launches[name]
    profile_main_path()

    print(json.dumps({"kernels": [
        kernel_entry("flash_attention", "tclight_torch/csrc/flash_attention.cu",
                     "tclight_tpu/ops/attention.py:135", launches["flash_attention"],
                     flash["rows"]),
        kernel_entry("online_argmax_scores", "tclight_torch/csrc/match_argmax.cu",
                     "tclight_tpu/ops/match_kernel.py:34",
                     launches["online_argmax_scores"], match["rows"]),
        kernel_entry("window_warp", "tclight_torch/csrc/window_warp.cu",
                     "tclight_tpu/ops/warp_kernel.py:108", launches["window_warp"],
                     warp["rows"]),
        kernel_entry("banded_gather", "tclight_torch/csrc/banded_gather.cu",
                     "tclight_tpu/ops/banded_gather.py:434", launches["banded_gather:render"],
                     banded["rows"][:1], path="main (the UVT render)"),
        kernel_entry("banded_gather:adjoint", "tclight_torch/csrc/banded_gather.cu",
                     "tclight_tpu/ops/banded_gather.py:434", launches["banded_gather:adjoint"],
                     banded["rows"][1:], path="main (the UVT adjoint)"),
        kernel_entry("banded_gather_multi", "tclight_torch/csrc/banded_gather.cu",
                     "tclight_tpu/ops/banded_gather.py:465", turnover["launches"]["render"],
                     turnover["rows"][:1], path="run_uvt on turnover-heavy ids (the render)"),
        kernel_entry("banded_gather_multi:adjoint", "tclight_torch/csrc/banded_gather.cu",
                     "tclight_tpu/ops/banded_gather.py:465", turnover["launches"]["adjoint"],
                     turnover["rows"][1:], path="run_uvt on turnover-heavy ids (the adjoint)"),
        kernel_entry("flash_attention_int8", "tclight_torch/csrc/flash_attention_qk_int8.cu",
                     "tclight_tpu/ops/attention.py:180", launches["flash_attention_int8"],
                     int8[False]["rows"],
                     path=f"yt-int8: navsim settings, {YT_FRAMES} frames, alpha_t 0.4, "
                          "attn_qk_int8"),
        kernel_entry("flash_attention_int8:prepass",
                     "tclight_torch/csrc/flash_attention_qk_int8.cu",
                     "tclight_tpu/ops/attention.py:180", launches["flash_attention_int8_prepass"],
                     int8[False]["prepass_rows"],
                     path="yt-int8 (K6's quantization pre-pass, two kernels a launch)"),
        kernel_entry("flash_attention_int8pv", "tclight_torch/csrc/flash_attention_int8.cu",
                     "tclight_tpu/ops/attention.py:227", launches["flash_attention_int8pv"],
                     int8[True]["rows"],
                     path=f"int8pv: main config, {FRAMES} frames, attn_qk_int8 + attn_pv_int8"),
        kernel_entry("flash_attention_int8pv:prepass",
                     "tclight_torch/csrc/flash_attention_qk_int8.cu",
                     "tclight_tpu/ops/attention.py:227",
                     launches["flash_attention_int8pv_prepass"], int8[True]["prepass_rows"],
                     path="int8pv (K7's quantization pre-pass, two kernels a launch)"),
        kernel_entry("flash_attention_int8pv:maxpass", "tclight_torch/csrc/flash_attention_int8.cu",
                     "tclight_tpu/ops/attention.py:227",
                     launches["flash_attention_int8pv_maxpass"], int8[True]["maxpass_rows"],
                     path="int8pv (K7's max pass: each (row, P block)'s logit max)"),
    ]}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
