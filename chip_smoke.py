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
     merge shapes (C = 320 and 640), beside bmm + max, reading a and bt in
     place (`in_place`), its time with the spread of three runs and the
     plan's cut (CTAs, tiles a CTA, src loads);
  5. K6 and K7, the int8 flash attentions (int8 q.k^T; K7 also int8 p.v),
     against their plain version on the same inputs at the xy shapes of
     phase 3 and at the yt pass's level-0 and level-1 shapes of a 30-frame
     960x720 run, beside K1 and SDPA at the same shapes and the
     quantization error against the fp attention, the exponentials' bound
     and whether the kernel read its operands in place (no copy at any
     head dim); K6's pre-pass kernels, and K7's pre-pass kernels and max
     pass, against their plain versions at the same shapes;
  6. reference: the tiny stack end to end on a small input, post-
     optimization included (3 + 3 epochs), on the card in bf16 against the
     CPU in f32 (`check_small_reference`);
  7. the main path: `python -m tclight_torch.run` on the full-width random
     SD1.5 IC-Light stack, 8 frames of a synthetic rolling video at
     960x720, 4 DPM++ steps, then the post-optimization on Farneback flows
     (35 exposure + 70 UVT epochs); checks the mp4, that the path launched
     K1-K4, finite loss histories, the banded UVT route, and that the
     output's warp L1 under the known roll flow is below the same path's
     with the post-optimization off, output_gt.mp4 beside the mp4 and the
     output stage's output_fetch / output_save; then K1 and K2 against their plain
     versions at each shape the run launched them at that phases 3 and 4
     did not hold (the CFG dedup's batches of one), as in phase 14;
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
  9b. exports: the ported JAX exports that no path calls (the ToMe "mean"
     merge and the three unmerges at the main path's level-0 shapes, the
     bilinear and bicubic samplers at 720 x 960), card against CPU;
 10. yt-int8: `tclight_torch.run.main` on configs/examples/tclight_navsim.yaml's
     settings (alpha_t 0.4, 30 frames at 960x720, of the synthetic video)
     with generation.attn_qk_int8=true, 4 steps, post-optimization off:
     a 30-frame mp4, K6 (and its pre-pass kernels, once per K6 launch)
     launched at xy and at yt shapes, K1 never, K2 yes, and held at each
     of its launch shapes not held before;
 11. int8 / int8pv: the 8-frame main config with the post-optimization
     off and attn_qk_int8 (then attn_pv_int8 too): K6 (then K7, with its
     pre-pass once a launch, and no max pass) launched, K1 never, and the frames against the fp run's (max abs difference,
     PSNR);
 12. traced runs of 2 sampling steps (fp, then int8 q.k^T), of one step
     of the yt-int8 config (after an untraced one) and of 2 + 2 post-opt
     epochs give the device time per kernel group (torch.profiler);
 13. raft: a full-width RAFT on random weights, written as a reference
     checkpoint and loaded by the evaluate CLI's loader: the card against
     the CPU at 128x160 under the entry point's own precision (f32 on
     PyTorch's convolution kernels), then
     both directions over the main cell's 8 frames at 960x720 (ms per pair,
     peak memory); memflow: the same for `load_memflow_core`, 7 streaming
     steps at 960x720 (ms per step, the memory count after each); eval:
     `tclight_torch.evaluate.main` on the main cell's run directory with
     that RAFT, random CLIP ViT-B/32, ViT-H/14 and VGG16 / lpips
     checkpoints and --eval_cost: every result.txt row, finite, and the
     wall time of each metric group; the random RAFT's consistency mask
     keeps no pixel (its warp-error row reads 100.00, its valid share is
     printed), so the warp-error metric is also held, card against CPU, on
     Farneback's flows of the rolling texture, whose mask must keep half
     the pixels and whose row must read below 100. These phases run under
     PyTorch's default precision flags and launch none of the kernels
     (checked);
 14. the editing path, background conditioning and single-image
     relighting, each at the full SD1.5 width on random weights, each with
     the launch counts set to 0 before its run and read after (K1 and K2
     must have launched where the path reaches them):
     pnp: `tclight_torch.run.main` with sd_version 1.5 on the generic
     4-channel stack (bf16): the DDIM inversion of the main cell's 8 frames
     (4 steps, the cache at each), then PnP generation (pnp_attn_t 0.5,
     pnp_f_t 0.8); controlnet: the same with a canny ControlNet, the stack
     written by the port's exporters as a checkpoint directory and loaded
     through `load_sd`; each also holds one noise prediction of its path
     on a three-level tiny stack, card (bf16) against the CPU (f32), within
     1.5 times the CPU's own bf16 error, a limit at most half of what
     turning the Q/K injection or the ControlNet's residuals off moves it;
     bkgd: the fbc stack with background_cond, a random RMBG reference
     checkpoint whose mattes spread over (0, 1) and a synthetic background
     video (the composite changes the frames; RMBG's mattes card against
     CPU; RMBG's ms at 896 x 1152); single-image: `SingleImageRelighter.
     process` (fc) and `process_bg` (fbc) at 512 x 640, 4 steps, the 1.5x
     pass at denoise 0.5. After each run, K1 and K2 are held against their
     plain versions at every shape the run launched them at that no
     earlier row covers (the keys their wrappers record; PnP's three-way
     batches with Q and K tiled from the first third), with the same
     fields as phases 3 and 4; and K1's row at the ControlNet's unmerged
     level 0;
     depth: `tclight_torch.run.main` with sd_version depth (the SD1.5-shaped
     5-channel stack in bf16, a random DPT-Hybrid at its published widths
     as a transformers-keyed `depth_ckpt`): inversion and generation of
     the main cell's 8 frames, 4 steps each; DPT's ms a frame at 384 x 384
     and its depth maps card against CPU; the small check on the 5-channel
     stack. annotators: HED, the lineart_anime U-Net (ngf 64, 8 downs) and
     the OpenPose body net at their published widths on random reference
     checkpoints, each `*_model_fn` on the 8 frames (ms a frame, peak,
     card against CPU in f32), then a softedge ControlNet run through
     `run.main` reading `annotator_ckpt`, and the small softedge check;
 15. upsampler: Pixtral-12B at its published widths on random weights
     (`check_small_upsampler`, `run_upsampler`): 400 tokens from the main
     cell's last frame (2,700 image tokens) through
     `pixtral.upsample_tokens`; ViT, prefill and per-token ms beside their
     bounds, peak memory; finite logits, 16 cached greedy steps against a
     recompute, the 2-layer full-width model card against CPU and read
     back from both checkpoint layouts by `load_vlm`; K1 / K2 not
     launched (its attention is a matmul, as JAX's);
 16. parallel: the port's multi-device code (tclight_torch/parallel/) in
     a world of one rank over NCCL (the machine has one card; the
     multi-rank semantics are held on CPU gloo worlds in the tests): the
     parallel denoise step (tiny UNet, bf16, K1 / K2), the sharded
     exposure and UVT steps (K3, K4, and K5 on turnover ids) and the
     context-parallel DiT forward, each against the same call without a
     process group (bit for bit, or one bf16 step);
 17. cosmos-small: a 2-block DiT of head dim 128 with non-zero gates over
     2,048 tokens, the card (bf16, K1) against the CPU (f32), within 1.5
     times the CPU's bf16 error, a limit at most half of what zeroing the
     self-attention moves it;
 18. t2w / v2w: `python -m tclight_torch.cosmos.text2world` (and
     video2world on a 121-frame video made here) as their mains run,
     --model_size 7b: the 7B DiT built on the card in bf16 from a seed,
     the CV8x8x8 tokenizer, 121 frames at 352 x 640 (14,080 DiT tokens),
     2 Heun steps; wall, seconds per solver step, one DiT forward, the
     decode, peak memory, the mp4's 121 frames; one denoiser evaluation
     at 704 x 1280 (56,320 tokens) and K1's share of it; t2w's forward
     also with attn_backend "int8" and "int8pv" (K6 / K7 at its 28 blocks:
     ms, launches, relative RMS against the bf16 forward); K1 held at every
     new shape (14,080 and 56,320 tokens, head dim 128), K6 and K7 at
     5,120, 14,080 and 56,320 (each row also says whether the kernel read
     its operands in place, in the head-dim-128 layout, and fails if that
     is not so exactly at head dim 128);
 19. ar-v2w: the port's `ARVideo2WorldPipeline` on the cosmos-4b AR
     (`create_video2world_model_config("5b")`, bf16) and the DV8x16x16
     tokenizer at its widths (bf16) through an adapter (its encode returns
     three values; ROADMAP C12): a 9-frame 320 x 512 context (1,280
     tokens), 3 latent frames generated (1,920 tokens), 33 frames decoded;
 20. dd: `diffusion_decoder_process_tokens` on that token grid (one
     57-frame window: 8 latent frames at 40 x 64, 5,120 DiT tokens) with
     the 7B decoder DiT (bf16), T5-11B's context (f32, 512 ids) and the
     CV8x8x8 tokenizer, 2 RES steps; K1 held at the decoder's shape;
 21. guardrails: LlamaGuard-7B + a LoRA adapter (f32) loaded from an
     HF-layout checkpoint written here, SigLIP-so400m and the safety head
     on 8 frames at 384, RetinaFace-R50 on 8 frames at 720 x 960, each
     through its checker's loader;
 22. ar-small: the card against the CPU: a 2-layer AR at the cosmos-4b
     widths (bf16 within 1.5x the CPU's bf16 error; the same sampled
     tokens in f32 with injected draws), a 2-block decoder DiT (K1), the
     tiny DV tokenizer's indices, T5, SigLIP and RetinaFace at tiny
     widths;
 23. one JSON line with every kernel's launches, error and times (K1's and
     K2's launches also by path, their rows of phases 14-20 among their
     shapes).
The last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero. Needs the repository around it and a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
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
    """Milliseconds a call of fn() takes on the card: one run of `reps`
    calls of the port's CUDA-event timer (`cuda_event_ms`)."""
    from tclight_torch.utils.logging import cuda_event_ms

    return cuda_event_ms(fn, reps)[0]


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


def flash_row(label: str, b: int, sq: int, skv: int, h: int, d: int,
              gen: torch.Generator, tiled: bool = False) -> dict:
    """K1 against its plain version on random bf16 q, k, v of one shape,
    beside SDPA, the byte and tensor-core bound and the exponentials'
    bound. `tiled`: Q and K are the first third's, repeated three times
    (contiguous copies), as PnP's injection makes them. The kernel reads
    q, k and v in place at every head dim (`kv_in_place`: the wrapper
    hands it k itself, no copy). Its time is the median of three runs of
    the CUDA-event timer, beside their spread (`spread_ms`)."""
    from tclight_torch.ops.attention import (flash_attention_cuda, flash_attention_plain,
                                             flash_kv_operands)
    from tclight_torch.utils.logging import cuda_event_ms

    q = torch.randn(b, sq, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
    k, v = (torch.randn(b, skv, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
            for _ in range(2))
    if tiled:
        q, k = q[:b // 3].repeat(3, 1, 1, 1), k[:b // 3].repeat(3, 1, 1, 1)
    scale = d ** -0.5
    out = flash_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    # bf16 output rounding (2^-8 relative) plus bf16 p in the p.v product
    tol = 2e-2 * ref.abs().max().item()
    in_place = flash_kv_operands(k, v)[0] is k
    ok = math.isfinite(err) and err <= tol and in_place
    reps = 3 if max(sq, skv) > 20000 else 10
    k_ms, spread = cuda_event_ms(lambda: flash_attention_cuda(q, k, v, scale), reps, 3)
    p_ms = cuda_ms(lambda: flash_attention_plain(q.float(), k.float(), v.float(), scale), 1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps)
    flops = 4.0 * b * h * sq * skv * d
    b_ms, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), flops)
    # one exponential per score: the softmax's floor on the special-
    # function units, beside the tensor-core and byte bound
    exp_ms = b * h * sq * skv / PEAK_EXP2 * 1e3
    shape = f"B={b} S={sq} H={h} D={d}" if sq == skv else f"B={b} Sq={sq} Skv={skv} H={h} D={d}"
    row = dict(shape=f"{label} {shape}" + (" QK tiled" if tiled else ""), max_abs_err=err,
               tol=tol, ms=k_ms, spread_ms=spread, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=b_ms, bound_by=by, exp_bound_ms=exp_ms, kv_in_place=in_place)
    phase("K1", ok=ok, **row)
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version at {row['shape']}")
    del q, k, v, out, ref, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def check_flash(gen: torch.Generator) -> dict:
    rows = [flash_row(level, b, s, s, HEADS, d, gen)
            for level, b, s, d in (attention_shapes()
                                   + attention_shapes(YT_FRAMES, HEIGHT // 8, "yt-"))]
    return {"rows": rows}


def check_int8(gen: torch.Generator, pv_int8: bool) -> dict:
    """K6 (pv_int8 False) or K7 against the plain int8 version on the same
    bf16 inputs, at the xy shapes and the 30-frame yt pass's shapes
    (`int8_row`). Returns the rows and the pre-pass rows."""
    out = {"rows": [], "prepass_rows": []}
    for level, b, s, d in attention_shapes() + attention_shapes(YT_FRAMES, HEIGHT // 8, "yt-"):
        int8_row(level, b, s, HEADS, d, gen, pv_int8, out)
    return out


def int8_row(level: str, b: int, s: int, h: int, d: int, gen: torch.Generator,
             pv_int8: bool, out: dict, plain_heads: int | None = None) -> dict:
    """K6 (pv_int8 False) or K7 against the plain int8 version on random
    bf16 inputs of one shape. `ms` is the wrapper's (the quantization
    pre-pass and the kernel), `prepass_ms` the pre-pass kernels alone, with
    the plain pre-pass's time beside it (`prepass_plain_ms`). Beside them
    K1 and SDPA at the same shape (the library has no call for the
    quantized function), and the quantization error of the plain version
    against the fp attention. Appends the row to out["rows"] and the
    pre-pass kernels' row against the plain pre-pass, in the kernel's
    operand layout, to out["prepass_rows"]. `operands_in_place`: the kernel
    read q8 and k8 row-major and v in place (K6) or a channel-major v8 and
    no copy of q8 or k8 (K7); the row fails if that is not so at any head
    dim. `exp_bound_ms`: one exponential a score at the special-function
    units' rate, as K1's rows. `plain_heads`: the plain attention (and the
    fp attention beside it) held on the first so many heads only, where
    the whole call's would take too long; each head is quantized on its
    own, so their outputs are the kernel's on those heads.""" 
    from tclight_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_int8_cuda,
                                             flash_attention_int8_plain,
                                             flash_attention_plain,
                                             int8pv_operands, int8pv_operands_plain,
                                             qk_int8_operands, qk_int8_operands_plain)

    tag = "K7" if pv_int8 else "K6"
    operands, operands_plain = ((int8pv_operands, int8pv_operands_plain) if pv_int8
                                else (qk_int8_operands, qk_int8_operands_plain))
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    res = flash_attention_int8_cuda(q, k, v, scale, pv_int8)
    torch.cuda.synchronize()
    ops = operands(q, k, v)
    in_place = ops["q8"].dim() == 3 and (("qb" not in ops and ops["v8"].dim() == 3) if pv_int8
                                         else ops["v"] is v)
    del ops
    hp = slice(0, plain_heads)
    qp, kp, vp = (t[:, :, hp].contiguous() for t in (q, k, v))
    ref, p_ms = timed_once(lambda: flash_attention_int8_plain(qp, kp, vp, scale, pv_int8))
    ref = ref.float()
    fp = flash_attention_plain(qp.float(), kp.float(), vp.float(), scale)
    del qp, kp, vp
    res_p = res[:, :, hp].float()
    err = (res_p - ref).abs().max().item()
    # bf16 output rounding and exp2 rounding, as K1; K6 also takes p in
    # bf16 for p.v, and a K7 p8 at a rounding tie moves by one step
    # (1/127 of its block's max)
    tol = 2e-2 * ref.abs().max().item()
    quant_err = (ref - fp).abs().max().item() / fp.abs().max().item()
    kernel_fp_err = (res_p - fp).abs().max().item() / fp.abs().max().item()
    del res_p
    ok = math.isfinite(err) and err <= tol and in_place
    reps = 3 if s > 20000 else 10
    k_ms = cuda_ms(lambda: flash_attention_int8_cuda(q, k, v, scale, pv_int8), reps)
    plain_pre_ms = cuda_ms(lambda: operands_plain(q, k, v), reps)
    pre_ms = cuda_ms(lambda: operands(q, k, v), reps)
    out["prepass_rows"].append(check_prepass(tag, level, q, k, v, operands, operands_plain,
                                             pre_ms))
    k1_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, scale), reps)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps)
    # the kernel's operands cross memory once: q8 and k8 (d bytes a row),
    # v8 (K7) or v in bf16, the scales (an f32 a key, a Q-scale block and,
    # K7, a channel), the bf16 output; q.k^T at the int8 peak, p.v at the
    # int8 (K7) or bf16 (K6) peak
    bh = b * h
    n_bytes = (bh * s * d * 2 + (bh * s * d if pv_int8 else 2 * v.numel()) + 2 * q.numel()
               + 4 * bh * (s + -(-s // 1024) + (d if pv_int8 else 0)))
    prod = 2.0 * bh * s * s * d
    t_ops = (prod / PEAK_INT8_OPS + prod / (PEAK_INT8_OPS if pv_int8 else PEAK_BF16_FLOPS)) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    # one exponential a score: the softmax's floor on the special-function
    # units, beside the tensor-core and byte bound, as K1's rows
    exp_ms = bh * s * s / PEAK_EXP2 * 1e3
    row = dict(shape=f"{level} B={b} S={s} H={h} D={d}", max_abs_err=err, tol=tol,
               plain_heads=plain_heads or h, operands_in_place=in_place,
               quant_rel_err_plain_vs_fp=quant_err, rel_err_kernel_vs_fp=kernel_fp_err,
               ms=k_ms, prepass_ms=pre_ms, prepass_plain_ms=plain_pre_ms,
               plain_ms=p_ms, library_ms=None, k1_ms=k1_ms, sdpa_ms=sdpa_ms, bound_ms=b_ms,
               bound_by=by, exp_bound_ms=exp_ms)
    phase(tag, ok=ok, **row)
    if not ok:
        raise SystemExit(f"{tag} disagrees with its plain version, or its operands' layout "
                         f"is not its head dim's, at {row['shape']}")
    out["rows"].append(row)
    del q, k, v, res, ref, fp, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def check_prepass(tag: str, level: str, q, k, v, kernel, plain, k_ms: float) -> dict:
    """K6's (or K7's) pre-pass kernels against the plain pre-pass in the
    kernel's layout: q8 and the Q scales (K7: also v8 and the V scales)
    bit-equal, K6's v the input itself; k8 within 1 and the K scales within
    a bf16 step, where K's token mean (an f32 sum in another order) rounds
    to another bf16 value (`max_abs_err` is k8's largest difference,
    `k8_differ` the share of k8 values that differ). Bound: q and k (K7:
    and v) read once, the function's outputs written once, whatever the
    layout pads: q8 and k8 (K7: and v8) a byte a value, an f32 scale a key,
    each Q-scale block's (K7: and each V channel's)."""
    ops = kernel(q, k, v)
    torch.cuda.synchronize()
    ref, p_ms = timed_once(lambda: plain(q, k, v))
    exact_names = ("q8", "sq", "v8", "sv") if tag == "K7" else ("q8", "sq")
    exact = all(torch.equal(ops[n], ref[n]) for n in exact_names) and (
        tag == "K7" or ops["v"] is v)
    dk8 = (ops["k8"].int() - ref["k8"].int()).abs()
    sk_ok = bool(((ops["sk"] - ref["sk"]).abs() <= ref["sk"].abs() * 2.0 ** -7).all())
    err, share = float(dk8.max().item()), float((dk8 > 0).float().mean().item())
    ok = exact and err <= 1 and share <= 0.01 and sk_ok
    b, s, h, d = q.shape
    n_vals = b * h * s * d
    n_bytes = (2 * (3 if tag == "K7" else 2) * n_vals + 2 * n_vals + 4 * b * h * s
               + 4 * ops["sq"].numel() + (n_vals + 4 * b * h * d if tag == "K7" else 0))
    b_ms, by = bound_ms(n_bytes, 0.0)
    row = dict(shape=f"{level} B={b} S={s} H={h} D={d}", max_abs_err=err, tol=1.0,
               k8_differ=share, exact=f"{'/'.join(exact_names)} {exact}", ms=k_ms,
               plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=by)
    phase(f"{tag}-prepass", ok=ok, **row)
    if not ok:
        raise SystemExit(f"{tag}'s pre-pass disagrees with the plain pre-pass at {row['shape']}")
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


def match_row(name: str, b: int, s: int, d: int, c: int, gen: torch.Generator) -> dict:
    """K2 against its plain version on unit-norm bf16 rows of one shape
    (the matcher's cosine metric), beside bmm + max and the bound. K2 reads
    a and bt in place (`in_place`: the wrapper hands it a and bt
    themselves, no copy). Its time is the median of three runs of the
    CUDA-event timer, beside their spread (`spread_ms`); the plan's fields
    say how the tiles were cut."""
    from tclight_torch.ops.match_kernel import (match_operands, match_plan,
                                                online_argmax_scores_cuda,
                                                online_argmax_scores_plain)
    from tclight_torch.utils.logging import cuda_event_ms

    a = F.normalize(torch.randn(b, s, c, device="cuda", generator=gen), dim=-1).bfloat16()
    bt = F.normalize(torch.randn(b, d, c, device="cuda", generator=gen), dim=-1).bfloat16()
    in_place = all(x is y for x, y in zip(match_operands(a, bt), (a, bt)))
    m, i = online_argmax_scores_cuda(a, bt)
    torch.cuda.synchronize()
    mr, ir = online_argmax_scores_plain(a, bt)
    err = (m - mr).abs().max().item()
    # f32 sums of exact bf16 products in another order: ~1e-6; an index
    # may differ only where the best two scores are that close
    tol = 1e-4
    scores = torch.einsum("bsc,bdc->bsd", a.float(), bt.float())
    top2 = scores.transpose(0, 1).reshape(s, b * d).topk(min(2, b * d), dim=-1).values
    del scores
    clear = (top2[:, 0] - top2[:, -1]) > tol
    mismatch = int(((i != ir) & clear).sum().item())
    near_ties = int((~clear).sum().item())
    ok = math.isfinite(err) and err <= tol and mismatch == 0 and in_place
    reps = 3 if s * d > 1e8 else 10
    k_ms, spread = cuda_event_ms(lambda: online_argmax_scores_cuda(a, bt), reps, 3)
    p_ms = cuda_ms(lambda: online_argmax_scores_plain(a, bt), 1)

    def library():
        sc = torch.bmm(a, bt.transpose(1, 2)).transpose(0, 1).reshape(s, b * d)
        return sc.max(dim=-1)

    l_ms = cuda_ms(library, reps)
    flops = 2.0 * b * s * d * c
    b_ms, by = bound_ms(2 * (a.numel() + bt.numel()) + 8 * s, flops)
    plan = match_plan(b, s, d, c, torch.cuda.get_device_properties(0).multi_processor_count)
    row = dict(shape=f"{name} B={b} S={s} D={d} C={c}", max_abs_err=err, tol=tol,
               idx_mismatch=mismatch, near_ties=near_ties, ms=k_ms, spread_ms=spread,
               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=by, in_place=in_place,
               src_rows=plan["src_rows"], stages=plan["stages"], ctas=plan["ctas"],
               tiles_per_cta=plan["tiles_per_cta"], src_loads=plan["src_loads"])
    phase("K2", ok=ok, **row)
    if not ok:
        raise SystemExit(f"K2 disagrees with its plain version at {row['shape']}"
                         + ("" if in_place else " (or copies its operands)"))
    del a, bt, m, i, mr, ir, top2
    torch.cuda.empty_cache()
    return row


def check_match(gen: torch.Generator) -> dict:
    return {"rows": [match_row(name, b, s, d, c, gen) for name, b, s, d, c in match_shapes()]}


def check_path_shapes(tag: str, shapes: dict, gen: torch.Generator, held: dict) -> dict:
    """K1 and K2 against their plain versions at every shape that the run
    of path `tag` launched them at (the keys their wrappers record: (B,
    Sq, Skv, H, D) and (B, S, D, C)) and no row in `held` ((kernel, key) ->
    row) covers; the new rows join `held`. On the PnP path a batch of
    three thirds has Q and K tiled from the first third, as the up blocks'
    injection makes them. Returns each kernel's new rows."""
    rows = {"flash_attention": [], "online_argmax_scores": []}
    for name, key in sorted((n, k) for n in rows for k in shapes[n]):
        if (name, key) in held:
            continue
        if name == "flash_attention":
            row = flash_row(tag, *key, gen, tiled=tag == "pnp" and key[0] % 3 == 0)
        else:
            _, s, d, _ = key
            row = match_row(f"{tag} {'global' if s == d else 'local'}", *key, gen)
        held[(name, key)] = row
        rows[name].append(row)
    return rows


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


def run_main_path() -> tuple[dict, dict]:
    """The main path's run and checks: (K1's and K2's launch keys, the
    launch counts of the kernels line)."""
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
    n_gt, shape_gt = read_mp4(out_dir / "output_gt.mp4")
    cfg = yaml.safe_load((out_dir / "config.yaml").read_text())
    st = cfg["stage_times"]
    losses = {k: np.load(out_dir / f"loss_{k}.npy") for k in ("exposure", "unique_tensor")}
    cached = postopt._UVT_TABLE_CACHE.get("slot")
    route = ("banded" if cached is not None and len(cached[1]) == 10 else "dense/sorted")
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    warp, band = stats["window_warp"], stats["banded_gather"]
    flash_dims = sorted({key[-1] for key in flash[1]})
    # K4's launches by direction: the render's plans and the adjoint's
    # have their own windows (the last item of the shape key)
    wf, wb = postopt._banded_windows(HEIGHT * WIDTH, postopt._UVT_TABLE_CACHE["slot"][0][4])
    directions = {name: sum(n for key, n in band[1].items() if key[-1] == w)
                  for name, w in (("render", wf), ("adjoint", wb))}
    merges = {"global" if s == d else "local" for _, s, d, _ in match[1]}
    warp_on = warp_l1(out_dir / "frames")

    # the same path with the post-optimization off, for the warp L1
    work_off = OUT / "wd_off"
    if main(main_args(work_off, False)) != 0:
        raise SystemExit("main path with apply_opt=false failed")
    warp_off = warp_l1(next(work_off.rglob("output.mp4")).parent / "frames")

    finite = all(h.size and np.isfinite(h).all() for h in losses.values())
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and (n_gt, shape_gt) == (n, shape)
          and flash[0] > 0
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
          output_fetch_s=st["output_fetch"], output_save_s=st["output_save"],
          gt_frames=n_gt, peak_mem_gb=peak,
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
    counts = {"flash_attention": flash[0], "online_argmax_scores": match[0],
              "window_warp": warp[0], "banded_gather": band[0],
              "banded_gather:render": directions["render"],
              "banded_gather:adjoint": directions["adjoint"]}
    return {k: stats[k][1] for k in ("flash_attention", "online_argmax_scores")}, counts


def read_frames(frames_dir: Path) -> np.ndarray:
    """The run's saved PNG frames, (N, H, W, 3) in [0, 1]."""
    import cv2

    files = sorted(frames_dir.glob("*.png"))
    out = np.stack([cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in files])
    return out.astype(np.float32) / 255.0


def run_yt_int8() -> tuple[dict, dict]:
    """The yt pass with int8 attention: configs/examples/tclight_navsim.yaml
    (alpha_t 0.4, 30 frames at 960x720) on a 30-frame synthetic video, with
    attn_qk_int8, 4 steps and the post-optimization off. The launch counts
    are set to 0 just before and read just after. Returns K1's and K2's
    launch keys and K6's counts."""
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
    return ({k: stats[k][1] for k in ("flash_attention", "online_argmax_scores")},
            {"flash_attention_int8": k6[0], "flash_attention_int8_prepass": pre[0]})


def run_int8_variants() -> dict:
    """The 8-frame main config with the post-optimization off, with int8
    q.k^T (K6), then with int8 q.k^T and p.v (K7); each frame set against
    the fp run's (`wd_off` of the main path: same seed, same noise). The
    launch counts are set to 0 before each run and read after it."""
    import yaml

    from tclight_torch.ops import kernels
    from tclight_torch.run import main

    fp_dir = next((OUT / "wd_off").rglob("output.mp4")).parent
    fp_frames = read_frames(fp_dir / "frames")
    # the fp run's steady step (the main config, post-optimization off), and
    # the main path's, beside each int8 run's
    fp_steps = yaml.safe_load((fp_dir / "config.yaml").read_text())["stage_times"]["step_times"]
    main_steps = yaml.safe_load((next((OUT / "wd").rglob("output.mp4")).parent
                                 / "config.yaml").read_text())["stage_times"]["step_times"]
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
        # K6 and K7 run their pre-pass kernels once a launch, and nothing
        # else of their own (K7 makes its P blocks' maxes itself)
        parts = [f"{name}_prepass"]
        ok = (n == FRAMES and stats[name] > 0 and all(stats[k] == 0 for k in others)
              and all(stats[k] == stats[name] for k in parts)
              and not any("maxpass" in k for k in stats)
              and frames.shape == fp_frames.shape and float(frames.std()) > 0)
        steady = float(np.mean(st["step_times"][1:]))
        phase(tag, ok=ok, frames=n, wall_s=wall, step_s=st["step_times"],
              step_steady_s=steady, fp_step_steady_s=float(np.mean(fp_steps[1:])),
              main_step_steady_s=float(np.mean(main_steps[1:])), launches=stats[name],
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


def check_exports(gen: torch.Generator) -> None:
    """[exports]: the JAX exports that no path calls, on the card against
    the CPU. The ToMe "mean" merge (f32; index_add_ sums in another order:
    1e-5) and the three unmerges (gathers: exact) at the main path's level
    0 (2 x 4 frames of 90 x 120 tokens, C = 320, then the merged chunk
    against a bank of its length), the merge indices found on the card (K2
    on a bf16 metric, as the UNet does) and handed to both sides; the
    bilinear and bicubic samplers (1e-5) on two 720 x 960 frames at
    coordinates up to 4 px off the roll flow's and past the edges."""
    from tclight_torch.ops import resample, tome

    t0 = time.perf_counter()

    def cpu(mi):
        return tome.MergeIndices(*(t.cpu() for t in mi[:5]), mi.n_total)

    def err(a, b) -> float:
        return float((a.cpu() - b).abs().max())

    tnum, c = (HEIGHT // 8) * (WIDTH // 8), 320
    x = torch.randn(2, CHUNK * tnum, c, generator=gen, device="cuda")
    spec = tome.plan_local_levels(CHUNK, tnum, LOCAL_RATIO)[0]
    mi = tome.compute_local_merge(x.bfloat16(), spec, 1)
    local = tome.tome_merge(x, mi, "mean")
    bank = torch.randn(local.shape, generator=gen, device="cuda")
    merged, mi_g, flip = tome.global_merge(local, bank, local.bfloat16(), bank.bfloat16(),
                                           GLOBAL_RATIO, True, mode="mean")
    x_cpu, local_cpu, merged_cpu = x.cpu(), local.cpu(), merged.cpu()
    y = torch.randn(local.shape, generator=gen, device="cuda")
    errs = {
        "mean_local": err(local, tome.tome_merge(x_cpu, cpu(mi), "mean")),
        "mean_global": err(merged, tome.tome_merge(torch.cat([bank.cpu(), local_cpu], 1),
                                                    cpu(mi_g), "mean")),
        "tome_unmerge": err(tome.tome_unmerge(y, mi), tome.tome_unmerge(y.cpu(), cpu(mi))),
        "local_unmerge": err(tome.local_unmerge_sequence(y, [mi]),
                             tome.local_unmerge_sequence(y.cpu(), [cpu(mi)])),
        "global_unmerge": err(tome.global_unmerge(merged, mi_g, flip, local.shape[1]),
                              tome.global_unmerge(merged_cpu, cpu(mi_g), flip,
                                                  local.shape[1])),
    }
    ms = {"mean_local": cuda_ms(lambda: tome.tome_merge(x, mi, "mean"), 20),
          "mean_global": cuda_ms(lambda: tome.tome_merge(torch.cat([bank, local], 1), mi_g,
                                                         "mean"), 20),
          "local_unmerge": cuda_ms(lambda: tome.local_unmerge_sequence(y, [mi]), 20),
          "global_unmerge": cuda_ms(lambda: tome.global_unmerge(merged, mi_g, flip,
                                                                local.shape[1]), 20)}
    images = torch.rand(2, HEIGHT, WIDTH, 3, generator=gen, device="cuda")
    grid = resample.identity_grid(HEIGHT, WIDTH, device="cuda")
    jitter = 8 * torch.rand(2, HEIGHT, WIDTH, 2, generator=gen, device="cuda") - 4
    coords = grid + torch.tensor([4.0, 0.0], device="cuda") + jitter
    for name in ("bilinear_sample", "bicubic_sample"):
        fn = getattr(resample, name)
        errs[name] = err(fn(images, coords), fn(images.cpu(), coords.cpu()))
        ms[name] = cuda_ms(lambda: fn(images, coords), 20)
    exact = ("tome_unmerge", "local_unmerge", "global_unmerge")
    ok = all(errs[k] == 0.0 for k in exact) and all(
        v <= 1e-5 for k, v in errs.items() if k not in exact)
    phase("exports", ok=ok, tol="exact (unmerges), 1e-5 (mean merges, samplers)",
          tokens=tuple(x.shape), merged=tuple(merged.shape), n_merged=mi.src_idx.shape[1],
          max_abs_err=errs, ms=ms, seconds=time.perf_counter() - t0)
    if not ok:
        raise SystemExit("[exports] the card disagrees with the CPU")


def post_batch() -> np.ndarray:
    """Frame indices of the main path's post-opt batch: its 8 frames, padded
    to the batch size with frame 0 as the epochs pad them."""
    return np.array(list(range(FRAMES)) + [0] * (POST_BATCH - FRAMES))


def check_warp(gen: torch.Generator) -> dict:
    from tclight_torch.ops.warp_kernel import (adjoint_fixed_point_exponent, window_warp_cuda,
                                               window_warp_plain)
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
        # the body each direction launched: the adjoint's one-limb tiles
        # (under 64 taps) of all
        _, limbs = adjoint_fixed_point_exponent(x.cpu(), f.cpu(), r)
        bodies = ("gather, a pixel a thread on 4x64 tiles",
                  f"scatter, one limb at {int((limbs == 0).sum())} of {limbs.numel()} tiles")
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
                       f"N={n} {height}x{width}x3 radius={r}", body=bodies[adjoint],
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
        # as the main path launches them: K4's render runs the frames' blocks
        # of one index together, its adjoint in plan order
        kw = {"rows": b} if not multi and label == "render" else {}
        out = kern(table, starts, offs, window, **kw)
        torch.cuda.synchronize()
        ref, p_ms = timed_once(lambda: plain(table, starts, offs, window))
        err = (out - ref).abs().max().item()
        ok = err == 0.0  # a gather: exact
        k_ms = cuda_ms(lambda: kern(table, starts, offs, window, **kw), 10)
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
        group = bg.block_order(offs.shape[0], b).shape[1]
        body = ("direct gather" + (f", {group} frames' block j a CTA, block j of the {b} frames"
                                   " together" if kw else ", plan order"))
        row = dict(shape=f"{label} B={b} hw={hw} p_pad={p_pad} NB={offs.shape[0]} "
                   f"window={window} K={k} offs={str(offs.dtype)[6:]}", body=body,
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


KERNEL_GROUPS = (("K6/K7 flash_attention_int8 (pre-passes included)",
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
    config (30 frames, the yt pass, K6) after an untraced one, then 2 exposure and 2 UVT epochs
    (one batch of 16 each) on the main video's flows, masks and tracks."""
    from tclight_torch.config import load_config
    from tclight_torch.data.dataparsers import VideoDataParser
    from tclight_torch.pipeline import postopt
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import build_full_width_random, encode_prompt_pair

    steps = 2
    config = load_config([a for a in main_args(OUT / "wd_prof", True)
                          if a != "--full-width-random"])
    config.set_path("generation.n_timesteps", steps)
    models = build_full_width_random(num_inference_steps=steps)
    gen = Generator(models, config, data_parser=VideoDataParser(config.data))
    frames = gen.data_parser.load_video(frame_ids=list(range(FRAMES)))
    conds = gen.encode_imgs_batch(frames)
    cond, uncond = encode_prompt_pair(gen.models, PROMPT, gen.negative_prompt)
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
    embeds = tuple(reversed(encode_prompt_pair(gen_yt.models, PROMPT,
                                               gen_yt.negative_prompt)))
    embeds_t = tuple(reversed(encode_prompt_pair(gen_yt.models, gen_yt.prompt_t,
                                                 gen_yt.negative_prompt_t)))
    x_yt = gen_yt.prepare_init_noise(YT_FRAMES, HEIGHT, WIDTH,
                                     torch.Generator(device="cuda").manual_seed(0))
    # the first yt pass captures the slots' CUDA graphs (pipeline/
    # slot_graphs.py): it runs before the trace, which holds a later step
    gen_yt.ddim_sample(x_yt, embeds, conds_yt, embeds_t=embeds_t)
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


# The flow networks and the evaluation (no hand-written kernel on these
# paths: convolutions, matmuls and gathers). The card's flows against the
# CPU's, both f32, on random weights that amplify rounding (see
# tests/test_torch_flow_cuda.py): max / mean end-point error in px.
FLOW_EPE_MAX, FLOW_EPE_MEAN = 1e-3, 1e-4
SMALL_FLOW = (128, 160)


def flow_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32), (0, 0), 2)
    return np.stack([np.roll(base, 3 * t, axis=1) for t in range(n)]).astype(np.float32)


def epe(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    e = np.linalg.norm(a - b, axis=-1)
    return float(e.max()), float(e.mean())


def write_flow_checkpoints(tmp: Path) -> tuple[Path, Path]:
    """Full-width RAFT and MemFlowNetSK on random weights (seed 0; random
    BatchNorm statistics; MemFlow's gamma 0.5, so its memory attention
    counts), written in the reference checkpoints' layouts: `module.`
    keys, MemFlow's nested under "model"."""
    from tclight_torch.models import memflow_sk, raft

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    out = []
    for name, model, export in (("raft-things.pth", raft.RAFT(), raft.reference_state_dict),
                                ("MemFlowNet_things.pth", memflow_sk.MemFlowNetSK(),
                                 memflow_sk.reference_state_dict)):
        if hasattr(model, "gamma"):
            model.gamma.data.fill_(0.5)
        sd = export(model)
        for k in sd:
            if k.endswith(("running_var", "running_mean")):
                sd[k] = torch.rand(sd[k].shape, generator=gen) + 0.5
        sd = {f"module.{k}": v for k, v in sd.items()}
        torch.save(sd if name.startswith("raft") else {"model": sd}, tmp / name)
        out.append(tmp / name)
    return out[0], out[1]


def check_raft(ckpt: Path) -> dict:
    """[raft]: the checkpoint through the evaluate CLI's loader; (a) the card
    against the CPU on 2 pairs at SMALL_FLOW, under the entry point's own
    precision (f32); (b) both directions
    over the main cell's 8 frames at 960x720 (`compute_flow_pairs`, 4 pairs
    a call): ms per pair, peak device memory, finite flows, no kernel
    launched."""
    from tclight_torch.data.flow_backends import compute_flow_pairs
    from tclight_torch.eval.loaders import load_flow_backend
    from tclight_torch.ops import kernels
    from tclight_torch.utils.video_io import load_video

    _, card = load_flow_backend("raft", ckpt)
    _, cpu = load_flow_backend("raft", ckpt, device="cpu")
    small = flow_frames(3, *SMALL_FLOW, seed=2)
    ref = cpu.batched_flow(small[:2], small[1:])
    e_max, e_mean = epe(card.batched_flow(small[:2], small[1:]), ref)
    del cpu
    frames = load_video(OUT / "vid")
    card.batched_flow(frames[:1], frames[1:2])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    t0 = time.perf_counter()
    flows = [compute_flow_pairs(frames, d, "raft", raft=card) for d in ("future", "past")]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = sum(st.launches for st in kernels.STATS.values())
    pairs = 2 * (len(frames) - 1)
    finite = all(np.isfinite(f).all() and f.shape == frames.shape[:3] + (2,) for f in flows)
    ok = e_max <= FLOW_EPE_MAX and e_mean <= FLOW_EPE_MEAN and finite and launched == 0
    phase("raft", ok=ok, small_shape=SMALL_FLOW, epe_max=e_max, epe_mean=e_mean,
          tol=(FLOW_EPE_MAX, FLOW_EPE_MEAN), precision="f32, PyTorch's convolution kernels",
          frames=frames.shape,
          pairs=pairs, ms_per_pair=wall * 1e3 / pairs, wall_s=wall, peak_mem_gb=peak,
          flow_abs_max=float(max(np.abs(f).max() for f in flows)), kernel_launches=launched)
    if not ok:
        raise SystemExit("[raft] failed")
    return {"ms_per_pair": wall * 1e3 / pairs, "peak_mem_gb": peak}


def check_memflow(ckpt: Path) -> dict:
    """[memflow]: `load_memflow_core`; (a) the card against the CPU over 3
    streaming steps at SMALL_FLOW; (b) 7 streaming steps over the main
    cell's frames at 960x720 (after one warm-up step and a reset): ms per
    step, peak device memory, the memory count after each step."""
    from tclight_torch.data.flow_backends import load_memflow_core
    from tclight_torch.ops import kernels
    from tclight_torch.utils.video_io import load_video

    card = load_memflow_core(ckpt)
    cpu = load_memflow_core(ckpt, device="cpu")
    small = flow_frames(4, *SMALL_FLOW, seed=3)
    errs = [epe(card.step(small[i], small[i + 1]), cpu.step(small[i], small[i + 1]))
            for i in range(3)]
    del cpu
    frames = load_video(OUT / "vid")
    card.reset()
    card.step(frames[0], frames[1])  # warm-up
    card.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    step_ms, counts, finite = [], [], True
    for i in range(len(frames) - 1):
        t0 = time.perf_counter()
        flow = card.step(frames[i], frames[i + 1])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(card.mem.count)
        finite &= bool(np.isfinite(flow).all()) and flow.shape == frames.shape[1:3] + (2,)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = sum(st.launches for st in kernels.STATS.values())
    e_max, e_mean = max(e[0] for e in errs), max(e[1] for e in errs)
    hw = (frames.shape[1] // 8) * (frames.shape[2] // 8)
    ok = (e_max <= FLOW_EPE_MAX and e_mean <= FLOW_EPE_MEAN and finite and launched == 0
          and counts == [hw] * len(counts))
    phase("memflow", ok=ok, small_shape=SMALL_FLOW, epe_max=e_max, epe_mean=e_mean,
          epe_per_step=errs, tol=(FLOW_EPE_MAX, FLOW_EPE_MEAN),
          precision="f32, PyTorch's convolution kernels",
          frames=frames.shape, steps=len(step_ms), step_ms=step_ms,
          ms_per_step=float(np.mean(step_ms)), peak_mem_gb=peak, mem_counts=counts,
          kernel_launches=launched)
    if not ok:
        raise SystemExit("[memflow] failed")
    return {"ms_per_step": float(np.mean(step_ms)), "peak_mem_gb": peak}


def write_eval_checkpoints(tmp: Path) -> dict[str, Path]:
    """Random CLIP ViT-B/32 (clip-frame) and ViT-H/14 (pick-score) vision
    towers and a random VGG16 with lpips heads (seed 0), in transformers' /
    torchvision's / lpips' layouts; ViT-H/14 in f16, to halve its 2.5 GB."""
    from tclight_torch.models import clip_vision, vgg_lpips

    torch.manual_seed(0)
    dirs = {}
    for name, cfg, dtype in (("clip", clip_vision.CLIPVisionConfig.vit_b32(), torch.float32),
                             ("pick", clip_vision.CLIPVisionConfig.vit_h14(), torch.float16)):
        with torch.device("cuda"):
            model = clip_vision.CLIPVisionModel(cfg)
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.data.fill_(1.0 if pname.endswith("weight") else 0.0)
            else:
                p.data.normal_(0.0, 0.02)
        dirs[name] = tmp / name
        dirs[name].mkdir()
        torch.save({k: v.to(dtype) for k, v in clip_vision.reference_state_dict(model).items()},
                   dirs[name] / "vision.pth")
        del model
    dirs["lpips"] = tmp / "lpips"
    dirs["lpips"].mkdir()
    torch.save(vgg_lpips.reference_state_dict(vgg_lpips.VGG16Features()),
               dirs["lpips"] / "vgg16.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                for i, c in enumerate((64, 128, 256, 512, 512))},
               dirs["lpips"] / "lpips_vgg.pth")
    return dirs


EVAL_ROWS = {"warp-error-ssim", "psnr", "ssim", "clip-frame", "frame-lpips", "z_fps",
             "z_max_memory_allocated(M)", "z_resolution", "z_total_frames", "z_total_time(s)",
             "zz_flow_backend"}


# The warp-error row prints 100 x the mean SSIM with 2 decimals: the card's
# value against the CPU's to 1.5 units of that digit; Farneback's
# consistency mask on the rolling texture must keep at least half the pixels.
WARP_SSIM_TOL, MIN_VALID_SHARE = 1.5e-4, 0.5


def check_warp_error(run_dir: Path, raft_ckpt: Path) -> dict:
    """The warp-error metric on flows whose consistency mask keeps pixels.
    The random RAFT's forward and backward flows disagree, so its mask drops
    (nearly) every pixel and its row reads 100.00, zeros against zeros: its
    valid share is reported beside it. Farneback's flows of the rolling
    texture agree, so `warp_error_ssim` on them, the masks and the bilinear
    warp on the card, is held against the CPU and must read below 100."""
    from tclight_torch.data.flow_backends import compute_flow_pairs
    from tclight_torch.eval.loaders import load_flow_backend
    from tclight_torch.eval.metrics import warp_error_ssim
    from tclight_torch.ops.flow import compute_fwdbwd_mask
    from tclight_torch.utils.video_io import load_video

    # the frames that evaluate_run reads (the run's size, so no resize)
    edited = load_video(run_dir / "output.mp4")
    source = load_video(run_dir / "output_gt.mp4")
    out = {}
    for backend in ("raft", "farneback"):
        _, model = load_flow_backend(backend, raft_ckpt if backend == "raft" else None)
        fwd = compute_flow_pairs(source, "future", backend, raft=model)[:-1]
        bwd = compute_flow_pairs(source, "past", backend, raft=model)[1:]
        with torch.no_grad():
            _, mask = compute_fwdbwd_mask(torch.from_numpy(fwd).cuda(),
                                          torch.from_numpy(bwd).cuda())
        out[backend] = {"valid_share": float(mask.float().mean())}
        del model
    card = warp_error_ssim(edited, source, flow_fwd=fwd, flow_bwd=bwd)
    cpu = warp_error_ssim(edited, source, flow_fwd=fwd, flow_bwd=bwd, device="cpu")
    out["farneback"].update(card=card, cpu=cpu)
    out["ok"] = (out["farneback"]["valid_share"] >= MIN_VALID_SHARE and card < 1.0
                 and abs(card - cpu) <= WARP_SSIM_TOL)
    return out


def check_eval(raft_ckpt: Path, tmp: Path) -> dict:
    """[eval]: `tclight_torch.evaluate.main` on the main cell's run directory
    with the random RAFT, CLIP, PickScore and LPIPS checkpoints and
    --eval_cost; every row of result.txt (the text rows need a tokenizer
    and are skipped, as in the JAX package), finite; the wall time of each
    metric group; then `check_warp_error`."""
    from tclight_torch import evaluate
    from tclight_torch.ops import kernels

    run_dir = next((OUT / "wd").rglob("output.mp4")).parent
    (run_dir / "result.txt").unlink(missing_ok=True)
    t0 = time.perf_counter()
    dirs = write_eval_checkpoints(tmp)
    write_s = time.perf_counter() - t0
    timings: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    t0 = time.perf_counter()
    rc = evaluate.main(["--output_dir", str(run_dir), "--flow_model", "raft",
                        "--flow_ckpt", str(raft_ckpt), "--clip_ckpt", str(dirs["clip"]),
                        "--pick_ckpt", str(dirs["pick"]), "--lpips_ckpt", str(dirs["lpips"]),
                        "--eval_cost"], timings=timings)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = sum(st.launches for st in kernels.STATS.values())
    rows = dict(line.split(": ", 1) for line in
                (run_dir / "result.txt").read_text().splitlines()[1:])
    finite = all(math.isfinite(float(v)) for k, v in rows.items() if not k.startswith("zz"))
    t0 = time.perf_counter()
    warp = check_warp_error(run_dir, raft_ckpt)
    warp_s = time.perf_counter() - t0
    ok = (rc == 0 and EVAL_ROWS <= rows.keys() and finite and launched == 0
          and rows["zz_flow_backend"] == "raft" and "zz_skipped_metrics" not in rows
          and warp.pop("ok"))
    phase("eval", ok=ok, rows=rows, wall_s=wall, group_s=timings, peak_mem_gb=peak,
          checkpoint_write_s=write_s,
          precision="f32 (the CLI's own setting)",
          kernel_launches=launched, warp_error=warp, warp_check_s=warp_s,
          warp_tol=WARP_SSIM_TOL, min_valid_share=MIN_VALID_SHARE)
    if not ok:
        raise SystemExit("[eval] failed")
    return {"wall_s": wall, "group_s": timings}


# The editing path, background conditioning and single-image relighting.
# Each phase sets the launch counts to 0 before its run through the entry
# point and reads them after; K1 / K2 must have launched where the path
# reaches them (the ControlNet, RMBG and the VAE launch no hand-written
# kernel).
EDIT_PROMPT = "an oil painting of a rolling landscape"
SMALL_EDIT = (4, 64)  # frames and size of the tiny-stack check


def editing_args(work: Path, control: str, extra: list[str]) -> list[str]:
    """The main cell's video and size through `tclight_torch.run` on the
    generic-SD path: inversion and generation of STEPS DDIM steps (the
    cache at every generation timestep), post-optimization off."""
    return ["--config", str(REPO / "configs" / "tclight_default.yaml"),
            "-i", str(OUT / "vid"), "-p", EDIT_PROMPT, "sd_version=1.5",
            f"generation.control={control}", "post_opt.apply_opt=false",
            f"generation.n_timesteps={STEPS}", f"generation.chunk_size={CHUNK}",
            "generation.chunk_ord=mix-4", f"generation.frame_range=[0,{FRAMES},1]",
            f"data.height={HEIGHT}", f"data.width={WIDTH}", "generation.save_frame=false",
            f"inversion.steps={STEPS}", f"inversion.save_steps={STEPS}",
            "inversion.save_intermediate=true", f"inversion.batch_size={FRAMES}",
            f"work_dir={work}"] + extra


def run_entry(tag: str, fn) -> tuple[dict, float, float]:
    """fn() with the launch counts set to 0 before and read after:
    ({kernel: (launches, {launch key: count})}, wall s, peak GiB)."""
    from tclight_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_stats()
    t0 = time.perf_counter()
    rc = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: (v.launches, dict(v.shapes)) for k, v in kernels.STATS.items()}
    if rc not in (0, None):
        raise SystemExit(f"[{tag}] exited {rc}")
    return stats, wall, torch.cuda.max_memory_allocated() / 2**30


def small_sd(dtype, device: str, state_dicts: dict | None = None, in_channels: int = 4):
    """The tiny SD stack with a three-level UNet (channels 32, 64, 64), so
    that PnP's sites sit as on SD1.5's: the conv injection at level 1, the
    Q/K injection at levels 1 and 0 but not level 1's first block; with 5
    input channels, the sd-depth stack."""
    import dataclasses

    from tclight_torch.diffusion.schedulers import DDIMStateScheduler
    from tclight_torch.models.clip_text import CLIPTextConfig
    from tclight_torch.models.unet import UNetConfig
    from tclight_torch.models.vae import VAEConfig
    from tclight_torch.pipeline.iclight import build_iclight

    ucfg = dataclasses.replace(UNetConfig.tiny(in_channels, dtype=dtype),
                               block_out_channels=(32, 64, 64))
    models = build_iclight(ucfg, VAEConfig.tiny(dtype=dtype), CLIPTextConfig.tiny(), 2, 0,
                           state_dicts, device)
    return dataclasses.replace(models, model_key="depth" if in_channels == 5 else "1.5",
                               scheduler=DDIMStateScheduler(num_inference_steps=2))


def small_editing_eps(control: str, weights: dict, device: str, dtype, x: np.ndarray,
                      src: np.ndarray, frames: np.ndarray, hooks: bool = True,
                      annotator: str | None = None, depth: np.ndarray | None = None
                      ) -> np.ndarray:
    """The Generator's guided noise prediction for one chunk of the
    editing path on `small_sd` at the first of 2 DDIM timesteps, merge
    ratios 0: PnP's [source | uncond | cond] batch with the conv and Q/K
    injection, as at a first step (`hooks` False: the Q/K injection off);
    a ControlNet's residuals of `frames`' control images (`hooks` False:
    times 0; a model-backed type's annotator from the checkpoint
    `annotator`, run on `device`); or, for control "none" with `depth`,
    the sd-depth stack's plain CFG batch with the depth maps as the fifth
    channel (`hooks` False: the depth channel 0)."""
    from tclight_torch.config import ConfigDict
    from tclight_torch.models.controlnet import ControlNetModel
    from tclight_torch.pipeline.generator import Generator
    from tclight_torch.pipeline.iclight import encode_prompt, encode_prompt_pair

    models = small_sd(dtype, device, weights, 4 if depth is None else 5)
    if control not in ("pnp", "none"):
        with torch.device(device):
            models.controlnet = ControlNetModel(models.unet.config)
        models.controlnet.load_state_dict(weights["controlnet"])
        models.controlnet.eval().requires_grad_(False)
    n = len(x)
    gen = Generator(models, ConfigDict({
        "sd_version": "1.5" if depth is None else "depth",
        "generation": {"control": control, "n_timesteps": 2, "chunk_size": n,
                       "local_merge_ratio": 0.0, "global_merge_ratio": 0.0,
                       "control_scale": 1.0 if hooks else 0.0, "annotator_ckpt": annotator,
                       "negative_prompt": "blurry", "save_frame": False},
        "post_opt": {"apply_opt": False}, "seed": 0}), device=device)
    t = float(gen.scheduler.timesteps()[0])
    xt, st = (torch.from_numpy(a).to(device) for a in (x, src))
    cc = torch.zeros(xt.shape[:3] + (0,), device=device)
    if depth is not None:
        cc = torch.from_numpy(depth * (1.0 if hooks else 0.0)).to(device)
    with torch.inference_mode():
        cond, uncond = encode_prompt_pair(gen.models, EDIT_PROMPT, gen.negative_prompt)
        if control == "pnp":
            embeds = (encode_prompt(gen.models, ""), uncond, cond)
            eps, _ = gen._pred_chunk_pnp(xt, st, cc, embeds, t, 0, False, None, False,
                                         pnp_attn=hooks, pnp_conv=True)
        elif control == "none":
            eps, _ = gen._pred_chunk(gen.models, xt, cc, (uncond, cond), t, 0, False, None,
                                     False)
        else:
            eps, _ = gen._pred_chunk_ctrl(xt, cc, gen.control_images(frames), (uncond, cond),
                                          t, 0, False, None, False)
    return eps.float().cpu().numpy()


def random_annotator(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random annotator weights at flax's scales (`init_like_flax`); HED's
    `norm` a mid grey, so its logits stay on the sigmoid's slope."""
    from tclight_torch.models.hed import ControlNetHED
    from tclight_torch.pipeline.iclight import init_like_flax

    init_like_flax(module, torch.Generator().manual_seed(seed))
    if isinstance(module, ControlNetHED):
        with torch.no_grad():
            module.norm.copy_(torch.tensor([120.0, 110.0, 100.0]).reshape(1, 1, 1, 3))
    return module.eval().requires_grad_(False)


def check_small_editing(control: str) -> dict:
    """One noise prediction of the editing path (`small_editing_eps`) over
    4 frames of 64 x 64 (32 x 32 latents: K1 at the merged levels 0 and 1
    and at the ControlNet's per-frame level 0; K2 runs, merging nothing),
    from the same random latents on the CPU in f32 (the reference), on the
    CPU in bf16 (the plain versions) and on the card in bf16 (K1, K2).
    `control` is pnp, canny, softedge (HED control images from a random
    full-width HED checkpoint, computed in f32 on each device) or sd-depth
    (the 5-channel stack, its depth channel a tiny random DPT's maps of
    the frames, made once on the CPU). Each error is the relative RMS
    difference from the reference (the max abs differences are printed
    beside them, not checked). `fault` is the reference's own difference
    with the Q/K injection off (PnP), without the ControlNet's residuals,
    or with the depth channel 0: the size of the error that a K1 or K2
    wrong on the three-way batch, on the ControlNet's frames or on the
    depth stack makes. The card may differ by 1.5 times the CPU's bf16
    error (the card's bf16 rounds at other places), and `fault` must be
    at least twice that limit, so the check sees an error half its
    size."""
    from tclight_torch.models import dpt, hed
    from tclight_torch.models.controlnet import ControlNetModel
    from tclight_torch.ops import kernels
    from tclight_torch.pipeline.iclight import init_like_flax

    n, size = SMALL_EDIT
    ref_models = small_sd(torch.float32, "cpu", in_channels=5 if control == "sd-depth" else 4)
    weights = {k: getattr(ref_models, k).state_dict() for k in ("unet", "vae", "text_encoder")}
    kind, extra = control, {}
    if control == "sd-depth":
        kind = "none"
    if control not in ("pnp", "sd-depth"):
        net = ControlNetModel(ref_models.unet.config)
        init_like_flax(net, torch.Generator().manual_seed(1))
        weights["controlnet"] = net.state_dict()
    f = 2 ** (len(ref_models.vae.config.block_out_channels) - 1)
    rng = np.random.default_rng(11)
    x, src = (rng.standard_normal((n, size // f, size // f, 4)).astype(np.float32)
              for _ in range(2))
    base = rng.uniform(0.2, 0.8, (size, size, 3)).astype(np.float32)
    frames = np.stack([np.roll(base, 3 * t, axis=1) for t in range(n)])

    if control == "sd-depth":
        net = dpt.random_dpt(dpt.DPTConfig.tiny_hybrid(), seed=2, device="cpu")
        extra["depth"] = dpt.prepare_depth_maps(net, frames, (size // f, size // f),
                                                input_size=64)

    def rel(a: np.ndarray, ref: np.ndarray) -> float:
        return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))

    def eps(device, dtype, hooks=True):
        return small_editing_eps(kind, weights, device, dtype, x, src, frames, hooks, **extra)

    OUT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        if control == "softedge":
            extra["annotator"] = str(Path(tmp) / "hed.pth")
            torch.save(hed.reference_state_dict(random_annotator(hed.ControlNetHED(), 3)),
                       extra["annotator"])
        ref = eps("cpu", torch.float32)
        plain_eps = eps("cpu", torch.bfloat16)
        plain = rel(plain_eps, ref)
        fault = rel(eps("cpu", torch.float32, hooks=False), ref)
        kernels.reset_stats()
        card_eps = eps("cuda", torch.bfloat16)
    launches = {k: kernels.STATS[k].launches for k in ("flash_attention", "online_argmax_scores")}
    card = rel(card_eps, ref) if np.isfinite(card_eps).all() else float("inf")
    tol = 1.5 * plain
    return dict(small_ok=card <= tol and fault >= 2 * tol and launches["flash_attention"] > 0,
                small_eps_rel_err=card, small_cpu_bf16_rel_err=plain, small_tol=tol,
                small_fault_rel=fault, small_launches=launches,
                small_eps_max_abs_err=float(np.abs(card_eps - ref).max()),
                small_cpu_bf16_max_abs_err=float(np.abs(plain_eps - ref).max()))


def editing_phase(tag: str, control: str, extra: list[str], fields: dict) -> dict:
    """One editing run through `tclight_torch.run.main`, then its checks:
    the mp4 of every frame, the inversion cache at every generation
    timestep, K1 and K2 launched, the small check of one noise prediction
    (`check_small_editing`); one phase line. Returns the run's launch
    stats."""
    import yaml

    from tclight_torch.diffusion.schedulers import DDIMStateScheduler
    from tclight_torch.pipeline.invert import check_latent_exists
    from tclight_torch.run import main

    work = OUT / f"wd_{tag}"
    stats, wall, peak = run_entry(tag, lambda: main(editing_args(work, control, extra)))
    mp4 = next(work.rglob("output.mp4"))
    n, shape = read_mp4(mp4)
    st = yaml.safe_load((mp4.parent / "config.yaml").read_text())["stage_times"]
    ts = DDIMStateScheduler(num_inference_steps=STEPS).timesteps()
    cached = all(check_latent_exists(work / "latents", t, range(FRAMES)) for t in ts)
    small = check_small_editing(control)
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and cached and flash[0] > 0
          and match[0] > 0 and small["small_ok"])
    phase(tag, ok=ok, frames=n, frame_shape=shape, wall_s=wall,
          inversion_s=st["inversion"], sampling_s=st["sampling"],
          step_s=st["step_times"], encode_s=st["encode"], decode_s=st["decode"],
          peak_mem_gb=peak, flash_launches=flash[0], match_launches=match[0],
          flash_shapes=sorted(flash[1].items()), match_shapes=sorted(match[1].items()),
          cache_complete=cached, **small, **fields)
    if not ok:
        raise SystemExit(f"[{tag}] failed")
    return stats


def run_pnp() -> dict:
    """[pnp]: the generic SD1.5 stack (4-channel UNet, bf16) on random
    weights: the inversion of the main cell's 8 frames, 4 DDIM steps with
    the cache at each, then PnP generation (pnp_attn_t 0.5, pnp_f_t 0.8)
    over [source | uncond | cond] chunks."""
    return editing_phase("pnp", "pnp", ["--full-width-random", "generation.pnp_attn_t=0.5",
                                        "generation.pnp_f_t=0.8"],
                         {"pnp_attn_steps": int(STEPS * 0.5), "pnp_conv_steps": int(STEPS * 0.8)})


def run_controlnet(tmp: Path) -> dict:
    """[controlnet]: the same stack and a canny ControlNet on random
    weights, written by the port's exporters as a checkpoint directory
    (bf16 safetensors) and loaded through `load_sd(model_dir,
    control="canny")` by the CLI; inversion, then ControlNet generation."""
    from tclight_torch.models.controlnet import ControlNetModel
    from tclight_torch.pipeline.iclight import (build_full_width_random_sd, init_like_flax,
                                               write_model_dir)

    t0 = time.perf_counter()
    models = build_full_width_random_sd(num_inference_steps=STEPS)
    with torch.device("cuda"):
        models.controlnet = ControlNetModel(models.unet.config)
    init_like_flax(models.controlnet, torch.Generator(device="cuda").manual_seed(5))
    write_model_dir(models, tmp / "sd15", control="canny", dtype=torch.bfloat16)
    size_gb = sum(p.stat().st_size for p in (tmp / "sd15").iterdir()) / 2**30
    write_s = time.perf_counter() - t0
    del models
    torch.cuda.empty_cache()
    return editing_phase("controlnet", "canny", [f"model_dir={tmp / 'sd15'}"],
                         {"model_dir_gb": size_gb, "write_s": write_s})


def run_bkgd(tmp: Path) -> dict:
    """[bkgd]: the fbc (12-channel) IC-Light stack on random weights with
    background_cond over a synthetic background video and a random RMBG
    reference checkpoint, through `tclight_torch.run.main` (4 DPM++ steps,
    post-optimization off): the saved ground truth is the composite of the
    source over the background through the card's mattes (nearer it than
    the source by 2x at least); RMBG's mattes on the card against the CPU on a
    small frame (f32 both, within 1e-4); `random_rmbg`'s mattes spread, on
    the frames and on the small frame: half their values at least lie in
    (0.01, 0.99); RMBG's ms at the 720 x 960 frames' working size (896 x
    1152)."""
    import cv2
    import yaml

    from tclight_torch.models.briarmbg import (compute_alpha_mattes, load_rmbg, random_rmbg,
                                               reference_state_dict, working_size)
    from tclight_torch.run import main
    from tclight_torch.utils.device import full_f32
    from tclight_torch.utils.video_io import save_frames

    ckpt = tmp / "rmbg.pth"
    torch.save(reference_state_dict(random_rmbg(0, "cpu")), ckpt)
    bg_dir = OUT / "bg"
    rng = np.random.default_rng(7)
    # a dark background, far from the source's mid-grey texture, so the
    # composite stands clear of the source beyond the mp4's coding error
    base = 0.05 + 0.1 * cv2.GaussianBlur(
        rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32), (0, 0), 9)
    save_frames(np.stack([np.roll(base, -3 * t, axis=0) for t in range(3)]), bg_dir)
    work = OUT / "wd_bkgd"
    args = main_args(work, False) + [
        "generation.background_cond=true", f"generation.background_image_path={bg_dir}",
        f"generation.rmbg_ckpt={ckpt}", "generation.save_frame=false"]
    stats, wall, peak = run_entry("bkgd", lambda: main(args))
    mp4 = next(work.rglob("output.mp4"))
    n, shape = read_mp4(mp4)
    st = yaml.safe_load((mp4.parent / "config.yaml").read_text())["stage_times"]
    cap = cv2.VideoCapture(str(mp4.parent / "output_gt.mp4"))
    gt = []
    while True:
        ok_read, frame = cap.read()
        if not ok_read:
            break
        gt.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
    cap.release()
    source = read_frames(OUT / "vid")
    model_cuda = load_rmbg(ckpt, "cuda")
    model_cpu = load_rmbg(ckpt, "cpu")
    # the saved ground truth (an 8-bit mp4) against the composite of the
    # source over the background with the card's mattes, and against the
    # source itself
    alpha = compute_alpha_mattes(model_cuda, source)[..., None]
    bgs = read_frames(bg_dir)
    composite = alpha * source + (1 - alpha) * np.concatenate([bgs] * 3)[:FRAMES]
    gt = np.stack(gt) if len(gt) == FRAMES else np.zeros_like(source)
    to_composite = float(np.abs(gt - composite).mean())
    to_source = float(np.abs(gt - source).mean())
    small = source[:1, :96, :128]
    small_cpu = compute_alpha_mattes(model_cpu, small)
    err = float(np.abs(compute_alpha_mattes(model_cuda, small) - small_cpu).max())
    # the share of matte values off the sigmoid's flat ends: the mattes
    # compared are neither saturated nor flat
    spread = float(((small_cpu > 0.01) & (small_cpu < 0.99)).mean())
    alpha_spread = float(((alpha > 0.01) & (alpha < 0.99)).mean())
    rh, rw = working_size(HEIGHT, WIDTH)
    x = torch.rand(1, rh, rw, 3, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)) * 255.0
    with full_f32(), torch.inference_mode():
        rmbg_ms = cuda_ms(lambda: model_cuda(x), 5)
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and to_composite < 0.5 * to_source
          and err <= 1e-4 and spread >= 0.5 and alpha_spread >= 0.5
          and flash[0] > 0 and match[0] > 0)
    phase("bkgd", ok=ok, frames=n, frame_shape=shape, wall_s=wall, sampling_s=st["sampling"],
          step_s=st["step_times"], encode_s=st["encode"], peak_mem_gb=peak,
          gt_mean_abs_diff_vs_composite=to_composite, gt_mean_abs_diff_vs_source=to_source,
          matte_share_in_0_01_0_99=alpha_spread, rmbg_card_vs_cpu_max_abs_err=err,
          rmbg_small_share_in_0_01_0_99=spread, rmbg_ms=rmbg_ms, rmbg_shape=f"1x{rh}x{rw}",
          precision="f32 (full f32 on the card)", flash_launches=flash[0],
          match_launches=match[0])
    if not ok:
        raise SystemExit("[bkgd] failed")
    return stats


def run_single_image() -> dict:
    """[single-image]: `SingleImageRelighter.process` (fc, 8-channel) at
    512 x 640 (the demo's width / height), 4 steps, then the 1.5x
    high-resolution img2img pass (768 x 960, denoise 0.5); then
    `process_bg` (fbc, 12-channel) with an uploaded background, the same
    way; full-width random stacks in bf16."""
    from tclight_torch.pipeline.iclight import build_full_width_random
    from tclight_torch.pipeline.single_image import (BGSource, BGSourceFBC,
                                                     SingleImageRelighter)

    rng = np.random.default_rng(3)
    fg = read_frames(OUT / "vid")[0]
    bg = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    out, launches, shapes = {}, {}, {}
    for mode in ("fc", "fbc"):
        models = build_full_width_random(num_inference_steps=STEPS,
                                         in_channels=8 if mode == "fc" else 12)
        relight = SingleImageRelighter(models, steps=STEPS)
        kw = dict(seed=1, highres_scale=1.5, highres_denoise=0.5, image_width=512,
                  image_height=640)

        def fn():
            if mode == "fc":
                out[mode] = relight.process(fg, PROMPT, BGSource.NONE, **kw)
            else:
                out[mode] = relight.process_bg(fg, bg, PROMPT, BGSourceFBC.UPLOAD, **kw)

        stats, wall, peak = run_entry(f"single-image-{mode}", fn)
        img, flash = out[mode], stats["flash_attention"]
        ok = img.shape == (960, 768, 3) and np.isfinite(img).all() and flash[0] > 0
        phase("single-image", ok=ok, mode=mode, out_shape=img.shape, wall_s=wall,
              peak_mem_gb=peak, flash_launches=flash[0], flash_shapes=sorted(flash[1].items()),
              match_launches=stats["online_argmax_scores"][0])
        if not ok:
            raise SystemExit(f"[single-image] {mode} failed")
        for k, (n, by_key) in stats.items():
            launches[k] = launches.get(k, 0) + n
            counts = shapes.setdefault(k, {})
            for key, count in by_key.items():
                counts[key] = counts.get(key, 0) + count
        del models, relight
        torch.cuda.empty_cache()
    return {k: (launches[k], shapes[k]) for k in launches}


def run_depth(tmp: Path) -> dict:
    """[depth]: `tclight_torch.run.main` with sd_version depth on the SD1.5-
    shaped 5-channel stack (bf16, random weights) and a random DPT-Hybrid
    at its published widths written as a transformers-keyed `depth_ckpt`:
    the inversion of the main cell's 8 frames (4 DDIM steps, the cache at
    each, the depth channel from the DPT), then generation (4 steps);
    checks the mp4, the cache, the depth cache (per frame -1 .. 1), K1 and
    K2 launched, and the small sd-depth check (`check_small_editing`);
    DPT's ms a frame at 384 x 384 (batch 4, as `prepare_depth_maps` runs
    it) and its maps of two frames on the card against the CPU (f32 both,
    within 1e-3 after the per-frame normalisation)."""
    import yaml

    from tclight_torch.diffusion.schedulers import DDIMStateScheduler
    from tclight_torch.models import dpt
    from tclight_torch.pipeline.invert import check_latent_exists
    from tclight_torch.run import main
    from tclight_torch.utils.device import full_f32

    ckpt = tmp / "dpt_hybrid.pth"
    torch.save(dpt.reference_state_dict(dpt.random_dpt(dpt.DPTConfig.hybrid(), 4, "cpu")), ckpt)
    work = OUT / "wd_depth"
    args = editing_args(work, "none", ["--full-width-random", "sd_version=depth",
                                       f"generation.depth_ckpt={ckpt}"])
    stats, wall, peak = run_entry("depth", lambda: main(args))
    mp4 = next(work.rglob("output.mp4"))
    n, shape = read_mp4(mp4)
    st = yaml.safe_load((mp4.parent / "config.yaml").read_text())["stage_times"]
    ts = DDIMStateScheduler(num_inference_steps=STEPS).timesteps()
    cached = all(check_latent_exists(work / "latents", t, range(FRAMES)) for t in ts)
    depth = np.load(work / "depth" / f"depth_{FRAMES}_{HEIGHT // 8}x{WIDTH // 8}.npy")
    depth_ok = (depth.shape == (FRAMES, HEIGHT // 8, WIDTH // 8, 1)
                and np.allclose(depth.min(axis=(1, 2, 3)), -1.0)
                and np.allclose(depth.max(axis=(1, 2, 3)), 1.0))
    model_cuda, model_cpu = dpt.load_dpt(ckpt, "cuda"), dpt.load_dpt(ckpt, "cpu")
    x = torch.rand(4, 384, 384, 3, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)) * 2 - 1
    with full_f32(), torch.inference_mode():
        dpt_ms = cuda_ms(lambda: model_cuda(x), 5) / 4
    frames = read_frames(OUT / "vid")[:2]
    card = dpt.prepare_depth_maps(model_cuda, frames, (HEIGHT // 8, WIDTH // 8))
    cpu = dpt.prepare_depth_maps(model_cpu, frames, (HEIGHT // 8, WIDTH // 8))
    err = float(np.abs(card - cpu).max())
    small = check_small_editing("sd-depth")
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and cached and depth_ok
          and err <= 1e-3 and flash[0] > 0 and match[0] > 0 and small["small_ok"])
    phase("depth", ok=ok, frames=n, frame_shape=shape, wall_s=wall,
          inversion_s=st["inversion"], sampling_s=st["sampling"], step_s=st["step_times"],
          encode_s=st["encode"], decode_s=st["decode"], peak_mem_gb=peak,
          dpt="hybrid (random, published widths)", dpt_ms_per_frame_384=dpt_ms,
          depth_card_vs_cpu_max_abs_err=err, depth_tol=1e-3, depth_cache=list(depth.shape),
          cache_complete=cached, flash_launches=flash[0], match_launches=match[0],
          flash_shapes=sorted(flash[1].items()), match_shapes=sorted(match[1].items()), **small)
    if not ok:
        raise SystemExit("[depth] failed")
    del model_cuda, model_cpu, x
    torch.cuda.empty_cache()
    return stats


def run_annotators(tmp: Path) -> dict:
    """[annotators]: HED, the lineart_anime U-Net (ngf 64, 8 downs) and the
    OpenPose body net at their published widths on random weights, each
    written as a reference checkpoint and loaded by its `*_model_fn` on
    the card: the main cell's 8 frames (ms a frame, peak memory), and the
    first frame on the card against the CPU (f32 both: HED's edges and
    the lineart maps, OpenPose's upsampled heatmaps and PAFs, within 1e-4
    of their largest magnitude). Then `tclight_torch.run.main` with
    control=softedge on the generic SD1.5 stack of [controlnet]'s
    checkpoint directory (`tmp/sd15`) and a softedge ControlNet on random
    weights written beside it, the HED of `annotator_ckpt`; with the small
    softedge check (`check_small_editing`)."""
    import yaml

    from tclight_torch.diffusion.schedulers import DDIMStateScheduler
    from tclight_torch.models import controlnet, hed, lineart, openpose
    from tclight_torch.models.convert import write_safetensors
    from tclight_torch.models.unet import UNetConfig
    from tclight_torch.pipeline.iclight import init_like_flax
    from tclight_torch.pipeline.invert import check_latent_exists
    from tclight_torch.run import main

    frames = read_frames(OUT / "vid")
    nets = {"softedge": (hed.ControlNetHED(), hed.reference_state_dict, hed.softedge_model_fn),
            "lineart_anime": (lineart.LineartAnimeUNet(64, 8), lineart.reference_state_dict,
                              lineart.lineart_model_fn),
            "openpose": (openpose.BodyPoseNet(), openpose.reference_state_dict,
                         openpose.openpose_model_fn)}
    rows, ckpts = {}, {}
    for seed, (kind, (net, export, make_fn)) in enumerate(nets.items()):
        ckpts[kind] = tmp / f"{kind}.pth"
        torch.save(export(random_annotator(net, 20 + seed)), ckpts[kind])
        torch.cuda.reset_peak_memory_stats()
        fn = make_fn(ckpts[kind], device="cuda")
        fn(frames[:1])  # the first call's set-up (cuDNN's plans) outside the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(frames)
        ms = (time.perf_counter() - t0) / FRAMES * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        if kind == "openpose":
            card_model = openpose.load_bodypose(ckpts[kind], device="cuda")
            cpu_model = openpose.load_bodypose(ckpts[kind], device="cpu")
            card_maps = np.concatenate(openpose.body_maps(card_model, frames[0]), -1)
            ref = np.concatenate(openpose.body_maps(cpu_model, frames[0]), -1)
            err = float(np.abs(card_maps - ref).max())
        else:
            ref = make_fn(ckpts[kind], device="cpu")(frames[:1])
            err = float(np.abs(out[:1] - ref).max())
        tol = 1e-4 * float(np.abs(ref).max())
        rows[kind] = dict(ms_per_frame=ms, peak_mem_gb=peak, card_vs_cpu_max_abs_err=err,
                          tol=tol, out_shape=list(out.shape), out_mean=float(out.mean()))
        ok = out.shape == (FRAMES, HEIGHT, WIDTH, 3) and np.isfinite(out).all() and err <= tol
        phase("annotator", ok=ok, kind=kind, precision="f32 (full f32 on the card)",
              **rows[kind])
        if not ok:
            raise SystemExit(f"[annotator] {kind} failed")
        del fn
        torch.cuda.empty_cache()

    model_dir = tmp / "sd15"  # [controlnet]'s stack
    with torch.device("cuda"):
        net = controlnet.ControlNetModel(UNetConfig.sd15(in_channels=4))
    init_like_flax(net, torch.Generator(device="cuda").manual_seed(6))
    write_safetensors({k: v.to(torch.bfloat16) for k, v in
                       controlnet.reference_state_dict(net).items()},
                      model_dir / "controlnet_softedge.safetensors")
    del net
    torch.cuda.empty_cache()
    work = OUT / "wd_softedge"
    args = editing_args(work, "softedge", [f"model_dir={model_dir}",
                                           f"generation.annotator_ckpt={ckpts['softedge']}"])
    stats, wall, peak = run_entry("annotators", lambda: main(args))
    mp4 = next(work.rglob("output.mp4"))
    n, shape = read_mp4(mp4)
    st = yaml.safe_load((mp4.parent / "config.yaml").read_text())["stage_times"]
    ts = DDIMStateScheduler(num_inference_steps=STEPS).timesteps()
    cached = all(check_latent_exists(work / "latents", t, range(FRAMES)) for t in ts)
    small = check_small_editing("softedge")
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    ok = (n == FRAMES and shape == (HEIGHT, WIDTH, 3) and cached and flash[0] > 0
          and match[0] > 0 and small["small_ok"])
    phase("softedge", ok=ok, frames=n, frame_shape=shape, wall_s=wall,
          inversion_s=st["inversion"], sampling_s=st["sampling"], step_s=st["step_times"],
          encode_s=st["encode"], peak_mem_gb=peak, cache_complete=cached,
          flash_launches=flash[0], match_launches=match[0],
          flash_shapes=sorted(flash[1].items()), match_shapes=sorted(match[1].items()), **small)
    if not ok:
        raise SystemExit("[softedge] failed")
    return stats


UPSAMPLER_SMALL_SIDE = 128  # the 2-layer check's image: 8 x 8 patches


def small_vlm_configs(dtype: torch.dtype):
    """Pixtral-12B's decoder and ViT at their published widths, 2 layers
    each; the decoder in `dtype`, the ViT in f32."""
    import dataclasses

    from tclight_torch.models.ar_transformer import ARConfig
    from tclight_torch.models.pixtral import ViTConfig

    return (dataclasses.replace(ARConfig.pixtral_12b(), n_layers=2, dtype=dtype),
            dataclasses.replace(ViTConfig(), n_layers=2))


def rel_rms(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2) / np.mean(ref ** 2)))


def check_small_upsampler(tmp: Path) -> dict:
    """The upsampler at full width and 2 layers (decoder and ViT): random
    f32 weights made on the card; the prompt logits (BOS, 64 [IMG] from a
    128 x 128 image, the instruction) of the bf16 decoder on the card
    against the f32 model on the CPU, within 1.5 times the CPU bf16
    decoder's own error (relative RMS); the f32 model on the card: 16
    greedy tokens decoded against the static cache equal those of
    recomputing the whole sequence at each step; the bf16 model written as
    a cosmos-native `model.pt` and as HF-keyed safetensors under `tmp` and
    read back by `load_vlm`: the same parameters and logits."""
    from tclight_torch.models import convert_ar, pixtral
    from tclight_torch.models.ar_transformer import ARGenerator
    from tclight_torch.models.convert import write_safetensors
    from tclight_torch.pipeline.iclight import DummyTokenizer

    cfg32, vcfg = small_vlm_configs(torch.float32)
    cfg16, _ = small_vlm_configs(torch.bfloat16)
    base = pixtral.build_vlm(cfg32, vcfg, seed=3, device="cuda")
    sds = {name: {k: v.cpu() for k, v in getattr(base, name).state_dict().items()}
           for name in ("text", "vit", "projector")}
    side = UPSAMPLER_SMALL_SIDE
    img = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(1, side, side, 3)).astype(np.float32))
    ids = pixtral.prepare_dialog_tokens(DummyTokenizer(), (side // 16) ** 2)

    @torch.inference_mode()
    def logits_of(vlm):
        return vlm.text(embeddings=vlm.embed_vision_language(ids, img))[0].float().cpu().numpy()

    # 16 greedy tokens against the cache and by recomputing, f32 on the card
    emb = base.embed_vision_language(ids, img)
    cached = ARGenerator(base.text).generate(prompt_embeddings=emb, max_gen_len=16,
                                             temperature=0.0)
    seq, recomputed = emb, []
    with torch.inference_mode():
        for _ in range(16):
            tok = base.text(embeddings=seq)[0][:, -1].argmax(-1)
            recomputed.append(int(tok))
            seq = torch.cat([seq, base.text.embed(tok[:, None])], dim=1)
    cache_ok = cached[0].tolist() == recomputed
    del base, emb, seq
    torch.cuda.empty_cache()
    ref = logits_of(pixtral.build_vlm(cfg32, vcfg, state_dicts=sds, device="cpu"))
    plain = rel_rms(logits_of(pixtral.build_vlm(cfg16, vcfg, state_dicts=sds, device="cpu")), ref)
    card_vlm = pixtral.build_vlm(cfg16, vcfg, state_dicts=sds, device="cuda")
    card_logits = logits_of(card_vlm)
    card = rel_rms(card_logits, ref) if np.isfinite(card_logits).all() else float("inf")
    tol = 1.5 * plain
    # both checkpoint layouts through load_vlm
    load_err, load_params_equal = {}, True
    for layout in ("cosmos", "hf"):
        d = tmp / f"vlm_{layout}"
        d.mkdir()
        sd = convert_ar.reference_state_dict(card_vlm, layout)
        if layout == "cosmos":
            torch.save(sd, d / "model.pt")
        else:
            write_safetensors(sd, d / "model.safetensors")
        del sd
        loaded = pixtral.load_vlm(d, cfg16, vcfg, device="cuda")
        for name in ("text", "vit", "projector"):
            back = getattr(loaded, name).state_dict()
            load_params_equal &= all(torch.equal(back[k], v)
                                     for k, v in getattr(card_vlm, name).state_dict().items())
        load_err[layout] = float(np.abs(logits_of(loaded) - card_logits).max())
        del loaded
        for f in d.iterdir():
            f.unlink()
        torch.cuda.empty_cache()
    del card_vlm
    torch.cuda.empty_cache()
    ok = (card <= tol and cache_ok and load_params_equal
          and all(e == 0.0 for e in load_err.values()))
    return dict(small_ok=ok, small_layers=2, small_prompt_tokens=int(ids.shape[1]),
                small_logits_rel_err=card, small_cpu_bf16_rel_err=plain, small_tol=tol,
                small_cache_tokens=cached[0].tolist(), small_recompute_tokens=recomputed,
                small_cache_equals_recompute=cache_ok, load_params_equal=load_params_equal,
                load_logits_max_abs_diff=load_err)


def run_upsampler() -> dict:
    """[upsampler]: Pixtral-12B at its published widths on random weights
    made on the card (decoder bf16, ViT f32): the main cell's last 720 x 960
    frame, 45 x 60 = 2,700 image tokens and the instruction, through
    `pixtral.upsample_tokens` with the DummyTokenizer (400 tokens at
    temperature 0.01, top-p 0.9). Checks: finite prompt logits; 16 greedy
    steps against the cache vs recomputing the sequence without it (bf16:
    each step's logits within 25% relative RMS, where a wrong cache gives
    ~140%, and the argmax agreement printed); then `check_small_upsampler`.
    Prints the parameter count and bytes, the ViT's ms, prefill ms, ms per
    decoded token beside its byte bound (every decoder weight but the
    embedding table, which one row of is read, and the KV cache of all
    max_seq_len slots, which JAX's attention reads), and peak memory."""
    from tclight_torch.models import pixtral
    from tclight_torch.models.ar_transformer import ARConfig, init_cache
    from tclight_torch.pipeline.iclight import DummyTokenizer

    cfg, vcfg = ARConfig.pixtral_12b(), pixtral.ViTConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vlm = pixtral.build_vlm(cfg, vcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    count = {name: sum(p.numel() for p in getattr(vlm, name).parameters())
             for name in ("text", "vit", "projector")}
    nbytes = {name: sum(p.numel() * p.element_size() for p in getattr(vlm, name).parameters())
              for name in ("text", "vit", "projector")}
    tok = DummyTokenizer()
    frames = read_frames(OUT / "vid")
    img = torch.from_numpy(np.ascontiguousarray(pixtral.upsampler_image(frames))).cuda()
    n_img = (img.shape[1] // 16) * (img.shape[2] // 16)
    ids = pixtral.prepare_dialog_tokens(tok, n_img)
    with torch.inference_mode():
        vit_ms = cuda_ms(lambda: vlm.vit(img), 3)
        emb = vlm.embed_vision_language(ids, img)
        s = emb.shape[1]
        state = {"caches": init_cache(cfg, 1, "cuda")}

        def prefill():
            state["logits"], state["caches"] = vlm.text(embeddings=emb, caches=state["caches"],
                                                        cur_len=0)

        # the prefill and 8 decode steps traced: device time by kernel group
        # and the device's busy share of the traced wall
        profile_window("profile-upsampler-prefill", prefill, 1, "prefill")
        finite = bool(torch.isfinite(state["logits"]).all())
        step_logits = [state.pop("logits")[:, -1]]
        toks = [step_logits[0].argmax(-1)]

        first = torch.full((1,), s, device="cuda")

        def steps(lo, hi):  # as ARGenerator steps, greedy
            for i in range(lo, hi):
                lg, state["caches"] = vlm.text(
                    tokens=toks[-1][:, None], caches=state["caches"], cur_len=s + i - 1,
                    positions=first + (i - 1))
                step_logits.append(lg[:, -1])
                toks.append(lg[:, -1].argmax(-1))

        steps(1, 8)
        profile_window("profile-upsampler-decode", lambda: steps(8, 16), 8, "token")
        del state
        errs, agree = [], 0
        seq = emb
        for i in range(16):
            lg = vlm.text(embeddings=seq)[0][:, -1]
            errs.append(rel_rms(step_logits[i].cpu(), lg.cpu()))
            agree += int(lg.argmax(-1) == toks[i])
            seq = torch.cat([seq, vlm.text.embed(toks[i][:, None])], dim=1)
        del seq, emb, step_logits
    torch.cuda.empty_cache()
    cache_ok = max(errs) <= 0.25
    out = {}

    def generate():
        out["tokens"] = pixtral.upsample_tokens(vlm, tok, frames, max_gen_len=400)

    stats, wall, _ = run_entry("upsampler", generate)
    times = vlm.last_times
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a decode step reads every decoder weight but the embedding table (one
    # row of it) and the whole KV cache; its products are 2 flops a weight
    emb = vlm.text.tok_embeddings.weight
    weights = count["text"] - emb.numel()
    kv_bytes = 2 * cfg.n_layers * cfg.max_seq_len * cfg.n_kv_heads * cfg.hd * emb.element_size()
    step_bytes = nbytes["text"] - emb.numel() * emb.element_size() + cfg.dim * 2 + kv_bytes
    decode_ms = times["decode_s"] / times["decode_steps"] * 1e3
    decode_bound_ms, decode_by = bound_ms(step_bytes, 2.0 * weights)
    prompt = times["prompt_tokens"]
    prefill_flops = (2.0 * weights * prompt
                     + 4.0 * cfg.n_layers * cfg.n_heads * prompt * cfg.max_seq_len * cfg.hd)
    prefill_bound_ms, prefill_by = bound_ms(nbytes["text"], prefill_flops)
    del vlm
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        small = check_small_upsampler(Path(tmp))
    flash, match = stats["flash_attention"], stats["online_argmax_scores"]
    ok = finite and cache_ok and small["small_ok"] and flash[0] == 0 and match[0] == 0
    phase("upsampler", ok=ok, params=count, param_gb={k: v / 1e9 for k, v in nbytes.items()},
          build_s=build_s, image=list(img.shape), image_tokens=n_img, prompt_tokens=prompt,
          vit_ms=vit_ms, embed_s=times["embed_s"], prefill_ms=times["prefill_s"] * 1e3,
          prefill_bound_ms=prefill_bound_ms, prefill_bound_by=prefill_by,
          decode_steps=times["decode_steps"], tokens_out=int(out["tokens"].shape[1]),
          decode_ms_per_token=decode_ms,
          decode_bound_ms=decode_bound_ms, decode_bound_by=decode_by,
          decode_step_gb=step_bytes / 1e9, wall_s=wall, peak_mem_gb=peak,
          logits_finite=finite, cache_vs_recompute_rel_rms_max=max(errs),
          cache_vs_recompute_argmax_agree=f"{agree}/16", flash_launches=flash[0],
          match_launches=match[0], **small)
    if not ok:
        raise SystemExit("[upsampler] failed")
    return stats


# ---------------------------------------------------------------- multi-device, Cosmos

DIT_K1_LAUNCH_KEYS = {}  # tag -> K1 launch keys of the Cosmos paths (filled by the phases)


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def check_parallel(gen: torch.Generator) -> dict:
    """[parallel]: the port's collective code in a world of one rank over
    NCCL on the card (the machine has one H100; the multi-rank semantics
    are held on CPU gloo worlds in tests/test_torch_parallel.py). Each step
    runs with the mesh and without a process group, and must agree bit for
    bit, or within one bf16 step: the parallel denoise step on the tiny
    UNet in bf16 at 48 x 48 latents (ToMe merges, K1, K2; the round's
    noises all-gathered, its banks broadcast), `run_exposure_align` and
    `run_uvt` on 8 frames of 96 x 128 with radius warps (K3) on the banded
    route (K4), `run_uvt` on turnover ids (K5), one update of each sharded
    step builder (gradients and losses all-reduced), and the
    context-parallel DiT forward of `small_dit` (K1; K and V all-gathered
    before each self-attention). A mesh's collectives run whatever its
    size, so the mesh run goes through NCCL: the phase counts the
    all_gather, all_reduce and broadcast calls and fails if one of the
    three never ran. The launch counts are set to 0 before the mesh runs
    and read after."""
    import torch.distributed as dist

    from tclight_torch.models.unet import ToMeSpec, UNet2DCondition, UNetConfig
    from tclight_torch.ops import kernels
    from tclight_torch.ops.flow import voxelization
    from tclight_torch.parallel.mesh import make_mesh
    from tclight_torch.ops.schedules import expon_lr_schedule
    from tclight_torch.parallel.sharded import (build_cp_dit_forward,
                                                build_parallel_denoise_step,
                                                build_sharded_exposure_step,
                                                build_sharded_uvt_step, pad_plans_to_rounds)
    from tclight_torch.pipeline import postopt
    from tclight_torch.pipeline.chunks import make_chunk_plan
    from tclight_torch.pipeline.iclight import init_like_flax

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        unet = UNet2DCondition(UNetConfig.tiny(in_channels=4, dtype=torch.bfloat16)).cuda()
        init_like_flax(unet, torch.Generator(device="cuda").manual_seed(0))
        unet.eval().requires_grad_(False)
        spec = ToMeSpec(n_frames=4, local_ratio=0.5, merge_global=True)
        rng = np.random.default_rng(3)
        n, lat = 8, 48
        plan = make_chunk_plan(n, 4, rng)
        plan_idx, plan_valid = pad_plans_to_rounds(plan.indices, plan.valid, 1)
        randfs = rng.integers(0, 4, size=plan_idx.shape[:2])
        flips = rng.random(plan_idx.shape[:2]) > 0.5
        x = torch.randn(n, lat, lat, 4, device="cuda", generator=gen)
        cc = torch.zeros(n, lat, lat, 0, device="cuda")
        emb = tuple(torch.randn(1, 77, 32, device="cuda", generator=gen) for _ in range(2))
        args = (x, cc, emb, 500.0, plan_idx, plan_valid, randfs, flips)

        nf, h, w = 8, 96, 128
        frames = torch.rand(nf, h, w, 3, device="cuda", generator=gen)
        flows = 1.5 * torch.randn(nf, h, w, 2, device="cuda", generator=gen)
        masks = torch.ones(nf, h, w, device="cuda")
        radius = postopt.flow_radius(flows.cpu().numpy())
        cfg = postopt.PostOptConfig(epochs_exposure=2, epochs=2, batch_size=4, ms_ssim_levels=2)
        ids = np.tile(np.arange(h * w, dtype=np.int64), nf)
        turn = voxelization(turnover_ids(nf, h, w).reshape(-1))

        dit = small_dit(torch.bfloat16, "cuda")
        dx = torch.randn(1, 8, 32, 32, 16, device="cuda", generator=gen)
        dctx = torch.randn(1, 16, dit.cfg.context_dim, device="cuda", generator=gen)
        dcn = torch.tensor([0.4], device="cuda")

        # the palette is made once for both runs: its scatter-mean (an
        # index_add_) sums in the order the card's atomics take
        tables, _ = postopt.build_uvt_tables(ids, nf, h, w, h * w, device="cuda")
        with torch.no_grad():
            palette = postopt.init_palette(frames, torch.from_numpy(ids).cuda(), h * w)

        def builder_steps(m):
            """One update of each sharded step builder on a batch of 4
            frames, one row masked."""
            idxs = torch.arange(4, device="cuda")
            bmask = torch.tensor([True, True, True, False], device="cuda")
            step, make_opt = build_sharded_exposure_step(
                m, cfg, expon_lr_schedule(0.01, 0.001, max_steps=10), warp_radius=radius)
            expo = torch.eye(3, 4, device="cuda").expand(nf, 3, 4).clone().requires_grad_(True)
            exp_loss = step(expo, make_opt(expo), frames, flows, masks[..., None], idxs, bmask)
            feats = palette.clone().requires_grad_(True)
            step, make_opt = build_sharded_uvt_step(m, cfg, h, w, warp_radius=radius)
            uvt_loss = step(feats, make_opt(feats), frames, flows, masks[..., None], tables,
                            idxs, bmask)
            return {"step_exposure": expo.detach(), "step_exposure_loss": exp_loss,
                    "step_uvt": feats.detach(), "step_uvt_loss": uvt_loss}

        def run(m):
            out = {"noises": build_parallel_denoise_step(unet, 4, 2.0, m, tome_spec=spec)(*args)}
            with torch.enable_grad():
                a, e, he, _ = postopt.run_exposure_align(frames, flows, masks, cfg, seed=3,
                                                         warp_radius=radius, mesh=m)
                r, hu, _ = postopt.run_uvt(a, flows, masks, ids, h * w, cfg, seed=3,
                                           warp_radius=radius, mesh=m)
                r5, h5, _ = postopt.run_uvt(a, flows, masks, turn, int(turn.max()) + 1, cfg,
                                            seed=3, warp_radius=radius, mesh=m)
                out.update(builder_steps(m))
            out.update(exposure=e, aligned=a, exposure_hist=torch.from_numpy(he), uvt=r,
                       uvt_hist=torch.from_numpy(hu), uvt_turnover=r5,
                       uvt_turnover_hist=torch.from_numpy(h5))
            with torch.inference_mode():
                out["dit"] = build_cp_dit_forward(dit, m)(dx, dcn, dctx)
            torch.cuda.synchronize()
            return {k: v.detach().float().cpu() for k, v in out.items()}

        ref = run(None)
        res = {}
        calls = dict.fromkeys(("all_gather", "all_reduce", "broadcast"), 0)
        originals = {name: getattr(dist, name) for name in calls}

        def counted(name):
            def call(*a, **k):
                calls[name] += 1
                return originals[name](*a, **k)
            return call

        for name in calls:
            setattr(dist, name, counted(name))
        try:
            stats, wall, peak = run_entry("parallel", lambda: res.update(got=run(mesh)))
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)
        got = res["got"]
    finally:
        dist.destroy_process_group()
    diffs = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    exact = {k: bool(torch.equal(got[k], ref[k])) for k in ref}
    # the mesh's runs do the same arithmetic: bit for bit, or (a kernel
    # whose sums the scheduler may order differently) one bf16 step of the
    # result's scale
    limits = {k: 2.0 ** -8 * float(ref[k].abs().max()) for k in ref}
    launched = {k: stats[k][0] for k in ("flash_attention", "online_argmax_scores",
                                         "window_warp", "banded_gather", "banded_gather_multi")}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = (finite and all(diffs[k] <= limits[k] for k in ref) and min(launched.values()) > 0
          and min(calls.values()) > 0)
    phase("parallel", ok=ok, world="1 rank, NCCL", mesh={"data": 1, "model": 1},
          collectives=calls, bit_equal=exact, max_abs_diff=diffs, launches=launched, wall_s=wall,
          peak_mem_gb=peak, phase_s=time.perf_counter() - t0)
    if not ok:
        raise SystemExit("[parallel] failed")
    return stats


def small_dit_config(dtype=torch.float32):
    """[cosmos-small]'s DiT: 2 blocks, 256 wide, 2 heads of 128."""
    from tclight_torch.cosmos.dit import DiTConfig

    return DiTConfig(in_channels=16, out_channels=16, model_channels=256, num_blocks=2,
                     num_heads=2, context_dim=128, adaln_lora_dim=64, max_frames=16,
                     max_img_h=64, max_img_w=64, dtype=dtype)


def small_dit(dtype, device, state_dict=None):
    """`small_dit_config`'s DiT on `device`: weights drawn on the CPU in
    f32 from seed 0 (adaLN gates non-zero), or `state_dict`, cast."""
    from tclight_torch.cosmos.dit import GeneralDIT, init_dit_

    if state_dict is None:
        model = GeneralDIT(small_dit_config())
        init_dit_(model, torch.Generator().manual_seed(0))
        state_dict = model.state_dict()
    model = GeneralDIT(small_dit_config(dtype))
    model.load_state_dict(state_dict)
    return model.to(device).eval().requires_grad_(False)


def check_cosmos_small() -> dict:
    """[cosmos-small]: `small_dit` over 8 x 16 x 16 = 2,048 tokens (its
    self-attention takes K1 on the card, the plain version on the CPU) on
    the card in bf16 against the CPU in f32; the CPU in bf16 measures what
    bf16 costs. The card may differ from the f32 reference by 1.5 times
    the CPU's bf16 error (relative RMS), and that limit must be at most
    half of what zeroing every self-attention's output moves the f32
    prediction."""
    from tclight_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 8, 32, 32, 16, generator=gen)
    ctx = torch.randn(1, 16, 128, generator=gen)
    cn = torch.tensor([0.4])
    ref_model = small_dit(torch.float32, "cpu")
    sd = ref_model.state_dict()
    with torch.inference_mode():
        ref = ref_model(x, cn, ctx)
        cpu_bf16 = small_dit(torch.bfloat16, "cpu", sd)(x, cn, ctx)
        kernels.reset_stats()
        card = small_dit(torch.bfloat16, "cuda", sd)(x.cuda(), cn.cuda(), ctx.cuda()).cpu()
        launches = kernels.STATS["flash_attention"].launches
        for blk in ref_model.blocks.values():
            blk.blocks[0].block.attn.to_out[0].weight.zero_()
        no_attn = ref_model(x, cn, ctx)
    cpu_err, card_err = rel_rms(cpu_bf16, ref), rel_rms(card, ref)
    tol, fault = 1.5 * cpu_err, rel_rms(no_attn, ref)
    ok = (bool(torch.isfinite(card).all()) and card_err <= tol and fault >= 2 * tol
          and launches > 0)
    return dict(cosmos_small_ok=ok, tokens=8 * 16 * 16, card_rel_rms=card_err,
                cpu_bf16_rel_rms=cpu_err, tol=tol, no_attention_rel_rms=fault,
                k1_launches=launches)


T2W_ARGS = ["--model_size", "7b", "--num_video_frames", "121", "--height", "352", "--width",
            "640", "--num_steps", "2", "--prompt", "a robot arm stacks wooden blocks on a table"]


def run_world_model(tag: str, tmp: Path) -> dict:
    """[t2w] / [v2w]: `python -m tclight_torch.cosmos.text2world` (or
    video2world) as its main runs it, at --model_size 7b: the 7B DiT (4096
    wide, 28 blocks, 32 heads; video2world 17 input channels and the
    augment-sigma embedder) built on the card in bf16 from a seed, the
    CV8x8x8 tokenizer at its published widths in bf16; 121 frames at 352 x
    640 (one causal chunk, 16 latent frames, 14,080 DiT tokens), 2 Heun
    steps (3 x0 evaluations of cond and uncond). video2world conditions
    on a 121-frame rolling video made here, which feeds the DiT the
    condition mask (C10). Then one DiT forward at the run's latents, and
    one denoiser evaluation at the CLI's default 704 x 1280 (56,320
    tokens) with K1's share of it. The launch counts are set to 0 before
    the entry point and read after; the mp4 must hold 121 finite frames."""
    from tclight_torch.cosmos import inference_cli, text2world, video2world
    from tclight_torch.cosmos.dit import make_edm_denoiser
    from tclight_torch.ops import kernels

    v2w = tag == "v2w"
    extra_res = {}  # t2w: the forward with attn_backend "int8" and "int8pv"
    argv = T2W_ARGS + ["--video_save_folder", str(tmp / tag), "--checkpoint_dir",
                       str(tmp / "no-checkpoints")]
    if v2w:
        make_video(tmp / "cond", 121, 352, 640)
        argv += ["--input_image_or_video_path", str(tmp / "cond")]
    entry = video2world if v2w else text2world
    held = {}

    def main():
        args = entry.parse_arguments(argv)
        t0 = time.perf_counter()
        pipe, tok = inference_cli.build_pipeline(args, video2world=v2w)
        torch.cuda.synchronize()
        held.update(pipe=pipe, tok=tok, build_s=time.perf_counter() - t0)
        cond = (video2world.load_condition(args.input_image_or_video_path, args.height,
                                           args.width, tok.pixel_chunk_duration) if v2w else None)
        return inference_cli.run_generation(args, pipe, tok, condition_video=cond)

    stats, wall, peak = run_entry(tag, main)
    pipe = held["pipe"]
    model = pipe.dit.module
    n_frames, shape = read_mp4(tmp / tag / "output.mp4")
    params = sum(p.numel() for p in model.parameters())
    # one DiT forward at the run's latent shape, and one denoiser evaluation
    # at the CLI's default 704 x 1280 (a run of 121 frames there)
    g = torch.Generator(device="cuda").manual_seed(2)
    ctx = torch.randn(1, 32, model.cfg.context_dim, device="cuda", generator=g)
    extra = {}
    if v2w:
        from tclight_torch.cosmos.pipelines import condition_mask

        extra = {"condition_video_input_mask": condition_mask(pipe.latent_shape, 1, "cuda")}
    x = torch.randn(pipe.latent_shape, device="cuda", generator=g)
    cn = torch.tensor([0.5], device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, cn, ctx, **extra), 2)
        if not v2w:
            # the same forward with the DiT's int8 attentions: K6, then K7,
            # at each block's self-attention (28 launches), against bf16
            ref = model(x, cn, ctx, **extra).float()
            for backend, name in (("int8", "flash_attention_int8"),
                                  ("int8pv", "flash_attention_int8pv")):
                model.attn_backend = backend
                kernels.reset_stats()
                out_q = model(x, cn, ctx, **extra).float()
                torch.cuda.synchronize()
                extra_res[f"{backend}_launches"] = kernels.STATS[name].launches
                extra_res[f"{backend}_rel_rms_vs_bf16"] = float(
                    ((out_q - ref).pow(2).mean() / ref.pow(2).mean()).sqrt())
                extra_res[f"{backend}_finite"] = bool(torch.isfinite(out_q).all())
                extra_res[f"{backend}_forward_ms"] = cuda_ms(lambda: model(x, cn, ctx, **extra), 2)
                model.attn_backend = None
            del ref, out_q
        big = (1, 16, 88, 160, 16)
        kernels.reset_stats()
        x0_fn = make_edm_denoiser(model, ctx, **({"condition_video_input_mask": condition_mask(
            big, 1, "cuda")} if v2w else {}))
        xb = torch.randn(big, device="cuda", generator=g)
        big_out, big_ms = timed_once(lambda: x0_fn(xb, 1.3))
        big_keys = dict(kernels.STATS["flash_attention"].shapes)
    finite_big = bool(torch.isfinite(big_out).all())
    del big_out, xb
    DIT_K1_LAUNCH_KEYS[tag] = {**stats["flash_attention"][1], **big_keys}
    steps = pipe.stage_times.get("step_seconds", [])
    k1 = stats["flash_attention"][0]
    # the int8 forwards: K6 / K7 at all 28 blocks, finite, and within 0.1
    # of the bf16 forward's RMS (the kernels are held tightly in their own
    # rows; this guards the path: a wrong layout or a missed launch)
    int8_ok = v2w or all(extra_res[f"{bk}_launches"] == 28 and extra_res[f"{bk}_finite"]
                         and extra_res[f"{bk}_rel_rms_vs_bf16"] <= 0.1
                         for bk in ("int8", "int8pv"))
    ok = (n_frames == 121 and shape == (352, 640, 3) and k1 > 0 and finite_big and int8_ok
          and len(steps) == 2 and (not v2w or model.cfg.in_channels == 17))
    res = dict(ok=ok, params_b=params / 1e9, dit_gb=params * 2 / 1e9, build_s=held["build_s"],
               wall_s=wall, sample_s=pipe.stage_times["sample"], step_s=steps,
               decode_s=pipe.stage_times["decode"], dit_forward_ms=fwd_ms,
               tokens=int(np.prod(pipe.latent_shape[1:4]) // 4), peak_mem_gb=peak,
               mp4_frames=n_frames, mp4_shape=shape, k1_launches=k1,
               k1_keys={str(k): v for k, v in stats["flash_attention"][1].items()},
               denoiser_704x1280_ms=big_ms, tokens_704x1280=16 * 44 * 80,
               in_channels=model.cfg.in_channels, **extra_res)
    del pipe, model, held
    torch.cuda.empty_cache()
    return {"stats": stats, "result": res}


def report_world_model(tag: str, res: dict, k1_rows: dict) -> None:
    """The [t2w] / [v2w] line, with K1's share of the 704 x 1280 denoiser
    evaluation (one forward: 28 K1 launches at 56,320 tokens) and of the
    forward at the run's 14,080 tokens, from K1's held rows."""
    r = dict(res)
    big = k1_rows.get((1, 56320, 56320, 32, 128))
    if big is not None:
        r["k1_56320_ms"] = big["ms"]
        r["k1_share_704x1280"] = 28 * big["ms"] / r["denoiser_704x1280_ms"]
    small = k1_rows.get((1, 14080, 14080, 32, 128))
    if small is not None:
        r["k1_14080_ms"] = small["ms"]
        r["k1_share_forward"] = 28 * small["ms"] / r["dit_forward_ms"]
    ok = r.pop("ok")
    phase(tag, ok=ok, **r)
    if not ok:
        raise SystemExit(f"[{tag}] failed")


# ---------------------------------------------------------------- the AR world stack, guardrails

AR_CONTEXT = (9, 320, 512)  # frames, height, width of [ar-v2w]'s context video
# latent frames [ar-v2w] generates: 9 + 24 = 33 frames, Cosmos's video2world
# output. A grid of at least 5 latent frames is what [dd]'s 8-frame window
# can reflect-pad (split_with_overlap pads by at most T - 1 frames)
AR_GEN_FRAMES = 3
DD_STEPS = 3        # rho ladder length: 2 RES 2ab steps and the clean evaluation
LLAMAGUARD_LAYERS = 32


class DVPipelineAdapter(torch.nn.Module):
    """The DV8x16x16 tokenizer as `ARVideo2WorldPipeline`'s tokenizer: the
    pipeline unpacks (indices, codes) from `encode`, the DV tokenizer's
    `encode` returns (indices, codes, loss) (ROADMAP C12)."""

    def __init__(self, dv):
        super().__init__()
        self.dv = dv

    def encode(self, video):
        idx, codes, _ = self.dv.encode(video)
        return idx, codes

    def decode_indices(self, idx):
        return self.dv.decode_indices(idx)


class WordTokenizer:
    """A token-id stand-in for LlamaGuard's tokenizer (the card has no
    transformers): a word's md5 as its id; decode writes "safe", or
    "unsafe" and an O-code, from the first id."""

    eos_token_id = 2

    def __init__(self, vocab: int):
        import hashlib

        self.vocab, self._md5 = vocab, hashlib.md5

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [3 + int(self._md5(w.encode()).hexdigest(), 16) % (self.vocab - 3)
                              for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        if not ids or ids[0] % 2 == 0:
            return "safe"
        return f"unsafe\nO{1 + ids[0] % 12}"


def _release() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _ar_model(cfg, seed: int, device):
    """`Transformer(cfg)` on `device` with flax-scaled random weights."""
    from tclight_torch.models.ar_transformer import Transformer
    from tclight_torch.pipeline.iclight import init_like_flax

    with torch.device(device):
        model = Transformer(cfg)
    with torch.no_grad():
        init_like_flax(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def run_ar_v2w() -> dict:
    """[ar-v2w]: the port's `ARVideo2WorldPipeline` on
    `create_video2world_model_config("5b")` (the cosmos-4b widths: dim
    3072, 16 layers, 32 / 8 heads, FFN 8192, vocab 64064, 12,864 cache
    slots) in bf16 and the DV8x16x16 tokenizer at `DVTokenizerConfig()`'s
    widths in bf16 through `DVPipelineAdapter`, random weights from seeds:
    a 9-frame 320 x 512 context (2 latent frames of 20 x 32: 1,280 prompt
    tokens), AR_GEN_FRAMES latent frames generated (1,920 tokens, top-p 0.9
    at temperature 1), 33 frames decoded. The spatial size is cut from
    640 x 1024; the widths are not. Prints the parameter count, prefill ms,
    decode ms a token beside its byte bound (every weight but the
    embedding table, one row of it, and the KV cache's slots, which the
    attention reads), DV encode / decode ms, the peak."""
    import dataclasses

    from tclight_torch.cosmos.dv_tokenizer import CausalDiscreteVideoTokenizer, DVTokenizerConfig
    from tclight_torch.cosmos.inference_cli import random_tokenizer_
    from tclight_torch.cosmos.pipelines import ARVideo2WorldPipeline
    from tclight_torch.models.ar_configs import create_video2world_model_config
    from tclight_torch.models.ar_transformer import ARGenerator

    _release()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(create_video2world_model_config("5b"), dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = _ar_model(cfg, 0, "cuda")
    with torch.device("cuda"):
        dv = CausalDiscreteVideoTokenizer(dataclasses.replace(DVTokenizerConfig(),
                                                              dtype=torch.bfloat16))
    with torch.no_grad():
        random_tokenizer_(dv, torch.Generator(device="cuda").manual_seed(1))
    dv.eval().requires_grad_(False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, h, w = AR_CONTEXT
    video = flow_frames(n, h, w, 5)[None] * 2.0 - 1.0
    tokens_per_frame = (h // 16) * (w // 16)
    pipe = ARVideo2WorldPipeline(ARGenerator(model), DVPipelineAdapter(dv),
                                 max_gen_tokens=AR_GEN_FRAMES * tokens_per_frame)
    out = {}
    stats, wall, peak = run_entry("ar-v2w", lambda: out.update(video=pipe(video, seed=0)))
    st = pipe.stage_times
    frames = out["video"]
    params = sum(p.numel() for p in model.parameters())
    emb = model.tok_embeddings.weight
    kv_bytes = 2 * cfg.n_layers * cfg.max_seq_len * cfg.n_kv_heads * cfg.hd * emb.element_size()
    step_bytes = (params - emb.numel() + cfg.dim) * emb.element_size() + kv_bytes
    decode_ms = st["decode_s"] / st["decode_steps"] * 1e3
    decode_bound, decode_by = bound_ms(step_bytes, 2.0 * (params - emb.numel()))
    t_lat = 1 + (n - 1) // 8 + AR_GEN_FRAMES
    ok = (frames is not None and frames.shape == (1, 1 + (t_lat - 1) * 8, h, w, 3)
          and bool(np.isfinite(frames).all()) and pipe.tokens.shape == (1, t_lat, h // 16, w // 16)
          and stats["flash_attention"][0] == 0)
    res = dict(ok=ok, params_b=params / 1e9, param_gb=params * 2 / 1e9, build_s=build_s,
               context=f"{n}x{h}x{w}", prompt_tokens=(1 + (n - 1) // 8) * tokens_per_frame,
               tokens_out=AR_GEN_FRAMES * tokens_per_frame,
               token_grid=list(pipe.tokens.shape), frames_out=None if frames is None else
               list(frames.shape), dv_encode_ms=st["encode"] * 1e3,
               prefill_ms=st["prefill_s"] * 1e3, decode_ms_per_token=decode_ms,
               decode_bound_ms=decode_bound, decode_bound_by=decode_by,
               dv_decode_ms=st["decode"] * 1e3, wall_s=wall, peak_mem_gb=peak,
               k1_launches=stats["flash_attention"][0])
    # a random AR samples the whole vocabulary: ids past the DV codebook
    # (the text and special ids) are folded into it for [dd]'s token table
    tokens = pipe.tokens[0] % 64000
    res["ids_past_codebook"] = int((pipe.tokens >= 64000).sum())
    del pipe, model, dv, out
    _release()
    phase("ar-v2w", **res)
    if not ok:
        raise SystemExit("[ar-v2w] failed")
    return {"stats": stats, "tokens": tokens}


def run_dd(tokens: np.ndarray) -> dict:
    """[dd]: `diffusion_decoder_process_tokens` on [ar-v2w]'s token grid
    (5 x 20 x 32): the 7B decoder DiT (`DiTConfig.faditv2_7b()` with
    `DiffusionDecoderGeneralDIT`'s token embedder: 16 + 32 + 1 input
    channels) in bf16, the context from the T5-11B encoder
    (`T5Config.t5_11b()`, f32, 512 ids, 40 of them a prompt) and the port's
    CV8x8x8 tokenizer (bf16) for `decode_fn`, random weights from seeds.
    One 57-frame window: 8 latent frames at 40 x 64 (the grid reflect-padded
    from 5), 5,120 DiT tokens; DD_STEPS = 3 (2 RES 2ab steps and the clean
    evaluation, 6 DiT forwards with CFG) instead of 15. Prints the T5 ms,
    ms a decoder forward, the wall and the peak; K1's rows and share
    follow (`report_dd`)."""
    from tclight_torch.cosmos.cv_tokenizer import CausalContinuousVideoTokenizer, cv_config_8x8x8
    from tclight_torch.cosmos.diffusion_decoder import (DiffusionDecoderGeneralDIT,
                                                        LatentDiffusionDecoder,
                                                        diffusion_decoder_process_tokens)
    from tclight_torch.cosmos.dit import DiTConfig, init_dit_
    from tclight_torch.cosmos.inference_cli import random_tokenizer_
    from tclight_torch.models.t5_encoder import T5Config, T5Encoder
    from tclight_torch.pipeline.iclight import init_like_flax

    _release()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(3)
    t5cfg = T5Config.t5_11b()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        t5 = T5Encoder(t5cfg)
    with torch.no_grad():
        init_like_flax(t5, g)
    t5.eval().requires_grad_(False)
    torch.cuda.synchronize()
    t5_build_s = time.perf_counter() - t0
    t5_params = sum(p.numel() for p in t5.parameters())
    ids = torch.randint(0, t5cfg.vocab_size, (1, 512), device="cuda", generator=g)
    mask = torch.zeros((1, 512), dtype=torch.long, device="cuda")
    mask[:, :40] = 1
    with torch.inference_mode():
        emb, t5_ms = timed_once(lambda: t5(ids, mask))
        t5_ms_again = cuda_ms(lambda: t5(ids, mask), 1)
    t5_peak = torch.cuda.max_memory_allocated() / 2**30
    t5_ok = bool(torch.isfinite(emb).all()) and bool((emb[0, 40:] == 0).all())
    emb = emb[0].float()
    del t5
    _release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        net = DiffusionDecoderGeneralDIT(DiTConfig.faditv2_7b(dtype=torch.bfloat16))
    net = net.to_empty(device="cuda")
    with torch.no_grad():
        init_dit_(net, g)
        net.token_embedder.weight.normal_(0.0, 1.0, generator=g)
    net.eval().requires_grad_(False)
    with torch.device("meta"):
        cv = CausalContinuousVideoTokenizer(cv_config_8x8x8(dtype=torch.bfloat16))
    cv = cv.to_empty(device="cuda")
    with torch.no_grad():
        random_tokenizer_(cv, g)
    cv.eval().requires_grad_(False)
    torch.cuda.synchronize()
    dit_build_s = time.perf_counter() - t0
    params = sum(p.numel() for p in net.parameters())
    decoder = LatentDiffusionDecoder(net, n_steps=DD_STEPS)
    h, w = AR_CONTEXT[1:]

    @torch.inference_mode()
    def decode_fn(z):
        return cv.decode(z).permute(0, 4, 1, 2, 3).float()

    out = {}
    stats, wall, peak = run_entry("dd", lambda: out.update(videos=diffusion_decoder_process_tokens(
        decoder, [tokens], decode_fn, h, w, t5_emb_batch=[emb], context_dim=1024, seed=1)))
    vid = out["videos"][0]
    x = torch.randn((1, 8, h // 8, w // 8, 16), device="cuda", generator=g)
    toks = torch.as_tensor(np.concatenate([tokens, tokens[1:4][::-1]])[None], device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: net(x, torch.tensor([0.5], device="cuda"), emb[None],
                                     latent_condition=toks), 2)
    ok = (t5_ok and vid.shape == (3, 57, h, w) and bool(np.isfinite(vid).all())
          and 0.0 <= vid.min() and vid.max() <= 1.0
          and stats["flash_attention"][0] == 28 * 2 * DD_STEPS)
    res = dict(ok=ok, t5_params_b=t5_params / 1e9, t5_gb=t5_params * 4 / 1e9,
               t5_build_s=t5_build_s, t5_ms=t5_ms, t5_ms_again=t5_ms_again, t5_peak_gb=t5_peak,
               dit_params_b=params / 1e9, dit_gb=params * 2 / 1e9, dit_build_s=dit_build_s,
               in_channels=net.cfg.in_channels, token_grid=list(tokens.shape),
               latent=f"8x{h // 8}x{w // 8}x16", dit_tokens=8 * (h // 16) * (w // 16),
               res_steps=DD_STEPS - 1, video=list(vid.shape), wall_s=wall,
               decoder_forward_ms=fwd_ms, peak_mem_gb=peak,
               k1_launches=stats["flash_attention"][0],
               k1_keys={str(k): v for k, v in stats["flash_attention"][1].items()})
    del net, cv, decoder, out, x
    _release()
    return {"stats": stats, "result": res}


def report_dd(res: dict, k1_rows: dict) -> None:
    """The [dd] line, with K1's share of a decoder forward (28 launches at
    5,120 tokens)."""
    r = dict(res)
    row = k1_rows.get((1, 5120, 5120, 32, 128))
    if row is not None:
        r["k1_5120_ms"] = row["ms"]
        r["k1_share_forward"] = 28 * row["ms"] / r["decoder_forward_ms"]
    ok = r.pop("ok") and row is not None
    phase("dd", ok=ok, **r)
    if not ok:
        raise SystemExit("[dd] failed")


def write_llamaguard(d: Path, n_layers: int, gen: torch.Generator) -> dict:
    """LlamaGuard-7B's HF layout (bf16 safetensors, a shard per 8 layers),
    its config.json, and a LoRA adapter (r 16 on every q_proj / v_proj) in
    a subdirectory; random from `gen`, drawn on the card. -> sizes."""
    from tclight_torch.models.convert import write_safetensors

    d.mkdir(parents=True)
    dim, ffn, vocab, heads = 4096, 11008, 32000, 32

    def rnd(*shape, std=None):
        std = shape[-1] ** -0.5 if std is None else std
        return (torch.randn(shape, device="cuda", generator=gen) * std).bfloat16().cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    nbytes = 0
    shard = {"model.embed_tokens.weight": rnd(vocab, dim, std=dim ** -0.5),
             "model.norm.weight": ones(dim), "lm_head.weight": rnd(vocab, dim)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            shard[p + f"self_attn.{n}.weight"] = rnd(dim, dim)
        shard[p + "mlp.gate_proj.weight"] = rnd(ffn, dim)
        shard[p + "mlp.up_proj.weight"] = rnd(ffn, dim)
        shard[p + "mlp.down_proj.weight"] = rnd(dim, ffn)
        shard[p + "input_layernorm.weight"] = ones(dim)
        shard[p + "post_attention_layernorm.weight"] = ones(dim)
        if i % 8 == 7 or i == n_layers - 1:
            nbytes += sum(t.numel() * 2 for t in shard.values())
            write_safetensors(shard, d / f"model-{i // 8:05d}.safetensors")
            shard = {}
    adapter = {}
    for i in range(n_layers):
        for proj in ("q_proj", "v_proj"):
            pre = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            adapter[f"{pre}.lora_A.weight"] = rnd(16, dim).float()
            adapter[f"{pre}.lora_B.weight"] = rnd(dim, 16, std=0.01).float()
    (d / "aegis").mkdir()
    write_safetensors(adapter, d / "aegis" / "adapter_model.safetensors")
    (d / "aegis" / "adapter_config.json").write_text(json.dumps({"lora_alpha": 32, "r": 16}))
    (d / "config.json").write_text(json.dumps({
        "vocab_size": vocab, "hidden_size": dim, "num_hidden_layers": n_layers,
        "num_attention_heads": heads, "num_key_value_heads": heads, "intermediate_size": ffn,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0}))
    return {"base_gb": nbytes / 1e9}


def write_siglip(d: Path, gen: torch.Generator) -> None:
    """siglip_vision.safetensors (transformers' SiglipVisionModel keys,
    so400m widths) and safety_filter.pt (the Cosmos head, BN statistics
    drawn), random from `gen`."""
    from tclight_torch.models.convert import write_safetensors
    from tclight_torch.models.siglip import SiglipVisionConfig

    c = SiglipVisionConfig.so400m()
    dm, f, p = c.hidden_size, c.intermediate_size, c.patch_size

    def rnd(*shape, std=None):
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        return torch.randn(shape, device="cuda", generator=gen).mul_(
            fan ** -0.5 if std is None else std).cpu()

    sd = {"vision_model.embeddings.patch_embedding.weight": rnd(dm, 3, p, p),
          "vision_model.embeddings.patch_embedding.bias": torch.zeros(dm),
          "vision_model.embeddings.position_embedding.weight": rnd(
              (c.image_size // p) ** 2, dm, std=0.02),
          "vision_model.post_layernorm.weight": torch.ones(dm),
          "vision_model.post_layernorm.bias": torch.zeros(dm),
          "vision_model.head.probe": rnd(1, 1, dm, std=1.0),
          "vision_model.head.attention.in_proj_weight": rnd(3 * dm, dm),
          "vision_model.head.attention.in_proj_bias": torch.zeros(3 * dm),
          "vision_model.head.attention.out_proj.weight": rnd(dm, dm),
          "vision_model.head.attention.out_proj.bias": torch.zeros(dm),
          "vision_model.head.layernorm.weight": torch.ones(dm),
          "vision_model.head.layernorm.bias": torch.zeros(dm),
          "vision_model.head.mlp.fc1.weight": rnd(f, dm), "vision_model.head.mlp.fc1.bias":
              torch.zeros(f),
          "vision_model.head.mlp.fc2.weight": rnd(dm, f), "vision_model.head.mlp.fc2.bias":
              torch.zeros(dm)}
    for i in range(c.num_layers):
        r = f"vision_model.encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[r + f"self_attn.{n}.weight"], sd[r + f"self_attn.{n}.bias"] = rnd(dm, dm), \
                torch.zeros(dm)
        sd[r + "mlp.fc1.weight"], sd[r + "mlp.fc1.bias"] = rnd(f, dm), torch.zeros(f)
        sd[r + "mlp.fc2.weight"], sd[r + "mlp.fc2.bias"] = rnd(dm, f), torch.zeros(dm)
        for n in ("layer_norm1", "layer_norm2"):
            sd[r + f"{n}.weight"], sd[r + f"{n}.bias"] = torch.ones(dm), torch.zeros(dm)
    write_safetensors(sd, d / "siglip_vision.safetensors")
    head = {}
    for i, (n_in, n_out) in ((0, (dm, 512)), (3, (512, 256)), (6, (256, 7))):
        head[f"network.layers.{i}.weight"] = rnd(n_out, n_in)
        head[f"network.layers.{i}.bias"] = 0.1 * rnd(n_out, std=1.0)
        if i < 6:
            bn = f"network.layers.{i + 1}."
            head[bn + "weight"] = 1.0 + 0.1 * rnd(n_out, std=1.0)
            head[bn + "bias"] = 0.1 * rnd(n_out, std=1.0)
            head[bn + "running_mean"] = 0.1 * rnd(n_out, std=1.0)
            head[bn + "running_var"] = 0.5 + torch.rand(n_out)
            head[bn + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    torch.save(head, d / "safety_filter.pt")


def run_guardrails(tmp: Path) -> dict:
    """[guardrails] at full widths, random weights from seeds, each model
    freed before the next:
    - `AegisLlamaGuard` (f32, as JAX builds it: ~27 GB) loaded from
      LlamaGuard-7B's HF layout in bf16 shards plus a LoRA adapter written
      to a temp directory (from_hf_llama, merge_lora), with a token-id
      stand-in tokenizer: a moderation of one prompt (prefill of the
      template, 100 greedy steps); prefill ms, ms a decoded token, the
      decision parsed;
    - `VideoContentSafetyChecker` (SigLIP-so400m and the 7-class head,
      from siglip_vision.safetensors and safety_filter.pt) on 8 frames at
      384 (ms a frame) and its 2 fps gate on 30 frames;
    - `FaceBlurFilter` (RetinaFace-R50 from a Resnet50_Final.pth) on 8
      frames at 720 x 960 (ms a frame, the host's decode and NMS included).
    The peak of each is printed."""
    import shutil

    from tclight_torch.cosmos.aegis import AegisLlamaGuard, moderation_prompt, parse_block_message
    from tclight_torch.cosmos.guardrails import FaceBlurFilter, VideoContentSafetyChecker
    from tclight_torch.models.retinaface import random_reference_state_dict
    from tclight_torch.models.siglip import preprocess_siglip

    g = torch.Generator(device="cuda").manual_seed(7)
    res = {}
    _release()
    # the bf16 shards take 0.40 GB a layer and 0.52 GB besides; fewer layers
    # (printed) if the disk holds less than twice that
    free = shutil.disk_usage(tmp).free
    layers = max(1, min(LLAMAGUARD_LAYERS, int((free / 2 - 0.6e9) / 0.41e9)))
    t0 = time.perf_counter()
    sizes = write_llamaguard(tmp / "llamaguard", layers, g)
    res["aegis_write_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    guard = AegisLlamaGuard(tmp / "llamaguard", tokenizer=WordTokenizer(32000), device="cuda")
    torch.cuda.synchronize()
    res["aegis_load_s"] = time.perf_counter() - t0
    params = sum(p.numel() for p in guard.model.parameters())
    t0 = time.perf_counter()
    safe, msg = guard.is_safe("a robot arm stacks wooden blocks on a table")
    res["aegis_moderate_s"] = time.perf_counter() - t0
    times = guard.generator.last_times
    out_text = guard.moderate("a robot arm stacks wooden blocks on a table")
    parsed = isinstance(safe, bool) and (safe == ("unsafe" not in out_text)) and (
        safe or msg == parse_block_message(out_text))
    res.update(aegis_params_b=params / 1e9, aegis_gb=params * 4 / 1e9, aegis_layers=layers,
               disk_free_gb=free / 1e9,
               aegis_file_gb=sizes["base_gb"], aegis_prompt_tokens=len(guard.tokenizer(
                   moderation_prompt("a robot arm stacks wooden blocks on a table"))["input_ids"]),
               aegis_prefill_ms=times["prefill_s"] * 1e3,
               aegis_decode_ms_per_token=times["decode_s"] / times["decode_steps"] * 1e3,
               aegis_decode_bound_ms=bound_ms(params * 4, 2.0 * params, PEAK_F32_FLOPS)[0],
               aegis_decision=("safe" if safe else msg), aegis_parsed=parsed,
               aegis_peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    del guard
    _release()
    # SigLIP-so400m and the head
    (tmp / "siglip").mkdir()
    write_siglip(tmp / "siglip", g)
    torch.cuda.reset_peak_memory_stats()
    checker = VideoContentSafetyChecker(tmp / "siglip", device="cuda")
    frames = flow_frames(30, 720, 960, 6)
    verdict = checker(frames)
    pre = preprocess_siglip(frames[:8], checker._image_size)
    sig_ms = cuda_ms(lambda: checker._fn(pre), 3) / 8
    logits = checker._fn(pre)
    res.update(siglip_ms_per_frame=sig_ms, siglip_logits_finite=bool(np.isfinite(logits).all()),
               siglip_verdict=f"{verdict.is_safe} {verdict.message}".strip(),
               siglip_peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    del checker
    _release()
    # RetinaFace-R50
    (tmp / "retinaface").mkdir()
    sd = random_reference_state_dict(seed=8)
    for i in range(3):  # a class bias that finds some faces at 0.7 (~14 a frame)
        sd[f"ClassHead.{i}.conv1x1.bias"][1::2] += 0.5
    torch.save({f"module.{k}": v for k, v in sd.items()}, tmp / "retinaface" / "Resnet50_Final.pth")
    torch.cuda.reset_peak_memory_stats()
    blur = FaceBlurFilter(tmp / "retinaface", device="cuda")
    blurred = blur.process(frames[:8])
    t0 = time.perf_counter()
    boxes = blur._detector.detect(frames[:8])
    rf_ms = (time.perf_counter() - t0) / 8 * 1e3
    x = torch.from_numpy(np.ascontiguousarray(frames[:4] * 255.0 - 110.0)).cuda()
    with torch.inference_mode():
        rf_net_ms = cuda_ms(lambda: blur._detector.model(x), 3) / 4
    res.update(retinaface_ms_per_frame=rf_ms, retinaface_net_ms_per_frame=rf_net_ms,
               retinaface_boxes=[len(b) for b in boxes],
               retinaface_changed=bool(not np.array_equal(blurred, frames[:8])),
               retinaface_peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    del blur
    _release()
    ok = (parsed and res["siglip_logits_finite"] and sum(res["retinaface_boxes"]) > 0
          and res["retinaface_changed"])
    phase("guardrails", ok=ok, **res)
    if not ok:
        raise SystemExit("[guardrails] failed")
    return res


def check_ar_small() -> dict:
    """[ar-small]: the card against the CPU in f32 (full f32 on both):
    - a 2-layer AR at the cosmos-4b widths: prompt logits of the bf16 model
      on the card within 1.5x the CPU's own bf16 error (relative RMS), a
      limit at most half of what zeroing every attention output moves the
      f32 logits; 16 sampled tokens (temperature 1, top-p 0.9) of the f32
      model equal on both with the same injected Gumbel draws;
    - a 2-block decoder DiT (256 wide, 2 heads of 128, 2,048 tokens: K1 on
      the card) in bf16 against the f32 CPU, the same 1.5x rule, zeroing the
      self-attention moving it at least 2x the limit;
    - the DV tokenizer at tiny(): indices equal wherever the pre-round value
      is more than 1e-3 from a rounding boundary, the decode within 1e-4;
    - T5, SigLIP and RetinaFace at tiny widths: within 1e-4 of max |CPU|."""
    import dataclasses

    from tclight_torch.cosmos import dv_tokenizer as dvt
    from tclight_torch.cosmos.diffusion_decoder import DiffusionDecoderGeneralDIT
    from tclight_torch.cosmos.dit import init_dit_
    from tclight_torch.models import retinaface, siglip, t5_encoder
    from tclight_torch.models.ar_configs import create_video2world_model_config
    from tclight_torch.models.ar_transformer import ARGenerator, Transformer
    from tclight_torch.ops import kernels
    from tclight_torch.pipeline.iclight import init_like_flax
    from tclight_torch.utils.device import full_f32

    out = {}
    with full_f32(), torch.inference_mode():
        # the AR at full width, 2 layers
        cfg = dataclasses.replace(create_video2world_model_config("5b"), n_layers=2,
                                  max_seq_len=256)
        ref_model = _ar_model(cfg, 0, "cpu")
        sd = ref_model.state_dict()

        def ar(dtype, device):
            with torch.device(device):
                m = Transformer(dataclasses.replace(cfg, dtype=dtype))
            m.load_state_dict(sd)
            return m.eval()

        ids = torch.randint(0, 64000, (1, 64), generator=torch.Generator().manual_seed(0))
        ref = ref_model(tokens=ids)[0]
        cpu_err = rel_rms(ar(torch.bfloat16, "cpu")(tokens=ids)[0], ref)
        card_err = rel_rms(ar(torch.bfloat16, "cuda")(tokens=ids.cuda())[0].cpu(), ref)
        gumbel = [-torch.log(-torch.log(torch.rand(1, cfg.vocab_size, generator=torch.Generator(
        ).manual_seed(100 + i)).clamp_min(1e-30))) for i in range(16)]
        toks = ARGenerator(ar(torch.float32, "cuda")).generate(
            ids, max_gen_len=16, temperature=1.0, gumbel=[g.cuda() for g in gumbel])
        ref_toks = ARGenerator(ref_model).generate(ids, max_gen_len=16, temperature=1.0,
                                                   gumbel=gumbel)
        for i in range(cfg.n_layers):
            getattr(ref_model, f"layers_{i}").attention.wo.weight.zero_()
        fault = rel_rms(ref_model(tokens=ids)[0], ref)
        tol = 1.5 * cpu_err
        out["ar_ok"] = card_err <= tol and fault >= 2 * tol and np.array_equal(toks, ref_toks)
        out.update(ar_card_rel_rms=card_err, ar_cpu_bf16_rel_rms=cpu_err, ar_tol=tol,
                   ar_no_attention_rel_rms=fault, ar_tokens_equal=bool(np.array_equal(toks,
                                                                                     ref_toks)))
        del ref_model, sd
        # the decoder DiT, 2 blocks
        dcfg = dataclasses.replace(small_dit_config(), in_channels=16)
        net = DiffusionDecoderGeneralDIT(dcfg, token_vocab=1000)
        gen = torch.Generator().manual_seed(4)
        init_dit_(net, gen)
        net.token_embedder.weight.normal_(0.0, 1.0, generator=gen)
        dsd = net.state_dict()

        def dd(dtype, device):
            m = DiffusionDecoderGeneralDIT(dataclasses.replace(dcfg, dtype=dtype),
                                           token_vocab=1000)
            m.load_state_dict(dsd)
            return m.to(device).eval()

        x = torch.randn(1, 8, 32, 32, 16, generator=gen)
        ctx = torch.randn(1, 16, 128, generator=gen)
        tk = torch.randint(0, 1000, (1, 8, 16, 16), generator=gen)
        cn = torch.tensor([0.4])
        dref = net.eval()(x, cn, ctx, latent_condition=tk)
        dcpu = rel_rms(dd(torch.bfloat16, "cpu")(x, cn, ctx, latent_condition=tk), dref)
        kernels.reset_stats()
        dcard = rel_rms(dd(torch.bfloat16, "cuda")(x.cuda(), cn.cuda(), ctx.cuda(),
                                                   latent_condition=tk.cuda()).cpu(), dref)
        k1 = kernels.STATS["flash_attention"].launches
        for blk in net.blocks.values():
            blk.blocks[0].block.attn.to_out[0].weight.zero_()
        dfault = rel_rms(net(x, cn, ctx, latent_condition=tk), dref)
        dtol = 1.5 * dcpu
        out["dd_ok"] = dcard <= dtol and dfault >= 2 * dtol and k1 > 0
        out.update(dd_card_rel_rms=dcard, dd_cpu_bf16_rel_rms=dcpu, dd_tol=dtol,
                   dd_no_attention_rel_rms=dfault, dd_k1_launches=k1)
        # the DV tokenizer, tiny
        dv = dvt.CausalDiscreteVideoTokenizer(dvt.DVTokenizerConfig.tiny())
        with torch.no_grad():
            for name, p in dv.named_parameters():
                p.normal_(0.05 if name.endswith("bias") else 1.0 if p.dim() == 1 else 0.0,
                          0.05 if name.endswith("bias") else 0.1 if p.dim() == 1
                          else p[0].numel() ** -0.5, generator=gen)
        video = torch.rand(1, 9, 32, 32, 3, generator=gen) * 2 - 1
        idx, _, _ = dv.eval().encode(video)
        zb = dv.quantizer.bound(dv.quant_conv(dv.encoder(video)).permute(0, 2, 3, 4, 1)).numpy()
        keep = (np.abs(np.abs(zb - np.floor(zb)) - 0.5) > 1e-3).all(-1)
        rec = dv.decode_indices(idx)
        dv_card = dv.cuda()
        cidx = dv_card.encode(video.cuda())[0].cpu()
        crec = dv_card.decode_indices(idx.cuda()).cpu()
        out["dv_ok"] = (bool((cidx.numpy()[keep] == idx.numpy()[keep]).all())
                        and float((crec - rec).abs().max()) <= 1e-4 * float(rec.abs().max()))
        out.update(dv_tie_free_share=float(keep.mean()),
                   dv_decode_max_abs_err=float((crec - rec).abs().max()))

        # T5, SigLIP and RetinaFace at tiny widths
        def small(name, module, *args):
            init_like_flax(module, gen)
            for prm in module.parameters():  # norms, biases, probe and positions drawn too
                if prm.dim() == 1 or float(prm.abs().max()) == 0.0:
                    prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
            ref_out = module.eval()(*args)
            card_out = module.cuda()(*(a.cuda() for a in args))
            ref_out = ref_out if isinstance(ref_out, tuple) else (ref_out,)
            card_out = card_out if isinstance(card_out, tuple) else (card_out,)
            err = max(float((c.cpu() - r).abs().max() / r.abs().max())
                      for c, r in zip(card_out, ref_out))
            out[f"{name}_rel_max_err"] = err
            return err <= 1e-4

        t5_ok = small("t5", t5_encoder.T5Encoder(t5_encoder.T5Config.tiny()),
                      torch.randint(0, 128, (2, 40), generator=gen),
                      torch.ones(2, 40, dtype=torch.long))
        sig_ok = small("siglip", siglip.SiglipVisionTower(siglip.SiglipVisionConfig.tiny()),
                       torch.rand(2, 28, 28, 3, generator=gen) * 2 - 1)
        rf_ok = small("retinaface", retinaface.RetinaFace(retinaface.RetinaFaceConfig.tiny()),
                      torch.rand(2, 72, 88, 3, generator=gen) * 200 - 100)
        out["small_models_ok"] = t5_ok and sig_ok and rf_ok
    out["ar_small_ok"] = out["ar_ok"] and out["dd_ok"] and out["dv_ok"] and out["small_models_ok"]
    return out


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
    # the rows held so far, by launch key: each path's run adds a row for
    # every shape it launched K1 or K2 at that none of these covers
    held = {("flash_attention", (b, s, s, HEADS, d)): row for (_, b, s, d), row in zip(
        attention_shapes() + attention_shapes(YT_FRAMES, HEIGHT // 8), flash["rows"])}
    held |= {("online_argmax_scores", key[1:]): row
             for key, row in zip(match_shapes(), match["rows"])}
    path_rows = {"flash_attention": [], "online_argmax_scores": []}

    def hold(tag: str, shapes: dict) -> None:
        for k, rows in check_path_shapes(tag, shapes, gen, held).items():
            path_rows[k] += rows

    shapes, launches = run_main_path()
    hold("main", shapes)
    warp = check_warp(gen)
    banded = check_banded(gen)
    turnover = check_turnover(gen)
    check_exports(gen)
    shapes, yt_launches = run_yt_int8()
    hold("yt-int8", shapes)
    launches.update(yt_launches)
    int8_launches = run_int8_variants()
    for name in ("flash_attention_int8pv", "flash_attention_int8pv_prepass"):
        launches[name] = int8_launches[name]
    profile_main_path()
    # PyTorch's default again (TF32 on for cuDNN's convolutions): the flow
    # and eval phases measure what a user of those entry points gets, which
    # set their own precision
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        raft_ckpt, memflow_ckpt = write_flow_checkpoints(Path(tmp))
        check_raft(raft_ckpt)
        check_memflow(memflow_ckpt)
        check_eval(raft_ckpt, Path(tmp))
    by_path = {"main": {k: launches[k] for k in path_rows}}
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        for tag, run in (("pnp", run_pnp), ("controlnet", lambda: run_controlnet(Path(tmp))),
                         ("bkgd", lambda: run_bkgd(Path(tmp))),
                         ("single-image", run_single_image),
                         ("depth", lambda: run_depth(Path(tmp))),
                         ("annotators", lambda: run_annotators(Path(tmp)))):
            stats = run()
            by_path[tag] = {k: stats[k][0] for k in path_rows}
            hold(tag, {k: stats[k][1] for k in path_rows})
            if tag == "controlnet":
                # the ControlNet's unmerged per-frame level 0, the largest
                # K1 shape of the slice; the inversion runs it too, so its
                # row may be PnP's
                tnum = (HEIGHT // 8) * (WIDTH // 8)
                key = (2 * CHUNK, tnum, tnum, HEADS, 320 // HEADS)
                if key not in stats["flash_attention"][1]:
                    raise SystemExit("the ControlNet path launched no K1 at its level-0 shape")
                row = held[("flash_attention", key)]
                phase("controlnet-K1-L0", launched=stats["flash_attention"][1][key],
                      **{k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by", "exp_bound_ms")})
    # the upsampler launches neither kernel: its attention is a matmul and a
    # softmax, as JAX's is (checked in the phase)
    stats = run_upsampler()
    by_path["upsampler"] = {k: stats[k][0] for k in path_rows}
    # multi-device (a world of one on the card) and the Cosmos world models
    stats = check_parallel(gen)
    by_path["parallel"] = {k: stats[k][0] for k in path_rows}
    hold("parallel", {k: stats[k][1] for k in path_rows})
    small = check_cosmos_small()
    small_ok = small.pop("cosmos_small_ok")
    phase("cosmos-small", ok=small_ok, **small)
    if not small_ok:
        raise SystemExit("[cosmos-small] failed")
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        worlds = {tag: run_world_model(tag, Path(tmp)) for tag in ("t2w", "v2w")}
    for tag, world in worlds.items():
        by_path[tag] = {k: world["stats"][k][0] for k in path_rows}
        hold(tag, {"flash_attention": DIT_K1_LAUNCH_KEYS[tag], "online_argmax_scores": {}})
    k1_rows = {key: row for (name, key), row in held.items() if name == "flash_attention"}
    for tag, world in worlds.items():
        report_world_model(tag, world["result"], k1_rows)
    # K6 and K7 at the DiTs' self-attention, where their attn_backend "int8"
    # / "int8pv" sends it: the decoder's 5,120 tokens, the t2w run's 14,080
    # and the CLI's default 704 x 1280 (56,320; the plain version held on 8
    # of the 32 heads there: the whole call's takes ~5 s and ~40 GB)
    dit_int8 = {pv: {"rows": [], "prepass_rows": []} for pv in (False, True)}
    for pv in (False, True):
        for label, s, heads in (("dit dd", 5120, None), ("dit t2w", 14080, None),
                                ("dit t2w-704", 56320, 8)):
            int8_row(label, 1, s, 32, 128, gen, pv, dit_int8[pv], plain_heads=heads)
    # the AR world stack: [ar-v2w]'s token grid feeds [dd]; then the
    # guardrail models and the card-against-CPU checks
    ar = run_ar_v2w()
    by_path["ar-v2w"] = {k: ar["stats"][k][0] for k in path_rows}
    dd = run_dd(ar["tokens"])
    by_path["dd"] = {k: dd["stats"][k][0] for k in path_rows}
    hold("dd", {"flash_attention": dd["stats"]["flash_attention"][1], "online_argmax_scores": {}})
    report_dd(dd["result"], {key: row for (name, key), row in held.items()
                             if name == "flash_attention"})
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        run_guardrails(Path(tmp))
    small = check_ar_small()
    small_ok = small.pop("ar_small_ok")
    phase("ar-small", ok=small_ok, **small)
    if not small_ok:
        raise SystemExit("[ar-small] failed")
    phase("launches", **{f"{tag}": counts for tag, counts in by_path.items()})

    k1 = kernel_entry("flash_attention", "tclight_torch/csrc/flash_attention.cu",
                      "tclight_tpu/ops/attention.py:135", launches["flash_attention"],
                      flash["rows"] + path_rows["flash_attention"])
    k2 = kernel_entry("online_argmax_scores", "tclight_torch/csrc/match_argmax.cu",
                      "tclight_tpu/ops/match_kernel.py:34", launches["online_argmax_scores"],
                      match["rows"] + path_rows["online_argmax_scores"])
    for entry in (k1, k2):
        entry["launches_by_path"] = {tag: c[entry["name"]] for tag, c in by_path.items()}
    print(json.dumps({"kernels": [
        k1, k2,
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
                     int8[False]["rows"] + dit_int8[False]["rows"],
                     path=f"yt-int8: navsim settings, {YT_FRAMES} frames, alpha_t 0.4, "
                          "attn_qk_int8"),
        kernel_entry("flash_attention_int8:prepass",
                     "tclight_torch/csrc/flash_attention_qk_int8.cu",
                     "tclight_tpu/ops/attention.py:180", launches["flash_attention_int8_prepass"],
                     int8[False]["prepass_rows"] + dit_int8[False]["prepass_rows"],
                     path="yt-int8 (K6's quantization pre-pass, two kernels a launch)"),
        kernel_entry("flash_attention_int8pv", "tclight_torch/csrc/flash_attention_int8.cu",
                     "tclight_tpu/ops/attention.py:227", launches["flash_attention_int8pv"],
                     int8[True]["rows"] + dit_int8[True]["rows"],
                     path=f"int8pv: main config, {FRAMES} frames, attn_qk_int8 + attn_pv_int8"),
        kernel_entry("flash_attention_int8pv:prepass",
                     "tclight_torch/csrc/flash_attention_qk_int8.cu",
                     "tclight_tpu/ops/attention.py:227",
                     launches["flash_attention_int8pv_prepass"],
                     int8[True]["prepass_rows"] + dit_int8[True]["prepass_rows"],
                     path="int8pv (K7's quantization pre-pass, two kernels a launch)"),
    ]}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
