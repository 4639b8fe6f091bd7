"""Where K7's time goes: its three parts (the PV pre-pass kernels, the max
pass, the attention) timed alone, and variants of the two kernels of
`csrc/flash_attention_int8.cu` with one part taken out, each built by a
text substitution and timed on the card on the pre-pass's operands at the
UNet's self-attention shapes (`unet`: levels 0-2, and the yt pass's levels
0 and 1) and the Cosmos DiTs' (`dit`: 32 heads of 128 at 5,120, 14,080 and
56,320 tokens, where `attn_backend="int8pv"` sends them), beside K6
(pre-pass included) on the same inputs.

    python -m tclight_torch.ablate_int8pv [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant.

Variants (all but base compute a wrong output by design; only their times
are read):
  base       the kernels as they are
  tconly     the attention without its softmax: the q.k^T and p.v products,
             the loads and the P blocks' dequantisation
  mp_tconly  the max pass without its per-score work (scale, mask, max):
             its q.k^T products and loads alone
  noload     the attention's k8, v8 and K-scale tiles loaded into the
             ring's first stages only, then reused
  mp_noload  the same for the max pass's k tiles and K scales
  mp_addcvt  head dim 128: the max pass's int32 sums converted by one
             integer and one float add on the magic number 1.5 * 2^23
             (exact below 2^22) instead of the conversion instruction
  nst4       head dim 128: a ring of 4 stages (the kernels: 3)
  mp_inplace head dim 128: the max pass's int32 sums converted to f32 in
             place right after the wait, as the attention's softmax does

Prints the card's name and power limit, then one line per shape with each
part's and variant's milliseconds (CUDA events, after a warm-up), the
pre-pass's two kernels' device milliseconds (torch.profiler) and K6's.
Needs a CUDA card and nvcc; builds into build/tclight_torch/ablate_int8pv/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tclight_torch.ops import attention, kernels
from tclight_torch.utils.logging import cuda_event_ms

SRC = kernels.CSRC / "flash_attention_int8.cu"
OUT = kernels.BUILD_DIR / "ablate_int8pv"

_SOFTMAX = "      softmax(j + 1);\n"
_MAX = "        bmax[mb][e >> 1] = fmaxf(bmax[mb][e >> 1], u);\n"
_LOADS = "        mbar_expect_tx(&full[st], BK * DK + BK * DP + BK * 4);\n"
_MP_LOADS = "        mbar_expect_tx(&full[st], BK * ROW + BK * 4);\n"
_MP_FINISH = """    auto finish = [&](Score (&sc)[MB][BK / 2], int j) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(sc[mb]);
"""
_NOLOAD = "        if (j >= NS) { mbar_arrive(&full[st]); continue; }\n"
VARIANTS = {
    "base": [],
    "tconly": [(_SOFTMAX, "")],
    "mp_tconly": [(_MAX, "")],
    "noload": [(_LOADS, _NOLOAD + _LOADS)],
    "mp_noload": [(_MP_LOADS, _NOLOAD + _MP_LOADS)],
    "mp_addcvt": [("float score_f32(uint32_t x) { return s32_to_f32(x); }",
                   "float score_f32(uint32_t x) {\n"
                   "  return __uint_as_float(x + 0x4B400000u) - ROUND_MAGIC;\n}")],
    "nst4": [("constexpr int SW_NST = 3;", "constexpr int SW_NST = 4;")],
    "mp_inplace": [("float score_f32(uint32_t x) { return s32_to_f32(x); }",
                    "float score_f32(uint32_t x) { return __uint_as_float(x); }"),
                   (_MP_FINISH, _MP_FINISH + """#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[mb][i] = __float_as_uint(s32_to_f32(sc[mb][i]));
""")],
}
# chip_smoke's level-0, 1 and 2 shapes (8 frames at 960x720, merged), the
# yt pass's levels 0 and 1; the DiTs' self-attention
# (label, B, S, H, D)
SHAPES = {"unet": [("L0", 2, 35640, 8, 40), ("L1", 2, 8910, 8, 80), ("L2", 8, 660, 8, 160),
                   ("yt-L0", 2, 8910, 8, 40), ("yt-L1", 2, 2228, 8, 80)],
          "dit": [("dd", 1, 5120, 32, 128), ("t2w", 1, 14080, 32, 128),
                  ("t2w-704", 1, 56320, 32, 128)]}


def variant_sources() -> dict[str, str]:
    """Every variant's CUDA source; raises when the kernel's source no
    longer holds the text a variant replaces."""
    src = SRC.read_text().replace('#include "hopper.cuh"', f'#include "{kernels.CSRC}/hopper.cuh"')
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build(names) -> dict[str, ctypes.CDLL]:
    """The named variants' libraries, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    texts = variant_sources()
    for name in names:
        text = texts[name]
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                                        str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("a variant failed to build")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in names}


def prepass_split_ms(fn, reps: int) -> dict[str, float]:
    """Device milliseconds per call of the pre-pass's two kernels (`stats`,
    `quant`) in fn(), from a torch.profiler trace of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"stats": 0.0, "quant": 0.0}
    for e in prof.key_averages():
        for part in out:
            if f"prepass_{part}_kernel" in e.key:
                out[part] += getattr(e, "device_time_total", 0.0) / 1e3 / reps
    return out


def main(argv: list[str]) -> int:
    sets = [a for a in argv if a in SHAPES] or list(SHAPES)
    names = [a for a in argv if a not in SHAPES] or list(VARIANTS)
    if any(n not in VARIANTS for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    if "base" not in names:
        names.insert(0, "base")
    if not torch.cuda.is_available():
        print("ablate_int8pv: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for level, b, s, h, d in (shape for name in sets for shape in SHAPES[name]):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps = 5 if s > 20000 else 20
        scale = d ** -0.5
        ops = attention.int8pv_operands(q, k, v)
        bm = attention.int8_block_rowmax(ops, b, h, s, s, d, scale)
        # the max pass's operands: the bf16 copies where the pre-pass makes
        # them, else q8 and k8 themselves
        mq, mk = (ops["qb"], ops["kb"]) if "qb" in ops else (ops["q8"], ops["k8"])
        o = torch.empty_like(q)
        times = {}
        for name, lib in libs.items():
            mp = lib.tclight_int8pv_blockmax
            mp.argtypes, mp.restype = attention.MAXPASS_ARGTYPES, ctypes.c_int
            main_fn = lib.tclight_flash_attention_int8pv
            main_fn.argtypes, main_fn.restype = attention.K7_ARGTYPES, ctypes.c_int
            bm_v = torch.empty_like(bm)
            times[f"{name}_maxpass"] = cuda_event_ms(lambda: kernels.check_launch(
                mp(mq.data_ptr(), mk.data_ptr(), ops["sq"].data_ptr(),
                   ops["sk"].data_ptr(), bm_v.data_ptr(), b, h, s, s, d, ops["bq"], scale,
                   stream), name), reps)[0]
            if d == 128 and name in ("base", "mp_addcvt", "nst4", "mp_inplace") \
                    and not torch.equal(bm_v, bm):
                raise RuntimeError(f"variant {name}: the max pass's block maxes differ")
            times[f"{name}_attention"] = cuda_event_ms(lambda: kernels.check_launch(
                main_fn(*(ops[n].data_ptr() for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                        bm.data_ptr(), o.data_ptr(), b, h, s, s, d, ops["bq"], scale, stream),
                name), reps)[0]
        pre_ms = cuda_event_ms(lambda: attention.int8pv_operands(q, k, v), reps)[0]
        split = prepass_split_ms(lambda: attention.int8pv_operands(q, k, v), reps)
        k7_ms = cuda_event_ms(lambda: attention.flash_attention_int8_cuda(q, k, v, scale, True),
                              reps)[0]
        k6_ms = cuda_event_ms(lambda: attention.flash_attention_int8_cuda(q, k, v, scale, False),
                              reps)[0]
        print(f"[ablate-k7] {level} B={b} S={s} H={h} D={d} k7_ms={k7_ms:.3f} "
              f"prepass_ms={pre_ms:.3f} prepass_stats_ms={split['stats']:.3f} "
              f"prepass_quant_ms={split['quant']:.3f} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
              + f" k6_ms={k6_ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
