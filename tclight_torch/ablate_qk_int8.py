"""Where K6's time goes: the kernel and variants of it with one part taken
out or replaced, each built from `csrc/flash_attention_qk_int8.cu` by a
text substitution and timed on the card on its pre-pass's operands at the
UNet's self-attention shapes (`unet`: levels 0-2, and the yt pass's levels
0 and 1) and the Cosmos DiTs' (`dit`: 32 heads of 128 at 5,120, 14,080 and
56,320 tokens, where `attn_backend="int8"` sends them), beside K6's
pre-pass kernels and K1 on the same inputs.

    python -m tclight_torch.ablate_qk_int8 [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant.

Variants (all but addcvt compute a wrong output by design; only their
times are read):
  base     the kernel as it is (its pre-pass not included)
  addcvt   the int32 sums converted by one integer and one float add on the
           magic number 1.5 * 2^23 instead of the conversion instruction
  noscale  the K scales left out of the scores
  tconly   no softmax: the q.k^T and p.v products alone (and the loads)
  noload   k8, v and K-scale tiles loaded into the ring's first stages
           only, then reused
  nst2, nst4
           head dim 128: a ring of 2 or 4 stages (the kernel: 3)

Prints the card's name and power limit, then one line per shape with each
variant's milliseconds (CUDA events, after a warm-up), its output's largest
difference from the kernel's, the pre-pass's and K1's milliseconds, and the
pre-pass's two kernels' device milliseconds (torch.profiler). Needs a CUDA
card and nvcc; builds into build/tclight_torch/ablate_qk_int8/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tclight_torch.ops import attention, kernels
from tclight_torch.utils.logging import cuda_event_ms

SRC = kernels.CSRC / "flash_attention_qk_int8.cu"
OUT = kernels.BUILD_DIR / "ablate_qk_int8"

_CONVERT = "{ return (float)(int)x; }"
_SCALE = "__float_as_uint(s32_to_f32(s[mb][4 * n + e]) * ((e & 1) ? skv.y : skv.x));"
_SOFTMAX = "      float alpha[MB][2];\n      softmax(j + 1, alpha);\n"
_LOADS = "        mbar_expect_tx(&full[st], BK * DK + BK * DP * 2 + BK * 4);\n"
VARIANTS = {
    "base": [],
    "addcvt": [(_CONVERT, "{ return __uint_as_float(x + 0x4B400000u) - 12582912.f; }")],
    "noscale": [(_SCALE, "__float_as_uint(s32_to_f32(s[mb][4 * n + e]));")],
    "tconly": [(_SOFTMAX, "      float alpha[MB][2] = {};\n")],
    "noload": [(_LOADS, "        if (j >= NST) { mbar_arrive(&full[st]); continue; }\n" + _LOADS)],
    **{f"nst{n}": [("constexpr int SW_NST = 3;", f"constexpr int SW_NST = {n};")] for n in (2, 4)},
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
        names.insert(0, "base")  # the differences are taken to it
    if not torch.cuda.is_available():
        print("ablate_qk_int8: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, b, s, h, d in (shape for name in sets for shape in SHAPES[name]):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps = 5 if s > 20000 else 20
        ops = attention.qk_int8_operands(q, k, v)
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        times, diffs, base = {}, {}, None
        for name, lib in libs.items():
            fn = lib.tclight_flash_attention_qk_int8
            fn.argtypes, fn.restype = attention.K6_ARGTYPES, ctypes.c_int
            times[name] = cuda_event_ms(lambda: kernels.check_launch(
                fn(ops["q8"].data_ptr(), ops["k8"].data_ptr(), ops["v"].data_ptr(),
                   ops["sq"].data_ptr(), ops["sk"].data_ptr(), o.data_ptr(), b, h, s, s, d,
                   ops["bq"], d ** -0.5, stream), name), reps)[0]
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        pre_ms = cuda_event_ms(lambda: attention.qk_int8_operands(q, k, v), reps)[0]
        split = prepass_split_ms(lambda: attention.qk_int8_operands(q, k, v), reps)
        k1_ms = cuda_event_ms(lambda: attention.flash_attention_cuda(q, k, v, d ** -0.5), reps)[0]
        print(f"[ablate-k6] {level} B={b} S={s} H={h} D={d} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
              + f" prepass_ms={pre_ms:.3f} prepass_stats_ms={split['stats']:.3f}"
              + f" prepass_quant_ms={split['quant']:.3f} k1_ms={k1_ms:.3f}"
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
