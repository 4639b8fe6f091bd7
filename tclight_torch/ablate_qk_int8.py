"""Where K6's time goes: the kernel and variants of it with one part taken
out or replaced, each built from `csrc/flash_attention_qk_int8.cu` by a
text substitution and timed on the card on its pre-pass's operands at the
UNet's self-attention shapes (levels 0-2, and the yt pass's levels 0 and
1), beside K6's pre-pass kernels and K1 on the same inputs.

    python -m tclight_torch.ablate_qk_int8

Variants (all but addcvt compute a wrong output by design; only their
times are read):
  base     the kernel as it is (its pre-pass not included)
  addcvt   the int32 sums converted by one integer and one float add on the
           magic number 1.5 * 2^23 instead of the conversion instruction
  noscale  the K scales left out of the scores
  tconly   no softmax: the q.k^T and p.v products alone (and the loads)

Prints the card's name and power limit, then one line per shape with each
variant's milliseconds (CUDA events, after a warm-up), its output's largest
difference from the kernel's, the pre-pass's and K1's milliseconds. Needs a
CUDA card and nvcc; builds into build/tclight_torch/ablate_qk_int8/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tclight_torch.ops import attention, kernels

SRC = kernels.CSRC / "flash_attention_qk_int8.cu"
OUT = kernels.BUILD_DIR / "ablate_qk_int8"

_CONVERT = "{ return (float)(int)x; }"
_SCALE = "__float_as_uint(s32_to_f32(s[mb][4 * n + e]) * ((e & 1) ? skv.y : skv.x));"
_SOFTMAX = "      float alpha[MB][2];\n      softmax(j + 1, alpha);\n"
VARIANTS = {
    "base": [],
    "addcvt": [(_CONVERT, "{ return __uint_as_float(x + 0x4B400000u) - 12582912.f; }")],
    "noscale": [(_SCALE, "__float_as_uint(s32_to_f32(s[mb][4 * n + e]));")],
    "tconly": [(_SOFTMAX, "      float alpha[MB][2] = {};\n")],
}


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


def build() -> dict[str, ctypes.CDLL]:
    """Every variant's library, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                                        str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("a variant failed to build")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in VARIANTS}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_qk_int8: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # chip_smoke's level-0, 1 and 2 shapes (8 frames at 960x720, merged)
    # and the yt pass's levels 0 and 1
    for level, b, s, h, d in (("L0", 2, 35640, 8, 40), ("L1", 2, 8910, 8, 80),
                              ("L2", 8, 660, 8, 160), ("yt-L0", 2, 8910, 8, 40),
                              ("yt-L1", 2, 2228, 8, 80)):
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
            times[name] = cuda_ms(lambda: kernels.check_launch(
                fn(ops["q8"].data_ptr(), ops["k8"].data_ptr(), ops["v"].data_ptr(),
                   ops["sq"].data_ptr(), ops["sk"].data_ptr(), o.data_ptr(), b, h, s, s, d,
                   ops["bq"], d ** -0.5, stream), name), reps)
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        pre_ms = cuda_ms(lambda: attention.qk_int8_operands(q, k, v), reps)
        k1_ms = cuda_ms(lambda: attention.flash_attention_cuda(q, k, v, d ** -0.5), reps)
        print(f"[ablate-k6] {level} B={b} S={s} H={h} D={d} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
              + f" prepass_ms={pre_ms:.3f} k1_ms={k1_ms:.3f}"
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
