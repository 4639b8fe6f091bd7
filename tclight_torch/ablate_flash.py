"""Where K1's time goes: the kernel and variants of it with one part taken
out, each built from `csrc/flash_attention.cu` by a text substitution and
timed on the card at the UNet's self-attention shapes (levels 0-2, and the
yt pass's level 0) and the Cosmos DiTs' (head dim 128: the 7B decoder's
5,120 tokens, 121 frames at 352 x 640 and at 704 x 1280; and 14,080
queries against twice the keys: twice the 14,080-key shape's time less
this one's is what a block costs besides its k/v tiles, its prologue,
epilogue and last wave).

    python -m tclight_torch.ablate_flash [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant.

Variants (all but ex2h and the geometries compute a wrong output by
design; only their times are read):
  base     the kernel as it is
  noload   k/v tiles loaded into the ring's first stages only, then reused
  tconly   no softmax: the q.k^T and p.v products alone (and the loads)
  noexp    each exponential replaced by its argument
  poly8    one exponential in eight computed on the FMA pipes (a cubic)
  ex2h     the exponentials two at a time in f16 (ex2.approx.f16x2)
  nopp     no ping-pong between the two consumer warpgroups
  nostore  the epilogue's stores taken out (its normalisation goes with them)
  nst2, bk176, bk192
           geometries of the head-dim-128 path: a ring of 2 stages of 128-,
           176- or 192-key tiles (the kernel: 3 of 128)

Prints the card's name and power limit, then one line per shape with each
variant's milliseconds (CUDA events, after a warm-up) and its output's
largest difference from the kernel's. Needs a CUDA card
and nvcc; builds into build/tclight_torch/ablate/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tclight_torch.ops import attention, kernels

SRC = kernels.CSRC / "flash_attention.cu"
OUT = kernels.BUILD_DIR / "ablate"

_LOADS = """        mbar_expect_tx(&full[st], 2 * TILE * 2);
        load_kv(sK"""
_SOFTMAX = "      float alpha[MB][2];\n      softmax(j + 1, alpha);\n"
_EXP = "          s[mb][i] = fast_exp2(fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]));"
_PACK = "__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {"
_POLY = """__device__ __forceinline__ float poly_exp2(float x) {
  x = fmaxf(x, -127.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.0555041086f, f, 0.2402264923f), f, 0.6931471825f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));
}

"""
VARIANTS = {
    "base": [],
    "noload": [(_LOADS, "        if (j >= NST) { mbar_arrive(&full[st]); continue; }\n" + _LOADS)],
    "tconly": [(_SOFTMAX, "      float alpha[MB][2] = {};\n")],
    "noexp": [(_EXP, _EXP.replace("fast_exp2(", "("))],
    "poly8": [(_PACK, _POLY + _PACK),
              (_EXP, """          {
            const float a = fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]);
            s[mb][i] = i % 8 == 7 ? poly_exp2(a) : fast_exp2(a);
          }""")],
    "ex2h": [("#include <cuda_bf16.h>", "#include <cuda_bf16.h>\n#include <cuda_fp16.h>"),
             (_EXP, """          if (i % 2 == 0) {
            const float a0 = fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]);
            const float a1 = fmaf(s[mb][i + 1], c, neg_m[(i >> 1) & 1]);
            uint32_t h;
            asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(h) : "f"(a1), "f"(a0));
            asm("ex2.approx.f16x2 %0, %0;" : "+r"(h));
            const float2 p = __half22float2(*reinterpret_cast<__half2*>(&h));
            s[mb][i] = p.x;
            s[mb][i + 1] = p.y;
          }""")],
    "nopp": [("    auto take_turn = [&]() { named_sync(my_turn, 256); };",
              "    auto take_turn = [&]() {};"),
             ("      if (cw == 0 || !last) named_arrive(other_turn, 256);", ""),
             ("    if (cw == 1) named_arrive(other_turn, 256);\n", "")],
    "nostore": [("          if (row < Sq)\n", "          if (row < 0)\n")],
    **{name: [("constexpr int SW_BK = 128;", f"constexpr int SW_BK = {bk};"),
              ("constexpr int SW_NST = 3;", "constexpr int SW_NST = 2;")]
       for name, bk in (("nst2", 128), ("bk176", 176), ("bk192", 192))},
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


# chip_smoke's level-0, 1 and 2 shapes (8 frames at 960x720, merged) and
# the yt pass's level 0; the DiTs' self-attention at 5,120, 14,080 and
# 56,320 tokens (32 heads of 128)
# (label, B, Sq, Skv, H, D)
SHAPES = {"unet": [("L0", 2, 35640, 35640, 8, 40), ("L1", 2, 8910, 8910, 8, 80),
                   ("L2", 8, 660, 660, 8, 160), ("yt-L0", 2, 8910, 8910, 8, 40)],
          "dit": [("dd", 1, 5120, 5120, 32, 128), ("t2w", 1, 14080, 14080, 32, 128),
                  ("t2w-kv2", 1, 14080, 28160, 32, 128), ("t2w-704", 1, 56320, 56320, 32, 128)]}


def main(argv: list[str]) -> int:
    sets = [a for a in argv if a in SHAPES] or list(SHAPES)
    names = [a for a in argv if a not in SHAPES] or list(VARIANTS)
    if any(n not in VARIANTS for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    if "base" not in names:
        names.insert(0, "base")  # the differences are taken to it
    if not torch.cuda.is_available():
        print("ablate_flash: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, b, sq, skv, h, d in (shape for name in sets for shape in SHAPES[name]):
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
        k, v = (torch.randn(b, skv, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                for _ in range(2))
        kc, vc = attention.flash_kv_operands(k, v)
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        times, diffs, base = {}, {}, None
        for name, lib in libs.items():
            fn = lib.tclight_flash_attention_bf16
            fn.argtypes, fn.restype = attention.K1_ARGTYPES, ctypes.c_int
            o.zero_()
            times[name] = cuda_ms(lambda: kernels.check_launch(
                fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), o.data_ptr(), b, h, sq, skv, d,
                   d ** -0.5, stream), name), 5 if max(sq, skv) > 20000 else 20)
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        print(f"[ablate] {level} B={b} Sq={sq} Skv={skv} H={h} D={d} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
