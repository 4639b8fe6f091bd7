"""Where K7's time goes: its three parts (the PV pre-pass kernels, the max
pass, the attention) timed alone, and variants of the two kernels of
`csrc/flash_attention_int8.cu` with one part taken out, each built by a
text substitution and timed on the card on the pre-pass's operands at the
UNet's self-attention shapes (levels 0-2, and the yt pass's levels 0 and
1), beside K6 (pre-pass included) on the same inputs.

    python -m tclight_torch.ablate_int8pv

Variants (all but base compute a wrong output by design; only their times
are read):
  base       the kernels as they are
  tconly     the attention without its softmax: the q.k^T and p.v products,
             the loads and the P blocks' dequantisation
  mp_tconly  the max pass without its per-score work (scale, mask, max):
             its q.k^T products and loads alone

Prints the card's name and power limit, then one line per shape with each
part's and variant's milliseconds (CUDA events, after a warm-up) and K6's.
Needs a CUDA card and nvcc; builds into build/tclight_torch/ablate_int8pv/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from tclight_torch.ops import attention, kernels

SRC = kernels.CSRC / "flash_attention_int8.cu"
OUT = kernels.BUILD_DIR / "ablate_int8pv"

_SOFTMAX = "      softmax(j + 1);\n"
_MAX = "        bmax[mb][e >> 1] = fmaxf(bmax[mb][e >> 1], u);\n"
VARIANTS = {
    "base": [],
    "tconly": [(_SOFTMAX, "")],
    "mp_tconly": [(_MAX, "")],
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
        print("ablate_int8pv: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for level, b, s, h, d in (("L0", 2, 35640, 8, 40), ("L1", 2, 8910, 8, 80),
                              ("L2", 8, 660, 8, 160), ("yt-L0", 2, 8910, 8, 40),
                              ("yt-L1", 2, 2228, 8, 80)):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps = 5 if s > 20000 else 20
        scale = d ** -0.5
        ops = attention.int8pv_operands(q, k, v)
        bm = attention.int8_block_rowmax(ops, b, h, s, s, d, scale)
        o = torch.empty_like(q)
        times = {}
        for name, lib in libs.items():
            mp = lib.tclight_int8pv_blockmax
            mp.argtypes, mp.restype = attention.MAXPASS_ARGTYPES, ctypes.c_int
            main_fn = lib.tclight_flash_attention_int8pv
            main_fn.argtypes, main_fn.restype = attention.K7_ARGTYPES, ctypes.c_int
            bm_v = torch.empty_like(bm)
            times[f"{name}_maxpass"] = cuda_ms(lambda: kernels.check_launch(
                mp(ops["qb"].data_ptr(), ops["kb"].data_ptr(), ops["sq"].data_ptr(),
                   ops["sk"].data_ptr(), bm_v.data_ptr(), b, h, s, s, d, ops["bq"], scale,
                   stream), name), reps)
            times[f"{name}_attention"] = cuda_ms(lambda: kernels.check_launch(
                main_fn(*(ops[n].data_ptr() for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                        bm.data_ptr(), o.data_ptr(), b, h, s, s, d, ops["bq"], scale, stream),
                name), reps)
        pre_ms = cuda_ms(lambda: attention.int8pv_operands(q, k, v), reps)
        k7_ms = cuda_ms(lambda: attention.flash_attention_int8_cuda(q, k, v, scale, True), reps)
        k6_ms = cuda_ms(lambda: attention.flash_attention_int8_cuda(q, k, v, scale, False), reps)
        print(f"[ablate-k7] {level} B={b} S={s} H={h} D={d} k7_ms={k7_ms:.3f} "
              f"prepass_ms={pre_ms:.3f} "
              + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
              + f" k6_ms={k6_ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
