"""Where the post-optimization kernels' time goes: K3 (the window warp,
`csrc/window_warp.cu`) and K4 (the banded gather, `csrc/banded_gather.cu`)
and variants of them with one part taken out or one choice changed, each
built from the kernel's source by a text substitution and timed on the
card at the shapes the main path launches them at.

    python -m tclight_torch.ablate_postopt [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [K3 | K4] [SHAPE ...] [VARIANT ...]

With no arguments, both kernels at every shape with every variant. A
variant `a+b` applies the substitutions of both. `--tree` ablates the
kernels of another checkout of this repository (its sources, launched
through its C entry points as its wrappers launch them); a variant whose
texts its source does not hold is left out, and says so. `--vs CHECKOUT`
adds that checkout's kernel as a variant `vs`, timed in the same rounds.

K4's shapes are the main path's real plans (`turns.k4_plans`: the render's
and the adjoint's single-window plans of the Farneback tracks of
chip_smoke's video, for its post-opt batch of 8 frames padded with frame 0
and for 16 distinct frames of a 16-frame video), and K5's turnover plans
ride along as a control (the base library's K5, no variant). K3's shapes
are chip_smoke's three cases both ways: farneback (16 x 720 x 960, r = 4,
chip_smoke's Farneback flows), random (r = 24), wide (2 x 160 x 192, r =
100).

K4's calls pass the render's plan rows to a checkout whose K4 takes them,
and one row for the adjoint, as the main path does (`interleave` takes
abl_rows from the same). K4 variants (`noread` computes a wrong output by
design; only its time is read):
  base        the kernel as it is
  noread      a constant instead of the table row: the offsets-and-output
              stream alone
  sorted      a CTA a block, blocks visited in order of their starts (a
              stable sort made outside the timing, read through an index
              array)
  interleave  a CTA a block, CTA c takes block (c mod B, c div B) of a plan
              of B rows
  evict_last  the table read with an L2 evict-last policy
  rows8       8 entries a thread
  c4          the table padded to 16-byte rows (a copy made outside the
              timing), one 16-byte load a row
  seq         a CTA a block, in plan order (a kernel whose CTAs gather block
              j of a group of plan rows)
  g1, g4, g8, g16  up to 1, 4, 8 or 16 plan rows a CTA (the kernel: 2)
K3 variants (all but the tile choice compute a wrong output by design):
  base        the kernel as it is
  noatomic    the adjoint's adds go to registers, one store a thread
  onelimb     the adjoint adds one 32-bit limb a channel (a kernel with two
              limbs at every tile)
  twolimb     two limbs at every tile (a kernel with one limb below 64 taps)
  noscatter   the adjoint without its scatter: zeroing, halo pass, outputs
  walkonly    the scatter's walk, loads and weights, no term
  nocvt       the adjoint's terms reinterpreted, not converted, to integers
  norange     the adjoint's halo pass replaced by each tile's flow range and
              max |g|, computed beforehand
  warpsum     the adjoint's lanes whose taps share a floor sum their terms
              by shuffles (integers, as the limbs) before one add
  tile16x32   16 x 32 tiles (both directions; its forward is the row read)

Prints the card's name and power limit, then one line per shape: each
variant's milliseconds (the median of N rounds, 3 by default, each timing
every variant in turn with `cuda_event_ms`, after a warm-up; the rounds'
spread beside it), the bound (bytes at 3.35 TB/s) and the base kernel's
largest difference from the plain version (K4: exact; K3 at the
farneback case only, the plain version taking seconds at larger radii).
Prints ptxas's register, spill and C75xx lines for each variant. A variant
whose first call does not end within 60 s ends the run (exit code 3) and
is named. Needs a CUDA card and nvcc; builds into
build/tclight_torch/ablate_postopt/.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tclight_torch.ablate_match import watchdog
from tclight_torch.ops import kernels
from tclight_torch.utils.logging import cuda_event_ms

OUT = kernels.BUILD_DIR / "ablate_postopt"
PEAK_BYTES = 3.35e12
SOURCES = {"K3": "window_warp.cu", "K4": "banded_gather.cu"}

# hooks every variant's source gets: device pointers a variant may read,
# set through one entry point before its calls
_HOOK_DECL = ("__device__ const int* abl_order;\n__device__ int abl_rows;\n"
              "__device__ const float* abl_ranges;\n\nnamespace {")
_HOOK_SET = """
extern "C" int tclight_ablate_set(const void* order, int rows, const void* ranges) {
  cudaError_t e = cudaMemcpyToSymbol(abl_order, &order, sizeof(order));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(abl_rows, &rows, sizeof(rows));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(abl_ranges, &ranges, sizeof(ranges));
  return (int)e;
}
"""

# ---------------------------------------------------------------- K4 texts
_K4_B = ("  const int b = blockIdx.x;\n  const OffT* ob = offs + (size_t)b * bl;\n"
         "  float* outb")
_K4_FETCH = "fetch_row<C>(r + e * C, table, row, o[e] >= 0 && row < n_rows);"
_K4_ROW_DOC = "// table row `row` into r[0..C), or zeros"
_LDG_LAST = """__device__ __forceinline__ float ldg_last(const float* p) {
  uint64_t pol;
  float v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float4 ldg4_last(const float4* p) {
  uint64_t pol;
  float4 v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}

"""
_K4_LD1 = "r[ch] = valid ? __ldg(table + row * C + ch) : 0.f;"
_K4_LD4 = "__ldg(reinterpret_cast<const float4*>(table + row * 4))"
_K4_C4 = ("  if constexpr (C == 4) {\n"
          "    const float4 v = valid ? __ldg(reinterpret_cast<const float4*>(table + row * 4))\n"
          "                           : make_float4(0.f, 0.f, 0.f, 0.f);\n"
          "    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;\n")
_K4_ROWS = "constexpr int K4_ROWS = 4;"
_K4_ASSERT = ("  static_assert(K4_ROWS * sizeof(OffT) == 8 || K4_ROWS * sizeof(OffT) == 16, "
              "\"vector width\");")
_K4_VEC16 = "    if constexpr (K4_ROWS * sizeof(OffT) == 16)\n"

# a kernel whose CTAs gather block j of a group of plan rows: its block and
# its grid, which the one-block-a-CTA orders replace, and its group
_K4_LOOP_B = "      const int b = (r0 + rr) * nbr + j;\n"
_K4_GRID = "banded_gather_kernel<OffT, C><<<nb / group, threads, 0, s>>>("
_K4_GROUP = "constexpr int K4_GROUP = 2;"


def _one_block(b: str) -> list[tuple[str, str]]:
    """A CTA a block, `b` the block CTA blockIdx.x takes (a kernel whose CTAs
    gather block j of a group of plan rows)."""
    return [(_K4_LOOP_B, f"      if (rr > 0) break;\n      const int b = {b};\n"),
            (_K4_GRID, "banded_gather_kernel<OffT, C><<<nb, threads, 0, s>>>(")]


_INTERLEAVE = "(blockIdx.x % abl_rows) * (gridDim.x / abl_rows) + blockIdx.x / abl_rows"

K4_VARIANTS = {
    "base": [],
    "noread": [(_K4_FETCH, "for (int ch = 0; ch < C; ++ch) r[e * C + ch] = (float)(row & 7);")],
    "sorted": ([(_K4_B, _K4_B.replace("blockIdx.x;", "abl_order[blockIdx.x];"))],
               _one_block("abl_order[blockIdx.x]")),
    "interleave": ([(_K4_B, _K4_B.replace("blockIdx.x;", _INTERLEAVE + ";"))],
                   _one_block(_INTERLEAVE)),
    "seq": _one_block("blockIdx.x"),
    "g1": [(_K4_GROUP, "constexpr int K4_GROUP = 1;")],
    "g4": [(_K4_GROUP, "constexpr int K4_GROUP = 4;")],
    "g8": [(_K4_GROUP, "constexpr int K4_GROUP = 8;")],
    "g16": [(_K4_GROUP, "constexpr int K4_GROUP = 16;")],
    "evict_last": [(_K4_ROW_DOC, _LDG_LAST + _K4_ROW_DOC),
                   (_K4_LD1, "r[ch] = valid ? ldg_last(table + row * C + ch) : 0.f;"),
                   (_K4_LD4, "ldg4_last(reinterpret_cast<const float4*>(table + row * 4))")],
    "rows8": [(_K4_ROWS, "constexpr int K4_ROWS = 8;"),
              (_K4_ASSERT, "  static_assert(K4_ROWS * sizeof(OffT) % 8 == 0, \"vector width\");"),
              (_K4_VEC16,
               "    if constexpr (K4_ROWS * sizeof(OffT) == 32) {\n"
               "      reinterpret_cast<int4*>(p)[0] = reinterpret_cast<const int4*>(ob + i0)[0];\n"
               "      reinterpret_cast<int4*>(p)[1] = reinterpret_cast<const int4*>(ob + i0)[1];\n"
               "    } else if constexpr (K4_ROWS * sizeof(OffT) == 16)\n")],
    "c4": [(_K4_C4,
            "  if constexpr (C >= 3) {\n"
            "    const float4 v = valid ? __ldg(reinterpret_cast<const float4*>(table + row * 4))\n"
            "                           : make_float4(0.f, 0.f, 0.f, 0.f);\n"
            "    r[0] = v.x, r[1] = v.y, r[2] = v.z;\n"
            "    if constexpr (C == 4) r[3] = v.w;\n")],
}

# ---------------------------------------------------------------- K3 texts
_K3_ATOMICS = ("            atomicAdd(&so[i], (unsigned)(t & low));\n"
               "            atomicAdd(reinterpret_cast<int*>(&so[C * TH * TW + i]), (int)(t >> L));\n")
_K3_SCATTER = "  // 3. every source of the window, in the frame, scatters into the tile\n"
_K3_OUTPUTS = "  __syncthreads();\n  // 4. the outputs"
_K3_PASS1 = ("  {\n    const int hy0 = max(y0 - rh, 0)", "  block_range(v, red);")
_K3_CVT = "const long long t = __float2ll_rn(wgt * gv[ch]);"
_K3_TILE = "constexpr int TH = 32, TW = 64;"
_K3_LOOP = ("  for (int sy = sy0 + warp; finite && sy <= sy1; sy += THREADS / 32) {\n"
            "    for (int sx = sx0 + lane; sx <= sx1; sx += 32) {", _K3_OUTPUTS)
# the scatter with lanes summing the terms that land on one output: lane l
# collects tap b of lane l + b where both lanes' tap floors agree (their
# tap b lands on lane l's tap 0); a tap no lane collects is added alone
_K3_WARPSUM = """  for (int sy = sy0 + warp; finite && sy <= sy1; sy += THREADS / 32) {
    for (int cx = sx0; cx <= sx1; cx += 32) {
      const int sx = cx + lane;
      const bool live = sx <= sx1;
      const size_t s = (size_t)sy * w + min(sx, sx1);
      const float2 f = fn[s];
      float gv[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) gv[ch] = live ? gn[s * C + ch] * up : 0.f;
      const int by = (int)floorf(-f.y) - RK + 1, bx = (int)floorf(-f.x) - RK + 1;
      float wy[NW], wx[NW];
      int qy[NW], qx[NW];
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        qy[a] = sy - (by + a) - y0;
        qx[a] = sx - (bx + a) - x0;
        const bool oky = qy[a] >= 0 && qy[a] < TH && by + a >= -rh && by + a <= rh;
        const bool okx = qx[a] >= 0 && qx[a] < TW && bx + a >= -rh && bx + a <= rh;
        wy[a] = live && oky ? tap_weight<RK>(a, (float)(by + a) + f.y) : 0.f;
        wx[a] = live && okx ? tap_weight<RK>(a, (float)(bx + a) + f.x) : 0.f;
      }
      const int key = (by & 0xffff) | (bx << 16);
      bool from[NW], mine[NW];
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        const int kd = __shfl_down_sync(0xffffffffu, key, b);
        const int ku = __shfl_up_sync(0xffffffffu, key, b);
        from[b] = b == 0 || (lane + b < 32 && kd == key);
        mine[b] = b > 0 && !(lane >= b && ku == key);
      }
      const bool qin = qx[0] >= 0 && qx[0] < TW;
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        if (!__any_sync(0xffffffffu, wy[a] != 0.f)) continue;
        const bool rin = qy[a] >= 0 && qy[a] < TH;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          unsigned slo = 0u;
          int shi = 0;
#pragma unroll
          for (int b = 0; b < NW; ++b) {
            const long long t = __float2ll_rn(wy[a] * wx[b] * gv[ch]);
            const unsigned tl = (unsigned)(t & low);
            const int th = (int)(t >> L);
            const unsigned cl = __shfl_down_sync(0xffffffffu, tl, b);
            const int ch_ = __shfl_down_sync(0xffffffffu, th, b);
            if (from[b]) {
              slo += cl;
              shi += ch_;
            }
            if (mine[b] && t != 0) {
              const int i = (ch * TH + qy[a]) * TW + qx[b];
              atomicAdd(&so[i], tl);
              atomicAdd(reinterpret_cast<int*>(&so[C * TH * TW + i]), th);
            }
          }
          if (rin && qin && (slo != 0u || shi != 0)) {
            const int i = (ch * TH + qy[a]) * TW + qx[0];
            atomicAdd(&so[i], slo);
            atomicAdd(reinterpret_cast<int*>(&so[C * TH * TW + i]), shi);
          }
        }
      }
    }
  }
"""

# the scatter of a kernel with one or two limbs a tile (`scatter<C, RK, ONE>`)
_K3_WALK = "  for (RectWalk p(sy0, sx0, rows, cols); p.live(); p.next()) {\n"
_K3_ONE_ADD = ("            atomicAdd(q + ch * PLANE, (unsigned)__float2int_rn(wgt * gv[ch]));\n")
_K3_TWO_ADD = ("            atomicAdd(q + ch * PLANE, (unsigned)(t & low));\n"
               "            atomicAdd(reinterpret_cast<int*>(q + (C + ch) * PLANE), (int)(t >> L));\n")
_K3_SCATTER_END = "    }\n  }\n}\n\n// 4 blocks an SM"
_K3_ONE = "  const bool one = ntap < 64;\n"

K3_VARIANTS = {
    "base": [],
    "noatomic": ([(_K3_SCATTER, _K3_SCATTER + "  unsigned nacc_lo = 0u;\n  int nacc_hi = 0;\n"),
                  (_K3_ATOMICS, "            nacc_lo += (unsigned)(t & low) ^ (unsigned)i;\n"
                                "            nacc_hi += (int)(t >> L);\n"),
                  (_K3_OUTPUTS, "  so[threadIdx.x] = nacc_lo;\n"
                                "  so[C * TH * TW + threadIdx.x] = (unsigned)nacc_hi;\n"
                   + _K3_OUTPUTS)],
                 [(_K3_WALK, "  unsigned nacc = 0u;\n" + _K3_WALK),
                  (_K3_ONE_ADD, "            nacc += (unsigned)__float2int_rn(wgt * gv[ch]);\n"),
                  (_K3_TWO_ADD, "            nacc += (unsigned)(t & low);\n"
                                "            nacc += (unsigned)(t >> L);\n"),
                  (_K3_SCATTER_END, "    }\n  }\n  so[threadIdx.x] += nacc;\n}\n\n"
                                    "// 4 blocks an SM")]),
    "onelimb": [(_K3_ATOMICS, "            atomicAdd(&so[i], (unsigned)t);\n")],
    "twolimb": [(_K3_ONE, "  const bool one = false;\n")],
    "noscatter": [("  if (finite && one)\n", "  if (false)\n"),
                  ("  else if (finite)\n", "  else if (false)\n")],
    "walkonly": [("        if (wx[b] == 0.f) continue;\n", "        if (true) continue;\n")],
    "nocvt": ([(_K3_CVT, "const long long t = (long long)__float_as_int(wgt * gv[ch]);")],
              [(_K3_ONE_ADD, "            atomicAdd(q + ch * PLANE, "
                             "(unsigned)__float_as_int(wgt * gv[ch]));\n")]),
    "noscatter": [("  if (finite && one)\n", "  if (false)\n"),
                  ("  else if (finite)\n", "  else if (false)\n")],
    "walkonly": [("        if (wx[b] == 0.f) continue;\n", "        if (true) continue;\n")],
    "nocvt": ([(_K3_CVT, "const long long t = (long long)__float_as_int(wgt * gv[ch]);")],
              [(_K3_ONE_ADD, "            atomicAdd(q + ch * PLANE, "
                             "(unsigned)__float_as_int(wgt * gv[ch]));\n")]),
    "nopad": [("constexpr int PLANE = TH * TW + 12;", "constexpr int PLANE = TH * TW;")],
    "scalarout": [(("  // 4. the outputs: a tile row's", "\n}\n\ntemplate <int C, int RK>\ncudaError_t"),
                   """  // 4. the outputs, a thread's pixels of one column, channel by channel
  const float down = pow2(-k);
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
#pragma unroll
  for (int i = 0; i < TH / ROWS_PER_STEP; ++i) {
    const int ly = ty + ROWS_PER_STEP * i, py = y0 + ly, px = x0 + tx;
    if (py >= h || px >= w) continue;
    float* o = on + ((size_t)py * w + px) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const int j = ch * PLANE + ly * TW + tx;
      const long long sum = one ? (long long)(int)so[j]
                                : (long long)(int)so[C * PLANE + j] * (1ll << L)
                                      + (long long)so[j];
      o[ch] = finite ? __ll2float_rn(sum) * down : NAN;
    }
  }""")],
    "norange": [(_K3_PASS1,
                 "  {\n    const float* rr = abl_ranges + 6 * (((size_t)n * gridDim.y + blockIdx.y)"
                 " * gridDim.x + blockIdx.x);\n"
                 "#pragma unroll\n    for (int i = 0; i < 6; ++i) v[i] = rr[i];\n  }\n")],
    "warpsum": [(_K3_LOOP, _K3_WARPSUM)],
    "tile16x32": [(_K3_TILE, "constexpr int TH = 16, TW = 32;")],
}
VARIANTS = {"K3": K3_VARIANTS, "K4": K4_VARIANTS}


def _alternatives(subs) -> list[list[tuple]]:
    return list(subs) if isinstance(subs, tuple) else [subs]


def _apply(src: str, alt) -> str | None:
    """src with each (old, new) of `alt` applied, or None where src lacks an
    old text. An old text that is a pair (start, end) names the span from
    start up to (not including) end."""
    for old, new in alt:
        if isinstance(old, tuple):
            i = src.find(old[0])
            j = src.find(old[1], i + 1) if i >= 0 else -1
            if j < 0:
                return None
            src = src[:i] + new + src[j:]
        elif old in src:
            src = src.replace(old, new)
        else:
            return None
    return src


def variant_sources(kernel: str, names, root: Path | None = None) -> dict[str, str]:
    """Each named variant's CUDA source (a name `a+b` applies both) for the
    kernel of the checkout at `root` (this one by default), with the hooks.
    A variant none of whose sets of texts the source holds is left out (the
    variants of the kernels before and after a redesign differ)."""
    csrc = (root / "tclight_torch" / "csrc") if root else kernels.CSRC
    src = (csrc / SOURCES[kernel]).read_text()
    src = src.replace("\nnamespace {", "\n" + _HOOK_DECL, 1) + _HOOK_SET
    texts = {}
    for name in names:
        text = src
        for part in name.split("+"):
            for alt in _alternatives(VARIANTS[kernel][part]):
                done = _apply(text, alt)
                if done is not None:
                    text = done
                    break
            else:
                text = None
                break
        if text is not None:
            texts[name] = text
    return texts


def ptxas_summary(log: str) -> str:
    """nvcc -Xptxas -v's output in one line: the functions, their register
    range, each function that spills (by name) and every C75xx, error or
    warning line."""
    regs, spills, other, fn = [], [], [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(f"{fn} ({m.group(1)}/{m.group(2)} bytes)")
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs.append(int(m.group(1)))
        if any(w in ln for w in ("C75", "error", "warning")):
            other.append(ln.strip())
    return (f"{len(regs)} functions, {min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"spills: {', '.join(spills) or 'none'}" + "".join(f" | {o}" for o in other))


def build(texts: dict[str, str], tag: str) -> dict[str, ctypes.CDLL]:
    """The variants' libraries, compiled in parallel (a library whose source
    is unchanged since its last build is kept); prints ptxas's register,
    spill and C75xx lines for each. A variant that does not build is
    reported and left out."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = OUT / f"{tag}-{name}.cu", OUT / f"{tag}-{name}.so"
        if so.exists() and cu.exists() and cu.read_text() == text:
            continue
        so.unlink(missing_ok=True)
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        print(f"[ptxas] {tag} {name}: {ptxas_summary(log)}", flush=True)
        if p.returncode:
            print(f"[ablate] {tag} {name}: does not build, left out", flush=True)
    return {name: ctypes.CDLL(str(OUT / f"{tag}-{name}.so")) for name in texts
            if (OUT / f"{tag}-{name}.so").exists()}


def wrapper_of(root: Path | None, module: str):
    """`tclight_torch/ops/<module>.py` of the checkout at `root` (this one's
    by default), loaded from its file."""
    path = (root or kernels.CSRC.parents[1]) / "tclight_torch" / "ops" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(f"_abl_{module}_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _set(lib, order=None, rows=1, ranges=None) -> None:
    fn = lib.tclight_ablate_set
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    kernels.check_launch(fn(order.data_ptr() if order is not None else None, rows,
                            ranges.data_ptr() if ranges is not None else None), "ablate hooks")


# ------------------------------------------------------------------ K4 calls

K4_SHAPES = ("render padded", "adjoint padded", "render distinct", "adjoint distinct",
             "k5 render", "k5 adjoint")


def k4_call(module, lib, case: dict, name: str):
    """(a call of `lib`'s K4 as `module` launches it on the case's plan, the
    output it writes)."""
    table = case["table4"] if "c4" in name.split("+") else case["table"]
    starts, offs, window, rows = case["starts"], case["offs"], case["window"], case["rows"]
    nb, bl = offs.shape
    out = torch.empty((nb, bl, 3), dtype=torch.float32, device="cuda")
    fn = lib.tclight_banded_gather
    argtypes = module._ENTRIES["tclight_banded_gather"]
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    extra = (rows,) if len(argtypes) == 12 else ()  # a checkout whose K4 takes the plan's rows
    stream = torch.cuda.current_stream().cuda_stream
    n_rows = case["table"].shape[0]

    _set(lib, case["order"], rows)  # once: a copy to a symbol waits on the card

    def call():
        kernels.check_launch(fn(table.data_ptr(), n_rows, 3, starts.data_ptr(),
                                offs.data_ptr(), offs.element_size(), out.data_ptr(), nb, bl,
                                window, *extra, stream), "K4")
    return call, out


def k5_call(module, lib, case: dict):
    """A call of `lib`'s K5 on the case's K-window plan (the control)."""
    fn = lib.tclight_banded_gather_multi
    fn.argtypes, fn.restype = module._ENTRIES["tclight_banded_gather_multi"], ctypes.c_int
    table, starts, offs, window = case["table"], case["starts"], case["offs"], case["window"]
    nb, bl = offs.shape
    out = torch.empty((nb, bl, 3), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: kernels.check_launch(
        fn(table.data_ptr(), table.shape[0], 3, starts.data_ptr(), offs.data_ptr(),
           offs.element_size(), out.data_ptr(), nb, bl, window, starts.shape[1], stream), "K5")


def k4_cases(plans: dict, k5: dict, gen: torch.Generator) -> dict:
    cases = {}
    for label, (n_rows, starts, offs, window, rows) in plans.items():
        table = torch.randn(n_rows, 3, device="cuda", generator=gen)
        starts, offs = starts.cuda().contiguous(), offs.cuda().contiguous()
        order = torch.sort(starts, stable=True).indices.int()
        # the plan's rows as the main path passes them: the render's, and one
        # for the adjoint
        cases[label] = dict(table=table, table4=F.pad(table, (0, 1)).contiguous(),
                            starts=starts, offs=offs, window=window, order=order,
                            rows=rows if label.startswith("render") else 1)
    for d in ("render", "adjoint"):
        n_rows, starts, offs, window = k5[d]
        cases[f"k5 {d}"] = dict(table=torch.randn(n_rows, 3, device="cuda", generator=gen),
                                starts=starts.cuda().contiguous(),
                                offs=offs.cuda().contiguous(), window=window, k5=True)
    return cases


def k4_bound(case: dict) -> float:
    offs, starts, table = case["offs"], case["starts"], case["table"]
    live = offs >= 0
    if starts.dim() == 1:
        idx = starts[:, None].long() + offs.long()
    else:
        o = offs.long().clamp(min=0)
        kk = o // case["window"]
        idx = torch.take_along_dim(starts.long(), kk, 1) + o - kk * case["window"]
    rows_read = torch.unique(idx[live]).numel()
    n_bytes = (4 * offs.numel() * 3 + offs.numel() * offs.element_size()
               + starts.numel() * 4 + rows_read * table.shape[1] * 4)
    return n_bytes / PEAK_BYTES * 1e3


# ------------------------------------------------------------------ K3 calls

K3_SHAPES = {f"{case} {d}": (case, r, d == "adjoint")
             for case, r in (("farneback", 4), ("random", 24), ("wide", 100))
             for d in ("forward", "adjoint")}


def tile_ranges(g: torch.Tensor, f: torch.Tensor, radius: int, th: int = 32,
                tw: int = 64, rk: int = 2) -> torch.Tensor:
    """K3's halo pass computed beforehand, per tile of th x tw: (N, tiles_y,
    tiles_x, 6) f32 of [min fx, max fx, min fy, max fy, 0, max |g|] over the
    tile's halo window (the tile +- radius + rk, clipped to the frame)."""
    n, h, w, _ = f.shape
    rh = radius + rk
    ty, tx = -(-h // th), -(-w // tw)

    def pool_max(x, fill):
        xp = F.pad(x[:, None], (rh, tx * tw - w + rh, rh, ty * th - h + rh), value=fill)
        return F.max_pool2d(xp, (th + 2 * rh, tw + 2 * rh), (th, tw))[:, 0]

    fx, fy = f[..., 0], f[..., 1]
    ninf = float("-inf")
    return torch.stack([-pool_max(-fx, ninf), pool_max(fx, ninf), -pool_max(-fy, ninf),
                        pool_max(fy, ninf), torch.zeros(n, ty, tx, device=f.device),
                        pool_max(g.abs().amax(-1), 0.0)], -1).contiguous()


def k3_cases(flows_path: Path, gen: torch.Generator) -> dict:
    big, wide = (16, 720, 960), (2, 160, 192)
    x = torch.rand(*big, 3, device="cuda", generator=gen)
    x_wide = torch.rand(*wide, 3, device="cuda", generator=gen)
    flows = {"farneback": (x, torch.from_numpy(np.load(flows_path)).cuda(), 4),
             "random": (x, (torch.rand(*big, 2, device="cuda", generator=gen) * 2 - 1) * 24, 24),
             "wide": (x_wide, (torch.rand(*wide, 2, device="cuda", generator=gen) * 2 - 1) * 100,
                      100)}
    cases = {}
    for label, (case, r, adjoint) in K3_SHAPES.items():
        xx, f, _ = flows[case]
        cases[label] = dict(x=xx, f=f.contiguous(), radius=r, adjoint=adjoint,
                            ranges={(th, tw): tile_ranges(xx, f, r, th, tw)
                                    for th, tw in ((32, 64), (16, 32))})
    return cases


def k3_call(module, lib, case: dict, name: str):
    """(a call of `lib`'s K3 as `module` launches it, the output it
    writes)."""
    x, f, r, adjoint = case["x"], case["f"], case["radius"], case["adjoint"]
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    fn = lib.tclight_window_warp_f32
    argtypes = getattr(module, "K3_ARGTYPES", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    ranges = case["ranges"][(16, 32) if "tile16x32" in name.split("+") else (32, 64)]
    stream = torch.cuda.current_stream().cuda_stream

    _set(lib, None, 1, ranges)

    def call():
        kernels.check_launch(fn(x.data_ptr(), f.data_ptr(), out.data_ptr(), n, h, w, c, r, 0,
                                int(adjoint), stream), "K3")
    return call, out


def k3_bound(case: dict) -> float:
    x, f = case["x"], case["f"]
    return 4 * (2 * x.numel() + f.numel()) / PEAK_BYTES * 1e3


# --------------------------------------------------------------------- main


def run_kernel(kernel: str, root, vs, names, shapes, rounds: int, gen) -> None:
    here = kernels.CSRC.parents[1]
    texts = variant_sources(kernel, names, root)
    for name in [n for n in names if n not in texts]:
        print(f"[ablate] {kernel} {name}: not applicable to {root or 'this checkout'}",
              flush=True)
    if vs is not None:
        texts["vs"] = variant_sources(kernel, ["base"], vs)["base"]
    libs = build(texts, kernel)
    wrapper = "banded_gather" if kernel == "K4" else "warp_kernel"
    module = wrapper_of(root, wrapper)
    vs_module = wrapper_of(vs, wrapper) if vs is not None else None
    if kernel == "K4":
        from tclight_torch import turns

        k4_path, k5_path = turns.plan_paths(here)
        cases = k4_cases(torch.load(k4_path, weights_only=False),
                         torch.load(k5_path, weights_only=False), gen)
    else:
        from tclight_torch import turns

        cases = k3_cases(turns.farneback_path(here), gen)
    for label in shapes:
        if label not in cases:
            print(f"[ablate] {kernel} {label}: no such plan in build/turns/, left out", flush=True)
            continue
        case = cases[label]
        calls, outs = {}, {}
        if case.get("k5"):
            calls["base"] = k5_call(module, libs["base"], case)
        else:
            for name, lib in libs.items():
                if kernel == "K4":
                    mod = vs_module if name == "vs" else module
                    calls[name], outs[name] = k4_call(mod, lib, case, name)
                else:
                    mod = vs_module if name == "vs" else module
                    calls[name], outs[name] = k3_call(mod, lib, case, name)
        for name, call in calls.items():
            timer = watchdog(f"{kernel} {label} {name}")
            call()
            torch.cuda.synchronize()
            timer.cancel()
        runs = {name: [] for name in calls}
        for _ in range(rounds):
            for name, call in calls.items():
                runs[name].append(cuda_event_ms(call, 10 if kernel == "K4" else 5)[0])
        times = {name: sorted(r)[rounds // 2] for name, r in runs.items()}
        err = "n/a"
        if kernel == "K4" and not case.get("k5"):
            from tclight_torch.ops.banded_gather import banded_gather_plain

            calls["base"]()
            torch.cuda.synchronize()
            ref = banded_gather_plain(case["table"], case["starts"], case["offs"])
            err = f"{(outs['base'] - ref).abs().max().item():.3e}"
            if "vs" in outs:
                err += f" vs_err={(outs['vs'] - ref).abs().max().item():.3e}"
            bound = k4_bound(case)
        elif kernel == "K4":
            bound = k4_bound(case)
        else:
            if label.startswith("farneback"):
                from tclight_torch.ops.warp_kernel import window_warp_plain

                calls["base"]()
                torch.cuda.synchronize()
                ref = window_warp_plain(case["x"], case["f"], case["radius"],
                                        adjoint=case["adjoint"])
                err = f"{(outs['base'] - ref).abs().max().item():.3e}"
            bound = k3_bound(case)
        print(f"[ablate] {kernel} {label} "
              + " ".join(f"{n}_ms={t:.4f}" for n, t in times.items())
              + " spread_ms: " + " ".join(f"{n}={max(r) - min(r):.4f}" for n, r in runs.items())
              + f" bound_ms={bound:.4f} base_err={err}", flush=True)
        del calls, outs
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    root, vs, rounds = None, None, 3
    while argv[:1] in (["--tree"], ["--vs"], ["--rounds"]) and len(argv) > 1:
        if argv[0] == "--rounds":
            rounds = int(argv[1])
        elif argv[0] == "--tree":
            root = Path(argv[1]).resolve()
        else:
            vs = Path(argv[1]).resolve()
        argv = argv[2:]
    which = [a for a in argv if a in VARIANTS] or list(VARIANTS)
    shape_names = {"K3": list(K3_SHAPES), "K4": list(K4_SHAPES)}
    rest = [a for a in argv if a not in VARIANTS]
    known = set(K3_SHAPES) | set(K4_SHAPES)
    if any(a not in known and not all(p in VARIANTS[k] for k in which for p in a.split("+"))
           for a in rest):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ablate_postopt: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel in which:
        shapes = [a for a in rest if a in shape_names[kernel]] or shape_names[kernel]
        names = [a for a in rest if a not in shape_names[kernel]
                 and all(p in VARIANTS[kernel] for p in a.split("+"))] or list(VARIANTS[kernel])
        if "base" not in names:
            names.insert(0, "base")
        run_kernel(kernel, root, vs, names, shapes, rounds, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
