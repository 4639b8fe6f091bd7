"""Where K7's time goes: its kernel (`csrc/flash_attention_int8.cu`, each P
block swept twice, its maxes then its softmax and p.v) and variants of it
with one part taken out or replaced, each built by a text substitution and
timed on the card on the pre-pass's operands at the UNet's self-attention
shapes (`unet`: levels 0-2, and the yt pass's levels 0 and 1) and the
Cosmos DiTs' (`dit`: 32 heads of 128 at 5,120, 14,080 and 56,320 tokens,
where `attn_backend="int8pv"` sends them), beside the PV pre-pass kernels,
the whole wrapper and K6's on the same inputs.

    python -m tclight_torch.ablate_int8pv [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant. `--tree` and `--vs` as
in `ablate_qk_int8`: another checkout's kernel (on the operands of its own
pre-pass, launched as its `ops/attention.py` launches it), and another's
whole wrapper and pre-pass (`vs_k7_ms`, `vs_prepass_ms`) in the same
rounds; where that checkout's wrapper launched a max pass before its K7
kernel, `vs_k7_ms` includes it.

Variants (all but base, nosweep1, twice, onesweep and the geometries
compute a wrong output by design; only their times are read):
  base       the kernel as it is
  nosweep1   no first sweep: each P block's max read from a buffer that the
             plain version (`int8_block_rowmax_plain`) filled (a block
             ahead, so its latency hides), its k8 tiles still loaded and
             waited for, so the sweep's products and reduction show alone
  mx_bound   nosweep1 with two consumer warpgroups at dp <= 48: the
             consumers of a kernel whose fourth warpgroup made the block
             maxes for them, with that warpgroup's work left out
  nored      the first sweep's products kept, its reduction dropped
  twice      every k8 tile loaded twice, once for each sweep, at every dp
             (the kernel: loaded once and kept for both where the ring fits,
             dp <= 112)
  onesweep   the k8 tiles kept for both sweeps up to dp 128, with two v8
             stages at dp 128 where three do not fit (the kernel: loaded
             twice above dp 112)
  tconly     neither sweep's per-score work (the softmax, the reduction):
             the q.k^T and p.v products, the loads and the dequantisation
  noload     the k8 and v8 tiles (and K scales) loaded into the rings'
             first slots only, then reused
  nocvt      the softmax's int32 scores read as floats, no conversion
  s1_magic   the first sweep's scores made by an integer add and one FMA
             with the key's scale pair (`kernel_k_scales`), no conversion
             instruction, at every dp (the kernel: the conversion and a
             multiply by sk')
  cmul       the softmax's row factor c multiplied into each score (the
             kernel: joined to each key's scale as the tile is read)
  s1_chain1, s1_chain4
             one or four chains a row for the first sweep's running max
             (the kernel: two)
  chain1     one chain a row for the softmax's row sum (the kernel: two)
  nooverlap  tile j - 1's p.v waited for before tile j's softmax (the
             kernel: in flight during it), so p8's registers are free there
  turn_issue, turn_softmax
             the warpgroups' turns cover the issue of their sweep-2 products,
             or their softmax (one warpgroup's softmax at a time, beside the
             others' sweep 1), at every dp (the kernel: the issue with three
             consumer warpgroups, the softmax with two)
  wg2        two consumer warpgroups of 240 registers at dp <= 48 (the
             kernel: three of 160)
  row128     q8's and k8's boxes 128 bytes a row, zero-filled, at every depth
             (the kernel: 64 bytes in the 64-byte swizzle up to depth 64)
  nst4       head dim 128: a v8 ring of 4 stages (the kernel: 3)
  bk64       64-key tiles at every dp (the kernel: 128 up to dp 128)

Prints the card's name and power limit and ptxas's register and spill
lines for each variant, then one line per shape: each variant's
milliseconds (the median of N rounds, 3 by default, each timing every call
in turn, after an untimed round; the rounds' spread beside it), each
checkout's pre-pass (`prepass_ms`) and whole wrapper (`k7_ms`), K6's
wrapper, the base kernel's largest difference from the plain version on
two heads (`base_err`, with the 2e-2-of-the-largest-output tolerance of
the card tests) and each variant's from the base kernel. Needs a CUDA card
and nvcc; builds into build/tclight_torch/ablate_int8pv/.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from tclight_torch.ablate_qk_int8 import (SHAPES, build, card_name, in_rounds, parse,
                                          variant_sources, wrapper_of)
from tclight_torch.ops import attention, kernels

OUT = kernels.BUILD_DIR / "ablate_int8pv"

# the texts the variants replace
_SOFTMAX = "      softmax(j, sS + st * BK);\n"
_CONVERT = "(float)(int)s[4 * n + e], (e & 1) ? kc1 : kc0"
_CJOIN = """    const float kc0 = skv.x * c_row, kc1 = skv.y * c_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf((float)(int)s[4 * n + e], (e & 1) ? kc1 : kc0, -bm[e >> 1]));"""
_CMUL = """#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float u = (float)(int)s[4 * n + e] * ((e & 1) ? skv.y : skv.x);
      float p = fast_exp2(fmaf(u, c_row, -bm[e >> 1]));"""
_S1_SCORE = "      float u = (float)(int)s[4 * n + e] * ((e & 1) ? sk2.y : sk2.x);"
# the pair's second row follows the first in each k8 slot
_S1_MAGIC_SCORE = ("      float u = fmaf(__uint_as_float(s[4 * n + e] + 0x4B400000u), "
                   "(e & 1) ? sk2.y : sk2.x, tS[BK + n * 8 + 2 * t + (e & 1)]);")
_K_SCALES = ("        bulk_load(sS + st * BK, sk + (long)bh * 2 * skv_pad + kt * BK, BK * 4, "
             "&kfull[st]);")
_K_PAIRS = ("        for (int c = 0; c < 2; ++c)\n"
            "          bulk_load(sS + (st * 2 + c) * BK, "
            "sk + ((long)bh * 2 + c) * skv_pad + kt * BK, "
            "BK * 4, &kfull[st]);")
_REDUCE = """      if ((kt + 1) * BK > Skv) {
        if (fold) reduce_tile<BK, true, true>(s, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, true, false>(s, bmax, tS, t, lim, c_row);
      } else {
        if (fold) reduce_tile<BK, false, true>(s, bmax, tS, t, lim, c_row);
        else reduce_tile<BK, false, false>(s, bmax, tS, t, lim, c_row);
      }
"""
_S1_PRODUCTS = """      fence_regs(s);
      wgmma_fence();
      issue_qk8<BQ, BK, DK, R8>(s, sQw, sK + st * KTILE);
      wgmma_wait<0>();
      fence_regs(s);
"""
_BM = "          bm[r] = fold ? m * c_row : m;\n"
_SMEM_MAX = "constexpr size_t SMEM_MAX = 232448;"
_CASES = "#define TCLIGHT_INT8PV_CASES(CALL)"
# nosweep1's block maxes: a device pointer that tclight_ablate_set_blockmax
# sets, to (BH, Sq, n_kb) f32 as `int8_block_rowmax_plain` lays them out
_ROW = "q0 + cw * 64 + warp * 16 + g + 8 * r"
_BM_DECL = "    float bm[2];           // the max of the P block of the softmax's tile\n"
_BM_PREFETCH = (
    "    auto ablate_load = [&](int r, int kb) {\n"
    f"      const int row = {_ROW}, n_kb = (n_tiles + tpb - 1) / tpb;\n"
    "      return row < Sq && kb < n_kb ? ablate_bm[((long)bh * Sq + row) * n_kb + kb] : 0.f;\n"
    "    };\n"
    "    float bm_next[2] = {ablate_load(0, 0), ablate_load(1, 0)};\n")
_BM_READ = "          bm[r] = bm_next[r];\n          bm_next[r] = ablate_load(r, j / tpb + 1);\n"
_SETTER = ('extern "C" int tclight_ablate_set_blockmax(const void* p) {\n'
           "  return (int)cudaMemcpyToSymbol(ablate_bm, &p, sizeof(p));\n}\n\n")
_RESIDENT = "resident(int dp) { return smem_bytes(dp, true) <= SMEM_MAX; }"
_V_STAGES = "n_stages(int dp) { return dp <= 64 ? 4 : 3; }"
_K_LOAD = "        mbar_expect_tx(&kfull[st], K_TX);\n"
_V_LOAD = "        mbar_expect_tx(&vfull[st], VTILE);\n"
_ROW8 = "row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }"
_TURN = "constexpr bool TURN_SOFTMAX = NWG == 2;"
_WG2 = ("consumers(int dp) { return dp <= 48 ? 3 : 2; }", "consumers(int dp) { return 2; }")
_OVERLAP = """      wgmma_wait<1>();  // q.k^T of tile j (the older group) is done
      fence_all();
      if constexpr (TURN_SOFTMAX) take_turn();
      softmax(j, sS + st * BK);
      if constexpr (TURN_SOFTMAX) pass_turn(false);
      wgmma_wait<0>();  // p.v of tile j - 1 is done: pv and pa are free
      fence_all();
      warp_arrive(&kempty[st], lane);
      warp_arrive(&vempty[vs], lane);
      dequant(j - 1);
      pack_p();
"""
_NOOVERLAP = """      wgmma_wait<0>();
      fence_all();
      warp_arrive(&vempty[vs], lane);
      dequant(j - 1);
      if constexpr (TURN_SOFTMAX) take_turn();
      softmax(j, sS + st * BK);
      if constexpr (TURN_SOFTMAX) pass_turn(false);
      warp_arrive(&kempty[st], lane);
      pack_p();
"""
VARIANTS = {
    "base": [],
    "nosweep1": [(_S1_PRODUCTS, ""), (_REDUCE, ""), (_BM, _BM_READ),
                 (_BM_DECL, _BM_DECL + _BM_PREFETCH),
                 (_SMEM_MAX, _SMEM_MAX + "\n__device__ const float* ablate_bm;"),
                 (_CASES, _SETTER + _CASES)],
    "mx_bound": [],
    "nored": [(_REDUCE, "")],
    "twice": [(_RESIDENT, "resident(int dp) { return false; }")],
    "onesweep": [(_RESIDENT, "resident(int dp) { return dp <= 128; }"),
                 (_V_STAGES, "n_stages(int dp) { return dp <= 64 ? 4 : dp == 128 ? 2 : 3; }")],
    "tconly": [(_SOFTMAX, ""), (_REDUCE, "")],
    "noload": [(_K_LOAD, "        if (n >= NK) { mbar_arrive(&kfull[st]); ++n; return; }\n"
                + _K_LOAD),
               (_V_LOAD, "        if (j >= NV) { mbar_arrive(&vfull[st]); continue; }\n"
                + _V_LOAD)],
    "nocvt": [(_CONVERT, "__uint_as_float(s[4 * n + e]), (e & 1) ? kc1 : kc0")],
    "s1_magic": [(_S1_SCORE, _S1_MAGIC_SCORE), (_K_SCALES, _K_PAIRS),
                 ("constexpr uint32_t K_TX = KTILE + BK * 4;",
                  "constexpr uint32_t K_TX = KTILE + BK * 8;"),
                 ("kv_rows(dp) * (slabs8(dp) * row8(dp) + 4);",
                  "kv_rows(dp) * (slabs8(dp) * row8(dp) + 8);"),
                 ("(sS + NK * BK);", "(sS + NK * 2 * BK);"),
                 ("sS + st * BK", "sS + st * 2 * BK")],
    "cmul": [(_CJOIN, _CMUL)],
    "s1_chain1": [("constexpr int S1_CH = 2;", "constexpr int S1_CH = 1;")],
    "s1_chain4": [("constexpr int S1_CH = 2;", "constexpr int S1_CH = 4;")],
    "chain1": [("constexpr int PV_CH = 2;", "constexpr int PV_CH = 1;")],
    "nooverlap": [(_OVERLAP, _NOOVERLAP)],
    "wg2": [_WG2],
    "row128": [(_ROW8, "row8(int dp) { return 128; }")],
    "nst4": [("n_stages(int dp) { return dp <= 64 ? 4 : 3; }",
              "n_stages(int dp) { return dp <= 64 || dp == 128 ? 4 : 3; }")],
    "bk64": [("kv_rows(int dp) { return dp <= 128 ? 128 : 64; }",
              "kv_rows(int dp) { return 64; }")],
}
VARIANTS["mx_bound"] = VARIANTS["nosweep1"] + [_WG2]
VARIANTS["turn_issue"] = [(_TURN, "constexpr bool TURN_SOFTMAX = false;")]
VARIANTS["turn_softmax"] = [(_TURN, "constexpr bool TURN_SOFTMAX = true;")]


def main(argv: list[str]) -> int:
    args = parse(argv, VARIANTS, __doc__)
    if args is None:
        return 2
    root, vs, rounds, sets, names = args
    if not torch.cuda.is_available():
        print("ablate_int8pv: no CUDA device", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {card_name()}", flush=True)
    src, pre = "flash_attention_int8.cu", "flash_attention_qk_int8.cu"
    texts = variant_sources(VARIANTS, src, root)
    for name in [n for n in names if n not in texts]:
        print(f"[ablate-k7] {name}: not applicable to {root or 'this checkout'}", flush=True)
    names = [n for n in names if n in texts]
    print(f"[ablate-k7] kernel source: {root or kernels.CSRC.parents[1]}", flush=True)
    texts = {n: texts[n] for n in names}
    texts["prepass"] = variant_sources({"base": []}, pre, root)["base"]
    if vs is not None:
        texts["vs"] = variant_sources({"base": []}, src, vs)["base"]
        texts["vs_prepass"] = variant_sources({"base": []}, pre, vs)["base"]
    libs = build(OUT, texts)
    # each checkout's wrapper on its base libraries: its operands, its K6
    trees = {"base": wrapper_of(root, {"flash_attention_int8": libs["base"],
                                       "flash_attention_qk_int8": libs["prepass"]})}
    if vs is not None:
        trees["vs"] = wrapper_of(vs, {"flash_attention_int8": libs["vs"],
                                      "flash_attention_qk_int8": libs["vs_prepass"]})
    variants = {n: lib for n, lib in libs.items() if n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for level, b, s, h, d in (shape for name in sets for shape in SHAPES[name]):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps, scale = (5 if s > 20000 else 20), d ** -0.5
        ops = trees["base"].int8pv_operands(q, k, v)
        bm = None  # the plain block maxes, for the variants that read them
        for name, lib in variants.items():
            if hasattr(lib, "tclight_ablate_set_blockmax"):
                if bm is None:
                    bm = trees["base"].int8_block_rowmax_plain(ops, s, s, scale)
                set_bm = lib.tclight_ablate_set_blockmax
                set_bm.argtypes, set_bm.restype = [ctypes.c_void_p], ctypes.c_int
                kernels.check_launch(set_bm(bm.data_ptr()), f"{name}'s block maxes")
        o = torch.empty_like(q)
        calls, diffs, base = {}, {}, None
        for name, lib in variants.items():
            fn = lib.tclight_flash_attention_int8pv
            fn.argtypes, fn.restype = attention.K7_ARGTYPES, ctypes.c_int
            calls[name] = (lambda fn=fn, name=name: kernels.check_launch(fn(
                *(ops[n].data_ptr() for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                o.data_ptr(), b, h, s, s, d, ops["bq"], scale, stream), name))
            o.zero_()
            calls[name]()
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        for t, m in trees.items():
            calls[f"{t}_prepass"] = lambda m=m: m.int8pv_operands(q, k, v)
            calls[f"{t}_k7"] = lambda m=m: m.flash_attention_int8_cuda(q, k, v, scale, True)
        calls["base_k6"] = lambda: trees["base"].flash_attention_int8_cuda(q, k, v, scale, False)
        times, spread = in_rounds(calls, reps, rounds)
        hp = min(h, 2)
        ref = attention.flash_attention_int8_plain(*(t[:, :, :hp].contiguous() for t in (q, k, v)),
                                                   scale, True).float()
        err = (base[:, :, :hp] - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        print(f"[ablate-k7] {level} B={b} S={s} H={h} D={d} "
              + " ".join(f"{n}_ms={x:.4f}" for n, x in times.items())
              + " spread_ms: " + " ".join(f"{n}={x:.4f}" for n, x in spread.items())
              + f" base_err={err:.2e} tol={tol:.2e} base_ok={err <= tol}"
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
        del q, k, v, ops, bm, o, base, ref, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
