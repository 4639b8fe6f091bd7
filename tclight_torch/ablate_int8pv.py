"""Where K7's time goes: its three parts (the PV pre-pass kernels, the max
pass, the attention) timed alone, and variants of the two kernels of
`csrc/flash_attention_int8.cu` with one part taken out or replaced, each
built by a text substitution and timed on the card on the pre-pass's
operands at the UNet's self-attention shapes (`unet`: levels 0-2, and the
yt pass's levels 0 and 1) and the Cosmos DiTs' (`dit`: 32 heads of 128 at
5,120, 14,080 and 56,320 tokens, where `attn_backend="int8pv"` sends
them), beside the whole wrapper and K6's on the same inputs.

    python -m tclight_torch.ablate_int8pv [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant. `--tree` and `--vs` as
in `ablate_qk_int8`: another checkout's kernels (on the operands of its
own pre-pass, launched as its `ops/attention.py` launches them), and
another's as a variant `vs` in the same rounds; the other checkout's max
pass must read q8 and k8, as this one's does (not bf16 copies).

Variants (all but base, addcvt, mp_addcvt, mp_cvt and the geometries
compute a wrong output by design; only their times are read):
  base       the kernels as they are
  addcvt     the attention's int32 scores converted by one integer and one
             float add on the magic number 1.5 * 2^23 (the kernel: the
             conversion instruction)
  nocvt      the attention's int32 scores read as floats, no conversion
  tconly     the attention without its softmax: the q.k^T and p.v
             products, the loads and the P blocks' dequantisation
  mp_tconly  the max pass without its per-score work (scale, mask, max):
             its q.k^T products and loads alone
  noload     the attention's k8, v8 and K-scale tiles loaded into the
             ring's first stages only, then reused
  mp_noload  the same for the max pass's k tiles and K scales
  mp_addcvt  the max pass's int32 sums converted as addcvt converts them
             where it takes the magic route (the kernel: an integer add and
             one FMA with the key's pair, up to dp 48)
  mp_cvt     the max pass's int32 sums converted by the conversion
             instruction, then multiplied by the key's scale, at every dp
  mp_magic   the max pass's magic route at every dp
  mp_wg2     the max pass with two consumer warpgroups at dp <= 48 (the
             kernel: three)
  mp_chain1, mp_chain2
             one or two chains a row for the max pass's running max (the
             kernel: four)
  chain1     one chain a row for the attention's row sum (the kernel: two)
  wg2        the attention with two consumer warpgroups of 240 registers at
             dp <= 48 (the kernel: three of 160)
  row128     q8's and k8's boxes 128 bytes a row, zero-filled, at every depth
             (the kernels: 64 bytes in the 64-byte swizzle up to depth 64)
  nst4       head dim 128: a ring of 4 stages (the kernels: 3)

Prints the card's name and power limit and ptxas's register and spill
lines for each variant, then one line per shape: each variant's max pass
and attention milliseconds (the median of N rounds, 3 by default, each
timing every call in turn, after a warm-up; the rounds' spread beside
it), each checkout's pre-pass (`prepass_ms`) and whole wrapper (`k7_ms`),
K6's wrapper, and whether the base max pass's block maxes equal the plain
version's on the same operands to 1e-6 relative (`maxpass_ok`). Needs a
CUDA card and nvcc; builds into build/tclight_torch/ablate_int8pv/.
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
_SOFTMAX = "      softmax(j + 1);\n"
_SCALE = "((e & 1) ? skv.y : skv.x)"
_CONVERT = f"const float u = (float)(int)s[4 * n + e] * {_SCALE};"
_MP_CONVERT = "MAGIC ? fmaf(__uint_as_float(s[4 * n + e] + MAGIC_BITS), k, kb)"
_MP_MAGIC = "mp_magic(int dp) { return dp <= 48; }"
_MAX = "      bmax[e >> 1][n % MP_CH] = fmaxf(bmax[e >> 1][n % MP_CH], u);\n"
_LOADS = "        mbar_expect_tx(&full[st], STAGE_TX);\n"
_MP_LOADS = "        mbar_expect_tx(&full[st], MP_STAGE_TX);\n"
_NOLOAD = "        if (j >= NS) { mbar_arrive(&full[st]); continue; }\n"
_ROW8 = "row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }"
VARIANTS = {
    "base": [],
    "addcvt": [(_CONVERT, "const float u = (__uint_as_float(s[4 * n + e] + MAGIC_BITS) - ROUND_MAGIC)"
                          f" * {_SCALE};")],
    "nocvt": [(_CONVERT, f"const float u = __uint_as_float(s[4 * n + e]) * {_SCALE};")],
    "tconly": [(_SOFTMAX, "")],
    "mp_tconly": [(_MAX, "")],
    "noload": [(_LOADS, _NOLOAD + _LOADS)],
    "mp_noload": [(_MP_LOADS, _NOLOAD + _MP_LOADS)],
    "mp_addcvt": [(_MP_CONVERT, "MAGIC ? (__uint_as_float(s[4 * n + e] + MAGIC_BITS)"
                                " - ROUND_MAGIC) * k")],
    "mp_cvt": [(_MP_MAGIC, "mp_magic(int dp) { return false; }")],
    "mp_magic": [(_MP_MAGIC, "mp_magic(int dp) { return true; }")],
    "mp_wg2": [("mp_consumers(int dp) { return dp <= 48 ? 3 : 2; }",
                "mp_consumers(int dp) { return 2; }")],
    "wg2": [("consumers(int dp) { return dp <= 48 ? 3 : 2; }", "consumers(int dp) { return 2; }")],
    "row128": [(_ROW8, "row8(int dp) { return 128; }")],
    "mp_chain1": [("constexpr int MP_CH = 4;", "constexpr int MP_CH = 1;")],
    "mp_chain2": [("constexpr int MP_CH = 4;", "constexpr int MP_CH = 2;")],
    "chain1": [("constexpr int PV_CH = 2;", "constexpr int PV_CH = 1;")],
    "nst4": [("n_stages(int dp) { return dp <= 64 ? 4 : 3; }",
              "n_stages(int dp) { return dp <= 64 || dp == 128 ? 4 : 3; }")],
}


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
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for level, b, s, h, d in (shape for name in sets for shape in SHAPES[name]):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps, scale = (5 if s > 20000 else 20), d ** -0.5
        ops = {t: m.int8pv_operands(q, k, v) for t, m in trees.items()}
        bms = {t: trees[t].int8_block_rowmax(op, b, h, s, s, d, scale) for t, op in ops.items()}
        ref = trees["base"].int8_block_rowmax_plain(ops["base"], s, s, scale)
        mp_err = float(((bms["base"] - ref).abs() / ref.abs().clamp(min=1e-30)).max().item())
        o = torch.empty_like(q)
        calls = {}
        for name, lib in (item for item in libs.items() if "prepass" not in item[0]):
            t = "vs" if name == "vs" else "base"
            op, bm = ops[t], torch.empty_like(bms[t])
            mp = lib.tclight_int8pv_blockmax
            mp.argtypes, mp.restype = attention.MAXPASS_ARGTYPES, ctypes.c_int
            fn = lib.tclight_flash_attention_int8pv
            fn.argtypes, fn.restype = attention.K7_ARGTYPES, ctypes.c_int
            calls[f"{name}_maxpass"] = (lambda mp=mp, op=op, bm=bm, name=name:
                                        kernels.check_launch(mp(
                                            op["q8"].data_ptr(), op["k8"].data_ptr(),
                                            op["sq"].data_ptr(),
                                            op["sk"].data_ptr(), bm.data_ptr(), b, h, s, s, d,
                                            op["bq"], scale, stream), name))
            calls[f"{name}_attention"] = (lambda fn=fn, op=op, bm=bms[t], name=name:
                                          kernels.check_launch(fn(
                                              *(op[n].data_ptr()
                                                for n in ("q8", "k8", "v8", "sq", "sk", "sv")),
                                              bm.data_ptr(), o.data_ptr(), b, h, s, s, d,
                                              op["bq"], scale, stream), name))
        for t, m in trees.items():
            calls[f"{t}_prepass"] = lambda m=m: m.int8pv_operands(q, k, v)
            calls[f"{t}_k7"] = lambda m=m: m.flash_attention_int8_cuda(q, k, v, scale, True)
        calls["base_k6"] = lambda: trees["base"].flash_attention_int8_cuda(q, k, v, scale, False)
        times, spread = in_rounds(calls, reps, rounds)
        print(f"[ablate-k7] {level} B={b} S={s} H={h} D={d} "
              + " ".join(f"{n}_ms={x:.4f}" for n, x in times.items())
              + " spread_ms: " + " ".join(f"{n}={x:.4f}" for n, x in spread.items())
              + f" maxpass_err={mp_err:.2e} maxpass_ok={mp_err <= 1e-6}", flush=True)
        del q, k, v, ops, bms, ref, o, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
