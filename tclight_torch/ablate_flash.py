"""Where K1's time goes: the kernel and variants of it with one part taken
out or one choice of its geometry changed, each built from
`csrc/flash_attention.cu` by a text substitution and timed on the card at
the UNet's self-attention shapes (xy levels 0-2, the yt pass's levels 0
and 1) and the Cosmos DiTs' (head dim 128: the 7B decoder's 5,120 tokens,
121 frames at 352 x 640 and at 704 x 1280; and 14,080 queries against
twice the keys: twice the 14,080-key shape's time less this one's is what
a block costs besides its k/v tiles, its prologue, epilogue and last
wave).

    python -m tclight_torch.ablate_flash [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant. `--tree` ablates the
kernel of another checkout of this repository (its
`tclight_torch/csrc/flash_attention.cu`, with the k and v its wrapper
hands the kernel: its `flash_kv_operands`); a variant whose texts its
source does not hold is left out, and says so. `--vs CHECKOUT` adds that
checkout's kernel, fed its own wrapper's k and v (their copies untimed),
as a variant `vs`, timed in the same rounds.

Variants (the geometries, ex2h, ex2bf and poly8 compute the same function,
the last three in other precisions; the rest a wrong output by design,
only their times are read):
  base     the kernel as it is
  noload   k/v tiles loaded into the ring's first stages only, then reused
  tconly   no softmax: the q.k^T and p.v products alone (and the loads)
  noexp    each exponential replaced by its argument
  poly8    one exponential in eight computed on the FMA pipes (a cubic)
  ex2h     the exponentials two at a time in f16 (ex2.approx.f16x2)
  nopp     no ping-pong between the consumer warpgroups
  nostore  the epilogue's stores taken out (its normalisation goes with them)
  wg2      two consumer warpgroups of 240 registers at dp <= 64 (the
           kernel: three of 160)
  bk64     64-key tiles up to dp 128 (the kernel: 128)
  wg4      four consumer warpgroups of 112 registers and 64-key tiles at
           dp <= 64
  mb2      up to dp 96 two 64-row q blocks per warpgroup, two warpgroups,
           64-key tiles in 4 stages: the tiles of the layout before, read
           in place
  pvslab   the p.v width padded to whole 64-dim slabs (the kernel: dp)
  nosumcol the row sums on the FMA pipes at D = dp - 8 too (the kernel:
           the tensor cores' p.v, through a v column of ones, up to dp 64)
  ex2bf    the exponentials two at a time on bf16 arguments
           (ex2.approx.ftz.bf16x2), their packed results p.v's operand;
           meaningful only where the row sums are p.v's (`sums_on_tc`)
  chain1, chain2, chain4
           one, two or four chains a row for the row max and sum at every
           dp (the kernel: two up to dp 96, one above)
  nst3     3 stages at dp <= 64 (the kernel: 4)
  nst2, bk176, bk192
           at dp 80-128 a ring of 2 stages of 128-, 176- or 192-key tiles
           (the kernel: 3 of 128)

Prints the card's name and power limit, then one line per shape: the
milliseconds of the wrapper's k/v operands alone (`kv_ms`: its copies,
where it makes them; 0 where it hands the kernel k and v as they are),
each variant's milliseconds (the median of N rounds, 3 by default, each
timing every variant in turn with `cuda_event_ms`, after a warm-up; the
rounds' spread beside it), the base
kernel's largest difference from the plain version (`base_err`, with the
2e-2-of-the-largest-output tolerance of the card tests) and each variant's
from the base kernel. Needs a CUDA card and nvcc; builds into
build/tclight_torch/ablate/.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

from tclight_torch.ops import attention, kernels
from tclight_torch.utils.logging import cuda_event_ms

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
_CONSUMERS = "consumers(int dp) { return dp <= 64 ? 3 : 2; }"
_KV_ROWS = "kv_rows(int dp) { return dp <= 128 ? 128 : 64; }"
_STAGES = "n_stages(int dp) { return dp <= 64 ? 4 : 3; }"
_CHAINS = "chains(int dp) { return dp <= 96 ? 2 : 1; }"


def _geometry(kv_rows: str, stages: str) -> list[tuple[str, str]]:
    return [(_KV_ROWS, f"kv_rows(int dp) {{ return {kv_rows}; }}"),
            (_STAGES, f"n_stages(int dp) {{ return {stages}; }}")]


# each variant: its substitutions, or several sets of them, the first set
# whose texts a source holds applying (the kernel's own first, then the
# layout before's)
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
    "nopp": ([("constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")],
             [("    auto take_turn = [&]() { named_sync(my_turn, 256); };",
               "    auto take_turn = [&]() {};"),
              ("      if (cw == 0 || !last) named_arrive(other_turn, 256);", ""),
              ("    if (cw == 1) named_arrive(other_turn, 256);\n", "")]),
    "nostore": [("          if (row < Sq)\n", "          if (row < 0)\n")],
    "wg2": [(_CONSUMERS, "consumers(int dp) { return 2; }")],
    "bk64": _geometry("64", "dp <= 64 ? 4 : 3"),
    "mb2": [(_CONSUMERS, "consumers(int dp) { return 2; }"),
            ("row_blocks(int dp) { return 1; }", "row_blocks(int dp) { return dp <= 96 ? 2 : 1; }"),
            *_geometry("dp <= 96 ? 64 : (dp <= 128 ? 128 : 64)", "dp <= 96 ? 4 : 3")],
    "wg4": [(_CONSUMERS, "consumers(int dp) { return dp <= 64 ? 4 : 2; }"),
            *_geometry("dp <= 64 ? 64 : (dp <= 128 ? 128 : 64)", "dp <= 64 ? 4 : 3")],
    "pvslab": [("pv_width(int dp) { return dp; }",
                "pv_width(int dp) { return slabs(dp) * SLAB; }")],
    "nosumcol": [("sums_on_tc(int dp) { return dp <= 64; }",
                  "sums_on_tc(int dp) { return false; }")],
    "ex2bf": [(_EXP, """          if (i % 2 == 0) {
            uint32_t h = pack_bf16(fmaf(s[mb][i], c, neg_m[(i >> 1) & 1]),
                                   fmaf(s[mb][i + 1], c, neg_m[(i >> 1) & 1]));
            asm("ex2.approx.ftz.bf16x2 %0, %0;" : "+r"(h));
            s[mb][i] = __uint_as_float(h);
          }"""),
              *[(f"pa[mb][kk][{n}] = pack_bf16(s[mb][8 * kk + {2 * n}], "
                 f"s[mb][8 * kk + {2 * n + 1}]);",
                 f"pa[mb][kk][{n}] = __float_as_uint(s[mb][8 * kk + {2 * n}]);")
                for n in range(4)]],
    "chain1": [(_CHAINS, "chains(int dp) { return 1; }")],
    "chain2": [(_CHAINS, "chains(int dp) { return 2; }")],
    "chain4": [(_CHAINS, "chains(int dp) { return 4; }")],
    "nst3": [(_STAGES, "n_stages(int dp) { return 3; }")],
    **{name: _geometry(f"dp > 64 && dp <= 128 ? {bk} : (dp <= 128 ? 128 : 64)",
                       "dp > 64 && dp <= 128 ? 2 : (dp <= 64 ? 4 : 3)")
       for name, bk in (("nst2", 128), ("bk176", 176), ("bk192", 192))},
}


def _alternatives(subs) -> list[list[tuple[str, str]]]:
    return list(subs) if isinstance(subs, tuple) else [subs]


def variant_sources(root: Path | None = None) -> dict[str, str]:
    """Every variant's CUDA source for the kernel of the checkout at `root`
    (this one by default). For this checkout every variant's first set of
    substitutions must apply, and a source that no longer holds a text it
    replaces raises; for another checkout a variant none of whose sets
    applies is left out."""
    csrc = (root / "tclight_torch" / "csrc") if root else kernels.CSRC
    src = (csrc / "flash_attention.cu").read_text().replace(
        '#include "hopper.cuh"', f'#include "{csrc.resolve()}/hopper.cuh"')
    texts = {}
    for name, subs in VARIANTS.items():
        for alt in _alternatives(subs):
            missing = [old for old, _ in alt if old not in src]
            if not missing:
                text = src
                for old, new in alt:
                    text = text.replace(old, new)
                texts[name] = text
                break
            if root is None:
                raise RuntimeError(f"variant {name}: the kernel source no longer has "
                                   f"{missing[0]!r}")
    return texts


def build(texts: dict[str, str], names) -> dict[str, ctypes.CDLL]:
    """The named variants' libraries, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        (OUT / f"{name}.cu").write_text(texts[name])
        procs[name] = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                                        str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")])
    if any(p.wait() for p in procs.values()):
        raise RuntimeError("a variant failed to build")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in names}


def kv_operands_of(root: Path):
    """`flash_kv_operands` of the checkout at `root`, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "_ablated_attention", root / "tclight_torch" / "ops" / "attention.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.flash_kv_operands


# chip_smoke's level-0, 1 and 2 shapes (8 frames at 960x720, merged) and
# the yt pass's levels 0 and 1 (30 frames); the DiTs' self-attention at
# 5,120, 14,080 and 56,320 tokens (32 heads of 128)
# (label, B, Sq, Skv, H, D)
SHAPES = {"unet": [("L0", 2, 35640, 35640, 8, 40), ("L1", 2, 8910, 8910, 8, 80),
                   ("L2", 8, 660, 660, 8, 160), ("yt-L0", 2, 8910, 8910, 8, 40),
                   ("yt-L1", 2, 2228, 2228, 8, 80)],
          "dit": [("dd", 1, 5120, 5120, 32, 128), ("t2w", 1, 14080, 14080, 32, 128),
                  ("t2w-kv2", 1, 14080, 28160, 32, 128), ("t2w-704", 1, 56320, 56320, 32, 128)]}


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
    texts = variant_sources(root)
    for name in [n for n in names if n not in texts]:
        print(f"[ablate] {name}: not applicable to {root}", flush=True)
    names = [n for n in names if n in texts]
    print(f"[ablate] kernel source: {root or kernels.CSRC.parents[1]}", flush=True)
    # --vs: the other checkout's kernel as one more variant, fed its own
    # wrapper's k and v, timed in the same rounds
    if vs is not None:
        texts, names = {**texts, "vs": variant_sources(vs)["base"]}, names + ["vs"]
    libs = build(texts, names)
    kv_operands = kv_operands_of(root) if root else attention.flash_kv_operands
    kv_vs = kv_operands_of(vs) if vs else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, b, sq, skv, h, d in (shape for name in sets for shape in SHAPES[name]):
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
        k, v = (torch.randn(b, skv, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                for _ in range(2))
        reps = 5 if max(sq, skv) > 20000 else 20
        kv_ms = cuda_event_ms(lambda: kv_operands(k, v), reps)[0]
        kc, vc = kv_operands(k, v)
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        calls, diffs, base = {}, {}, None
        operands = {"vs": kv_vs(k, v)} if vs else {}
        for name, lib in libs.items():
            fn = lib.tclight_flash_attention_bf16
            fn.argtypes, fn.restype = attention.K1_ARGTYPES, ctypes.c_int
            kn, vn = operands.get(name, (kc, vc))
            calls[name] = (lambda fn=fn, name=name, kn=kn, vn=vn: kernels.check_launch(
                fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), o.data_ptr(), b, h, sq, skv, d,
                   d ** -0.5, stream), name))
            o.zero_()
            calls[name]()
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        # the variants in turns, round after round: a card that slows as it
        # warms up weighs on each alike
        runs = {name: [] for name in calls}
        for _ in range(rounds):
            for name, call in calls.items():
                runs[name].append(cuda_event_ms(call, reps)[0])
        times = {name: sorted(r)[rounds // 2] for name, r in runs.items()}
        # the plain version on at most 2 heads: the base kernel's error
        hp = min(h, 2)
        ref = attention.flash_attention_plain(q[:, :, :hp].float(), k[:, :, :hp].float(),
                                              v[:, :, :hp].float(), d ** -0.5)
        err = (base[:, :, :hp] - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        print(f"[ablate] {level} B={b} Sq={sq} Skv={skv} H={h} D={d} kv_ms={kv_ms:.4f} "
              + " ".join(f"{n}_ms={t:.4f}" for n, t in times.items())
              + " spread_ms: " + " ".join(f"{n}={max(r) - min(r):.4f}" for n, r in runs.items())
              + f" base_err={err:.2e} tol={tol:.2e} base_ok={err <= tol}"
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
        del q, k, v, kc, vc, o, base, ref, operands
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
