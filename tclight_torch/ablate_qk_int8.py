"""Where K6's time goes: the kernel and variants of it with one part taken
out or replaced, each built from `csrc/flash_attention_qk_int8.cu` by a
text substitution and timed on the card on its pre-pass's operands at the
UNet's self-attention shapes (`unet`: levels 0-2, and the yt pass's levels
0 and 1) and the Cosmos DiTs' (`dit`: 32 heads of 128 at 5,120, 14,080 and
56,320 tokens, where `attn_backend="int8"` sends them), beside K6's
pre-pass kernels, the whole wrapper and K1 on the same inputs.

    python -m tclight_torch.ablate_qk_int8 [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [unet | dit] [VARIANT ...]

With no arguments, every shape and every variant. `--tree` ablates the
kernel of another checkout of this repository (its
`tclight_torch/csrc/flash_attention_qk_int8.cu`, on the operands of that
checkout's own pre-pass, launched as its `ops/attention.py` launches it);
a variant whose texts its source does not hold is left out, and says so.
`--vs CHECKOUT` adds that checkout's kernel, on its own pre-pass's
operands, as a variant `vs`, timed in the same rounds.

Variants (all but base, addcvt and the geometries compute a wrong output
by design; only their times are read):
  base     the kernel as it is (its pre-pass not included)
  addcvt   the int32 sums converted by one integer and one float add on the
           magic number 1.5 * 2^23 (the kernel: the conversion instruction),
           then multiplied by the key's scale
  nocvt    the int32 sums read as floats, no conversion at all
  noscale  the K scales left out of the scores
  tconly   no softmax: the q.k^T and p.v products alone (and the loads)
  noload   k8, v and K-scale tiles loaded into the ring's first stages
           only, then reused
  nosumcol the row sums on the FMA pipes at D = dp - 8 too (the kernel: the
           tensor cores' p.v, through a v column of ones, up to dp 64)
  wg2      two consumer warpgroups of 240 registers at dp <= 64 (the
           kernel: three of 160)
  row128   q8's and k8's boxes 128 bytes a row, zero-filled, at every depth
           (the kernel: 64 bytes in the 64-byte swizzle up to depth 64)
  nst3     3 stages at dp <= 64 (the kernel: 4)
  chain1, chain2, chain4
           one, two or four chains a row for the softmax's row max and sum
           (the kernel: two up to dp 96, one above)
  nst2, nst4
           head dim 128: a ring of 2 or 4 stages (the kernel: 3)

Prints the card's name and power limit and ptxas's register and spill
lines for each variant, then one line per shape: each variant's
milliseconds (the median of N rounds, 3 by default, each timing every
variant in turn with `cuda_event_ms` after a warm-up; the rounds' spread
beside it), the pre-pass's (`prepass_ms`) and the whole wrapper's
(`k6_ms`) of each checkout, K1's on the same inputs, the base kernel's
largest difference from the plain version on two heads (`base_err`, with
the 2e-2-of-the-largest-output tolerance of the card tests) and each
variant's from the base kernel. Needs a CUDA card and nvcc; builds into
build/tclight_torch/ablate_qk_int8/.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import torch

from tclight_torch.ops import attention, kernels
from tclight_torch.utils.logging import cuda_event_ms

OUT = kernels.BUILD_DIR / "ablate_qk_int8"

# the texts the variants replace
_SCALE = "((e & 1) ? skv.y : skv.x)"
_CONVERT = f"s[i] = __float_as_uint((float)(int)s[i] * {_SCALE});"
_SOFTMAX = "      float alpha[2];\n      softmax(j + 1, alpha);\n"
_LOADS = "        mbar_expect_tx(&full[st], STAGE_TX);\n"
_NOLOAD = "        if (j >= NST) { mbar_arrive(&full[st]); continue; }\n"
_CONSUMERS = "consumers(int dp) { return dp <= 64 ? 3 : 2; }"
_STAGES = "n_stages(int dp) { return dp <= 64 ? 4 : 3; }"
VARIANTS = {
    "base": [],
    "addcvt": [(_CONVERT, "s[i] = __float_as_uint((__uint_as_float(s[i] + 0x4B400000u) - 12582912.f)"
                          f" * {_SCALE});")],
    "nocvt": [(_CONVERT, f"s[i] = __float_as_uint(__uint_as_float(s[i]) * {_SCALE});")],
    "noscale": [(_CONVERT, "s[i] = __float_as_uint((float)(int)s[i]);")],
    "tconly": [(_SOFTMAX, "      float alpha[2] = {};\n")],
    "noload": [(_LOADS, _NOLOAD + _LOADS)],
    "nosumcol": [("sums_on_tc(int dp) { return dp <= 64; }", "sums_on_tc(int dp) { return false; }")],
    "wg2": [(_CONSUMERS, "consumers(int dp) { return 2; }")],
    "row128": [("row8(int dp) { return depth8(dp) <= 64 ? 64 : 128; }",
                "row8(int dp) { return 128; }")],
    "nst3": [(_STAGES, "n_stages(int dp) { return 3; }")],
    **{f"chain{n}": [("chains(int dp) { return dp <= 96 ? 2 : 1; }",
                      f"chains(int dp) {{ return {n}; }}")] for n in (1, 2, 4)},
    **{f"nst{n}": [(_STAGES, f"n_stages(int dp) {{ return dp == 128 ? {n} : (dp <= 64 ? 4 : 3); }}")]
       for n in (2, 4)},
}
# chip_smoke's level-0, 1 and 2 shapes (8 frames at 960x720, merged), the
# yt pass's levels 0 and 1; the DiTs' self-attention
# (label, B, S, H, D)
SHAPES = {"unet": [("L0", 2, 35640, 8, 40), ("L1", 2, 8910, 8, 80), ("L2", 8, 660, 8, 160),
                   ("yt-L0", 2, 8910, 8, 40), ("yt-L1", 2, 2228, 8, 80)],
          "dit": [("dd", 1, 5120, 32, 128), ("t2w", 1, 14080, 32, 128),
                  ("t2w-704", 1, 56320, 32, 128)]}


def variant_sources(variants: dict, source: str, root: Path | None = None) -> dict[str, str]:
    """Every variant's CUDA source of `source` (a file of csrc/) in the
    checkout at `root` (this one by default), each variant a list of (old,
    new) substitutions. For this checkout a source that no longer holds a
    text a variant replaces raises; for another checkout that variant is
    left out."""
    csrc = (root / "tclight_torch" / "csrc") if root else kernels.CSRC
    src = (csrc / source).read_text().replace(
        '#include "hopper.cuh"', f'#include "{csrc.resolve()}/hopper.cuh"')
    texts = {}
    for name, subs in variants.items():
        missing = [old for old, _ in subs if old not in src]
        if missing and root is None:
            raise RuntimeError(f"variant {name}: the kernel source no longer has {missing[0]!r}")
        if not missing:
            text = src
            for old, new in subs:
                text = text.replace(old, new)
            texts[name] = text
    return texts


def ptxas_summary(log: str) -> str:
    """ptxas -v's lines per kernel instance, shortened: `name<first template
    int>:registers`, with its spill stores / loads in bytes where it spills,
    then every C75xx warning (a serialised wgmma) as ptxas wrote it."""
    lines, items = log.splitlines(), []
    for i, ln in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", ln)
        if not m:
            continue
        k = re.search(r"\d+([a-z][a-z_0-9]*)I(?:Li(\d+)E)?", m.group(1))
        name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
        after = "\n".join(lines[i + 1:i + 3])  # the spill line, then the registers
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", after)
        regs = re.search(r"Used (\d+) registers", after)
        items.append(f"{name}:{regs.group(1) if regs else '?'}"
                     + (f" SPILLS {spill[1]}/{spill[2]}" if spill and spill.groups() != ("0", "0")
                        else ""))
    warns = sorted({ln.strip() for ln in log.splitlines() if "C75" in ln or "error" in ln})
    return " | ".join(sorted(items) + warns)


def build(out: Path, texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """The libraries of `texts` (name -> source), compiled in parallel;
    prints ptxas's registers and spills per kernel instance and its
    serialisation warnings for each (`ptxas_summary`)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, p in procs.items():
        log, _ = p.communicate()
        print(f"[ptxas] {name}: " + ptxas_summary(log), flush=True)
        if p.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"variants failed to build: {failed}")
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in texts}


class LibKernels:
    """Stands in for the `kernels` module of a loaded `ops/attention.py`:
    its kernel calls go to the given libraries (by source name), its
    launches to a table of its own."""

    def __init__(self, libs: dict[str, ctypes.CDLL]) -> None:
        self.libs = libs
        self.STATS = collections.defaultdict(kernels.KernelStats)
        self.check_launch = kernels.check_launch

    def function(self, name: str, entry: str, argtypes, restype):
        fn = getattr(self.libs[name], entry)
        fn.argtypes, fn.restype = argtypes, restype
        return fn


def wrapper_of(root: Path | None, libs: dict[str, ctypes.CDLL]):
    """The `ops/attention.py` of the checkout at `root` (this one's by
    default), loaded from its file, its kernels those of `libs`."""
    path = (root or kernels.CSRC.parents[1]) / "tclight_torch" / "ops" / "attention.py"
    spec = importlib.util.spec_from_file_location(f"_ablated_attention_{abs(hash(str(path)))}_"
                                                  f"{len(libs)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.kernels = LibKernels(libs)
    return module


def parse(argv: list[str], variants: dict, doc: str):
    """(tree, vs, rounds, shape sets, variant names) from the command line,
    or None after printing the usage."""
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
    names = [a for a in argv if a not in SHAPES] or list(variants)
    if any(n not in variants for n in names):
        print(doc, file=sys.stderr)
        return None
    if "base" not in names:
        names.insert(0, "base")  # the differences are taken to it
    return root, vs, rounds, sets, names


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def in_rounds(calls: dict, reps: int, rounds: int) -> tuple[dict, dict]:
    """Each call's median milliseconds over `rounds` rounds after an untimed
    one, every call timed in turn in each (a card that slows as it warms
    weighs on each alike), and the rounds' spread."""
    runs = {name: [] for name in calls}
    for call in calls.values():  # an untimed round: the first call timed reads high
        cuda_event_ms(call, 1)
    for _ in range(rounds):
        for name, call in calls.items():
            runs[name].append(cuda_event_ms(call, reps)[0])
    return ({n: sorted(r)[rounds // 2] for n, r in runs.items()},
            {n: max(r) - min(r) for n, r in runs.items()})


def main(argv: list[str]) -> int:
    args = parse(argv, VARIANTS, __doc__)
    if args is None:
        return 2
    root, vs, rounds, sets, names = args
    if not torch.cuda.is_available():
        print("ablate_qk_int8: no CUDA device", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {card_name()}", flush=True)
    src = "flash_attention_qk_int8.cu"
    texts = variant_sources(VARIANTS, src, root)
    for name in [n for n in names if n not in texts]:
        print(f"[ablate-k6] {name}: not applicable to {root or 'this checkout'}", flush=True)
    names = [n for n in names if n in texts]
    print(f"[ablate-k6] kernel source: {root or kernels.CSRC.parents[1]}", flush=True)
    texts = {n: texts[n] for n in names}
    if vs is not None:
        texts["vs"] = variant_sources({"base": []}, src, vs)["base"]
    libs = build(OUT, texts)
    # each checkout's wrapper, its kernels its base library: its operands
    trees = {"base": wrapper_of(root, {"flash_attention_qk_int8": libs["base"]})}
    if vs is not None:
        trees["vs"] = wrapper_of(vs, {"flash_attention_qk_int8": libs["vs"]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for level, b, s, h, d in (shape for name in sets for shape in SHAPES[name]):
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen, dtype=torch.bfloat16)
                   for _ in range(3))
        reps, scale = (5 if s > 20000 else 20), d ** -0.5
        ops = {t: m.qk_int8_operands(q, k, v) for t, m in trees.items()}
        o = torch.empty_like(q)
        calls, diffs, base = {}, {}, None
        for name, lib in libs.items():
            fn = lib.tclight_flash_attention_qk_int8
            fn.argtypes, fn.restype = attention.K6_ARGTYPES, ctypes.c_int
            op = ops["vs" if name == "vs" else "base"]
            calls[name] = (lambda fn=fn, op=op, name=name: kernels.check_launch(
                fn(op["q8"].data_ptr(), op["k8"].data_ptr(), op["v"].data_ptr(),
                   op["sq"].data_ptr(), op["sk"].data_ptr(), o.data_ptr(), b, h, s, s, d,
                   op["bq"], scale, stream), name))
            o.zero_()
            calls[name]()
            if base is None:
                base = o.float()
            diffs[name] = (o.float() - base).abs().max().item()
        for t, m in trees.items():
            calls[f"{t}_prepass"] = lambda m=m: m.qk_int8_operands(q, k, v)
            calls[f"{t}_k6"] = lambda m=m: m.flash_attention_int8_cuda(q, k, v, scale, False)
        calls["k1"] = lambda: attention.flash_attention_cuda(q, k, v, scale)
        times, spread = in_rounds(calls, reps, rounds)
        hp = min(h, 2)
        ref = attention.flash_attention_int8_plain(*(t[:, :, :hp].contiguous() for t in (q, k, v)),
                                                   scale).float()
        err = (base[:, :, :hp] - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        print(f"[ablate-k6] {level} B={b} S={s} H={h} D={d} "
              + " ".join(f"{n}_ms={t:.4f}" for n, t in times.items())
              + " spread_ms: " + " ".join(f"{n}={x:.4f}" for n, x in spread.items())
              + f" base_err={err:.2e} tol={tol:.2e} base_ok={err <= tol}"
              + " max_abs_diff_to_base: " + " ".join(f"{n}={e:.2e}" for n, e in diffs.items()),
              flush=True)
        del q, k, v, ops, o, base, ref, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
