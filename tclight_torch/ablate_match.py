"""Where K2's time goes: the ToMe matcher and variants of it with one part
taken out or one choice of its geometry changed, each built from
`csrc/match_argmax.cu` by a text substitution and timed on the card at the
main path's four merges (chip_smoke's `match_shapes`: the global and the
local merge at UNet levels 0 and 1, C = 320 and 640) and two of the yt
pass's small ones.

    python -m tclight_torch.ablate_match [--tree CHECKOUT] [--vs CHECKOUT] [--rounds N]
        [SHAPE ...] [VARIANT ...]

With no arguments, every shape and every variant. `--tree` ablates the
kernel of another checkout of this repository (its
`tclight_torch/csrc/match_argmax.cu`, launched as that checkout's
`ops/match_kernel.py` launches it); a variant whose texts its source does
not hold is left out, and says so. `--vs CHECKOUT` adds that checkout's
kernel as a variant `vs`, timed in the same rounds.

Variants (the geometries compute the same function; the rest a wrong
output by design, only their times are read):
  base      the kernel as it is
  noload    dst stages loaded into the ring's first stages only, then
            reused: the producer arrives on a stage's full barrier without
            a load, so the consumers never wait on the dst stream
  nofold    no fold: the products alone, one score of each row kept (its
            max with the running value) so that the products stay
  nosrc     each block loads its first src tile only, later ones not
  mb1       128-row src tiles at every channel count (C = 320: 256)
  nooverlap each accumulator folded with no product in flight (the
            kernel: accumulator 0's fold under accumulator 1's last
            products, accumulator 1's under the next tile's first)
  search    the fold searches every tile for its first maximiser (the
            kernel: only where a row's tile max beats its running max)
  noepi     the key buffer's memset and the unpack kernel left out

Prints the card's name and power limit, then one line per shape: the
milliseconds of the wrapper's operand copies alone (`copy_ms`: the
chunk-major copies of a and bt where a checkout's wrapper makes them, 0
where it reads them in place), each variant's milliseconds, the kernel
alone with its operands made beforehand (the median of N rounds, 3 by
default, each timing every variant in turn with `cuda_event_ms`, after a
warm-up; the rounds' spread beside it), the bound (2 B S D C operations at
the bf16 peak), and the base kernel's largest difference from the plain
version with its index mismatches where the best two scores differ by more
than 1e-4 (the card tests' tolerance). Prints ptxas's register, spill and
wgmma-serialisation lines for each variant. A variant whose first call
does not end within 60 s ends the run (exit code 3) and is named. Needs a
CUDA card and nvcc; builds into build/tclight_torch/ablate_match/.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from tclight_torch.ops import kernels, match_kernel
from tclight_torch.utils.logging import cuda_event_ms

OUT = kernels.BUILD_DIR / "ablate_match"
PEAK_BF16_FLOPS = 989e12

# the layout before (the chunk-major copies and the (n_chunks, grid) split
# of PR 5's kernel): the texts its variants replace
_OLD_LOAD = """            mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);
            tma_load_4d(sB + (size_t)s * BN * KC, &tb, &full[s], 0, t * BN, kc * 8, b);"""
_OLD_FOLD = """            float best = -INFINITY;
            int col = 0;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {  // columns in increasing order
                const float x = acc[mb][4 * j + 2 * r + e];
                if (x > best) {
                  best = x;
                  col = 8 * j + 2 * t4 + e;
                }
              }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes of a row
              const float ob = __shfl_xor_sync(0xffffffffu, best, off);
              const int oc = __shfl_xor_sync(0xffffffffu, col, off);
              if (ob > best || (ob == best && oc < col)) {
                best = ob;
                col = oc;
              }
            }
            if (best > run_max[mb][r]) {  // strictly greater: the first one wins
              run_max[mb][r] = best;
              run_idx[mb][r] = d0 + col;
            }
"""
_OLD_SRC = """        mbar_expect_tx(a_full, (uint32_t)src_bytes(MB, nkc));
        tma_load_4d(sA, &ta, a_full, 0, st * BS, 0, b);"""
_OLD_EPI = [("  cudaError_t err = cudaMemsetAsync(keys, 0, (size_t)S * 8, stream);\n"
             "  if (err != cudaSuccess) return (int)err;\n",
             "  cudaError_t err;\n"),
            ("  match_argmax_unpack_kernel<<<(S + 255) / 256, 256, 0, stream>>>(\n"
             "      (const unsigned long long*)keys, (float*)node_max, (int*)node_idx, S);\n", "")]

# the kernel's own texts that its variants replace
_LOAD = """          mbar_expect_tx(&full[s], (uint32_t)STAGE_BYTES);"""
_FOLD = """      float tmax[2];
      bool up = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m0 = acc[J][2 * r], m1 = acc[J][2 * r + 1];
#pragma unroll
        for (int j = 1; j < BW / 8; ++j) {
          m0 = fmaxf(m0, acc[J][4 * j + 2 * r]);
          m1 = fmaxf(m1, acc[J][4 * j + 2 * r + 1]);
        }
        float m = fmaxf(m0, m1);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the 4 lanes of a row
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        tmax[r] = m;
        up |= m > run_max[R][r];
      }
      if (__any_sync(0xffffffffu, up)) {  // the lowest column of the tile max
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int col = BW;
#pragma unroll
          for (int j = BW / 8 - 1; j >= 0; --j)
#pragma unroll
            for (int e = 1; e >= 0; --e)
              if (acc[J][4 * j + 2 * r + e] == tmax[r]) col = 8 * j + 2 * t4 + e;
          col = min(col, __shfl_xor_sync(0xffffffffu, col, 1));
          col = min(col, __shfl_xor_sync(0xffffffffu, col, 2));
          if (tmax[r] > run_max[R][r]) {  // strictly greater: the first one wins
            run_max[R][r] = tmax[r];
            run_idx[R][r] = d0 + col;
          }
        }
      }
"""
_SRC = """            mbar_expect_tx(&a_full[kc], (uint32_t)(BS * SLAB * 2));"""
_EPI = [("  err = cudaMemsetAsync(keys, 0, (size_t)S * 8, stream);\n"
         "  if (err != cudaSuccess) return (int)err;\n", ""), _OLD_EPI[1]]

# each variant: its substitutions, or several sets of them, the first set
# whose texts a source holds applying (the kernel's own first, then the
# layout before's)
VARIANTS = {
    "base": [],
    "noload": ([(_LOAD, "          if (it >= NST) { mbar_arrive(&full[s]); continue; }\n" + _LOAD)],
               [(_OLD_LOAD, "            if (it >= nst) { mbar_arrive(&full[s]); continue; }\n"
                 + _OLD_LOAD)]),
    "nofold": ([(_FOLD, "      run_max[R][0] = fmaxf(run_max[R][0], acc[J][0]);\n"
                        "      run_max[R][1] = fmaxf(run_max[R][1], acc[J][2]);\n")],
               [(_OLD_FOLD,
                 "            run_max[mb][r] = fmaxf(run_max[mb][r], acc[mb][2 * r]);\n")]),
    "nosrc": ([(_SRC, "            if (k > 0) {\n              mbar_arrive(&a_full[kc]);\n"
                      "              continue;\n            }\n" + _SRC)],
              [(_OLD_SRC, "        if (k > 0) {\n          mbar_arrive(a_full);\n        } else {\n"
                + _OLD_SRC + "\n        }")]),
    "mb1": [("row_blocks(int nkc) { return nkc <= 6 ? 2 : 1; }",
             "row_blocks(int nkc) { return 1; }")],
    "nooverlap": [("        first();  // tile t + 1's first products, under which "
                   "accumulator 1 folds\n        wgmma_wait<1>();\n", "        wgmma_wait<0>();\n"),
                  ("        fold(J1, t % n_dt * BN + J1_ROW);\n",
                   "        fold(J1, t % n_dt * BN + J1_ROW);\n        first();\n"),
                  ("      wgmma_wait<1>();  // accumulator 0 folds under accumulator 1's last "
                   "products", "      wgmma_wait<0>();")],
    "search": [("      if (__any_sync(0xffffffffu, up)) {  // the lowest column of the tile max",
                "      if (true) {")],
    "noepi": (_EPI, _OLD_EPI),
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
    src = (csrc / "match_argmax.cu").read_text().replace(
        '#include "hopper.cuh"', f'#include "{csrc.resolve()}/hopper.cuh"')
    texts = {}
    for name, subs in VARIANTS.items():
        alts = _alternatives(subs)
        for n_alt, alt in enumerate(alts):
            missing = [old for old, _ in alt if old not in src]
            if not missing:
                text = src
                for old, new in alt:
                    text = text.replace(old, new)
                texts[name] = text
                break
            if root is None and n_alt == 0:
                raise RuntimeError(f"variant {name}: the kernel source no longer has "
                                   f"{missing[0]!r}")
    return texts


def build(texts: dict[str, str], names) -> dict[str, ctypes.CDLL]:
    """The named variants' libraries, compiled in parallel (a library whose
    source is unchanged since its last build is kept); prints ptxas's
    register, spill and serialisation lines for each."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        if so.exists() and cu.exists() and cu.read_text() == texts[name]:
            continue
        so.unlink(missing_ok=True)
        cu.write_text(texts[name])
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, p in procs.items():
        log, _ = p.communicate()
        keep = [ln.strip() for ln in log.splitlines()
                if any(w in ln for w in ("registers", "spill", "C75", "error", "warning"))]
        print(f"[ptxas] {name}: " + " | ".join(keep), flush=True)
        if p.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"variants failed to build: {failed}")
    return {name: ctypes.CDLL(str(OUT / f"{name}.so")) for name in names}


def watchdog(what: str, seconds: float = 60.0) -> threading.Timer:
    """A timer that ends the process (exit code 3) if it is not cancelled
    within `seconds`: a variant whose first call does not return names
    itself instead of holding the card."""
    def fire():
        print(f"[ablate] {what}: no end after {seconds:.0f} s: hung", flush=True)
        os._exit(3)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def wrapper_of(root: Path | None):
    """The `ops/match_kernel.py` of the checkout at `root` (this one's by
    default), loaded from its file."""
    if root is None:
        return match_kernel
    spec = importlib.util.spec_from_file_location(
        f"_ablated_match_{abs(hash(str(root)))}",
        root / "tclight_torch" / "ops" / "match_kernel.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chunk_major(t: torch.Tensor) -> torch.Tensor:
    """The layout before's operand: (B, R, C) as (B, C / 8, R, 8)."""
    b, r, c = t.shape
    return t.view(b, r, c // 8, 8).transpose(1, 2).contiguous()


def kernel_call(module, lib: ctypes.CDLL, a: torch.Tensor, bt: torch.Tensor):
    """(a call of `lib`'s K2 on a and bt as `module` launches it, with the
    operands made beforehand; (node_max, node_idx) it writes; the
    wrapper's operand copies as a call, or None where it reads in place)."""
    fn = lib.tclight_match_argmax_bf16
    fn.argtypes, fn.restype = module.K2_ARGTYPES, ctypes.c_int
    b, s, c = a.shape
    d = bt.shape[1]
    keys = torch.empty(s, dtype=torch.int64, device=a.device)
    m = torch.empty(s, dtype=torch.float32, device=a.device)
    i = torch.empty(s, dtype=torch.int32, device=a.device)
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    if len(module.K2_ARGTYPES) == 12:  # chunk-major copies, (n_chunks, grid)
        ops = (chunk_major(a), chunk_major(bt))
        plan = module.match_plan(b, s, d, c, n_sm)
        split = (plan["n_chunks"], plan["grid"])
        copies = lambda: (chunk_major(a), chunk_major(bt))  # noqa: E731
    else:  # in place, one CTA an SM
        ops, split, copies = (a, bt), (n_sm,), None
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        kernels.check_launch(fn(ops[0].data_ptr(), ops[1].data_ptr(), keys.data_ptr(),
                                m.data_ptr(), i.data_ptr(), b, s, d, c, *split, stream), "K2")
    return call, (m, i), copies


# chip_smoke's `match_shapes` at 960x720 (8 frames, chunks of 4): the
# global merge against the bank and the local merge of 3 src frames
# against 1 dst frame, at UNet levels 0 and 1; (B, S, D, C)
SHAPES = {"global-L0": (2, 23760, 23760, 320), "local-L0": (2, 32400, 10800, 320),
          "global-L1": (2, 5940, 5940, 640), "local-L1": (2, 8100, 2700, 640),
          # the yt pass's smallest merges (30 frames at 960x720), where a
          # call's fixed cost counts
          "yt-global-L0": (1, 5940, 5940, 320), "yt-local-L1": (2, 2025, 675, 640)}


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
    shapes = [a for a in argv if a in SHAPES] or list(SHAPES)
    names = [a for a in argv if a not in SHAPES] or list(VARIANTS)
    if any(n not in VARIANTS for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    if "base" not in names:
        names.insert(0, "base")  # the base kernel's error is checked
    if not torch.cuda.is_available():
        print("ablate_match: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    texts = variant_sources(root)
    for name in [n for n in names if n not in texts]:
        print(f"[ablate] {name}: not applicable to {root or 'this checkout'}", flush=True)
    names = [n for n in names if n in texts]
    print(f"[ablate] kernel source: {root or kernels.CSRC.parents[1]}", flush=True)
    modules = {name: wrapper_of(root) for name in names}
    if vs is not None:
        texts, names = {**texts, "vs": variant_sources(vs)["base"]}, names + ["vs"]
        modules["vs"] = wrapper_of(vs)
    libs = build(texts, names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label in shapes:
        b, s, d, c = SHAPES[label]
        a = F.normalize(torch.randn(b, s, c, device="cuda", generator=gen), dim=-1).bfloat16()
        bt = F.normalize(torch.randn(b, d, c, device="cuda", generator=gen), dim=-1).bfloat16()
        calls, outs = {}, {}
        copies = None
        for name, lib in libs.items():
            calls[name], outs[name], cp = kernel_call(modules[name], lib, a, bt)
            if name == "base":
                copies = cp
            timer = watchdog(f"{label} {name}")
            calls[name]()
            torch.cuda.synchronize()
            timer.cancel()
        copy_ms = cuda_event_ms(copies, 5)[0] if copies else 0.0
        # the variants in turns, round after round: a card that slows as it
        # warms up weighs on each alike
        runs = {name: [] for name in calls}
        for _ in range(rounds):
            for name, call in calls.items():
                runs[name].append(cuda_event_ms(call, 5)[0])
        times = {name: sorted(r)[rounds // 2] for name, r in runs.items()}
        # the base kernel against the plain version, as the card tests hold it
        calls["base"]()
        torch.cuda.synchronize()
        m, i = outs["base"]
        mr, ir = match_kernel.online_argmax_scores_plain(a, bt)
        err = (m - mr).abs().max().item()
        scores = torch.einsum("bsc,bdc->sbd", a.float(), bt.float()).reshape(s, b * d)
        top2 = scores.topk(2, dim=-1).values
        del scores
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4
        mismatch = int(((i != ir) & clear).sum().item())
        bound = 2.0 * b * s * d * c / PEAK_BF16_FLOPS * 1e3
        print(f"[ablate] {label} B={b} S={s} D={d} C={c} copy_ms={copy_ms:.4f} "
              + " ".join(f"{n}_ms={t:.4f}" for n, t in times.items())
              + " spread_ms: " + " ".join(f"{n}={max(r) - min(r):.4f}" for n, r in runs.items())
              + f" bound_ms={bound:.4f} base_err={err:.2e} idx_mismatch={mismatch} "
              f"near_ties={int((~clear).sum().item())} base_ok={err <= 1e-4 and mismatch == 0}",
              flush=True)
        del a, bt, calls, outs, mr, ir, top2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
