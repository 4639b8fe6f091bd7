"""Run one cell of the benchmark once and print its result as JSON.

    python3 -m tcbench.run --workload NAME --seed N --seconds S --trace 0|1

The cell is `tcbench/workloads/NAME.json`: its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`) and its
stage (`stages/<stage>.py`, the code that runs one program entry). Set-up, from
the start of the process, builds the program and runs one step of the
cell's shapes; the window then runs the stage for S seconds and closes at
the first step boundary at or after that. With --trace 1, torch.profiler
traces `TRACE_STEPS` whole steps of the window, after its first, and the
per-layer metrics (`metrics/<metric>.py`, one reader each) are read from
that trace; with --trace 0 the end-to-end metrics are printed. Once the
window has closed and the program is freed, a sample of its steps drawn
from the seed is checked against the plain float32 reference
(`tcbench/reference`), which decides `correct`; the numbers compared are
printed with their limits as the last lines on standard error and under
the result's last key.

The run needs as many CUDA cards as the cell asks for and exits with code
2 without them. It fails, printing no result, if `jax`, `jaxlib`, `flax` or
`tclight_tpu` is loaded once the window has closed. Builds, traces and
caches stay under `build/` in the checkout.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

TCBENCH = Path(__file__).resolve().parent
ROOT = TCBENCH.parent
OUT = ROOT / "build" / "tcbench"
TRACE_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "tclight_tpu")
GIB = float(1 << 30)


def process_start() -> float:
    """The perf_counter reading at which this process started."""
    now = time.perf_counter()
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - (uptime - int(stat[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()


def environment() -> None:
    """Fixed build and kernel-cache directories inside the checkout, and
    one host thread for the CPU's math libraries: the program's host work
    is one Python thread feeding the card, which spinning worker threads
    only slow."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(OUT / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(bench: dict, kind: str, workload: str) -> list[dict]:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def read_per_layer(bench: dict, workload: str, trace, work: dict) -> dict:
    out = {}
    for m in cell_metrics(bench, "per_layer", workload):
        spec = importlib.util.spec_from_file_location(
            "tcbench_metric", TCBENCH / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(trace, work)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, bench: dict,
             files: Path = TCBENCH, device: str = "cuda", variant: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result (the printed line's object)."""
    import numpy as np
    import torch

    from tcbench import seeds

    t_start = time.perf_counter() if t_start is None else t_start
    w = load_json(files / "workloads" / f"{workload}.json")
    config = load_json(files / "configs" / f"{w['config']}.json")
    traffic = load_json(files / "traffic" / f"{w['traffic']}.json")
    stage_mod = importlib.import_module(f"tcbench.stages.{w['stage']}")
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage = stage_mod.Stage(w, config, traffic, seed, device, variant)
    stage.setup()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity and the runtime calls that feed it: tracing
        # every host op as well slowed a step by a third
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts):  # the profiler's own first start
            torch.ones(1, device=device).add_(1)
        prof = profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    clock = {"steps": 0, "end": None, "tr0": None, "tr1": None, "at": []}

    def boundary() -> bool:
        now = time.perf_counter()
        clock["steps"] += 1
        clock["at"].append(now - t0)
        if prof is not None:
            if clock["steps"] == 1:
                prof.start()
                clock["tr0"] = time.perf_counter()
            elif clock["steps"] == 1 + TRACE_STEPS:
                clock["tr1"] = now
                prof.stop()
        done = now - t0 >= seconds and (prof is None or clock["tr1"] is not None)
        if done:
            clock["end"] = now
        return done

    gc.collect()
    stage.record(math.ceil(seconds / w["min_step_s"]) + 2 + (1 + TRACE_STEPS if trace else 0))
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    stage.window(boundary)
    window_s = clock["end"] - t0
    steps = clock["steps"]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the measuring process: {', '.join(found)}")

    result: dict = {"correct": False, "attempted": steps, "failed": stage.failed()}
    if trace:
        from tcbench import trace as trace_mod

        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"trace-{workload}.json"
        prof.export_chrome_trace(str(path))
        tr = trace_mod.read_chrome(path, TRACE_STEPS, clock["tr1"] - clock["tr0"])
        path.unlink()
        metrics = read_per_layer(bench, workload, tr, stage.step_work())
        extra = {"busy_s": tr.busy_s(), "window_s": tr.wall_s}
        groups = sorted(tr.by_group().items(), key=lambda kv: -kv[1])
        breakdown = {"device_ops": [[f"group:{g}", s] for g, s in groups][:5]
                     + [[n[:120], s] for n, s in tr.top_kernels(10 - min(5, len(groups)))],
                     "idle_gaps": [[n[:120], s] for n, s in tr.idle_gaps(10)]}
    else:
        e2e = dict(stage.end_to_end(steps, window_s))
        e2e["setup_s"] = setup_s
        e2e["peak_device_gib"] = window_peak / GIB
        metrics = {}
        for m in cell_metrics(bench, "end_to_end", workload):
            if m["name"] not in e2e:
                raise KeyError(f"the stage reports no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        extra, breakdown = {}, None
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name() if cuda else "cpu",
                        "count": 1,
                        "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0,
                        **extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    stage.free()
    check = stage.check(np.random.default_rng(seeds.derive(seed, "check")))
    nums = check["numbers"]
    result["correct"] = result["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in nums.values())
    result["info"] = {"steps": check["checked"], **check["info"]}
    result["info"]["step_s"] = [round(b - a, 4) for a, b in zip([0.0] + clock["at"], clock["at"])]
    if trace:
        result["info"]["traced_step_s"] = (clock["tr1"] - clock["tr0"]) / TRACE_STEPS
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in nums.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found {n}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench,
                      t_start=T_START)
    print(f"card: {card_line()} (peaks: 989e12 bf16 FLOP/s, 3.35e12 B/s)", flush=True)
    print(f"correct = {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
