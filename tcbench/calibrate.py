"""Readings for the limits of `correct`: several seeds of a cell, and of its
control, in one process (one set-up of the interpreter and the card).

    python3 -m tcbench.calibrate --workload NAME --seconds S --seeds N ... [--variant int8pv]

Each run is `run.run_cell` with the variant; one JSON line a run with the
numbers compared and what the check saw. The benchmark's own runs never
run a variant.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from tcbench import run


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", default=None, help="int8pv or fp8")
    args = p.parse_args(argv)
    run.environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run.run_cell(args.workload, seed, args.seconds, False, bench, variant=args.variant)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"], "info": r["info"],
                          "metrics": r["metrics"], "run_s": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
