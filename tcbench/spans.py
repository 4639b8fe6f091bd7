"""The program's own spans on the device trace's clock, and what they put
down to each layer: the device's idle time, the host's waits on the device
and the device time of what each layer launched.

The program (`tclight_torch.utils.logging.SPANS`) records its spans while
a torch.profiler session runs, on `time.perf_counter_ns`'s clock: (id,
parent id, name, step index, t0_ns, t1_ns). The trace keeps the runtime
calls on its own microsecond clock (`trace.Trace.host`). The two are tied
at each traced step's end: a step's `scheduler` span ends after the last
launch-type call it made (the step's last operation, or a copy of its
output) and before the step's closing `torch.cuda.synchronize`, which the
trace records as `cudaDeviceSynchronize` and which no other call of the
sampling path makes; its step span ends after that sync has returned. The
k-th traced step pairs with the k-th such call among as many consecutive
ones as there are steps (the profiler's own start and stop may
synchronise too), the run of calls whose offsets agree best. Each step
bounds the offset between those calls; the offset is the median of the
bounds' middles over the steps, its spread (max - min) the mapping's
error, and the width of the bounds all steps share the most it can be off
by besides. A point of the trace belongs to the innermost span that
holds it; the layers are those of PERF.md's section 3.

Device operations pair with the calls that launched them in stream order
(one stream), kind by kind (kernels, copies, fills): the i-th launch-type
call of a kind with the i-th operation of that kind, both sorted by start;
a launch-type call inside another (a driver call under a runtime one)
counts once.

Every reader returns None where the program has no recorder (a checkout
older than the spans), where the pairing of steps fails, or where launches
and operations do not pair one to one: a reader that raised would end the
traced run.

    python3 -m tcbench.spans --workload NAME --seed N [--seconds S]

runs one traced run of a cell, as `tcbench.run --trace 1` does, and prints
its result line and then the whole breakdown as JSON (`breakdown`).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import statistics
import sys
from pathlib import Path

PIPELINE = ("step", "xy", "yt", "yt_window", "slot", "scheduler")
LAYERS = {**{n: "pipeline" for n in PIPELINE}, "unet": "unet", "tome": "tome",
          "attention": "attention"}
ANCHOR = "cudaDeviceSynchronize"
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"))
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"))
MIN_GAP_US = 5.0  # as trace.Trace.idle_gaps


def program_records() -> list | None:
    """The spans the program recorded, or None where it has no recorder."""
    try:
        from tclight_torch.utils.logging import SPANS
    except ImportError:
        return None
    return list(SPANS.records)


@dataclasses.dataclass
class Spans:
    """The recorded spans on the trace's clock."""

    spans: list        # (t0_us, t1_us, name, id, parent id), sorted by start
    offset_us: float   # trace clock - perf_counter clock, in us
    spread_us: float   # max - min of the per-step offsets
    anchors: frozenset  # starts of the steps' closing syncs, in us
    bracket_us: float  # width of the offsets that fit every step's bounds
    tail_us: float     # start of the last step's scheduler span

    def __post_init__(self) -> None:
        self._starts = [s[0] for s in self.spans]
        self._by_id = {s[3]: s for s in self.spans}

    def innermost(self, t_us: float) -> str | None:
        """The name of the innermost span holding t_us, None outside all."""
        j = bisect.bisect_right(self._starts, t_us) - 1
        s = self.spans[j] if j >= 0 else None
        while s is not None and not s[0] <= t_us < s[1]:
            s = self._by_id.get(s[4])
        return None if s is None else s[2]

    def layer(self, t_us: float) -> str:
        name = self.innermost(t_us)
        return "outside" if name is None else LAYERS.get(name, name)


def on_trace(trace, records: list | None = None) -> Spans | None:
    """Map the program's spans onto the trace's clock (module docstring)."""
    records = program_records() if records is None else records
    if not records or trace.steps <= 0:
        return None
    steps = sorted((r for r in records if r[2] == "step"), key=lambda r: r[4])
    sched_end = {r[1]: r[5] for r in records if r[2] == "scheduler"}
    calls = sorted(h[:2] for h in trace.host if h[2] == ANCHOR)
    n = len(steps)
    if n != trace.steps or len(calls) < n or not all(r[0] in sched_end for r in steps):
        return None
    ends = [sched_end[r[0]] * 1e-3 for r in steps]

    def spread(k):
        offs = [c[0] - e for c, e in zip(calls[k:k + n], ends)]
        return max(offs) - min(offs)
    k = min(range(len(calls) - n + 1), key=spread)
    syncs = calls[k:k + n]
    launch_ends = sorted(h[1] for h in trace.host if h[2] in LAUNCHES)
    his, los = [], []
    for r, sync, end in zip(steps, syncs, ends):
        j = bisect.bisect_right(launch_ends, sync[0]) - 1
        last = launch_ends[j] - end if j >= 0 else -math.inf
        his.append(sync[0] - end)
        los.append(max(last, sync[1] - r[5] * 1e-3))
    mids = [0.5 * (lo + hi) for lo, hi in zip(los, his)]
    off = statistics.median(mids)
    spans = sorted((r[4] * 1e-3 + off, r[5] * 1e-3 + off, r[2], r[0], r[1]) for r in records)
    tail = next(r[4] for r in records if r[2] == "scheduler" and r[1] == steps[-1][0])
    return Spans(spans, off, max(mids) - min(mids), frozenset(s[0] for s in syncs),
                 min(his) - max(los), tail * 1e-3 + off)


def idle_gaps(trace, min_us: float = MIN_GAP_US) -> list:
    """(start, end) of the gaps between the device's busy intervals, in us,
    of min_us and up."""
    busy = trace.busy()
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 - e0 >= min_us]


def idle_ms_by_layer(trace, sp: Spans) -> dict:
    """Idle ms a traced step by the layer whose span holds each gap's middle."""
    out = dict.fromkeys(("pipeline", "unet", "tome", "attention", "outside"), 0.0)
    for e0, s1 in idle_gaps(trace):
        layer = sp.layer(0.5 * (e0 + s1))
        out[layer] = out.get(layer, 0.0) + (s1 - e0) * 1e-3
    return {k: v / trace.steps for k, v in out.items()}


def syncs_by_span(trace, sp: Spans) -> dict:
    """Host calls that wait on the device a traced step, by the innermost
    span at their start (None: outside every span), the steps' closing
    syncs left out."""
    out: dict = {}
    for s, _, name in trace.host:
        if name in SYNCS and s not in sp.anchors:
            inner = sp.innermost(s)
            out[inner] = out.get(inner, 0) + 1
    return {k: v / trace.steps for k, v in out.items()}


def launch_calls(trace) -> list:
    """The launch-type calls sorted by start, each counted once."""
    out: list = []
    for call in sorted(h for h in trace.host if h[2] in LAUNCHES):
        if out and call[0] < out[-1][1]:
            continue  # inside the call before it
        out.append(call)
    return out


def kind(name: str) -> str:
    """"memcpy", "memset" or "kernel": what a device operation is, or what
    a launch-type call launches."""
    if name.startswith(("Memcpy", "cudaMemcpy")):
        return "memcpy"
    if name.startswith(("Memset", "cudaMemset")):
        return "memset"
    return "kernel"


def launched_ops(trace, tail_us: float = math.inf) -> list | None:
    """[(launch call, device operation)] in stream order kind by kind, or
    None when a kind's counts differ. Calls past the operations of their
    kind are let go where all of them start at `tail_us` or later: the
    profiler can lose the last records of a trace (those of the last
    step's scheduler, PERF.md section 6, PR 23)."""
    calls, ops = launch_calls(trace), sorted(trace.device)
    if not ops:
        return None
    pairs: list = []
    for k in ("kernel", "memcpy", "memset"):
        c = [x for x in calls if kind(x[2]) == k]
        o = [x for x in ops if kind(x[2]) == k]
        if len(c) < len(o) or (len(c) > len(o) and c[len(o)][0] < tail_us):
            return None
        pairs += zip(c, o)
    return pairs


def device_ms_by_layer(trace, sp: Spans) -> dict | None:
    """Device ms a traced step by the layer whose span held the launch."""
    pairs = launched_ops(trace, sp.tail_us)
    if pairs is None:
        return None
    out: dict = {}
    for call, op in pairs:
        layer = sp.layer(call[0])
        out[layer] = out.get(layer, 0.0) + (op[1] - op[0]) * 1e-3
    return {k: v / trace.steps for k, v in out.items()}


# ------------------------------------------------------------------ readers


def _idle(layer: str):
    def read(trace, work):
        sp = on_trace(trace)
        return None if sp is None else idle_ms_by_layer(trace, sp)[layer]
    read.__doc__ = (f"Device idle ms a traced step in gaps of {MIN_GAP_US:g} us and up whose "
                    f"middle's innermost span is of the {layer} layer.")
    return read


pipeline_idle_ms_per_step = _idle("pipeline")
unet_idle_ms_per_step = _idle("unet")
tome_idle_ms_per_step = _idle("tome")


def host_syncs_per_step(trace, work):
    """Host calls waiting on the device a traced step inside a span below
    `step` (the step's own closing sync is left out)."""
    sp = on_trace(trace)
    if sp is None:
        return None
    return sum(n for k, n in syncs_by_span(trace, sp).items() if k not in (None, "step"))


def tome_device_ms_per_step(trace, work):
    """Device ms a traced step of the operations launched inside `tome` spans."""
    sp = on_trace(trace)
    by_layer = None if sp is None else device_ms_by_layer(trace, sp)
    return None if by_layer is None else by_layer.get("tome", 0.0)


# ------------------------------------------------------------------ breakdown


def breakdown(trace, records: list | None = None) -> dict:
    """Everything the spans put down to the layers of one traced window,
    with the checks of the mapping: the clock offset's spread, the
    launches' pairing, and the idle time's sum against the trace's; where
    the mapping fails, what it had to pair."""
    records = program_records() if records is None else records
    sp = on_trace(trace, records)
    if sp is None:
        return {"mapped": False, "records": None if records is None else len(records),
                "step_spans": sum(1 for r in records or () if r[2] == "step"),
                "steps_traced": trace.steps,
                "anchors": sum(1 for h in trace.host if h[2] == ANCHOR)}
    steps = trace.steps
    idle_total = (trace.wall_s - trace.busy_s()) * 1e3 / steps
    by_layer = idle_ms_by_layer(trace, sp)
    all_gaps = sum(s1 - e0 for e0, s1 in idle_gaps(trace, 0.0)) * 1e-3 / steps
    big_gaps = sum(by_layer.values())
    calls, ops = launch_calls(trace), sorted(trace.device)
    pairs = launched_ops(trace, sp.tail_us)
    kinds: dict = {}
    for op in ops:
        kinds[kind(op[2])] = kinds.get(kind(op[2]), 0) + 1
    syncs = syncs_by_span(trace, sp)
    # a short gap is the card's own wait before the next operation: put it
    # down to the layer that launched that operation
    short: dict = {}
    launcher = {op[0]: call for call, op in pairs or ()}
    for e0, s1 in idle_gaps(trace, 0.0):
        if s1 - e0 < MIN_GAP_US and s1 in launcher:
            layer = sp.layer(launcher[s1][0])
            short[layer] = short.get(layer, 0.0) + (s1 - e0) * 1e-3 / steps
    return {
        "mapped": True, "offset_us": sp.offset_us, "spread_us": sp.spread_us,
        "bracket_us": sp.bracket_us, "spans": len(sp.spans),
        "idle_ms_per_step": idle_total,
        "idle_ms_per_step_by_layer": by_layer,
        "idle_ms_per_step_in_gaps_under_5us": all_gaps - big_gaps,
        "idle_ms_per_step_in_gaps_under_5us_by_launching_layer": short,
        "idle_ms_per_step_before_and_after_ops": idle_total - all_gaps,
        "idle_sum_gap_pct": 100.0 * (big_gaps - idle_total) / idle_total if idle_total else None,
        "host_syncs_per_step_by_span": {str(k): v for k, v in syncs.items()},
        "host_syncs_per_step": sum(n for k, n in syncs.items() if k not in (None, "step")),
        "launch_calls_per_step": len(calls) / steps,
        "device_ops_per_step": {k: v / steps for k, v in kinds.items()},
        "paired": pairs is not None,
        "launch_to_op_min_us": min(o[0] - c[0] for c, o in pairs) if pairs else None,
        "ops_before_their_launch": sum(o[0] < c[0] for c, o in pairs) if pairs else None,
        "device_ms_per_step": trace.device_s() * 1e3 / steps,
        "device_ms_per_step_by_layer": device_ms_by_layer(trace, sp),
        "device_ms_per_step_by_layer_and_group": _by_layer_and_group(pairs, sp, steps),
    }


def _by_layer_and_group(pairs, sp: Spans, steps: int) -> dict | None:
    from tcbench.trace import group_of

    if pairs is None:
        return None
    out: dict = {}
    for call, op in pairs:
        key = f"{sp.layer(call[0])}:{group_of(op[2])}"
        out[key] = out.get(key, 0.0) + (op[1] - op[0]) * 1e-3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv: list[str] | None = None) -> int:
    import argparse

    from tcbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    run.environment()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("tcbench.spans needs a CUDA card", file=sys.stderr)
        return 2
    result, seen = traced_run(args.workload, args.seed, args.seconds, bench,
                              t_start=run.T_START)
    print(f"card: {run.card_line()}", flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps(seen), flush=True)
    return 0


def traced_run(workload: str, seed: int, seconds: float, bench: dict, **kw) -> tuple:
    """`run.run_cell` with --trace 1, and beside its result the breakdown
    of its traced window and the launch pairing checked against the
    profiler's correlation ids (`correlation_check`)."""
    from tcbench import run, trace as trace_mod

    seen: dict = {}
    read_per_layer, read_chrome = run.read_per_layer, trace_mod.read_chrome

    def reading(bench, workload, trace, work):
        seen["breakdown"] = breakdown(trace)
        return read_per_layer(bench, workload, trace, work)

    def chrome(path, *args):
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
        seen["pairing_by_correlation"] = correlation_check(events)
        return read_chrome(path, *args)

    run.read_per_layer, trace_mod.read_chrome = reading, chrome
    try:
        result = run.run_cell(workload, seed, seconds, True, bench, **kw)
    finally:
        run.read_per_layer, trace_mod.read_chrome = read_per_layer, read_chrome
    return result, seen


def correlation_check(events: list) -> dict:
    """How far the pairing in stream order agrees with the profiler's own
    correlation ids (which `trace.Trace` does not keep), in order over all
    kinds and kind by kind: the pairs that disagree, the first of them,
    the device's streams, and the calls behind operations that no
    launch-type call made."""
    from tcbench.trace import DEVICE_CATS, HOST_CATS

    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        args = ev.get("args") or {}
        item = (float(ev["ts"]), float(ev["dur"]), str(ev.get("name", "")),
                args.get("correlation"), args.get("stream"))
        if ev.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif ev.get("cat") in HOST_CATS:
            host.append(item)
    dev.sort()
    calls: list = []
    nested: dict = {}
    for h in sorted(h for h in host if h[2] in LAUNCHES):
        if not calls or h[0] >= calls[-1][0] + calls[-1][1]:
            calls.append(h)
        else:
            nested[h[2]] = nested.get(h[2], 0) + 1
    by_corr = {h[3]: h for h in host}
    unlaunched: dict = {}
    launched = {c[3] for c in calls}
    for d in dev:
        if d[3] not in launched:
            name = by_corr[d[3]][2] if d[3] in by_corr else None
            unlaunched[str(name)] = unlaunched.get(str(name), 0) + 1
    op_of = {d[3]: d for d in dev}
    no_op: dict = {}
    leads = []
    for c in calls:
        if c[3] in op_of:
            leads.append(op_of[c[3]][0] - c[0])
        else:
            no_op[c[2]] = no_op.get(c[2], 0) + 1
    streams: dict = {}
    for d in dev:
        streams[str(d[4])] = streams.get(str(d[4]), 0) + 1

    def agree(cs, ds):
        if len(cs) != len(ds):
            return {"calls": len(cs), "ops": len(ds)}
        bad = [i for i, (c, d) in enumerate(zip(cs, ds)) if c[3] != d[3]]
        first = None
        if bad:
            near = slice(max(0, bad[0] - 2), bad[0] + 3)
            first = [[c[:4] for c in cs[near]], [d[:4] for d in ds[near]]]
        return {"pairs": len(cs), "disagree": len(bad), "first": first}
    out = {"streams": streams, "ops_without_launch_call": unlaunched,
           "launch_calls_without_op": no_op, "nested_launch_calls": nested,
           "ops_before_their_launch": sum(x < 0 for x in leads),
           "launch_to_op_min_us": min(leads, default=None), "merged": agree(calls, dev)}
    for k in ("kernel", "memcpy", "memset"):
        out[k] = agree([c for c in calls if kind(c[2]) == k], [d for d in dev if kind(d[2]) == k])
    return out


if __name__ == "__main__":
    sys.exit(main())
