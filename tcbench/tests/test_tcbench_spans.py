"""The readers of the program's spans (tcbench/spans.py) on synthetic traces:
the clock mapping from the steps' ends, the idle time put down to the
innermost span, the host's waits, the launches paired with the device's
operations, and None wherever the pairing or the recorder is missing; and
a traced run of a tiny cell that completes, without the new metrics,
whether the program has a recorder or not."""

from __future__ import annotations

import importlib.util

import pytest

from tcbench import run, spans, trace

OFF = 5000.0  # trace clock - perf clock, us


def _records(steps: int = 1, period: float = 1000.0) -> list:
    """(id, parent, name, step, t0_ns, t1_ns): a step of one xy slot whose
    UNet merges (tome), attends and unmerges (tome), then the scheduler."""
    out = []
    for k in range(steps):
        b, i = k * period, 10 * k

        def add(j, parent, name, t0, t1):
            out.append((i + j, None if parent is None else i + parent, name, k,
                        int((b + t0) * 1e3), int((b + t1) * 1e3)))
        add(0, None, "step", 1000, 1998)
        add(1, 0, "xy", 1010, 1500)
        add(2, 1, "slot", 1020, 1490)
        add(3, 2, "unet", 1030, 1480)
        add(4, 3, "tome", 1040, 1100)
        add(5, 3, "attention", 1110, 1200)
        add(6, 3, "tome", 1210, 1250)
        add(7, 0, "scheduler", 1600, 1900)
    return out


def _trace(device, host, steps=1, lags=(0.0,)) -> trace.Trace:
    """A Trace from perf-clock us; each step's closing cudaDeviceSynchronize
    starts `lag` us after its scheduler span's end."""
    sync = [(1900.0 + 1000 * k + lag, 1995.0 + 1000 * k, "cudaDeviceSynchronize")
            for k, lag in enumerate(lags)]
    dev = [(s + OFF, e + OFF, n) for s, e, n in device]
    hst = [(s + OFF, e + OFF, n) for s, e, n in list(host) + sync]
    wall = max(e for _, e, _ in dev) - min(s for s, _, _ in dev)
    return trace.Trace(dev, hst, steps=steps, wall_s=wall * 1e-6)


# device operations of one step (perf us) and the calls that launched them
OPS = [(990.0, 1050.0, "elementwise_kernel"), (1090.0, 1120.0, "match_argmax_wgmma_kernel<5>"),
       (1180.0, 1260.0, "flash_fwd_wgmma_kernel<48>"), (1300.0, 1550.0, "sm90_xmma_fprop_conv"),
       (1580.0, 1990.0, "elementwise_kernel"), (1993.0, 2030.0, "Memcpy DtoH")]
LAUNCH_AT = [(985.0, "cudaLaunchKernel"), (1060.0, "cudaLaunchKernelExC"),
             (1120.0, "cudaLaunchKernelExC"), (1260.0, "cudaLaunchKernel"),
             (1570.0, "cudaLaunchKernel"), (1620.0, "cudaMemcpyAsync")]
LAUNCHES = [(t, t + 4.0, n) for t, n in LAUNCH_AT]


def reader(name: str):
    spec = importlib.util.spec_from_file_location("m", run.TCBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers `records` as the program's spans."""
    def put(records):
        monkeypatch.setattr(spans, "program_records", lambda: records)
    return put


@pytest.mark.parametrize("extra", [[], [3996.0], [950.0, 3996.0]],
                         ids=["steps-only", "profiler-stop", "profiler-start-and-stop"])
def test_steps_ends_pair_with_the_closing_syncs(extra):
    """The steps' closing syncs are the consecutive run of calls whose
    offsets agree, whatever the profiler's own start and stop add; each
    step bounds the offset between its scheduler span's end (before the
    sync starts) and its step span's end (after the sync ends), and after
    the last launch-type call before the sync."""
    recs = _records(steps=3)
    host = [(t, t + 20.0, "cudaDeviceSynchronize") for t in extra]
    tr = _trace(OPS, host, steps=3, lags=(3.0, 5.0, 4.0))
    sp = spans.on_trace(tr, recs)
    # step k: the sync starts `lag` after the scheduler's end and ends 3 us
    # before the step's end: the offset lies in [OFF - 3, OFF + lag]
    assert sp.offset_us == pytest.approx(OFF + 0.5) and sp.spread_us == pytest.approx(1.0)
    assert sp.bracket_us == pytest.approx(6.0)
    assert len(sp.spans) == len(recs)
    off = sp.offset_us
    assert sp.innermost(1050.0 + off) == "tome"
    assert sp.innermost(1035.0 + off) == "unet"
    assert sp.innermost(1999.0 + off) is None  # between two steps
    # a copy the scheduler made 1 us before its span ended tightens the bounds
    copy = [(1898.0 + 1000 * k, 1899.0 + 1000 * k, "cudaMemcpyAsync") for k in range(3)]
    sp = spans.on_trace(_trace(OPS, host + copy, steps=3, lags=(3.0, 5.0, 4.0)), recs)
    assert sp.offset_us == pytest.approx(OFF + 1.5) and sp.bracket_us == pytest.approx(4.0)


def test_gaps_go_to_the_innermost_span_and_sum_to_the_idle_time(recorded):
    recorded(_records())
    tr = _trace(OPS, LAUNCHES)
    sp = spans.on_trace(tr)
    by_layer = spans.idle_ms_by_layer(tr, sp)
    # gaps: 1050-1090 in tome, 1120-1180 in attention, 1260-1300 in unet,
    # 1550-1580 in the step (pipeline); 1990-1993 is under 5 us
    assert by_layer == pytest.approx({"tome": 0.040, "attention": 0.060, "unet": 0.040,
                                      "pipeline": 0.030, "outside": 0.0})
    assert reader("tome_idle_ms_per_step.sampling")(tr, {}) == pytest.approx(0.040)
    assert reader("unet_idle_ms_per_step.sampling")(tr, {}) == pytest.approx(0.040)
    assert reader("pipeline_idle_ms_per_step.sampling_yt")(tr, {}) == pytest.approx(0.030)
    # with no gap under 5 us, the layers' idle is the trace's idle time
    ops = OPS[:-1] + [(1990.0, 2030.0, "Memcpy DtoH")]
    tr = _trace(ops, LAUNCHES)
    idle_ms = (tr.wall_s - tr.busy_s()) * 1e3
    assert sum(spans.idle_ms_by_layer(tr, spans.on_trace(tr)).values()) == pytest.approx(idle_ms)
    b = spans.breakdown(tr)
    assert b["idle_sum_gap_pct"] == pytest.approx(0.0, abs=1e-9)
    assert b["idle_ms_per_step_in_gaps_under_5us"] == pytest.approx(0.0, abs=1e-9)


def test_waits_below_the_step_are_counted(recorded):
    recorded(_records(steps=2))
    host = [(1025.0, 1030.0, "cudaStreamSynchronize"),   # in the slot
            (1035.0, 1036.0, "cudaStreamSynchronize"),   # in the UNet
            (1520.0, 1521.0, "cudaStreamSynchronize"),   # in the step itself
            (1999.0, 2000.0, "cudaStreamSynchronize"),   # between the steps
            (2060.0, 2070.0, "cudaMemcpy"),              # step 2's tome
            (2080.0, 2081.0, "cudaLaunchKernel")]        # not a wait
    tr = _trace(OPS, host, steps=2, lags=(2.0, 2.0))
    sp = spans.on_trace(tr)
    got = spans.syncs_by_span(tr, sp)
    assert got == {"slot": 0.5, "unet": 0.5, "step": 0.5, None: 0.5, "tome": 0.5}
    # the closing syncs (the anchors) and the waits outside a sub-step span are left out
    assert reader("host_syncs_per_step.sampling")(tr, {}) == pytest.approx(1.5)


def test_launches_pair_with_operations_in_stream_order(recorded):
    recorded(_records())
    # a driver call inside the runtime call that made it counts once
    host = LAUNCHES + [(1061.0, 1062.0, "cuLaunchKernelEx")]
    tr = _trace(OPS, host)
    pairs = spans.launched_ops(tr)
    assert [c[2] for c, _ in pairs] == [n for _, n in LAUNCH_AT]
    by_layer = spans.device_ms_by_layer(tr, spans.on_trace(tr))
    # the first launch precedes the step; the matcher's is in tome, the
    # flash kernel's in attention, the convolution's in the UNet, the rest
    # in the step and the scheduler
    assert by_layer == pytest.approx({"outside": 0.060, "tome": 0.030, "attention": 0.080,
                                      "unet": 0.250, "pipeline": 0.410 + 0.037})
    assert reader("tome_device_ms_per_step.sampling")(tr, {}) == pytest.approx(0.030)
    b = spans.breakdown(tr)
    assert b["paired"] and b["launch_to_op_min_us"] == pytest.approx(5.0)


def test_calls_lost_at_the_end_of_the_trace_are_let_go(recorded):
    """The profiler may lose the records of the last operations of a trace:
    surplus calls in the last step's scheduler span are let go, anywhere
    else they make the pairing fail."""
    recorded(_records())
    lost = [(1700.0, 1704.0, "cudaLaunchKernel"), (1710.0, 1714.0, "cudaMemcpyAsync")]
    tr = _trace(OPS, LAUNCHES + lost)
    assert len(spans.launched_ops(tr, spans.on_trace(tr).tail_us)) == len(OPS)
    assert reader("tome_device_ms_per_step.sampling")(tr, {}) == pytest.approx(0.030)
    early = [(1101.0, 1102.0, "cudaLaunchKernel")]  # in the UNet, before the scheduler
    assert reader("tome_device_ms_per_step.sampling")(_trace(OPS, LAUNCHES + early), {}) is None


def test_readers_return_nothing_where_the_pairing_fails(recorded, monkeypatch):
    names = [f"{m}.sampling" for m in ("pipeline_idle_ms_per_step", "unet_idle_ms_per_step",
                                      "tome_idle_ms_per_step", "host_syncs_per_step",
                                      "tome_device_ms_per_step")]
    # one launch short of the operations
    recorded(_records())
    tr = _trace(OPS, LAUNCHES[:-1])
    assert reader(names[-1])(tr, {}) is None
    assert reader(names[0])(tr, {}) is not None
    # fewer step ends than steps traced
    tr = _trace(OPS, LAUNCHES, steps=2)
    assert all(reader(n)(tr, {}) is None for n in names)
    # a step without its closing sync in the trace
    recorded(_records(steps=2))
    assert all(reader(n)(_trace(OPS, LAUNCHES, steps=2, lags=(0.0,)), {}) is None
               for n in names)
    # no spans recorded, and no recorder at all (a program older than the spans)
    recorded([])
    assert all(reader(n)(_trace(OPS, LAUNCHES), {}) is None for n in names)
    monkeypatch.undo()
    from tclight_torch.utils import logging as tlogging

    monkeypatch.delattr(tlogging, "SPANS")
    assert spans.program_records() is None
    assert all(reader(n)(_trace(OPS, LAUNCHES), {}) is None for n in names)


@pytest.mark.parametrize("recorder", [True, False], ids=["program", "program-without-spans"])
def test_a_traced_run_completes_without_the_span_metrics(monkeypatch, recorder):
    """On the CPU the trace has no runtime calls to pair with, and a program
    without a recorder has no spans: either way the traced run completes and
    leaves the span metrics out."""
    from tclight_torch.utils import logging as tlogging

    from .conftest import DATA, TINY_BENCH

    if not recorder:
        monkeypatch.delattr(tlogging, "SPANS")
    names = [f"{m}.sampling" for m in ("pipeline_idle_ms_per_step", "host_syncs_per_step",
                                      "tome_device_ms_per_step")]
    bench = dict(TINY_BENCH, per_layer=TINY_BENCH["per_layer"] + [
        {"name": n, "unit": "ms"} for n in names])
    r, seen = spans.traced_run("tiny-sample", 2**31 + 91, 0.5, bench, files=DATA,
                               device="cpu")
    assert r["correct"] and r["attempted"] >= 1 + run.TRACE_STEPS
    assert not set(names) & set(r["metrics"])
    # the program recorded its traced steps; the CPU trace has no steps' syncs to pair
    b = seen["breakdown"]
    assert not b["mapped"] and b["anchors"] == 0
    assert b["records"] is None if not recorder else b["step_spans"] == run.TRACE_STEPS


def test_the_pairing_is_checked_against_correlation_ids():
    """A copy that the card ran before a kernel launched ahead of it breaks
    the pairing over all kinds, not kind by kind."""
    def ev(cat, name, ts, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1.0,
                "args": {"correlation": corr, "stream": 7}}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 0.0, 1),
              ev("cuda_runtime", "cudaMemcpyAsync", 2.0, 2),
              ev("cuda_runtime", "cudaLaunchKernel", 4.0, 3),
              ev("cuda_runtime", "cudaMemsetAsync", 6.0, 4),
              ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3.0, 2),
              ev("kernel", "elementwise_kernel", 5.0, 1), ev("kernel", "gemm", 8.0, 3),
              ev("gpu_memset", "Memset (Device)", 9.0, 4)]
    got = spans.correlation_check(events)
    assert got["merged"]["disagree"] == 2
    assert all(got[k]["disagree"] == 0 for k in ("kernel", "memcpy", "memset"))
    assert got["streams"] == {"7": 4} and got["ops_without_launch_call"] == {}
    tr = trace.Trace([(e["ts"], e["ts"] + 1.0, e["name"]) for e in events[4:]],
                     [(e["ts"], e["ts"] + 1.0, e["name"]) for e in events[:4]], 1, 1e-5)
    assert [(c[2], o[2]) for c, o in spans.launched_ops(tr)] == [
        ("cudaLaunchKernel", "elementwise_kernel"), ("cudaLaunchKernel", "gemm"),
        ("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)"),
        ("cudaMemsetAsync", "Memset (Device)")]
