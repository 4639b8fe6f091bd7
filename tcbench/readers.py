"""The per-layer metrics' arithmetic, one function each, over a traced
window (`trace.Trace`) and the stage's counted work (`Stage.step_work`).
Each returns None where it finds nothing to read. The files under
`metrics/` name a metric and take its function from here, so a metric of a
cell with another end-to-end metric reuses the arithmetic."""

from __future__ import annotations

from tcbench import yardstick


def launches_per_step(trace, work):
    """Device kernels launched per step: the kernels in the trace of the
    traced steps over their number."""
    return trace.kernels() / trace.steps if trace.kernels() else None


def step_mfu(trace, work):
    """The step's share of the bf16 tensor-core peak, in %: the step's
    model FLOPs, counted over the reference's step at the cell's shapes,
    over the traced step's wall."""
    if not work.get("flops_per_step") or trace.steps <= 0:
        return None
    return yardstick.step_mfu(work["flops_per_step"], trace.wall_s / trace.steps)


def other_ms_per_step(trace, work):
    """Device ms a step spends outside the attention and matching kernels,
    the convolutions and the GEMMs: elementwise ops, normalisation, layout
    copies and fills."""
    ms = trace.device_s("other") * 1e3
    return ms / trace.steps if ms > 0 else None


def k1_ms_per_step(trace, work):
    """Device ms a step spends in K1, the flash attention."""
    ms = trace.device_s("flash_attention") * 1e3
    return ms / trace.steps if ms > 0 else None


def k1_roofline(trace, work):
    """K1's share of its roofline, in %: the sum of the bounds of the flash
    attentions one step needs (the reference's shapes at the cell's sizes,
    `yardstick.attention_bound_s`) over K1's device time a step."""
    calls = work.get("attention_calls") or []
    device_s = trace.device_s("flash_attention") / trace.steps
    if not calls or device_s <= 0:
        return None
    return yardstick.roofline_share(sum(yardstick.attention_bound_s(*c) for c in calls), device_s)


def k2_roofline(trace, work):
    """K2's share of its roofline, in %: the sum of the bounds of the ToMe
    matchings one step needs (`yardstick.match_bound_s` at the reference's
    shapes) over K2's device time a step."""
    calls = work.get("match_calls") or []
    device_s = trace.device_s("match_argmax") / trace.steps
    if not calls or device_s <= 0:
        return None
    return yardstick.roofline_share(sum(yardstick.match_bound_s(*c) for c in calls), device_s)


def device_idle_share(trace, work):
    """The share of the traced steps' wall in which no operation ran on the
    device, in %: 1 - union of the device intervals / wall."""
    if trace.wall_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
