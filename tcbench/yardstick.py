"""Peaks of the card and the least time a kernel call could take.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 989e12 bf16 tensor-core FLOP/s and 3.35e12 bytes/s of HBM3. A
share of a peak or of a roofline is stated against these, with the card's
power limit printed beside it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, n_bytes: float) -> float:
    """The larger of operations over the tensor-core peak and bytes over
    the memory peak, in seconds."""
    return max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES)


def attention_bound_s(b: int, h: int, sq: int, skv: int, d: int) -> float:
    """Flash attention (B, H, Sq, Skv, D) in bf16: 4 B H Sq Skv D
    operations (q.k^T and p.v); q, k, v read once and the output written
    once."""
    return bound_s(4.0 * b * h * sq * skv * d, BF16 * b * h * d * (2 * sq + 2 * skv))


def match_bound_s(b: int, s: int, d: int, c: int) -> float:
    """The ToMe matcher (B, S, D, C): 2 B S D C operations; a (B, S, C) and
    b (B, D, C) in bf16 read once, the f32 maximum and the int32 index of
    each of the S rows written once."""
    return bound_s(2.0 * b * s * d * c, BF16 * b * c * (s + d) + 8 * s)


def step_mfu(flops_per_step: float, step_s: float) -> float:
    """Share of the bf16 peak, in %, of a step's model FLOPs over its wall."""
    return 100.0 * flops_per_step / (step_s * PEAK_BF16_FLOPS)


def roofline_share(bounds_s: float, device_s: float) -> float | None:
    """Sum of bounds over the sum of device time, in %; None without time."""
    return 100.0 * bounds_s / device_s if device_s > 0 else None
