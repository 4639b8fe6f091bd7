"""Flow warp as a bounded-window stencil, and its adjoint (counterpart of
tclight_tpu/ops/warp_kernel.py).

With the Keys cubic kernel k (a = -0.75, support (-2, 2)) or the bilinear
one, the backward warp of an image by a flow and its adjoint are

    out[p] = sum_d k(dy - fy[p]) k(dx - fx[p]) img[p + d]
    adj[q] = sum_d k(dy + fy[q+d]) k(dx + fx[q+d]) g[q + d]

over integer displacements |dy|, |dx| <= radius + kernel radius, with zero
padding outside the frame. `radius` must bound max |flow|: a tap beyond
the window is dropped, which is why `ops.flow.flow_radius` caps it and
falls back to the gather warp above the cap.

On a CUDA tensor `window_warp` launches K3 (`csrc/window_warp.cu`); on a
CPU tensor it takes `window_warp_plain` (`window_warp_xla`).

K3 replaces the TPU kernel `_warp_kernel` of tclight_tpu/ops/warp_kernel.py.
On the H100 it is bound by bytes when the flow is smooth (a few taps per
pixel: x, flows and out cross device memory once) and by f32 operations
when the tile's flow range is wide. Its design: the forward is a direct
gather of each pixel's 4x4 (bilinear 2x2) taps with separable weights,
read through L1 (a window staged in shared memory first measured slower,
PERF.md), a pixel a thread on 4 x 64 tiles, which also fill the card with
a small frame batch; the adjoint, a block per 32 x 64 output tile,
bounds its sources by the flow range of the tile's halo (`tile_tap_bounds`
is that step in plain torch) and scatters each source's 4x4 taps into the
tile's fixed-point accumulators in shared memory, scaled by 2^k: one
32-bit limb where the tile has fewer than 64 taps (the post-optimization's
smooth flows), two otherwise (`adjoint_fixed_point_exponent` gives k and
the low limb's width in plain torch), so its sums do not depend on the
order of the adds and a run repeats bit for bit (details in the source).

`warp_flow_window` is the autograd wrapper: its image gradient is the
adjoint window sum (exact: the warp is linear in the image) and its flow
gradient is zero, as in `_warp_bwd`. A loss that optimizes flows must use
the gather warp (`ops.flow.warp_flow` with `radius=None`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tclight_torch.ops import kernels

__all__ = ["window_warp", "window_warp_plain", "window_warp_cuda",
           "warp_flow_window", "kernel_radius", "tile_tap_bounds",
           "adjoint_fixed_point_exponent", "TILE"]

_MODES = {"bicubic": 0, "bilinear": 1}


def _kernel_fn(s: torch.Tensor, mode: str) -> torch.Tensor:
    """Interpolation kernel weight at signed distance s."""
    if mode == "bilinear":
        return torch.clamp(1.0 - s.abs(), min=0.0)
    a = -0.75
    s = s.abs()
    near = ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0
    far = (((s - 5.0) * s + 8.0) * s - 4.0) * a
    return torch.where(s <= 1.0, near, torch.where(s < 2.0, far, 0.0))


def kernel_radius(mode: str) -> int:
    return 1 if mode == "bilinear" else 2


def window_warp_plain(x: torch.Tensor, flows: torch.Tensor, radius: int,
                      mode: str = "bicubic", adjoint: bool = False) -> torch.Tensor:
    """The window sum, unrolled over every tap (small radius, CPU).
    x (N, H, W, C); flows (N, H, W, 2) as [dx, dy]."""
    n, h, w, c = x.shape
    rh = int(radius) + kernel_radius(mode)
    xp = F.pad(x, (0, 0, rh, rh, rh, rh))
    fp = F.pad(flows, (0, 0, rh, rh, rh, rh))
    fx_c, fy_c = flows[..., 0], flows[..., 1]
    out = torch.zeros_like(x)
    for dy in range(-rh, rh + 1):
        for dx in range(-rh, rh + 1):
            xs = xp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w, :]
            if adjoint:
                fs = fp[:, rh + dy: rh + dy + h, rh + dx: rh + dx + w, :]
                wgt = _kernel_fn(dy + fs[..., 1], mode) * _kernel_fn(dx + fs[..., 0], mode)
            else:
                wgt = _kernel_fn(dy - fy_c, mode) * _kernel_fn(dx - fx_c, mode)
            out = out + wgt[..., None] * xs
    return out


TILE = (32, 64)  # K3's adjoint output tile, rows x columns


def tile_tap_bounds(flows: torch.Tensor, radius: int, mode: str = "bicubic",
                    adjoint: bool = False) -> torch.Tensor:
    """The TPU kernel's tap bounds per output tile of `TILE` pixels, in
    plain torch: the taps (lo_y, hi_y, lo_x, hi_x) that can carry weight,
    as an int tensor (N, tiles_y, tiles_x, 4). The forward's taps of a
    pixel are floor(f) - rk + 1 .. floor(f) + rk, so the tile's flow range
    bounds them; the adjoint's tap d reads the flow at q + d, so its range
    is taken over the halo (the tile +- radius + rk, clipped to the frame)
    and the taps are floor(-max f) - rk + 1 .. floor(-min f) + rk (K3's
    adjoint scatters from the sources of that window). Both are clipped to
    +- (radius + rk). lo > hi: no tap."""
    n, h, w, _ = flows.shape
    rk = kernel_radius(mode)
    rh = int(radius) + rk
    th, tw = TILE
    out = torch.zeros(n, -(-h // th), -(-w // tw), 4, dtype=torch.int64)
    for by in range(out.shape[1]):
        for bx in range(out.shape[2]):
            y0, x0 = by * th, bx * tw
            if adjoint:
                f = flows[:, max(y0 - rh, 0):y0 + th + rh, max(x0 - rh, 0):x0 + tw + rh]
            else:
                f = flows[:, y0:y0 + th, x0:x0 + tw]
            f = f.reshape(n, -1, 2)
            lo, hi = f.amin(dim=1), f.amax(dim=1)  # (N, 2) as [x, y]
            if adjoint:
                lo, hi = -hi, -lo
            lo = torch.floor(lo).long() - rk + 1
            hi = torch.floor(hi).long() + rk
            out[:, by, bx] = torch.stack([lo[:, 1].clamp(min=-rh), hi[:, 1].clamp(max=rh),
                                          lo[:, 0].clamp(min=-rh), hi[:, 0].clamp(max=rh)], -1)
    return out


def adjoint_fixed_point_exponent(g: torch.Tensor, flows: torch.Tensor, radius: int,
                                 mode: str = "bicubic") -> tuple[torch.Tensor, torch.Tensor]:
    """K3's adjoint fixed point per output tile, in plain torch: (k, L),
    int tensors (N, tiles_y, tiles_x). The tile's tap count ntap (of its
    `tile_tap_bounds`) has bit length b and max |g| over its halo is below
    2^e1. Each of an output's at most ntap terms is at most max |g|, and the
    kernel rounds each term scaled by 2^k to an integer T. Below 64 taps it
    sums T in one signed 32-bit limb (L = 0), with k = 31 - b - e1: ntap
    terms sum below 2^31. From 64 taps on it adds T's low L = 32 - b bits
    into an unsigned 32-bit limb and T >> L into a signed one, with k = 2L -
    2 - e1: the terms sum below 2^(L + 30). k is clamped to [-126, 126]."""
    n, h, w, _ = g.shape
    rh = int(radius) + kernel_radius(mode)
    th, tw = TILE
    b = tile_tap_bounds(flows, radius, mode, adjoint=True)
    ntap = (b[..., 1] - b[..., 0] + 1).clamp(min=1) * (b[..., 3] - b[..., 2] + 1).clamp(min=1)
    gmax = torch.zeros(b.shape[:3])
    for by in range(b.shape[1]):
        for bx in range(b.shape[2]):
            y0, x0 = by * th, bx * tw
            gmax[:, by, bx] = g[:, max(y0 - rh, 0):y0 + th + rh,
                                max(x0 - rh, 0):x0 + tw + rh].abs().reshape(n, -1).amax(1)
    e1 = torch.frexp(gmax).exponent.long()
    low_bits = 31 - torch.floor(torch.log2(ntap.double())).long()  # 32 - bit length
    one = ntap < 64
    k = torch.where(one, low_bits - 1 - e1, 2 * low_bits - 2 - e1).clamp(-126, 126)
    return k, torch.where(one, 0, low_bits)


# tclight_window_warp_f32's parameters
K3_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def window_warp_cuda(x: torch.Tensor, flows: torch.Tensor, radius: int,
                     mode: str = "bicubic", adjoint: bool = False) -> torch.Tensor:
    """Launch K3 on contiguous f32 CUDA tensors; C <= 4."""
    for name, t in (("x", x), ("flows", flows)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"window warp: {name} must be an f32 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"window warp: {name} must be a contiguous 4-d tensor")
    n, h, w, c = x.shape
    if flows.shape != (n, h, w, 2):
        raise ValueError(f"window warp: x {tuple(x.shape)} and flows "
                         f"{tuple(flows.shape)} disagree")
    if not 1 <= c <= 4:
        raise ValueError(f"window warp: {c} channels; the kernel takes 1 to 4")
    if mode not in _MODES or radius < 0:
        raise ValueError(f"window warp: mode {mode!r}, radius {radius}")
    out = torch.empty_like(x)
    fn = kernels.function("window_warp", "tclight_window_warp_f32", K3_ARGTYPES, ctypes.c_int)
    rc = fn(x.data_ptr(), flows.data_ptr(), out.data_ptr(), n, h, w, c,
            int(radius), _MODES[mode], int(adjoint),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(rc, "window_warp")
    kernels.STATS["window_warp"].record((n, h, w, c, int(radius), bool(adjoint)))
    return out


def window_warp(x: torch.Tensor, flows: torch.Tensor, radius: int,
                mode: str = "bicubic", adjoint: bool = False) -> torch.Tensor:
    """A CUDA tensor goes to the kernel (or the call raises); a CPU tensor
    to the plain version."""
    if x.is_cuda:
        return window_warp_cuda(x.contiguous(), flows.float().contiguous(),
                                radius, mode, adjoint)
    return window_warp_plain(x, flows, radius, mode, adjoint)


class _WarpFlowWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, frames, flows, radius, mode):
        ctx.save_for_backward(flows)
        ctx.radius, ctx.mode = radius, mode
        return window_warp(frames, flows, radius, mode, adjoint=False)

    @staticmethod
    def backward(ctx, g):
        (flows,) = ctx.saved_tensors
        gi = window_warp(g.contiguous(), flows, ctx.radius, ctx.mode, adjoint=True)
        return gi.to(g.dtype), torch.zeros_like(flows), None, None


def warp_flow_window(frames: torch.Tensor, flows: torch.Tensor, radius: int,
                     mode: str = "bicubic") -> torch.Tensor:
    """Backward-warp frames (N, H, W, C) by flows (N, H, W, 2) as a window
    sum. Gradients reach `frames` only; the flow gradient is zero."""
    return _WarpFlowWindow.apply(frames, flows, int(radius), mode)
