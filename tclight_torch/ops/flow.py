"""Optical-flow pixel machinery (counterpart of tclight_tpu/ops/flow.py):
backward warping, forward/backward consistency masks, soft occlusion
masks, flow-id (pixel track) propagation and voxelization to unique
tracks.

Layout: frames (N, H, W, C); flows (N, H, W, 2) as [dx, dy].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tclight_torch.ops.resample import grid_sample_2d, identity_grid
from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import get_logger

__all__ = ["warp_flow", "compute_fwdbwd_mask", "get_mask_bwds",
           "get_soft_mask_bwds", "get_soft_mask_pairs",
           "get_soft_mask_bwds_chunked", "get_flowid", "voxelization",
           "flow_radius"]


def warp_flow(frames: torch.Tensor, flows: torch.Tensor, mode: str = "bicubic",
              radius: int | None = None) -> torch.Tensor:
    """Backward-warp frames (N, H, W, C) by flows (N, H, W, 2):
    out[n, y, x] = frames[n, y + dy, x + dx], zero padding.

    With a `radius` bounding max |flow| the warp is the window sum
    (`ops.warp_kernel`: K3 on the card); with None it is the gather warp
    (`ops.resample.grid_sample_2d`), whose autograd is exact in both
    arguments."""
    if radius is not None:
        from tclight_torch.ops.warp_kernel import warp_flow_window

        return warp_flow_window(frames, flows, int(radius), mode)
    n, h, w = frames.shape[:3]
    grid = identity_grid(h, w, dtype=flows.dtype, device=flows.device)
    coords = grid[None] + flows[..., :2]
    return grid_sample_2d(frames, coords.expand(n, h, w, 2), mode=mode)


def _norm2(flow: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(flow, dim=-1)


def compute_fwdbwd_mask(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                        alpha: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward/backward flow consistency masks, bool (N, H, W) each."""
    bwd2fwd = warp_flow(bwd_flow, fwd_flow)
    fwd_err = _norm2(fwd_flow + bwd2fwd)
    fwd_mask = fwd_err < alpha * (_norm2(fwd_flow) + _norm2(bwd2fwd)) + alpha
    fwd2bwd = warp_flow(fwd_flow, bwd_flow)
    bwd_err = _norm2(bwd_flow + fwd2bwd)
    bwd_mask = bwd_err < alpha * (_norm2(bwd_flow) + _norm2(fwd2bwd)) + alpha
    return fwd_mask, bwd_mask


def _erode(mask: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Min-pool with SAME padding, borders treated as valid (the
    reference's -MaxPool2d(-mask), whose pads are -inf)."""
    m = mask.float()[:, None]
    return (-F.max_pool2d(-m, k, stride=1, padding=k // 2))[:, 0] > 0.5


def get_mask_bwds(org_images: torch.Tensor, flows: torch.Tensor,
                  past_flows: torch.Tensor, alpha: float = 0.1,
                  diff_threshold: float = 0.1) -> torch.Tensor:
    """Hard backward-consistency mask per frame, bool (N, H, W); frame 0 is
    all True. flows[i] maps frame i -> i+1, past_flows[i] frame i -> i-1."""
    _, bwd = compute_fwdbwd_mask(flows[:-1], past_flows[1:], alpha=alpha)
    warped = warp_flow(org_images[:-1], past_flows[1:])
    photo_ok = ((warped - org_images[1:]).abs().amax(dim=-1)
                < org_images.max() * diff_threshold)
    rest = bwd & photo_ok
    mask = torch.cat([torch.ones_like(rest[:1]), rest])
    return _erode(mask, 5)


def get_soft_mask_bwds(org_images: torch.Tensor, flows: torch.Tensor,
                       past_flows: torch.Tensor, alpha: float = 0.1,
                       beta: float = 1e2, diff_threshold: float = 0.1) -> torch.Tensor:
    """Soft (sigmoid) occlusion mask, float (N, H, W) in [0, 1]; frame 0
    is all ones."""
    rest = get_soft_mask_pairs(org_images[:-1], org_images[1:], flows[:-1],
                               past_flows[1:], org_images.max(), alpha, beta,
                               diff_threshold)
    return torch.cat([torch.ones_like(rest[:1]), rest])


def get_soft_mask_pairs(prev_imgs: torch.Tensor, cur_imgs: torch.Tensor,
                        fwd_flows: torch.Tensor, past_flows: torch.Tensor,
                        global_max, alpha: float = 0.1, beta: float = 1e2,
                        diff_threshold: float = 0.1,
                        radius: int | None = None) -> torch.Tensor:
    """The soft mask of each `cur` frame against its `prev` frame;
    fwd_flows map prev -> cur, past_flows cur -> prev."""
    fwd2bwd = warp_flow(fwd_flows, past_flows, radius=radius)
    flow_term = torch.sigmoid(
        -beta * (_norm2(past_flows + fwd2bwd)
                 - (_norm2(past_flows) + _norm2(fwd2bwd) + 1.0) * alpha))
    warped = warp_flow(prev_imgs, past_flows, radius=radius)
    diff = (warped - cur_imgs).abs().amax(dim=-1)
    photo_term = torch.sigmoid(-beta * (diff - global_max * diff_threshold))
    return flow_term * photo_term


def flow_radius(*flows: np.ndarray, bucket: int = 4, cap: int = 128) -> int | None:
    """The window-warp radius for host flow arrays: ceil(max |flow|)
    rounded up to `bucket` (at least `bucket`). None when that exceeds
    `cap`: the window warp drops taps beyond its radius, so large motion
    takes the exact gather warp instead."""
    m = max((float(np.max(np.abs(f))) for f in flows if np.size(f)), default=0.0)
    r = max(bucket, int(np.ceil(m / bucket)) * bucket)
    if r > cap:
        get_logger().info("max |flow| %.1f px exceeds the %d px window-warp cap; "
                          "using the exact gather warp", m, cap)
        return None
    return r


@torch.no_grad()
def get_soft_mask_bwds_chunked(org_images: np.ndarray, flows: np.ndarray,
                               past_flows: np.ndarray, chunk: int = 8,
                               device: str | torch.device | None = "cuda",
                               **kw) -> np.ndarray:
    """Soft masks chunk by chunk, so device memory stays bounded by the
    chunk size. On the card the warps are window sums (K3) at
    `flow_radius`; on the CPU they stay gather warps."""
    dev = resolve_device(device)
    n = org_images.shape[0]
    out = np.ones(org_images.shape[:3], np.float32)
    gmax = float(org_images.max())
    if "radius" not in kw and dev.type == "cuda" and n > 1:
        kw["radius"] = flow_radius(flows, past_flows)

    def up(a, sl):
        return torch.from_numpy(np.ascontiguousarray(a[sl], np.float32)).to(dev)

    i = 1
    while i < n:
        j = min(i + chunk, n)
        pad = chunk - (j - i)
        sl_prev, sl_cur = np.arange(i - 1, j - 1), np.arange(i, j)
        if pad:
            sl_prev = np.concatenate([sl_prev, [sl_prev[-1]] * pad])
            sl_cur = np.concatenate([sl_cur, [sl_cur[-1]] * pad])
        m = get_soft_mask_pairs(up(org_images, sl_prev), up(org_images, sl_cur),
                                up(flows, sl_prev), up(past_flows, sl_cur), gmax, **kw)
        out[i:j] = m[: j - i].cpu().numpy()
        i = j
    return out


def get_flowid(frames: torch.Tensor, flows: torch.Tensor, mask_bwds: torch.Tensor,
               rgb_threshold: float = 0.01) -> torch.Tensor:
    """Propagate integer pixel-track ids along the forward flow, one frame
    at a time. Frame 0 starts one track per pixel; a later pixel inherits
    the id of the pixel that flows onto it when that target is in the
    frame, backward-consistent and photometrically close, and otherwise
    gets a fresh id. Returns int32 (N, H, W). Where two pixels flow onto
    one target, which one wins is not specified."""
    n, h, w = frames.shape[:3]
    dev = frames.device
    grid = identity_grid(h, w, device=dev)
    gx, gy = grid[..., 0].int(), grid[..., 1].int()
    diff_threshold = frames.max() * rgb_threshold
    prev = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    last_id = h * w
    out = [prev]
    for t in range(1, n):
        flow = flows[t - 1]
        x = torch.round(gx + flow[..., 0]).int()
        y = torch.round(gy + flow[..., 1]).int()
        inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        xc, yc = x.clamp(0, w - 1).long(), y.clamp(0, h - 1).long()
        tgt_rgb = frames[t][yc, xc]
        sim = (tgt_rgb - frames[t - 1]).abs().amax(dim=-1) < diff_threshold
        ok = inb & (mask_bwds[t].float() > 0.5) & sim
        cur = torch.full((h * w,), -1, dtype=torch.int32, device=dev)
        tgt = (yc * w + xc)[ok]
        cur[tgt] = prev[ok]
        unassigned = cur < 0
        n_new = int(unassigned.sum())
        cur[unassigned] = torch.arange(last_id, last_id + n_new, dtype=torch.int32,
                                       device=dev)
        last_id += n_new
        prev = cur.reshape(h, w)
        out.append(prev)
    return torch.stack(out)


def voxelization(flow_ids: np.ndarray, in_feats_rgb: np.ndarray | None = None,
                 in_feats_coord: np.ndarray | None = None,
                 voxel_size: float | None = None, rgb_vox_size: float = 2 / 255,
                 instance_ids: np.ndarray | None = None) -> np.ndarray:
    """Map each pixel to its unique track (or spatial voxel) id, on the
    host. flow_ids: (P,) or (P, C) ints. Returns int32 `unq_inv` (P,) with
    values in [0, n_unique)."""
    flow_ids = np.asarray(flow_ids)
    if flow_ids.ndim == 1:
        flow_ids = flow_ids[:, None]
    if instance_ids is not None:
        flow_ids = np.concatenate(
            [flow_ids, np.asarray(instance_ids).reshape(len(flow_ids), -1)], axis=1)
    if flow_ids.shape[1] == 1:
        _, unq_inv_t = np.unique(flow_ids[:, 0], return_inverse=True)
    else:
        _, unq_inv_t = np.unique(flow_ids, axis=0, return_inverse=True)
    unq_inv_t = unq_inv_t.reshape(-1).astype(np.int32)
    if voxel_size is None:
        return unq_inv_t

    # time + spatial voxel hashing
    assert in_feats_rgb is not None and in_feats_coord is not None
    n_unique = int(unq_inv_t.max()) + 1

    def segment_mean(vals: np.ndarray) -> np.ndarray:
        sums = np.zeros((n_unique, vals.shape[1]), dtype=np.float64)
        np.add.at(sums, unq_inv_t, vals)
        counts = np.bincount(unq_inv_t, minlength=n_unique).astype(np.float64)
        return sums / np.maximum(counts, 1)[:, None]

    rgb = np.floor(segment_mean(np.asarray(in_feats_rgb)) / rgb_vox_size)
    coord = segment_mean(np.asarray(in_feats_coord))
    coord = coord - coord.min(axis=0, keepdims=True)
    coord = np.floor(coord / voxel_size)
    key = np.concatenate([coord, rgb], axis=1)
    _, unq_inv_xyz = np.unique(key, axis=0, return_inverse=True)
    return unq_inv_xyz.reshape(-1).astype(np.int32)[unq_inv_t]
