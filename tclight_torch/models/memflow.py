"""MemFlow-style streaming flow: a RAFT backbone with a bounded key-value
motion memory across frames (counterpart of tclight_tpu/models/memflow.py).

This is the architecture-only variant, not checkpoint-compatible (the
`memflow` backend loads models/memflow_sk.py). The memory is a ring of
`mem_capacity` frames of (key, value) tokens; the current frame's context
queries attend over the written slots and add a projected residual to the
context features once a frame; the frame's tokens are then written at
slot count % capacity. `forward_interpolate` warm-starts the next pair on
the host. Modules work in NCHW; `MemFlowNet` takes NHWC frames in [0, 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.models.raft import (BasicEncoder, BasicUpdateBlock, RAFTConfig,
                                       convex_upsample, corr_lookup, corr_pyramid, nchw,
                                       nhwc, pixel_grid)
from tclight_torch.utils.device import resolve_device

__all__ = ["MemFlowConfig", "MemFlowNet", "MemoryState", "init_memory", "InferenceCore",
           "forward_interpolate"]


@dataclasses.dataclass(frozen=True)
class MemFlowConfig:
    raft: RAFTConfig = RAFTConfig()
    mem_capacity: int = 16
    mem_dim: int = 128
    n_heads: int = 1

    @staticmethod
    def tiny() -> "MemFlowConfig":
        return MemFlowConfig(raft=RAFTConfig.tiny(), mem_capacity=4, mem_dim=32)


@dataclasses.dataclass
class MemoryState:
    """keys / values (B, capacity, h*w, D); count, a host int, the frames
    written so far."""

    keys: torch.Tensor
    values: torch.Tensor
    count: int


def init_memory(cfg: MemFlowConfig, batch: int, h8: int, w8: int, device=None) -> MemoryState:
    shape = (batch, cfg.mem_capacity, h8 * w8, cfg.mem_dim)
    return MemoryState(torch.zeros(shape, device=device), torch.zeros(shape, device=device), 0)


class MemoryAggregator(nn.Module):
    """Cross-attends this frame's queries into the memory bank and adds a
    projected residual; writes this frame's (key, value) tokens."""

    def __init__(self, cfg: MemFlowConfig, context_dim: int, motion_dim: int, out_dim: int):
        super().__init__()
        self.cfg = cfg
        d = cfg.mem_dim
        self.to_q = nn.Linear(context_dim, d)
        self.proj = nn.Linear(d, out_dim)
        self.mem_k = nn.Linear(context_dim, d)
        self.mem_v = nn.Linear(motion_dim, d)

    def forward(self, context, motion, memory: MemoryState):
        """context, motion NCHW -> motion + residual, NCHW."""
        b, _, h, w = motion.shape
        d = self.cfg.mem_dim
        q = self.to_q(nhwc(context)).reshape(b, h * w, d)
        n = min(memory.count, self.cfg.mem_capacity)  # written slots
        mem_k = memory.keys[:, :n].reshape(b, -1, d)
        mem_v = memory.values[:, :n].reshape(b, -1, d)
        if n:
            probs = torch.softmax(torch.bmm(q, mem_k.transpose(1, 2)) / np.sqrt(d), dim=-1)
            agg = torch.bmm(probs, mem_v)
        else:  # an empty memory adds the projection of zeros
            agg = torch.zeros_like(q)
        return motion + nchw(self.proj(agg.reshape(b, h, w, d)))

    def write(self, context, motion, memory: MemoryState) -> MemoryState:
        b, _, h, w = motion.shape
        d = self.cfg.mem_dim
        k = self.mem_k(nhwc(context)).reshape(b, h * w, d)
        v = self.mem_v(nhwc(motion)).reshape(b, h * w, d)
        slot = memory.count % self.cfg.mem_capacity
        keys, values = memory.keys.clone(), memory.values.clone()
        keys[:, slot], values[:, slot] = k, v
        return MemoryState(keys, values, memory.count + 1)


class MemFlowNet(nn.Module):
    """step(frame_t, frame_t+1, memory) -> (flow_up, flow at 1/8, memory);
    frames (B, H, W, 3) in [0, 1], flows NHWC."""

    def __init__(self, cfg: MemFlowConfig = MemFlowConfig()):
        super().__init__()
        self.cfg = cfg
        r = cfg.raft
        self.fnet = BasicEncoder(r.fnet_dim, r.fnet_dim // 4)
        self.cnet = BasicEncoder(r.hidden_dim + r.context_dim, r.fnet_dim // 4)
        self.update_block = BasicUpdateBlock(r.corr_planes, r.hidden_dim, r.context_dim)
        self.memory = MemoryAggregator(cfg, r.context_dim, r.hidden_dim, r.context_dim)

    def forward(self, image1, image2, memory: MemoryState | None = None, init_flow=None,
                iters: int | None = None):
        r = self.cfg.raft
        iters = iters or r.iters
        x1, x2 = nchw(2 * image1 - 1), nchw(2 * image2 - 1)
        f1, f2 = nhwc(self.fnet(x1)), nhwc(self.fnet(x2))
        ctx = self.cnet(x1)
        net = torch.tanh(ctx[:, :r.hidden_dim])
        inp = F.relu(ctx[:, r.hidden_dim:])
        b, h8, w8, _ = f1.shape
        if memory is None:
            memory = init_memory(self.cfg, b, h8, w8, f1.device)

        pyramid = corr_pyramid(f1, f2, r.corr_levels)
        coords0 = pixel_grid(h8, w8, f1.device).expand(b, h8, w8, 2)
        coords1 = coords0 if init_flow is None else coords0 + init_flow
        # the memory enriches the context features once a frame
        inp = self.memory(inp, inp, memory)
        mask = None
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1, r.corr_radius)
            net, mask, delta = self.update_block(net, inp, nchw(corr),
                                                 nchw(coords1 - coords0))
            coords1 = coords1 + nhwc(delta)
        flow8 = coords1 - coords0
        new_memory = self.memory.write(inp, net, memory)
        return convex_upsample(flow8, nhwc(mask)), flow8, new_memory


def forward_interpolate(flow8: np.ndarray) -> np.ndarray:
    """The previous coarse flow (h, w, 2) splatted forward as the next
    pair's init, on the host: each pixel's flow lands at its rounded
    target, collisions averaged, holes zero."""
    h, w, _ = flow8.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tx = np.round(xs + flow8[..., 0]).astype(np.int64)
    ty = np.round(ys + flow8[..., 1]).astype(np.int64)
    ok = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    out = np.zeros_like(flow8)
    cnt = np.zeros((h, w, 1), np.float32)
    np.add.at(out, (ty[ok], tx[ok]), flow8[ok])
    np.add.at(cnt, (ty[ok], tx[ok], np.zeros_like(ty[ok])), 1.0)
    nz = cnt[..., 0] > 0
    out[nz] /= cnt[nz]
    return out


class InferenceCore:
    """Streams frame pairs through a MemFlowNet on `device` with a
    persistent memory and warm starts."""

    def __init__(self, model: MemFlowNet, warm_start: bool = True,
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.warm_start = warm_start
        self.reset()

    def reset(self):
        self.memory: MemoryState | None = None
        self._prev_flow8: np.ndarray | None = None

    @torch.no_grad()
    def step(self, frame_a: np.ndarray, frame_b: np.ndarray) -> np.ndarray:
        """frames (H, W, 3) in [0, 1] -> flow (H, W, 2)."""
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a[None], np.float32)).to(self.device)
        if self.memory is None:
            self.memory = init_memory(self.model.cfg, 1, frame_a.shape[0] // 8,
                                      frame_a.shape[1] // 8, self.device)
        init = None
        if self.warm_start and self._prev_flow8 is not None:
            init = up(forward_interpolate(self._prev_flow8))
        flow_up, flow8, self.memory = self.model(up(frame_a), up(frame_b), self.memory, init)
        self._prev_flow8 = flow8[0].cpu().numpy()
        return flow_up[0].cpu().numpy()
