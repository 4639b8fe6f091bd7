"""MemFlowNet, the GMA-SK2 ("skflow") variant that `MemFlowNet_things.pth`
parameterizes (counterpart of tclight_tpu/models/memflow_sk.py): the
`memflow` flow backend.

- the feature and context encoders are RAFT's `BasicEncoder` (instance /
  batch norm), shared with models/raft.py;
- the SK update block stacks `PCBlock`s: 1x1 FFNs and depthwise k x k
  convs (k in 1, 15 for the motion encoder and the flow head, 1, 7 for the
  GRU) with GELU residues;
- the memory attention: the context queries attend over [memory keys |
  this frame's key] with the scale d^-1/2 * log(max(L, 2)) /
  log(train_avg_length), L the true key count. The probabilities are
  computed once a frame and read out against the values of every decoder
  iteration; memory slots past `count` are left out of the softmax, as
  the JAX package masks them with -inf;
- the decoder's `coords1` starts at zero (plus the warm start) and the
  lookup is at grid + coords1.

`InferenceCoreSK` streams frame pairs: it rolls the working memory on the
device between frames (capacity (max_mid_term_frames - 1) * hw, the most
recent kept) and warm-starts each pair from the previous low-resolution
flow splatted forward on the host (`forward_interpolate_np`). Modules work
in NCHW; `MemFlowNetSK.__call__` takes NHWC frames in [-1, 1]. On the
card the core's step computes in full f32 on PyTorch's convolution
kernels, as RAFTFlowModel does (cuDNN's depthwise kernel took 2.1-2.7x
longer).
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.models import raft
from tclight_torch.models.raft import (BasicEncoder, conv, convex_upsample, corr_lookup,
                                       corr_pyramid, nchw, nhwc, pixel_grid)
from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["MemFlowSKConfig", "PCBlock", "SKMotionEncoder", "SKUpdateBlock",
           "MemFlowNetSK", "MemoryState", "forward_interpolate_np", "InferenceCoreSK",
           "convert_memflow_params", "reference_state_dict"]


@dataclasses.dataclass(frozen=True)
class MemFlowSKConfig:
    corr_levels: int = 4
    corr_radius: int = 4
    hidden_dim: int = 128
    context_dim: int = 128
    feat_dim: int = 256
    decoder_depth: int = 15          # the things config's val_decoder_depth
    train_avg_length: float = (400 * 720 // 64) * 3 / 2
    max_mid_term_frames: int = 2
    min_mid_term_frames: int = 1

    @property
    def cor_planes(self) -> int:
        return (2 * self.corr_radius + 1) ** 2 * self.corr_levels


class PCBlock(nn.Module):
    """PCBlock4_Deep_nopool_res: pointwise FFN, depthwise k x k convs and a
    pointwise conv, each with a GELU residue, then an FFN to c_out."""

    def __init__(self, c_in: int, c_out: int, k_conv: tuple):
        super().__init__()
        mid = int(1.5 * c_in)
        self.ffn1_0 = conv(c_in, mid, 1)
        self.ffn1_2 = conv(mid, c_in, 1)
        self.k_conv = tuple(k_conv)
        for i, k in enumerate(self.k_conv):
            self.add_module(f"conv_{i}", conv(c_in, c_in, k, groups=c_in))
        self.pw = conv(c_in, c_in, 1)
        self.ffn2_0 = conv(c_in, mid, 1)
        self.ffn2_2 = conv(mid, c_out, 1)

    def forward(self, x):
        x = F.gelu(x + self.ffn1_2(F.gelu(self.ffn1_0(x))))
        for i in range(len(self.k_conv)):
            x = F.gelu(x + getattr(self, f"conv_{i}")(x))
        x = F.gelu(x + self.pw(x))
        return self.ffn2_2(F.gelu(self.ffn2_0(x)))


class SKMotionEncoder(nn.Module):
    """SKMotionEncoder6_Deep_nopool_res_Mem_skflow: (flow, corr) -> 128
    channels (126 of motion, then the flow)."""

    def __init__(self, cfg: MemFlowSKConfig):
        super().__init__()
        k = (1, 15)
        self.convc1 = PCBlock(cfg.cor_planes, 256, k)
        self.convc2 = PCBlock(256, 192, k)
        self.convf1 = conv(2, 128, 1)
        self.convf2 = PCBlock(128, 64, k)
        self.conv = PCBlock(192 + 64, 126, k)

    def forward(self, flow, corr):
        cor = self.convc2(F.gelu(self.convc1(corr)))
        flo = self.convf2(self.convf1(flow))
        return torch.cat([self.conv(torch.cat([cor, flo], 1)), flow], 1)


class SKUpdateBlock(nn.Module):
    """SKUpdateBlock6_Deep_nopoolres_AllDecoder2_Mem_skflow."""

    def __init__(self, cfg: MemFlowSKConfig):
        super().__init__()
        self.encoder = SKMotionEncoder(cfg)
        self.gru = PCBlock(cfg.hidden_dim + cfg.context_dim + 128 + 128, 128, (1, 7))
        self.flow_head = PCBlock(128, 2, (1, 15))
        self.mask_0 = conv(128, 256, 3)
        self.mask_2 = conv(256, 64 * 9, 1)
        self.to_v = conv(128, cfg.context_dim, 1, bias=False)

    def motion_and_value(self, flow, corr):
        motion = self.encoder(flow, corr)
        return motion, self.to_v(motion)

    def forward(self, net, inp, motion, motion_global):
        net = self.gru(torch.cat([net, inp, motion, motion_global], 1))
        delta = self.flow_head(net)
        mask = 0.25 * self.mask_2(F.relu(self.mask_0(net)))
        return net, mask, delta


@dataclasses.dataclass
class MemoryState:
    """Working memory: keys / values (B, cap, C) on the device and the
    number of valid entries (the first `count`), a host int."""

    keys: torch.Tensor
    values: torch.Tensor
    count: int


class MemFlowNetSK(nn.Module):
    def __init__(self, cfg: MemFlowSKConfig = MemFlowSKConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg.feat_dim, 64, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, 64, "batch")
        self.to_qk = conv(cfg.context_dim, 2 * cfg.context_dim, 1, bias=False)
        self.update = SKUpdateBlock(cfg)
        self.gamma = nn.Parameter(torch.zeros(1))

    def empty_memory(self, b: int, h: int, w: int, device) -> MemoryState:
        cap = max(self.cfg.max_mid_term_frames - 1, 1) * h * w
        zeros = torch.zeros(b, cap, self.cfg.context_dim, device=device)
        return MemoryState(zeros, zeros.clone(), 0)

    def encode_context(self, frame):
        """frame (B, 3, H, W) in [-1, 1] -> (query, key, net, inp) at 1/8, NCHW."""
        net, inp = self.cnet(frame).chunk(2, dim=1)
        inp = F.relu(inp)
        q, k = self.to_qk(inp).chunk(2, dim=1)
        return q, k, torch.tanh(net), inp

    def decode(self, fmap1, fmap2, query, key, net, inp, mem: MemoryState,
               flow_init=None, iters: int | None = None):
        """The decoder loop on NCHW maps: `iters` refinement steps with the
        memory attention. Returns (flow_low (B, h, w, 2), flow_up (B, H, W, 2),
        the last iteration's value (B, hw, C))."""
        cfg = self.cfg
        iters = iters or cfg.decoder_depth
        b, _, h, w = fmap1.shape
        hw = h * w
        pyramid = corr_pyramid(nhwc(fmap1), nhwc(fmap2), cfg.corr_levels)
        coords1 = torch.zeros(b, h, w, 2, device=fmap1.device)
        if flow_init is not None:
            coords1 = coords1 + flow_init
        grid = pixel_grid(h, w, fmap1.device)

        def tokens(x):  # (B, C, h, w) -> (B, hw, C)
            return x.flatten(2).transpose(1, 2)

        q = tokens(query).float()
        keys = torch.cat([mem.keys[:, :mem.count], tokens(key)], 1).float()
        scale = q.shape[-1] ** -0.5 * (math.log(max(mem.count + hw, 2.0))
                                        / math.log(cfg.train_avg_length))
        attn = torch.softmax(torch.bmm(q, keys.transpose(1, 2)) * scale, dim=-1)
        del keys

        up_mask = value = None
        for _ in range(iters):
            corr = corr_lookup(pyramid, grid[None] + coords1, cfg.corr_radius)
            motion, value = self.update.motion_and_value(nchw(coords1), nchw(corr))
            vals = torch.cat([mem.values[:, :mem.count], tokens(value)], 1).float()
            readout = torch.bmm(attn, vals).transpose(1, 2).reshape(b, -1, h, w)
            net, up_mask, delta = self.update(net, inp, motion,
                                              motion + self.gamma * readout)
            coords1 = coords1 + nhwc(delta)
        return coords1, convex_upsample(coords1, nhwc(up_mask)), tokens(value)

    def forward(self, frame1, frame2, mem: MemoryState | None = None, flow_init=None,
                iters: int | None = None):
        """One frame pair, frames (B, H, W, 3) in [-1, 1]. Returns (flow_low,
        flow_up, this frame's key (B, hw, C), the last value (B, hw, C))."""
        b, hh, ww, _ = frame1.shape
        h, w = hh // 8, ww // 8
        if mem is None:
            cap = (self.cfg.max_mid_term_frames - 1) * h * w
            zeros = torch.zeros(b, cap, self.cfg.context_dim, device=frame1.device)
            mem = MemoryState(zeros, zeros.clone(), 0)
        x1 = nchw(frame1)
        query, key, net, inp = self.encode_context(x1)
        f = self.fnet(torch.cat([x1, nchw(frame2)], 0))
        flow_low, flow_up, value = self.decode(f[:b], f[b:], query, key, net, inp, mem,
                                               flow_init, iters)
        return flow_low, flow_up, key.flatten(2).transpose(1, 2), value


def forward_interpolate_np(flow_low: np.ndarray) -> np.ndarray:
    """The low-resolution flow (h, w, 2) splatted forward to warm-start the
    next pair: each pixel's flow lands at its rounded target, colliding
    flows are averaged and pixels that nothing lands on are zero."""
    h, w = flow_low.shape[:2]
    fx, fy = flow_low[..., 0], flow_low[..., 1]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x1 = np.round(xs + fx).astype(np.int64)
    y1 = np.round(ys + fy).astype(np.int64)
    valid = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
    out = np.zeros_like(flow_low)
    cnt = np.zeros((h, w, 1), np.float32)
    np.add.at(out, (y1[valid], x1[valid]), flow_low[valid])
    np.add.at(cnt, (y1[valid], x1[valid]), 1.0)
    filled = cnt[..., 0] > 0
    out[filled] /= cnt[filled]
    return out


class InferenceCoreSK:
    """Streams frame pairs through a MemFlowNetSK on `device`, with the
    working memory rolled between frames (mem_every = 1: the memory holds
    the most recent frames' keys and values) and warm starts."""

    def __init__(self, model: MemFlowNetSK, warm_start: bool = True,
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.warm_start = warm_start
        self.reset()

    def reset(self):
        self.mem: MemoryState | None = None
        self.flow_prev = None

    @torch.no_grad()
    def step(self, frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
        """frames (H, W, 3) in [0, 1] -> flow (H, W, 2) at full resolution."""
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a[None] * 2.0 - 1.0,
                                                             np.float32)).to(self.device)
        h, w = frame1.shape[0] // 8, frame1.shape[1] // 8
        if self.mem is None:
            self.mem = self.model.empty_memory(1, h, w, self.device)
        fi = (torch.from_numpy(self.flow_prev[None]).to(self.device)
              if self.warm_start and self.flow_prev is not None else None)
        with full_f32(cudnn=False):
            flow_low, flow_up, key, value = self.model(up(frame1), up(frame2), self.mem, fi)
        # the memory roll: append this frame's (key, value), keep the most
        # recent `cap` entries
        mem, hw = self.mem, h * w
        cap = mem.keys.shape[1]
        if hw >= cap:
            self.mem = MemoryState(key[:, -cap:], value[:, -cap:], cap)
        else:
            self.mem = MemoryState(torch.cat([mem.keys[:, hw:], key], 1)[:, -cap:],
                                   torch.cat([mem.values[:, hw:], value], 1)[:, -cap:],
                                   min(mem.count + hw, cap))
        if self.warm_start:
            self.flow_prev = forward_interpolate_np(flow_low[0].cpu().numpy())
        return flow_up[0].cpu().numpy()


# ------------------------------------------------------------- conversion


def _t_conv(w):
    """torch OIHW (depthwise (C, 1, k, k) too) -> flax HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _conv_leaf(sd, key, bias=True):
    leaf = {"kernel": _t_conv(sd[f"{key}.weight"])}
    if bias:
        leaf["bias"] = np.asarray(sd[f"{key}.bias"])
    return leaf


def _convert_pcblock(sd, prefix):
    out = {}
    i = 0
    while f"{prefix}.conv_list.{i}.weight" in sd:
        out[f"conv_{i}"] = _conv_leaf(sd, f"{prefix}.conv_list.{i}")
        i += 1
    for ours, theirs in (("ffn1_0", "ffn1.0"), ("ffn1_2", "ffn1.2"), ("pw", "pw"),
                         ("ffn2_0", "ffn2.0"), ("ffn2_2", "ffn2.2")):
        out[ours] = _conv_leaf(sd, f"{prefix}.{theirs}")
    return out


def _fold_bn(sd, key, eps=1e-5):
    scale = np.asarray(sd[f"{key}.weight"]) / np.sqrt(np.asarray(sd[f"{key}.running_var"]) + eps)
    bias = np.asarray(sd[f"{key}.bias"]) - np.asarray(sd[f"{key}.running_mean"]) * scale
    return {"scale": scale.astype(np.float32), "bias": bias.astype(np.float32)}


def _convert_encoder(sd, prefix, norm):
    """The reference's BasicEncoder keys -> models/raft.BasicEncoder's tree."""
    batch = norm == "batch"
    out: dict = {"conv1": _conv_leaf(sd, f"{prefix}.conv1"),
                 "conv2": _conv_leaf(sd, f"{prefix}.conv2")}
    if batch and f"{prefix}.norm1.weight" in sd:
        out["norm1"] = _fold_bn(sd, f"{prefix}.norm1")
    for lvl in (1, 2, 3):
        for blk in (0, 1):
            pre = f"{prefix}.layer{lvl}.{blk}"
            node = {sub: _conv_leaf(sd, f"{pre}.{sub}") for sub in ("conv1", "conv2")}
            if f"{pre}.downsample.0.weight" in sd:
                node["downsample_0"] = _conv_leaf(sd, f"{pre}.downsample.0")
            if batch:
                for sub in ("norm1", "norm2"):
                    if f"{pre}.{sub}.weight" in sd:
                        node[sub] = _fold_bn(sd, f"{pre}.{sub}")
                if f"{pre}.downsample.1.weight" in sd:
                    node["downsample_norm"] = _fold_bn(sd, f"{pre}.downsample.1")
            out[f"layer{lvl}_{blk}"] = node
    return out


def convert_memflow_params(sd: dict, cfg: MemFlowSKConfig | None = None) -> dict:
    """A `MemFlowNet_things.pth` state dict -> the flax tree of the JAX
    package's MemFlowNetSK (the 'module.' prefix stripped; att.pos_emb,
    unused at inference, ignored)."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    enc = "update_block.encoder"
    out = {
        "fnet": _convert_encoder(sd, "fnet", "instance"),
        "cnet": _convert_encoder(sd, "cnet", "batch"),
        "to_qk": _conv_leaf(sd, "att.to_qk", bias=False),
        "gamma": np.asarray(sd["update_block.aggregator.gamma"]),
        "update": {
            "encoder": {
                "convc1": _convert_pcblock(sd, f"{enc}.convc1"),
                "convc2": _convert_pcblock(sd, f"{enc}.convc2"),
                "convf1": _conv_leaf(sd, f"{enc}.convf1"),
                "convf2": _convert_pcblock(sd, f"{enc}.convf2"),
                "conv": _convert_pcblock(sd, f"{enc}.conv"),
            },
            "gru": _convert_pcblock(sd, "update_block.gru"),
            "flow_head": _convert_pcblock(sd, "update_block.flow_head"),
            "mask_0": _conv_leaf(sd, "update_block.mask.0"),
            "mask_2": _conv_leaf(sd, "update_block.mask.2"),
            "to_v": _conv_leaf(sd, "update_block.aggregator.to_v", bias=False),
        },
    }
    return {"params": out}


def reference_key(key: str) -> str:
    """A port key of MemFlowNetSK as `MemFlowNet_things.pth` names it."""
    if key == "gamma":
        return "update_block.aggregator.gamma"
    key = key.replace("to_qk.", "att.to_qk.").replace("update.to_v.",
                                                      "update.aggregator.to_v.")
    key = re.sub(r"^update\.", "update_block.", key)
    key = re.sub(r"\.conv_(\d+)\.", r".conv_list.\1.", key)
    key = re.sub(r"\.ffn([12])_([02])\.", r".ffn\1.\2.", key)
    return raft.reference_key(key)


def reference_state_dict(model: MemFlowNetSK) -> dict[str, torch.Tensor]:
    """`model`'s weights under `MemFlowNet_things.pth`'s keys: the inverse of
    `convert_memflow_params` followed by `bridge.memflow_sk_state_dict`."""
    return raft.reference_state_dict(model, reference_key)
