"""RAFT optical flow (counterpart of tclight_tpu/models/raft.py).

The modules work in NCHW; `RAFT` takes and returns NHWC, as the JAX
module does, and the correlation helpers keep the JAX package's NHWC
signatures:

- `corr_pyramid`: the dense all-pairs volume, one batched matmul, each
  further level a 2x2 VALID average pool of the correlation (odd sizes
  drop a row or column);
- `corr_lookup`: the (2r+1)^2 window at every level, by a bilinear gather
  whose four taps are zero-padded one by one; the window is flattened
  x-major (the reference's `meshgrid(dy, dx)` quirk, which the
  checkpoint's `convc1` weights depend on);
- `corr_lookup_chunked`: the bounded-memory form that pools the features
  instead of the correlation (the JAX package's approximation of
  alt_cuda_corr, not equal to the dense path past level 0).

The correlation is a matmul and a gather, so no hand-written kernel runs
here. Precision on the card: `RAFTFlowModel` computes in full f32, set
for its call whatever the global flags, on PyTorch's own convolution
kernels: cuDNN in f32 picks an FFT algorithm for this network that took
7-10x longer, and TF32 inputs move the flows (PERF.md, the flow
networks' findings).

`convert_raft_params` (numpy, the JAX package's code) maps a reference
`raft-things.pth` onto the flax tree, and `models.bridge.raft_state_dict`
turns the tree into this module's state dict.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["RAFTConfig", "BasicEncoder", "corr_pyramid", "corr_lookup",
           "corr_lookup_chunked", "BasicUpdateBlock", "convex_upsample", "RAFT",
           "convert_raft_params", "reference_state_dict", "RAFTFlowModel"]


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20
    fnet_dim: int = 256

    @staticmethod
    def tiny() -> "RAFTConfig":
        return RAFTConfig(hidden_dim=32, context_dim=32, corr_levels=2,
                          corr_radius=2, iters=4, fnet_dim=64)

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


def conv(cin: int, cout: int, k, stride: int = 1, bias: bool = True,
         groups: int = 1) -> nn.Conv2d:
    """A conv with the flax module's SAME-style padding: k // 2 per side
    (k an int or an (h, w) pair)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), stride, (kh // 2, kw // 2), bias=bias,
                     groups=groups)


class InstanceNorm(nn.Module):
    """InstanceNorm2d without affine: biased variance, eps 1e-5."""

    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


class FrozenAffine(nn.Module):
    """BatchNorm2d in eval mode, its running statistics folded into a
    per-channel scale (`weight`) and `bias` by the converter."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def _norm(kind: str, channels: int) -> nn.Module:
    return FrozenAffine(channels) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, norm: str = "instance"):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.norm1 = _norm(norm, planes)
        self.conv2 = conv(planes, planes, 3)
        self.norm2 = _norm(norm, planes)
        self.downsample_0 = self.downsample_norm = None
        if stride != 1 or cin != planes:
            self.downsample_0 = conv(cin, planes, 1, stride)
            self.downsample_norm = _norm(norm, planes)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample_0 is not None:
            x = self.downsample_norm(self.downsample_0(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT's feature / context encoder: (B, 3, H, W) -> (B, output_dim,
    H/8, W/8). The reference's fnet uses instance norm, its cnet batch norm."""

    def __init__(self, output_dim: int = 256, base: int = 64, norm: str = "instance"):
        super().__init__()
        b = base
        self.conv1 = conv(3, b, 7, 2)
        self.norm1 = _norm(norm, b)
        widths = [(b, b, 1), (b, b, 1), (b, b * 3 // 2, 2), (b * 3 // 2, b * 3 // 2, 1),
                  (b * 3 // 2, b * 2, 2), (b * 2, b * 2, 1)]
        for i, (cin, cout, stride) in enumerate(widths):
            self.add_module(f"layer{i // 2 + 1}_{i % 2}",
                            ResidualBlock(cin, cout, stride, norm))
        self.conv2 = conv(b * 2, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1", "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        return self.conv2(x)


# ------------------------------------------------------------- correlation


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """All-pairs correlation pyramid. f1 / f2: (B, H, W, C) -> one
    (B, H*W, H_l, W_l) volume per level."""
    b, h, w, c = f1.shape
    corr = torch.bmm(f1.reshape(b, h * w, c).float(),
                     f2.reshape(b, h * w, c).float().transpose(1, 2))
    corr = (corr / np.sqrt(np.float32(c))).reshape(b, h * w, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr)
    return pyramid


def _bilinear_gather(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """plane (Q, H, W); x / y (Q, K) sample coordinates -> (Q, K); each of
    the four taps reads zero outside the plane."""
    qn, h, w = plane.shape
    flat = plane.reshape(qn, h * w)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0

    def tap(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        return torch.where(valid, torch.gather(flat, 1, idx), 0.0)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy


def _window_offsets(radius: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The window's (dx, dy) offsets, flattened x-major: tap i * (2r+1) + j
    is (dx, dy) = (i - r, j - r)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    n = 2 * radius + 1
    return d.repeat_interleave(n), d.repeat(n)


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """The (2r+1)^2 window around `coords` (B, H, W, 2) at each level ->
    (B, H, W, levels * (2r+1)^2)."""
    b, h, w, _ = coords.shape
    offs_x, offs_y = _window_offsets(radius, coords.device)
    outs = []
    for lvl, corr in enumerate(pyramid):
        scale = 2.0 ** lvl
        cx = coords[..., 0].reshape(b * h * w, 1) / scale + offs_x[None]
        cy = coords[..., 1].reshape(b * h * w, 1) / scale + offs_y[None]
        plane = corr.reshape(b * h * w, corr.shape[2], corr.shape[3])
        outs.append(_bilinear_gather(plane, cx, cy).reshape(b, h, w, -1))
    return torch.cat(outs, dim=-1)


def corr_lookup_chunked(f1: torch.Tensor, f2: torch.Tensor, coords: torch.Tensor,
                        levels: int, radius: int, chunk: int = 1024) -> torch.Tensor:
    """The window lookup without the (HW)^2 volume: f2's features are
    average-pooled per level, and each chunk of queries takes its row block
    of correlations by one matmul and reduces it by the window gather at
    once. f1 / f2 (B, H, W, C), coords (B, H, W, 2) -> (B, H, W,
    levels * (2r+1)^2)."""
    b, h, w, c = f1.shape
    q = h * w
    offs_x, offs_y = _window_offsets(radius, coords.device)
    f2_levels = [f2.float()]
    for _ in range(levels - 1):
        pooled = F.avg_pool2d(f2_levels[-1].permute(0, 3, 1, 2), 2, 2)
        f2_levels.append(pooled.permute(0, 2, 3, 1))
    f1_flat = f1.reshape(b, q, c).float()
    coords_flat = coords.reshape(b, q, 2)
    outs = []
    for lvl, f2l in enumerate(f2_levels):
        hl, wl = f2l.shape[1], f2l.shape[2]
        f2_flat = f2l.reshape(b, hl * wl, c)
        scale = 2.0 ** lvl
        vals = []
        for bi in range(b):
            rows = []
            for s in range(0, q, chunk):
                scores = (f1_flat[bi, s:s + chunk] @ f2_flat[bi].T) / np.sqrt(np.float32(c))
                cxy = coords_flat[bi, s:s + chunk]
                cx = cxy[:, :1] / scale + offs_x[None]
                cy = cxy[:, 1:] / scale + offs_y[None]
                rows.append(_bilinear_gather(scores.reshape(-1, hl, wl), cx, cy))
            vals.append(torch.cat(rows))
        outs.append(torch.stack(vals).reshape(b, h, w, -1))
    return torch.cat(outs, dim=-1)


# ------------------------------------------------------------- update block


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = conv(corr_planes, 256, 1)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(256, 126, 3)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)  # 128 channels


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, input_dim: int):
        super().__init__()
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}", conv(hidden + input_dim, hidden, k))

    def forward(self, h, x):
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv1 = conv(hidden, 256, 3)
        self.conv2 = conv(256, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """One refinement step: (net, inp, corr, flow) NCHW -> (net, 0.25 *
    upsampling mask (B, 576, h, w), flow delta (B, 2, h, w))."""

    def __init__(self, corr_planes: int, hidden: int = 128, context: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, context + 128)
        self.flow_head = FlowHead(hidden)
        self.mask_0 = conv(hidden, 256, 3)
        self.mask_2 = conv(256, 64 * 9, 1)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        delta = self.flow_head(net)
        mask = self.mask_2(F.relu(self.mask_0(net)))
        return net, 0.25 * mask, delta


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex upsampling. flow (B, H, W, 2), mask (B, H, W, 576) laid out
    as (9 taps, 8, 8) with a softmax over the taps -> (B, 8H, 8W, 2)."""
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    fpad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack([fpad[:, dy:dy + h, dx:dx + w]
                             for dy in range(3) for dx in range(3)], dim=3)  # (B,H,W,9,2)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", mask, neighbors)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


def pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) pixel coordinates as [x, y]."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], -1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class RAFT(nn.Module):
    """(image1, image2) (B, H, W, 3) in [0, 1] -> (flow at full resolution
    (B, H, W, 2), flow at 1/8 (B, H/8, W/8, 2)). No padding to a multiple
    of 8, as in the JAX package; `iters` refinement steps on the dense
    pyramid; `init_flow` (B, H/8, W/8, 2) warm-starts them."""

    def __init__(self, config: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.config = cfg = config
        self.fnet = BasicEncoder(cfg.fnet_dim, cfg.fnet_dim // 4, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, cfg.fnet_dim // 4, "batch")
        self.update_block = BasicUpdateBlock(cfg.corr_planes, cfg.hidden_dim, cfg.context_dim)

    def forward(self, image1, image2, iters: int | None = None, init_flow=None):
        cfg = self.config
        iters = iters or cfg.iters
        x1, x2 = nchw(2.0 * image1 - 1.0), nchw(2.0 * image2 - 1.0)
        f1, f2 = nhwc(self.fnet(x1)), nhwc(self.fnet(x2))
        ctx = self.cnet(x1)
        net = torch.tanh(ctx[:, :cfg.hidden_dim])
        inp = F.relu(ctx[:, cfg.hidden_dim:])

        b, h8, w8, _ = f1.shape
        pyramid = corr_pyramid(f1, f2, cfg.corr_levels)
        coords0 = pixel_grid(h8, w8, f1.device).expand(b, h8, w8, 2)
        coords1 = coords0 if init_flow is None else coords0 + init_flow
        mask = None
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1, cfg.corr_radius)
            net, mask, delta = self.update_block(net, inp, nchw(corr),
                                                 nchw(coords1 - coords0))
            coords1 = coords1 + nhwc(delta)
        flow = coords1 - coords0
        return convex_upsample(flow, nhwc(mask)), flow


# --------------------------------------------------------------- conversion


def convert_raft_params(sd: dict, config: RAFTConfig = RAFTConfig()) -> dict:
    """A reference `raft-things.pth` state dict -> the flax parameter tree
    of the JAX package's RAFT (the 'module.' DDP prefix stripped; eval-mode
    BatchNorm folded into FrozenAffine scale / bias)."""

    def convw(w):
        return np.transpose(np.asarray(w), (2, 3, 1, 0))

    out: dict = {}

    def put(path, val):
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def put_conv(path, leaf, v):
        put(f"{path}/{'kernel' if leaf == 'weight' else 'bias'}",
            convw(v) if leaf == "weight" else v)

    bn_raw: dict = {}

    def put_bn(path, leaf, val):
        bn_raw.setdefault(path, {})[leaf] = val

    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        v = np.asarray(v)
        top, *rest = k.split(".")
        if top in ("fnet", "cnet"):
            name = rest[0]
            if name.startswith("layer"):
                lvl, blk, sub, leaf = name[-1], rest[1], rest[2], rest[3]
                if sub == "downsample":
                    # downsample.0 is the conv, downsample.1 the norm
                    if rest[3] == "0":
                        put_conv(f"{top}/layer{lvl}_{blk}/downsample_0", rest[4], v)
                    else:
                        put_bn(f"{top}/layer{lvl}_{blk}/downsample_norm", rest[4], v)
                elif sub.startswith("norm"):
                    put_bn(f"{top}/layer{lvl}_{blk}/{sub}", leaf, v)
                else:
                    put_conv(f"{top}/layer{lvl}_{blk}/{sub}", leaf, v)
            elif name.startswith("norm"):
                put_bn(f"{top}/{name}", rest[1], v)
            else:  # conv1 / conv2
                put_conv(f"{top}/{name}", rest[1], v)
        elif top == "update_block":
            sub = rest[0]
            if sub in ("encoder", "gru", "flow_head"):
                put_conv(f"update_block/{sub}/{rest[1]}", rest[2], v)
            elif sub == "mask":  # mask.0 and mask.2 (mask.1 is the ReLU)
                put_conv(f"update_block/mask_{rest[1]}", rest[2], v)
    # eval-mode BatchNorm -> FrozenAffine; norms without a weight (no
    # affine) hold no parameters
    eps = 1e-5
    for path, pieces in bn_raw.items():
        if "weight" not in pieces:
            continue
        scale = pieces["weight"] / np.sqrt(pieces["running_var"] + eps)
        bias = pieces["bias"] - pieces["running_mean"] * scale
        put(f"{path}/scale", scale.astype(np.float32))
        put(f"{path}/bias", bias.astype(np.float32))
    return {"params": out}


def reference_key(key: str) -> str:
    """A port key of RAFT's modules as the reference checkpoint names it:
    layer1_0 -> layer1.0, downsample_0 / downsample_norm -> downsample.0 /
    .1, mask_0 / mask_2 -> mask.0 / .2."""
    key = re.sub(r"layer(\d)_(\d)\.", r"layer\1.\2.", key)
    key = key.replace("downsample_0.", "downsample.0.").replace("downsample_norm.",
                                                                "downsample.1.")
    return re.sub(r"\bmask_([02])\.", r"mask.\1.", key)


def reference_state_dict(model: nn.Module, rename=reference_key) -> dict[str, torch.Tensor]:
    """`model`'s weights under the reference checkpoint's keys (`rename`):
    for RAFT, those of `raft-things.pth`, the inverse of
    `convert_raft_params` followed by `bridge.raft_state_dict`. A
    FrozenAffine becomes an eval-mode BatchNorm with running mean 0 and
    variance 1. This writes reference-format checkpoints from random
    weights."""
    out = {rename(k): v.detach().float().cpu().clone() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenAffine):
            pre = rename(f"{name}.weight")[:-len(".weight")]
            out[f"{pre}.weight"] = out[f"{pre}.weight"] * float(np.sqrt(np.float32(1 + 1e-5)))
            out[f"{pre}.running_mean"] = torch.zeros_like(out[f"{pre}.weight"])
            out[f"{pre}.running_var"] = torch.ones_like(out[f"{pre}.weight"])
    return out


class RAFTFlowModel:
    """The data layer's `raft` backend: a RAFT on `device` in eval mode,
    from a state dict of this module's keys; in full f32 on the card, on
    PyTorch's convolution kernels."""

    def __init__(self, state_dict: dict, config: RAFTConfig = RAFTConfig(),
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = RAFT(config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, frames_a: np.ndarray, frames_b: np.ndarray) -> np.ndarray:
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        with full_f32(cudnn=False):
            return self.model(up(frames_a), up(frames_b))[0].cpu().numpy()

    def batched_flow(self, frames_a: np.ndarray, frames_b: np.ndarray,
                     batch: int = 4) -> np.ndarray:
        """Flows (N, H, W, 2) from frames_a[i] to frames_b[i], (N, H, W, 3)
        in [0, 1], `batch` pairs a call."""
        return np.concatenate([self(frames_a[i:i + batch], frames_b[i:i + batch])
                               for i in range(0, len(frames_a), batch)])
