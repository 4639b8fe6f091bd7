"""DPT monocular depth estimator, the sd-depth pipeline's depth model
(counterpart of tclight_tpu/models/dpt.py).

Both layouts of transformers' `DPTForDepthEstimation`:

- plain-ViT DPT (dpt-large): 16 x 16 patches, a ViT, and four taps;
- DPT-hybrid (`is_hybrid`, Intel/dpt-hybrid-midas, what
  stable-diffusion-2-depth ships): a BiT / ResNetV2 stem (weight-
  standardised convolutions, group norm, TF "SAME" padding and max pool,
  bottleneck stages) whose stage-3 map feeds the ViT, and whose stage-1 and
  stage-2 maps go straight to the first two neck positions.

Then the reassemble stage (readout projection, 1x1 projection, resize),
the fusion stage (deepest first, residual units, x2 bilinear resizes with
aligned corners) and the head. `_resize_bilinear` computes JAX's own axis
weights (both align modes), which is what both the position-embedding
resize and the fusion use.

The modules carry the flax module names, so `convert_dpt` (the JAX
package's converter, numpy) and `models.bridge.dpt_state_dict` load a
transformers checkpoint; `reference_state_dict` is their inverse.
`prepare_depth_maps` makes the sd-depth UNet's fifth channel. The port
computes in NCHW and f32 (full f32 on the card: `utils.device.full_f32`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["DPTConfig", "DPTForDepthEstimation", "convert_dpt", "dpt_config_for_state_dict",
           "random_dpt", "reference_state_dict", "load_dpt", "prepare_depth_maps"]


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    backbone_out_indices: tuple = (5, 11, 17, 23)
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    # DPT-hybrid: only out_indices[2:] tap the ViT; neck positions 0-1
    # are the BiT stage-1 / stage-2 maps
    is_hybrid: bool = False
    bit_embedding_size: int = 64
    bit_hidden_sizes: tuple = (256, 512, 1024)
    bit_depths: tuple = (3, 4, 9)
    bit_num_groups: int = 32

    @staticmethod
    def large() -> "DPTConfig":
        return DPTConfig()

    @staticmethod
    def hybrid() -> "DPTConfig":
        """Intel/dpt-hybrid-midas, stable-diffusion-2-depth's depth model."""
        return DPTConfig(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                         backbone_out_indices=(2, 5, 8, 11),
                         neck_hidden_sizes=(256, 512, 768, 768),
                         reassemble_factors=(1, 1, 1, 0.5), is_hybrid=True)

    @staticmethod
    def tiny() -> "DPTConfig":
        return DPTConfig(image_size=64, patch_size=16, hidden_size=32, num_layers=4,
                         num_heads=2, intermediate_size=64, backbone_out_indices=(0, 1, 2, 3),
                         neck_hidden_sizes=(16, 24, 32, 40), fusion_hidden_size=32)

    @staticmethod
    def tiny_hybrid() -> "DPTConfig":
        return DPTConfig(image_size=64, patch_size=16, hidden_size=32, num_layers=4,
                         num_heads=2, intermediate_size=64, backbone_out_indices=(0, 1, 2, 3),
                         neck_hidden_sizes=(16, 24, 32, 32), reassemble_factors=(1, 1, 1, 0.5),
                         fusion_hidden_size=32, is_hybrid=True, bit_embedding_size=16,
                         bit_hidden_sizes=(16, 24, 32), bit_depths=(1, 1, 1), bit_num_groups=4)


def _resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                     align_corners: bool) -> torch.Tensor:
    """Bilinear resize of x (B, C, H, W) with JAX's axis weights: source
    positions linspace(0, n - 1) with aligned corners, else (i + 0.5) *
    n_in / n_out - 0.5 clipped to [0, n - 1]; neighbours floor and floor +
    1 (clipped)."""
    def axis_weights(n_in, n_out):
        if align_corners and n_out > 1:
            pos = torch.linspace(0.0, n_in - 1.0, n_out, device=x.device)
        else:
            pos = (torch.arange(n_out, device=x.device, dtype=torch.float32) + 0.5) \
                * (n_in / n_out) - 0.5
            pos = pos.clamp(0.0, n_in - 1.0)
        lo = pos.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(max=n_in - 1)
        return lo, hi, (pos - lo).to(x.dtype)

    ylo, yhi, wy = axis_weights(x.shape[2], out_h)
    rows = x[:, :, ylo] * (1 - wy)[:, None] + x[:, :, yhi] * wy[:, None]
    xlo, xhi, wx = axis_weights(x.shape[3], out_w)
    return rows[..., xlo] * (1 - wx) + rows[..., xhi] * wx


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF "SAME" padding of x (B, C, H, W) for a k x k window at stride s:
    the total max((ceil(n / s) - 1) s + k - n, 0), the smaller half before."""
    def amount(n):
        return max((-(-n // s) - 1) * s + k - n, 0)

    ph, pw = amount(x.shape[2]), amount(x.shape[3])
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


class _ViTLayer(nn.Module):
    def __init__(self, c: DPTConfig):
        super().__init__()
        d = c.hidden_size
        self.num_heads = c.num_heads
        self.layernorm_before = nn.LayerNorm(d, eps=1e-12)
        self.query, self.key, self.value = (nn.Linear(d, d) for _ in range(3))
        self.attention_output = nn.Linear(d, d)
        self.layernorm_after = nn.LayerNorm(d, eps=1e-12)
        self.intermediate = nn.Linear(d, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads
        h = self.layernorm_before(x)
        q, k, v = (m(h).reshape(b, s, self.num_heads, hd).transpose(1, 2)
                   for m in (self.query, self.key, self.value))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, s, d)
        x = x + self.attention_output(o)
        h = F.gelu(self.intermediate(self.layernorm_after(x)), approximate="none")
        return x + self.output(h)


# ------------------------------------------------ BiT / ResNetV2 stem


def _make_div(value: float, divisor: int = 8) -> int:
    new = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new < 0.9 * value:
        new += divisor
    return new


class _WSConv(nn.Module):
    """Weight-standardised conv, TF-SAME padding, no bias: each output
    channel's kernel normalised by its mean and biased variance (eps
    1e-8)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) * torch.rsqrt(var + 1e-8)
        return F.conv2d(_same_pad(x, self.kernel, self.stride), w, stride=self.stride)


class _BitGroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, act: bool = True):
        super().__init__()
        self.gn = nn.GroupNorm(groups, channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gn(x)
        return F.relu(y) if self.act else y


class _BitBottleneck(nn.Module):
    """Non-pre-activation bottleneck; a downsample shortcut on a stage's
    first layer."""

    def __init__(self, c: DPTConfig, cin: int, cout: int, stride: int, is_first: bool):
        super().__init__()
        g = c.bit_num_groups
        mid = _make_div(cout * 0.25)
        self.is_first = is_first
        if is_first:
            self.downsample_conv = _WSConv(cin, cout, 1, stride)
            self.downsample_norm = _BitGroupNorm(g, cout, act=False)
        self.conv1 = _WSConv(cin, mid, 1)
        self.norm1 = _BitGroupNorm(g, mid)
        self.conv2 = _WSConv(mid, mid, 3, stride)
        self.norm2 = _BitGroupNorm(g, mid)
        self.conv3 = _WSConv(mid, cout, 1)
        self.norm3 = _BitGroupNorm(g, cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample_norm(self.downsample_conv(x)) if self.is_first else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


def _same_max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """TF-SAME zero padding and a max pool (exact: the input is post-ReLU)."""
    return F.max_pool2d(_same_pad(x, k, s), k, s)


class _BitBackbone(nn.Module):
    """Stem and bottleneck stages -> the stage maps at 1/4, 1/8, 1/16."""

    def __init__(self, c: DPTConfig):
        super().__init__()
        self.c = c
        self.stem_conv = _WSConv(3, c.bit_embedding_size, 7, 2)
        self.stem_norm = _BitGroupNorm(c.bit_num_groups, c.bit_embedding_size)
        cin = c.bit_embedding_size
        for s, (depth, width) in enumerate(zip(c.bit_depths, c.bit_hidden_sizes)):
            for layer in range(depth):
                cout = _make_div(width)
                setattr(self, f"stage_{s}_layer_{layer}", _BitBottleneck(
                    c, cin, cout, stride=2 if s > 0 and layer == 0 else 1,
                    is_first=layer == 0))
                cin = cout

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = _same_max_pool(self.stem_norm(self.stem_conv(x)))
        feats = []
        for s, depth in enumerate(self.c.bit_depths):
            for layer in range(depth):
                x = getattr(self, f"stage_{s}_layer_{layer}")(x)
            feats.append(x)
        return feats


def _conv3(cin: int, cout: int, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class DPTForDepthEstimation(nn.Module):
    """forward(pixel_values (B, H, W, 3), normalised; H and W multiples of
    32) -> depth (B, H, W)."""

    def __init__(self, config: DPTConfig = DPTConfig()):
        super().__init__()
        c = self.config = config
        d, fh = c.hidden_size, c.fusion_hidden_size
        if c.is_hybrid:
            self.bit = _BitBackbone(c)
            self.hybrid_projection = nn.Conv2d(_make_div(c.bit_hidden_sizes[-1]), d, 1)
        else:
            self.patch_projection = nn.Conv2d(3, d, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, (c.image_size // c.patch_size) ** 2 + 1, d))
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", _ViTLayer(c))
        first_tap = 2 if c.is_hybrid else 0
        for i, ch in enumerate(c.neck_hidden_sizes):
            if i >= first_tap:
                setattr(self, f"readout_project_{i}", nn.Linear(2 * d, d))
                setattr(self, f"reassemble_projection_{i}", nn.Conv2d(d, ch, 1))
                f = c.reassemble_factors[i]
                if f > 1:
                    setattr(self, f"reassemble_resize_{i}",
                            nn.ConvTranspose2d(ch, ch, int(f), stride=int(f)))
                elif f < 1:
                    setattr(self, f"reassemble_resize_{i}",
                            _conv3(ch, ch, stride=int(round(1 / f))))
            setattr(self, f"neck_conv_{i}", _conv3(ch, fh, bias=False))
        for j in range(len(c.neck_hidden_sizes)):
            for r in (1, 2):
                for cv in (1, 2):
                    setattr(self, f"fusion_{j}_res{r}_conv{cv}", _conv3(fh, fh))
            setattr(self, f"fusion_{j}_projection", nn.Conv2d(fh, fh, 1))
        self.head_0 = _conv3(fh, fh // 2)
        self.head_2 = _conv3(fh // 2, 32)
        self.head_4 = nn.Conv2d(32, 1, 1)

    def _residual_unit(self, y: torch.Tensor, name: str) -> torch.Tensor:
        r = y
        y = getattr(self, f"{name}_conv1")(F.relu(y))
        y = getattr(self, f"{name}_conv2")(F.relu(y))
        return y + r

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = pixel_values.permute(0, 3, 1, 2)
        b, d = x.shape[0], c.hidden_size
        bit_feats: list[torch.Tensor] = []
        if c.is_hybrid:
            bit_feats = self.bit(x)
            x = self.hybrid_projection(bit_feats[-1])
        else:
            x = self.patch_projection(_same_pad(x, c.patch_size, c.patch_size))
        ph, pw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        pos = self.position_embeddings
        old = int(math.isqrt(pos.shape[1] - 1))
        grid = pos[:, 1:].reshape(1, old, old, d).permute(0, 3, 1, 2)
        grid = _resize_bilinear(grid, ph, pw, align_corners=False)
        pos_r = torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1) + pos_r

        vit_indices = set(c.backbone_out_indices[2:] if c.is_hybrid
                          else c.backbone_out_indices)
        taps = []
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i in vit_indices:
                taps.append(x)

        feats = [getattr(self, f"neck_conv_{i}")(t) for i, t in enumerate(bit_feats[:2])]
        for i, t in enumerate(taps, start=2 if c.is_hybrid else 0):
            patches, readout = t[:, 1:], t[:, :1].expand(-1, t.shape[1] - 1, -1)
            p = F.gelu(getattr(self, f"readout_project_{i}")(torch.cat([patches, readout], -1)),
                       approximate="none")
            p = p.transpose(1, 2).reshape(b, d, ph, pw)
            p = getattr(self, f"reassemble_projection_{i}")(p)
            if c.reassemble_factors[i] != 1:
                p = getattr(self, f"reassemble_resize_{i}")(p)
            feats.append(getattr(self, f"neck_conv_{i}")(p))

        fused = None
        for j, feat in enumerate(feats[::-1]):
            name = f"fusion_{j}"
            if fused is None:
                state = feat
            else:
                if fused.shape[2:] != feat.shape[2:]:
                    fused = _resize_bilinear(fused, feat.shape[2], feat.shape[3], False)
                state = feat + self._residual_unit(fused, f"{name}_res1")
            state = self._residual_unit(state, f"{name}_res2")
            state = _resize_bilinear(state, state.shape[2] * 2, state.shape[3] * 2, True)
            fused = getattr(self, f"{name}_projection")(state)

        y = self.head_0(fused)
        y = _resize_bilinear(y, y.shape[2] * 2, y.shape[3] * 2, True)
        y = F.relu(self.head_4(F.relu(self.head_2(y))))
        return y[:, 0]


# ------------------------------------------------ checkpoints


def _conv_t(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _convtrans_t(w):
    # ConvTranspose2d weight (in, out, kh, kw) -> flax (kh, kw, in, out)
    return np.transpose(np.asarray(w), (2, 3, 0, 1))


def dpt_config_for_state_dict(sd: Mapping[str, Any]) -> DPTConfig:
    """The layout of a transformers DPT checkpoint: the BiT stem's key marks
    DPT-hybrid, else plain-ViT dpt-large. A checkpoint of the tiny test
    configs' width (32) takes `tiny_hybrid` / `tiny`, as `load_iclight`
    reads the tiny stack's files (JAX's picks hybrid or large only)."""
    hybrid = "dpt.embeddings.backbone.bit.embedder.convolution.weight" in sd
    if np.shape(sd["dpt.embeddings.cls_token"])[-1] == DPTConfig.tiny().hidden_size:
        return DPTConfig.tiny_hybrid() if hybrid else DPTConfig.tiny()
    return DPTConfig.hybrid() if hybrid else DPTConfig.large()


@torch.no_grad()
def random_dpt(cfg: DPTConfig, seed: int = 0, device: str | torch.device = "cuda"
               ) -> DPTForDepthEstimation:
    """A DPT on random weights whose depth maps vary: N(0, 1 / fan_in)
    kernels, zero biases, unit norms, N(0, 0.02) class token and position
    embeddings, and a head bias of 1 so the last ReLU passes most pixels
    (with a zero bias about half the map would be flat 0)."""
    device = resolve_device(device)
    with torch.device(device):
        model = DPTForDepthEstimation(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif w is not None and w.ndim >= 2:
            fan_in = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            w.normal_(0.0, fan_in ** -0.5, generator=gen)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    for p in (model.cls_token, model.position_embeddings):
        p.normal_(0.0, 0.02, generator=gen)
    model.head_4.bias.fill_(1.0)
    return model.eval().requires_grad_(False)


def convert_dpt(sd: Mapping[str, np.ndarray], cfg: DPTConfig) -> dict:
    """transformers DPTForDepthEstimation (plain or hybrid) -> the flax tree
    of the JAX package's DPT (the JAX converter, numpy)."""
    p: dict = {}

    def put(path, v):
        node = p
        parts = path.split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = np.asarray(v)

    def wb_name(wb):
        return "kernel" if wb == "weight" else "bias"

    bit = r"dpt\.embeddings\.backbone\.bit\."
    for k, v in sd.items():
        if k == "dpt.embeddings.cls_token":
            put("cls_token", v)
        elif k == "dpt.embeddings.position_embeddings":
            put("position_embeddings", v)
        elif k == "dpt.embeddings.patch_embeddings.projection.weight":
            put("patch_projection/kernel", _conv_t(v))
        elif k == "dpt.embeddings.patch_embeddings.projection.bias":
            put("patch_projection/bias", v)
        elif k == "dpt.embeddings.projection.weight":
            put("hybrid_projection/kernel", _conv_t(v))
        elif k == "dpt.embeddings.projection.bias":
            put("hybrid_projection/bias", v)
        elif k == "dpt.embeddings.backbone.bit.embedder.convolution.weight":
            put("bit/stem_conv/kernel", _conv_t(v))
        elif m := re.fullmatch(bit + r"embedder\.norm\.(weight|bias)", k):
            put(f"bit/stem_norm/gn/{'scale' if m.group(1) == 'weight' else 'bias'}", v)
        elif m := re.fullmatch(bit + r"encoder\.stages\.(\d+)\.layers\.(\d+)\.(.+)", k):
            s, layer, rest = m.groups()
            base = f"bit/stage_{s}_layer_{layer}"
            if cm := re.fullmatch(r"conv(\d)\.weight", rest):
                put(f"{base}/conv{cm.group(1)}/kernel", _conv_t(v))
            elif cm := re.fullmatch(r"norm(\d)\.(weight|bias)", rest):
                put(f"{base}/norm{cm.group(1)}/gn/"
                    f"{'scale' if cm.group(2) == 'weight' else 'bias'}", v)
            elif rest == "downsample.conv.weight":
                put(f"{base}/downsample_conv/kernel", _conv_t(v))
            elif cm := re.fullmatch(r"downsample\.norm\.(weight|bias)", rest):
                put(f"{base}/downsample_norm/gn/"
                    f"{'scale' if cm.group(1) == 'weight' else 'bias'}", v)
            else:
                raise KeyError(f"unmatched BiT key {k}")
        elif k in ("dpt.layernorm.weight", "dpt.layernorm.bias"):
            continue  # the pooled output's norm, unused for depth
        elif m := re.fullmatch(r"dpt\.encoder\.layer\.(\d+)\.(.+)\.(weight|bias)", k):
            i, rest, wb = m.groups()
            name = {"attention.attention.query": "query", "attention.attention.key": "key",
                    "attention.attention.value": "value",
                    "attention.output.dense": "attention_output",
                    "intermediate.dense": "intermediate", "output.dense": "output",
                    "layernorm_before": "layernorm_before",
                    "layernorm_after": "layernorm_after"}[rest]
            if "layernorm" in name:
                put(f"layer_{i}/{name}/{'scale' if wb == 'weight' else 'bias'}", v)
            else:
                put(f"layer_{i}/{name}/{wb_name(wb)}",
                    np.transpose(v) if wb == "weight" else v)
        elif m := re.fullmatch(
                r"neck\.reassemble_stage\.readout_projects\.(\d+)\.0\.(weight|bias)", k):
            i, wb = m.groups()
            put(f"readout_project_{i}/{wb_name(wb)}", np.transpose(v) if wb == "weight" else v)
        elif m := re.fullmatch(
                r"neck\.reassemble_stage\.layers\.(\d+)\.projection\.(weight|bias)", k):
            i, wb = m.groups()
            put(f"reassemble_projection_{i}/{wb_name(wb)}", _conv_t(v) if wb == "weight" else v)
        elif m := re.fullmatch(
                r"neck\.reassemble_stage\.layers\.(\d+)\.resize\.(weight|bias)", k):
            i, wb = m.groups()
            if wb == "bias":
                put(f"reassemble_resize_{i}/bias", v)
            elif cfg.reassemble_factors[int(i)] > 1:
                put(f"reassemble_resize_{i}/kernel", _convtrans_t(v))
            else:
                put(f"reassemble_resize_{i}/kernel", _conv_t(v))
        elif m := re.fullmatch(r"neck\.convs\.(\d+)\.weight", k):
            put(f"neck_conv_{m.group(1)}/kernel", _conv_t(v))
        elif m := re.fullmatch(
                r"neck\.fusion_stage\.layers\.(\d+)\.projection\.(weight|bias)", k):
            i, wb = m.groups()
            put(f"fusion_{i}_projection/{wb_name(wb)}", _conv_t(v) if wb == "weight" else v)
        elif m := re.fullmatch(r"neck\.fusion_stage\.layers\.(\d+)\.residual_layer(\d)"
                               r"\.convolution(\d)\.(weight|bias)", k):
            i, rl, cv, wb = m.groups()
            put(f"fusion_{i}_res{rl}_conv{cv}/{wb_name(wb)}", _conv_t(v) if wb == "weight" else v)
        elif m := re.fullmatch(r"head\.head\.(\d)\.(weight|bias)", k):
            i, wb = m.groups()
            put(f"head_{i}/{wb_name(wb)}", _conv_t(v) if wb == "weight" else v)
        else:
            raise KeyError(f"unmatched DPT key {k}")
    return {"params": p}


def reference_state_dict(model: DPTForDepthEstimation) -> dict[str, torch.Tensor]:
    """`model`'s weights under transformers' DPTForDepthEstimation keys (the
    inverse of `convert_dpt` and `bridge.dpt_state_dict`, the transposed
    convs' kernels turned back), f32 on the CPU: writes reference
    checkpoints from random weights."""
    bit = "dpt.embeddings.backbone.bit."
    rules = [
        (r"^cls_token$", "dpt.embeddings.cls_token"),
        (r"^position_embeddings$", "dpt.embeddings.position_embeddings"),
        (r"^patch_projection\.", "dpt.embeddings.patch_embeddings.projection."),
        (r"^hybrid_projection\.", "dpt.embeddings.projection."),
        (r"^bit\.stem_conv\.weight$", bit + "embedder.convolution.weight"),
        (r"^bit\.stem_norm\.gn\.", bit + "embedder.norm."),
        (r"^bit\.stage_(\d+)_layer_(\d+)\.(conv\d)\.", bit + r"encoder.stages.\1.layers.\2.\3."),
        (r"^bit\.stage_(\d+)_layer_(\d+)\.(norm\d)\.gn\.",
         bit + r"encoder.stages.\1.layers.\2.\3."),
        (r"^bit\.stage_(\d+)_layer_(\d+)\.downsample_conv\.",
         bit + r"encoder.stages.\1.layers.\2.downsample.conv."),
        (r"^bit\.stage_(\d+)_layer_(\d+)\.downsample_norm\.gn\.",
         bit + r"encoder.stages.\1.layers.\2.downsample.norm."),
        (r"^layer_(\d+)\.(query|key|value)\.", r"dpt.encoder.layer.\1.attention.attention.\2."),
        (r"^layer_(\d+)\.attention_output\.", r"dpt.encoder.layer.\1.attention.output.dense."),
        (r"^layer_(\d+)\.intermediate\.", r"dpt.encoder.layer.\1.intermediate.dense."),
        (r"^layer_(\d+)\.output\.", r"dpt.encoder.layer.\1.output.dense."),
        (r"^layer_(\d+)\.(layernorm_before|layernorm_after)\.", r"dpt.encoder.layer.\1.\2."),
        (r"^readout_project_(\d+)\.", r"neck.reassemble_stage.readout_projects.\1.0."),
        (r"^reassemble_projection_(\d+)\.", r"neck.reassemble_stage.layers.\1.projection."),
        (r"^reassemble_resize_(\d+)\.", r"neck.reassemble_stage.layers.\1.resize."),
        (r"^neck_conv_(\d+)\.", r"neck.convs.\1."),
        (r"^fusion_(\d+)_projection\.", r"neck.fusion_stage.layers.\1.projection."),
        (r"^fusion_(\d+)_res(\d)_conv(\d)\.",
         r"neck.fusion_stage.layers.\1.residual_layer\2.convolution\3."),
        (r"^head_(\d)\.", r"head.head.\1."),
    ]
    out = {}
    for key, val in model.state_dict().items():
        for pat, rep in rules:
            new, n = re.subn(pat, rep, key)
            if n:
                break
        else:
            raise KeyError(f"no reference key for {key}")
        val = val.detach().float().cpu().clone()
        m = re.fullmatch(r"reassemble_resize_(\d+)\.weight", key)
        if m and model.config.reassemble_factors[int(m.group(1))] > 1:
            val = val.flip(2, 3)  # a transposed conv's kernel
        out[new] = val
    return out


def load_dpt(ckpt_path, device: str | torch.device = "cuda") -> DPTForDepthEstimation:
    """A transformers DPTForDepthEstimation checkpoint (hybrid or large) as
    the port's model on `device`, f32."""
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    device = resolve_device(device)
    sd = load_torch_state_dict(ckpt_path)
    cfg = dpt_config_for_state_dict(sd)
    with torch.device(device):
        model = DPTForDepthEstimation(cfg)
    model.load_state_dict(bridge.dpt_state_dict(convert_dpt(sd, cfg), cfg))
    return model.eval().requires_grad_(False)


_DPT_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
_DPT_STD = np.array([0.5, 0.5, 0.5], np.float32)


@torch.inference_mode()
def prepare_depth_maps(model: DPTForDepthEstimation, frames: np.ndarray,
                       latent_hw: tuple[int, int], batch: int = 4,
                       input_size: int = 384) -> np.ndarray:
    """frames (N, H, W, 3) in [0, 1] -> the depth channel (N, lh, lw, 1) in
    [-1, 1]: a cubic resize to input_size, DPT's normalisation, the model
    on its device (full f32), a bilinear resize to latent size (JAX's
    weights), then each frame's min / max mapped to -1 / 1."""
    import cv2

    dev = next(model.parameters()).device
    lh, lw = latent_hw
    outs = []
    with full_f32():
        for i in range(0, len(frames), batch):
            resized = np.stack([cv2.resize(f, (input_size, input_size),
                                           interpolation=cv2.INTER_CUBIC)
                                for f in frames[i: i + batch]])
            norm = (resized - _DPT_MEAN) / _DPT_STD
            outs.append(model(torch.from_numpy(np.ascontiguousarray(norm, np.float32)).to(dev)))
        depth = torch.cat(outs)[:, None]
        depth_lat = _resize_bilinear(depth, lh, lw, False).permute(0, 2, 3, 1).cpu().numpy()
    lo = depth_lat.min(axis=(1, 2, 3), keepdims=True)
    hi = depth_lat.max(axis=(1, 2, 3), keepdims=True)
    return (2.0 * (depth_lat - lo) / np.maximum(hi - lo, 1e-8) - 1.0).astype(np.float32)
