"""RetinaFace (ResNet-50) face detection and face pixelation for the Cosmos
face-blur guardrail (counterpart of tclight_tpu/models/retinaface.py).

The detector is Pytorch_Retinaface's `RetinaFace(cfg_re50, phase='test')`:
a ResNet-50 body tapped at layers 2-4, a 3-level FPN (nearest top-down),
SSH context modules and 1x1 class / box / landmark heads with 2 anchors.
`convert_retinaface` reads the published `Resnet50_Final.pth` layout and
folds every BatchNorm (eval mode) into the convolution before it, so the
port's module is biased convolutions only, named as JAX's flax modules
(`stem`, `layer2_0_conv1`, `fpn_merge1`, `ssh1_conv3X3`, `BboxHead_0`
...). The priors, box decode, NMS, thresholding and pixelation run on the
host in numpy, as in JAX. `random_reference_state_dict` writes the
published layout from a seed (BN statistics included), for tests and the
chip smoke run.
"""

from __future__ import annotations

import dataclasses
import math
import re
from itertools import product
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import resolve_device

__all__ = ["RetinaFaceConfig", "RetinaFace", "convert_retinaface", "prior_boxes",
           "decode_boxes", "nms", "filter_detected_boxes", "pixelate_face",
           "RetinaFaceDetector", "random_reference_state_dict"]

# the detector's constants, as the Cosmos filter sets them
TOP_K = 5000
KEEP_TOP_K = 750
NMS_THRESHOLD = 0.4
VARIANCES = (0.1, 0.2)
BGR_MEANS = np.array([104.0, 117.0, 123.0], np.float32)
_SSH = ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")
_HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10))


@dataclasses.dataclass(frozen=True)
class RetinaFaceConfig:
    # cfg_re50: the resnet50 body, tapped at layers 2, 3, 4
    layers: tuple = (3, 4, 6, 3)
    stem_width: int = 64
    in_channels: tuple = (512, 1024, 2048)
    out_channel: int = 256
    min_sizes: tuple = ((16, 32), (64, 128), (256, 512))
    steps: tuple = (8, 16, 32)
    n_anchors: int = 2
    dtype: torch.dtype = torch.float32

    @staticmethod
    def re50() -> "RetinaFaceConfig":
        return RetinaFaceConfig()

    @staticmethod
    def tiny() -> "RetinaFaceConfig":
        """The same structure at small widths."""
        return RetinaFaceConfig(layers=(1, 1, 1, 1), stem_width=8, in_channels=(64, 128, 256),
                                out_channel=32)


def _conv(cin: int, cout: int, k: int, s: int = 1, padding: int | None = None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2 if padding is None else padding)


def _up_nearest(t: torch.Tensor, hw) -> torch.Tensor:
    """Repeat by the ceiling ratio, then crop to hw (JAX's nearest)."""
    rh, rw = -(-hw[0] // t.shape[2]), -(-hw[1] // t.shape[3])
    return t.repeat_interleave(rh, dim=2).repeat_interleave(rw, dim=3)[:, :, : hw[0], : hw[1]]


class RetinaFace(nn.Module):
    """images (B, H, W, 3), BGR, mean-subtracted -> (loc (B, P, 4), conf
    (B, P, 2) softmaxed, landms (B, P, 10))."""

    def __init__(self, config: RetinaFaceConfig = RetinaFaceConfig()):
        super().__init__()
        c = self.config = config
        w0 = c.stem_width
        self.stem = _conv(3, w0, 7, 2, 3)
        inp = w0
        for li, blocks in enumerate(c.layers):
            width = w0 * 2 ** li
            for bi in range(blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                name = f"layer{li + 1}_{bi}"
                setattr(self, f"{name}_conv1", _conv(inp, width, 1))
                setattr(self, f"{name}_conv2", _conv(width, width, 3, stride))
                setattr(self, f"{name}_conv3", _conv(width, width * 4, 1))
                if bi == 0:
                    setattr(self, f"{name}_down", _conv(inp, width * 4, 1, stride, 0))
                inp = width * 4
        oc = c.out_channel
        for i, cin in enumerate(c.in_channels):
            setattr(self, f"fpn_output{i + 1}", _conv(cin, oc, 1, padding=0))
        self.fpn_merge1, self.fpn_merge2 = _conv(oc, oc, 3), _conv(oc, oc, 3)
        for i in range(1, 4):
            for sub, cin, cout in zip(_SSH, (oc, oc, oc // 4, oc // 4, oc // 4),
                                      (oc // 2, oc // 4, oc // 4, oc // 4, oc // 4)):
                setattr(self, f"ssh{i}_{sub}", _conv(cin, cout, 3))
        for head, dims in _HEADS:
            for i in range(3):
                setattr(self, f"{head}_{i}", nn.Conv2d(oc, c.n_anchors * dims, 1))
        self.to(c.dtype)

    def _ssh(self, t, i):
        g = lambda sub: getattr(self, f"ssh{i}_{sub}")  # noqa: E731
        c3 = g("conv3X3")(t)
        c5_1 = F.relu(g("conv5X5_1")(t))
        c5 = g("conv5X5_2")(c5_1)
        c7 = g("conv7x7_3")(F.relu(g("conv7X7_2")(c5_1)))
        return F.relu(torch.cat([c3, c5, c7], dim=1))

    def forward(self, x: torch.Tensor):
        c = self.config
        h = F.relu(self.stem(x.to(self.stem.weight.dtype).permute(0, 3, 1, 2)))
        h = F.max_pool2d(h, 3, 2, padding=1)
        taps = []
        for li, blocks in enumerate(c.layers):
            for bi in range(blocks):
                name = f"layer{li + 1}_{bi}"
                out = F.relu(getattr(self, f"{name}_conv1")(h))
                out = F.relu(getattr(self, f"{name}_conv2")(out))
                out = getattr(self, f"{name}_conv3")(out)
                if bi == 0:
                    h = getattr(self, f"{name}_down")(h)
                h = F.relu(out + h)
            if li >= 1:
                taps.append(h)
        o1, o2, o3 = (getattr(self, f"fpn_output{i + 1}")(t) for i, t in enumerate(taps))
        o2 = self.fpn_merge2(o2 + _up_nearest(o3, o2.shape[2:]))
        o1 = self.fpn_merge1(o1 + _up_nearest(o2, o1.shape[2:]))
        feats = [self._ssh(t, i + 1) for i, t in enumerate((o1, o2, o3))]

        def head(name, dims):
            return torch.cat([getattr(self, f"{name}_{i}")(t).permute(0, 2, 3, 1)
                              .reshape(t.shape[0], -1, dims) for i, t in enumerate(feats)], 1)

        return (head("BboxHead", 4), torch.softmax(head("ClassHead", 2), -1),
                head("LandmarkHead", 10))


# ------------------------------------------------------------- priors / boxes


def prior_boxes(cfg: RetinaFaceConfig, image_h: int, image_w: int) -> np.ndarray:
    """The anchors in center-offset form, (P, 4)."""
    anchors = []
    for k, step in enumerate(cfg.steps):
        fh, fw = math.ceil(image_h / step), math.ceil(image_w / step)
        for i, j in product(range(fh), range(fw)):
            for min_size in cfg.min_sizes[k]:
                anchors.append([(j + 0.5) * step / image_w, (i + 0.5) * step / image_h,
                                min_size / image_w, min_size / image_h])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray, variances=VARIANCES) -> np.ndarray:
    """loc (B, P, 4), priors (P, 4) -> normalized corner boxes (B, P, 4)."""
    priors = priors[None]
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    sizes = priors[..., 2:] * np.exp(loc[..., 2:] * variances[1])
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=-1)


def nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy IoU suppression over (x1, y1, x2, y2, score) rows."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def filter_detected_boxes(boxes: np.ndarray, scores: np.ndarray,
                          confidence_threshold: float = 0.7,
                          nms_threshold: float = NMS_THRESHOLD, top_k: int = TOP_K,
                          keep_top_k: int = KEEP_TOP_K) -> np.ndarray:
    """The confidence threshold, the top k, then NMS -> (K, 4) boxes."""
    inds = np.where(scores > confidence_threshold)[0]
    boxes, scores = boxes[inds], scores[inds]
    order = scores.argsort()[::-1][:top_k]
    boxes, scores = boxes[order], scores[order]
    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    return dets[nms(dets, nms_threshold)][:keep_top_k, :4]


def pixelate_face(face_img: np.ndarray, blocks: int = 5) -> np.ndarray:
    """Block-average pixelation over a blocks x blocks grid."""
    h, w = face_img.shape[:2]
    out = face_img.copy()
    xs = np.linspace(0, w, blocks + 1, dtype=int)
    ys = np.linspace(0, h, blocks + 1, dtype=int)
    for i in range(blocks):
        for j in range(blocks):
            y0, y1, x0, x1 = ys[i], ys[i + 1], xs[j], xs[j + 1]
            if y1 > y0 and x1 > x0:
                out[y0:y1, x0:x1] = face_img[y0:y1, x0:x1].mean(axis=(0, 1), keepdims=True)
    return out


class RetinaFaceDetector:
    """Detection and blur: frames (N, H, W, 3) in [0, 1] RGB; the detector
    sees them BGR, 255-scaled, mean-subtracted, `batch` frames a call."""

    def __init__(self, state_dict: Mapping, config: RetinaFaceConfig = RetinaFaceConfig(),
                 confidence_threshold: float = 0.7, batch: int = 4, device="cuda"):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = RetinaFace(config)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        self.model.eval().requires_grad_(False)
        self.config = config
        self.confidence_threshold = confidence_threshold
        self.batch = batch

    @torch.inference_mode()
    def detect(self, frames: np.ndarray) -> list[np.ndarray]:
        """-> per frame, (K, 4) pixel boxes."""
        n, h, w, _ = frames.shape
        priors = prior_boxes(self.config, h, w)
        bgr = (frames[..., ::-1] * 255.0 - BGR_MEANS).astype(np.float32)
        out = []
        for i in range(0, n, self.batch):
            loc, conf, _ = self.model(torch.from_numpy(np.ascontiguousarray(
                bgr[i: i + self.batch])).to(self.device))
            boxes = decode_boxes(loc.float().cpu().numpy(), priors)
            boxes = boxes * np.array([w, h, w, h], np.float32)
            scores = conf.float().cpu().numpy()[..., 1]
            for b in range(boxes.shape[0]):
                out.append(filter_detected_boxes(boxes[b], scores[b], self.confidence_threshold))
        return out

    def blur_faces(self, frames: np.ndarray) -> np.ndarray:
        """Every detected face region pixelated."""
        out = frames.copy()
        h, w = frames.shape[1:3]
        for f, boxes in enumerate(self.detect(frames)):
            for x1, y1, x2, y2 in boxes:
                x1, y1 = max(int(x1), 0), max(int(y1), 0)
                x2, y2 = min(int(x2), w), min(int(y2), h)
                if x2 > x1 and y2 > y1:
                    out[f, y1:y2, x1:x2] = pixelate_face(out[f, y1:y2, x1:x2])
        return out


# ---------------------------------------------------------------- converter


def _fold_bn(conv_w, bn, eps=1e-5):
    """An eval-mode BatchNorm folded into the bias-free conv before it:
    (OIHW weight, bias), f32."""
    gamma, beta, mean, var = bn
    scale = gamma / np.sqrt(var + eps)
    w = np.asarray(conv_w) * scale[:, None, None, None]
    return w.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _published_convs(cfg: RetinaFaceConfig):
    """(port name, published conv key, published BN prefix or None, O, I, k)
    of every convolution."""
    w0, oc = cfg.stem_width, cfg.out_channel
    convs = [("stem", "body.conv1", "body.bn1", w0, 3, 7)]
    inp = w0
    for li, blocks in enumerate(cfg.layers):
        width = w0 * 2 ** li
        for bi in range(blocks):
            base = f"body.layer{li + 1}.{bi}"
            for ci, (o, i, k) in enumerate(((width, inp, 1), (width, width, 3),
                                            (width * 4, width, 1)), 1):
                convs.append((f"layer{li + 1}_{bi}_conv{ci}", f"{base}.conv{ci}", f"{base}.bn{ci}",
                              o, i, k))
            if bi == 0:
                convs.append((f"layer{li + 1}_{bi}_down", f"{base}.downsample.0",
                              f"{base}.downsample.1", width * 4, inp, 1))
            inp = width * 4
    for i, cin in enumerate(cfg.in_channels):
        convs.append((f"fpn_output{i + 1}", f"fpn.output{i + 1}.0", f"fpn.output{i + 1}.1",
                      oc, cin, 1))
    convs += [(f"fpn_merge{i}", f"fpn.merge{i}.0", f"fpn.merge{i}.1", oc, oc, 3) for i in (1, 2)]
    for i in (1, 2, 3):
        for sub, cin, cout in zip(_SSH, (oc, oc, oc // 4, oc // 4, oc // 4),
                                  (oc // 2, oc // 4, oc // 4, oc // 4, oc // 4)):
            convs.append((f"ssh{i}_{sub}", f"ssh{i}.{sub}.0", f"ssh{i}.{sub}.1", cout, cin, 3))
    for head, dims in _HEADS:
        convs += [(f"{head}_{i}", f"{head}.{i}.conv1x1", None, cfg.n_anchors * dims, oc, 1)
                  for i in range(3)]
    return convs


def convert_retinaface(sd: Mapping, cfg: RetinaFaceConfig = RetinaFaceConfig()
                       ) -> dict[str, torch.Tensor]:
    """Pytorch_Retinaface's `Resnet50_Final.pth` state dict (``module.``
    prefixes allowed) -> `RetinaFace`'s state dict, BatchNorms folded."""
    sd = {re.sub(r"^module\.", "", k): (v.detach().cpu().float().numpy()
                                        if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in sd.items()}
    out = {}
    for name, conv, bn, *_ in _published_convs(cfg):
        if bn is None:
            w, b = sd[f"{conv}.weight"].astype(np.float32), sd[f"{conv}.bias"].astype(np.float32)
        else:
            w, b = _fold_bn(sd[f"{conv}.weight"], tuple(
                sd[f"{bn}.{s}"] for s in ("weight", "bias", "running_mean", "running_var")))
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(b))
    return out


def random_reference_state_dict(cfg: RetinaFaceConfig = RetinaFaceConfig(), seed: int = 0
                                ) -> dict[str, torch.Tensor]:
    """A `Resnet50_Final.pth`-layout state dict drawn from `seed`: convs
    N(0, 1 / fan_in) (the stem's over 128 more, for the 255-scale input;
    the heads' 10x smaller, so that the box offsets stay a few units), BN
    weights near 1, biases and means near 0, variances in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, conv, bn, o, i, k in _published_convs(cfg):
        std = math.sqrt(1.0 / (i * k * k)) * (1 / 128 if name == "stem" else
                                              0.1 if bn is None else 1.0)
        sd[f"{conv}.weight"] = torch.randn(o, i, k, k, generator=gen) * std
        if bn is None:
            sd[f"{conv}.bias"] = 0.1 * torch.randn(o, generator=gen)
            continue
        sd[f"{bn}.weight"] = 1.0 + 0.1 * torch.randn(o, generator=gen)
        sd[f"{bn}.bias"] = 0.1 * torch.randn(o, generator=gen)
        sd[f"{bn}.running_mean"] = 0.1 * torch.randn(o, generator=gen)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(o, generator=gen)
        sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd
