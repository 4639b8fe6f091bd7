"""OpenPose body-pose annotator (counterpart of
tclight_tpu/models/openpose.py), the control images of the openpose
ControlNet type.

The network is the CMU COCO-18 body model (pytorch-openpose's
`bodypose_model`, body_pose_model.pth): a VGG-derived trunk to 128
channels at stride 8, a two-branch stage 1 (PAFs, 38 channels; heatmaps,
19) and five 7x7-conv refinement stages over [PAFs, heatmaps, features].
The modules carry the checkpoint's layer names, so `convert_bodypose` (the
JAX package's converter) and `models.bridge.bodypose_state_dict` load it;
`reference_state_dict` is their inverse. The network runs in f32 (full f32
on the card).

The post-processing is host numpy, the port's own copy of JAX's: one scale
(0.5 * 368 / H), stride-8 padding, the /256 - 0.5 feed, cubic upsampling of
heatmaps and PAFs, Gaussian-smoothed peaks (thre1 0.1), 10-point PAF line
integrals with the distance prior (thre2 0.05), greedy limb assignment and
the multi-person subsets; `draw_bodypose` draws the 18-colour skeleton on
black.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tclight_torch.utils.device import full_f32, resolve_device

__all__ = ["BodyPoseNet", "convert_bodypose", "reference_state_dict", "load_bodypose",
           "body_maps", "estimate_body", "draw_bodypose", "openpose_model_fn", "LIMB_SEQ",
           "MAP_IDX", "COLORS"]

# (name, out channels, kernel) per trunk layer; "P" is a 2x2 max pool
_TRUNK = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), "P",
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), "P",
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3), ("conv3_4", 256, 3), "P",
    ("conv4_1", 512, 3), ("conv4_2", 512, 3), ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
]

# COCO-18 limb pairs (1-indexed) and their PAF channel pairs
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
           [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
           [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
           [45, 46]]
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
          [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
          [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
          [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
          [255, 0, 170], [255, 0, 85]]


class BodyPoseNet(nn.Module):
    """forward(x (B, H, W, 3) in [-0.5, 0.5]) -> (PAFs (B, H/8, W/8, 38),
    heatmaps (B, H/8, W/8, 19))."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()

        def ch(c):
            return max(1, int(c * width_mult))

        def conv(name, cin, cout, k):
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))

        cin = 3
        for item in _TRUNK:
            if item != "P":
                name, cout, k = item
                conv(name, cin, ch(cout), k)
                cin = ch(cout)
        feat = cin
        for branch, out_ch in (("L1", 38), ("L2", 19)):
            for i in (1, 2, 3):
                conv(f"conv5_{i}_CPM_{branch}", feat if i == 1 else ch(128), ch(128), 3)
            conv(f"conv5_4_CPM_{branch}", ch(128), ch(512), 1)
            conv(f"conv5_5_CPM_{branch}", ch(512), out_ch, 1)
            for n in range(2, 7):
                for i in range(1, 6):
                    conv(f"Mconv{i}_stage{n}_{branch}", 38 + 19 + feat if i == 1 else ch(128),
                         ch(128), 7)
                conv(f"Mconv6_stage{n}_{branch}", ch(128), ch(128), 1)
                conv(f"Mconv7_stage{n}_{branch}", ch(128), out_ch, 1)

    def _stage(self, names: list[str], x: torch.Tensor) -> torch.Tensor:
        for name in names[:-1]:
            x = F.relu(getattr(self, name)(x))
        return getattr(self, names[-1])(x)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2)
        for item in _TRUNK:
            h = F.max_pool2d(h, 2, 2) if item == "P" else F.relu(getattr(self, item[0])(h))
        feat = h

        def stage1(b):
            return [f"conv5_{i}_CPM_{b}" for i in range(1, 6)]

        def stage_n(n, b):
            return [f"Mconv{i}_stage{n}_{b}" for i in range(1, 8)]

        l1, l2 = self._stage(stage1("L1"), feat), self._stage(stage1("L2"), feat)
        for n in range(2, 7):
            cat = torch.cat([l1, l2, feat], dim=1)
            l1, l2 = self._stage(stage_n(n, "L1"), cat), self._stage(stage_n(n, "L2"), cat)
        return l1.permute(0, 2, 3, 1), l2.permute(0, 2, 3, 1)


def convert_bodypose(sd: Mapping[str, np.ndarray]) -> dict:
    """body_pose_model.pth (``model0.conv1_1.weight``,
    ``model{s}_{b}.Mconv...``) -> the JAX package's flax tree."""
    p: dict = {}
    for k, v in sd.items():
        v = np.asarray(v)
        _, layer, wb = k.split(".")
        p.setdefault(layer, {})["kernel" if wb == "weight" else "bias"] = (
            np.transpose(v, (2, 3, 1, 0)) if wb == "weight" else v)
    return {"params": p}


def _block_of(layer: str) -> str:
    """The checkpoint block of a layer: model0 (trunk), model1_1 / _2
    (stage 1's branches), model{n}_1 / _2 (stage n's)."""
    if layer.startswith("conv5_"):
        return f"model1_{layer[-1]}"
    if layer.startswith("Mconv"):
        stage = layer.split("_stage")[1].split("_")[0]
        return f"model{stage}_{layer[-1]}"
    return "model0"


def reference_state_dict(model: BodyPoseNet) -> dict[str, torch.Tensor]:
    """`model`'s weights under body_pose_model.pth's keys, f32 on the CPU."""
    out = {}
    for key, val in model.state_dict().items():
        layer, leaf = key.split(".")
        out[f"{_block_of(layer)}.{layer}.{leaf}"] = val.detach().float().cpu().clone()
    return out


def load_bodypose(ckpt_path: str | Path, width_mult: float = 1.0,
                  device: str | torch.device = "cuda") -> BodyPoseNet:
    from tclight_torch.models import bridge
    from tclight_torch.models.convert import load_torch_state_dict

    device = resolve_device(device)
    with torch.device(device):
        model = BodyPoseNet(width_mult)
    model.load_state_dict(bridge.bodypose_state_dict(
        convert_bodypose(load_torch_state_dict(ckpt_path))))
    return model.eval().requires_grad_(False)


def _pad_to_stride(img: np.ndarray, stride: int, pad_value: float):
    h, w = img.shape[:2]
    ph = (stride - h % stride) % stride
    pw = (stride - w % stride) % stride
    out = np.pad(img, ((0, ph), (0, pw), (0, 0)), constant_values=pad_value)
    return out, (ph, pw)


def _find_peaks(heatmap: np.ndarray, thre1: float):
    """Each part's peaks of the Gaussian-smoothed heatmap, [(x, y, score,
    id), ...]."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    peak_counter = 0
    for part in range(18):
        map_ori = heatmap[:, :, part]
        smooth = gaussian_filter(map_ori, sigma=3)
        up = np.zeros_like(smooth)
        up[1:, :] = smooth[:-1, :]
        down = np.zeros_like(smooth)
        down[:-1, :] = smooth[1:, :]
        left = np.zeros_like(smooth)
        left[:, 1:] = smooth[:, :-1]
        right = np.zeros_like(smooth)
        right[:, :-1] = smooth[:, 1:]
        binary = ((smooth >= up) & (smooth >= down) & (smooth >= left) & (smooth >= right)
                  & (smooth > thre1))
        ys, xs = np.nonzero(binary)
        peaks = [(int(x), int(y), float(map_ori[y, x]), peak_counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _connect_limbs(paf: np.ndarray, all_peaks, img_h: int, thre2: float):
    """Each limb's candidate pairs scored by their PAF line integral, then
    assigned greedily."""
    connection_all, special_k = [], []
    mid_num = 10
    for k, (ma, mb) in enumerate(MAP_IDX):
        score_mid = paf[:, :, [ma - 19, mb - 19]]
        cand_a = all_peaks[LIMB_SEQ[k][0] - 1]
        cand_b = all_peaks[LIMB_SEQ[k][1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.asarray([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(math.hypot(*vec), 1e-5)
                vec = vec / norm
                xs = np.linspace(a[0], b[0], mid_num).round().astype(int)
                ys = np.linspace(a[1], b[1], mid_num).round().astype(int)
                score_pts = score_mid[ys, xs, 0] * vec[0] + score_mid[ys, xs, 1] * vec[1]
                prior = min(0.5 * img_h / norm - 1, 0)
                score = float(score_pts.mean() + prior)
                if int((score_pts > thre2).sum()) > 0.8 * mid_num and score > 0:
                    candidates.append((i, j, score, score + a[2] + b[2]))
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = np.zeros((0, 5))
        used_a, used_b = set(), set()
        for i, j, s, _ in candidates:
            if i in used_a or j in used_b:
                continue
            connection = np.vstack([connection, [cand_a[i][3], cand_b[j][3], s, i, j]])
            used_a.add(i)
            used_b.add(j)
            if len(connection) >= min(len(cand_a), len(cand_b)):
                break
        connection_all.append(connection)
    return connection_all, special_k


def _assemble_subsets(all_peaks, connection_all, special_k):
    """Greedy multi-person assembly into (people, 20) subset rows; subsets
    of fewer than 4 parts or a mean score below 0.4 are dropped."""
    subset = -1 * np.ones((0, 20))
    candidate = np.asarray([item for sub in all_peaks for item in sub], np.float64)
    for k in range(len(MAP_IDX)):
        if k in special_k or len(connection_all[k]) == 0:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        idx_a, idx_b = np.asarray(LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found, subset_idx = 0, [-1, -1]
            for j in range(len(subset)):
                if subset[j][idx_a] == part_as[i] or subset[j][idx_b] == part_bs[i]:
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][idx_b] != part_bs[i]:
                    subset[j][idx_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += (candidate[part_bs[i].astype(int), 2]
                                      + connection_all[k][i][2])
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][idx_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += (candidate[part_bs[i].astype(int), 2]
                                       + connection_all[k][i][2])
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[idx_a] = part_as[i]
                row[idx_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (candidate[connection_all[k][i, :2].astype(int), 2].sum()
                           + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    delete_idx = [i for i in range(len(subset))
                  if subset[i][-1] < 4 or subset[i][-2] / subset[i][-1] < 0.4]
    return candidate, np.delete(subset, delete_idx, axis=0)


@torch.inference_mode()
def body_maps(model: BodyPoseNet, img: np.ndarray, boxsize: int = 368, stride: int = 8):
    """img (H, W, 3) in [0, 1] -> (heatmap (H, W, 19), PAF (H, W, 38)): the
    image scaled by 0.5 * boxsize / H (cubic), padded to the stride with
    128 / 255, fed as pixel / 256 - 0.5 (0..255 pixels), the outputs
    upsampled by the stride (cubic), cropped and resized to (H, W)."""
    import cv2

    dev = next(model.parameters()).device
    h, w = img.shape[:2]
    scale = 0.5 * boxsize / h
    scaled = cv2.resize(img, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_CUBIC)
    padded, (ph, pw) = _pad_to_stride(scaled, stride, 128 / 255.0)
    x = torch.from_numpy(np.ascontiguousarray(padded[None] * 255.0 / 256.0 - 0.5, np.float32))
    with full_f32():
        paf_lo, heat_lo = (t[0].float().cpu().numpy() for t in model(x.to(dev)))

    def up(m):
        m = cv2.resize(m, (0, 0), fx=stride, fy=stride, interpolation=cv2.INTER_CUBIC)
        m = m[: padded.shape[0] - ph, : padded.shape[1] - pw]
        return cv2.resize(m, (w, h), interpolation=cv2.INTER_CUBIC)

    return up(heat_lo), up(paf_lo)


def estimate_body(model: BodyPoseNet, img: np.ndarray, boxsize: int = 368, stride: int = 8,
                  thre1: float = 0.1, thre2: float = 0.05):
    """img (H, W, 3) in [0, 1] RGB -> (candidate (n, 4), subset (m, 20)) in
    image coordinates."""
    heatmap, paf = body_maps(model, img, boxsize, stride)
    all_peaks = _find_peaks(heatmap, thre1)
    connection_all, special_k = _connect_limbs(paf, all_peaks, img.shape[0], thre2)
    return _assemble_subsets(all_peaks, connection_all, special_k)


def draw_bodypose(h: int, w: int, candidate: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """The skeleton on a black (h, w, 3) uint8 canvas: ellipse limbs at 60%
    and radius-4 joints in the 18 reference colours."""
    import cv2

    canvas = np.zeros((h, w, 3), np.uint8)
    stickwidth = 4
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.asarray(LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            ys = candidate[index.astype(int), 0]
            xs = candidate[index.astype(int), 1]
            m_x, m_y = xs.mean(), ys.mean()
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.degrees(math.atan2(xs[0] - xs[1], ys[0] - ys[1]))
            poly = cv2.ellipse2Poly((int(m_y), int(m_x)), (int(length / 2), stickwidth),
                                    int(angle), 0, 360, 1)
            cv2.fillConvexPoly(canvas, poly, COLORS[i])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            cv2.circle(canvas, (int(x), int(y)), 4, COLORS[i], thickness=-1)
    return canvas


def openpose_model_fn(ckpt_path, width_mult: float = 1.0, device: str | torch.device = "cuda"):
    """The `model_fn` of `control_preprocess` for openpose: frames -> the
    skeleton canvases in [0, 1]."""
    model = load_bodypose(ckpt_path, width_mult, device)

    def model_fn(frames: np.ndarray) -> np.ndarray:
        n, h, w, _ = frames.shape
        out = np.zeros((n, h, w, 3), np.float32)
        for i, f in enumerate(frames):
            cand, sub = estimate_body(model, f)
            out[i] = draw_bodypose(h, w, cand, sub).astype(np.float32) / 255.0
        return out

    return model_fn
