"""Synthetic-scene parsers: SceneFlow, CARLA and InteriorNet (counterpart
of tclight_tpu/data/synthetic.py).

Ground-truth flows are read from PFM / .flo files (InteriorNet ships none:
its flows come from a flow backend, data/flow_backends.py), depth is
unprojected to world points (`rgbd_to_world`), camera poses are parsed
from SceneFlow's camera_data.txt and InteriorNet's visim trajectories, and
`load_data` turns the flows into soft masks and pixel tracks with the
port's `get_soft_mask_bwds` and `get_flowid` on the device and
`voxelization` on the host (spatial voxels when `voxel_size` is set).
Frames, depths and flows are NHWC numpy on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tclight_torch.data.formats import read_flo, read_pfm
from tclight_torch.ops.flow import get_flowid, get_soft_mask_bwds, voxelization
from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import get_logger
from tclight_torch.utils.video_io import resize_center_crop

log = get_logger()


def _process_frames(frames: np.ndarray, h: int | None, w: int | None) -> np.ndarray:
    if h is None and w is None:
        return frames
    return np.stack([resize_center_crop(f, h, w) for f in frames])


def rgbd_to_world(
    depths: np.ndarray,       # (N, H, W)
    intrinsics: np.ndarray,   # (3, 3) or (N, 3, 3)
    c2ws: np.ndarray,         # (N, 4, 4)
    flip_yz: bool = True,
) -> np.ndarray:
    """Unproject depth maps to world-space points (N, H, W, 3)
    (sceneflow_dataparsers.py rgbd2pcd :257-276; blender convention flips
    y/z when `flip_yz`)."""
    n, h, w = depths.shape
    if intrinsics.ndim == 2:
        intrinsics = np.broadcast_to(intrinsics, (n, 3, 3))
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    xs = xs[None].astype(np.float64)
    ys = ys[None].astype(np.float64)
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]
    x_cam = (xs - cx) * depths / fx
    y_cam = (ys - cy) * depths / fy
    if flip_yz:
        p_cam = np.stack([x_cam, -y_cam, -depths, np.ones_like(x_cam)], axis=-1)
    else:
        p_cam = np.stack([x_cam, y_cam, depths, np.ones_like(x_cam)], axis=-1)
    pts = np.einsum("nhwc,ndc->nhwd", p_cam, c2ws)[..., :3]
    return pts.astype(np.float32)


class _SyntheticParserBase:
    """Shared load_data: GT flows -> soft masks -> flow ids -> (spatial)
    voxelization."""

    fps: int = 30
    voxel_size = None
    unq_inv: np.ndarray | None = None
    n_unique: int | None = None

    def load_video(self, frame_ids=None) -> np.ndarray:
        raise NotImplementedError

    def _load_frames_depths_poses(self, frame_ids):
        raise NotImplementedError

    def _load_gt_flows(self, frame_ids):
        raise NotImplementedError

    @torch.no_grad()
    def load_data(self, frame_ids: Sequence[int] | None = None, device="cuda",
                  rgb_threshold: float = 0.01):
        """Returns (rgbs, depths, c2ws, future_flows, past_flows, mask_bwds),
        host numpy arrays, and sets self.unq_inv / self.n_unique. The soft
        masks and flow ids are computed on `device`."""
        dev = resolve_device(device)
        frame_ids = list(frame_ids) if frame_ids is not None else list(range(self.n_frames))
        rgbs, depths, intrinsics, c2ws = self._load_frames_depths_poses(frame_ids)
        future, past = self._load_gt_flows(frame_ids)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        rgbs_t, future_t = t(rgbs), t(future)
        masks_t = get_soft_mask_bwds(rgbs_t, future_t, t(past))
        flow_ids = get_flowid(rgbs_t, future_t, masks_t, rgb_threshold).cpu().numpy()
        mask_bwds = masks_t.cpu().numpy()
        if self.voxel_size is not None and depths is not None:
            p_world = rgbd_to_world(depths, intrinsics, c2ws)
            self.unq_inv = voxelization(
                flow_ids.reshape(-1),
                rgbs.reshape(-1, 3),
                p_world.reshape(-1, 3),
                voxel_size=self.voxel_size,
            )
        else:
            self.unq_inv = voxelization(flow_ids.reshape(-1))
        self.n_unique = int(self.unq_inv.max()) + 1
        log.info("unique tracks/voxels: %d / %d", self.n_unique, flow_ids.size)
        return rgbs, depths, c2ws, future, past, mask_bwds


def read_sceneflow_camdata(path: str | Path) -> list[dict]:
    """camera_data.txt: per-frame 'Frame N' + L/R 4x4 row-major matrices."""
    entries: list[dict] = []
    cur: dict | None = None
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("Frame"):
            if cur:
                entries.append(cur)
            cur = {"frame_id": int(line.split()[1])}
        elif cur is not None and line[0] in "LR":
            vals = np.asarray([float(v) for v in line.split()[1:]])
            mat = np.eye(4)
            mat[:3] = vals.reshape(3, 4) if vals.size == 12 else vals.reshape(4, 4)[:3]
            cur["left" if line[0] == "L" else "right"] = mat
    if cur:
        entries.append(cur)
    return entries


class SceneFlowDataParser(_SyntheticParserBase):
    """SceneFlow (Monkaa/Driving-style tree): frames_cleanpass PNGs,
    disparity PFMs, into_future/into_past .pfm/.flo flows, camera_data.txt."""

    def __init__(self, cfg, **_):
        self.data_dir = Path(cfg.get("data_dir", "data/sceneflow"))
        self.scene_path = cfg.get("scene_path", "15mm_focallength/scene_backwards/fast")
        self.stereo_sel = cfg.get("stereo_sel", "left")
        self.voxel_size = cfg.get("voxel_size")
        self.fps = cfg.get("fps", 30)
        self.h = cfg.get("height")
        self.w = cfg.get("width")
        self.rgb_path = self.data_dir / "frames_cleanpass" / self.scene_path / self.stereo_sel
        self.disparity_path = self.data_dir / "disparity" / self.scene_path / self.stereo_sel
        self.future_flow_path = (
            self.data_dir / "optical_flow" / self.scene_path / "into_future" / self.stereo_sel
        )
        self.past_flow_path = (
            self.data_dir / "optical_flow" / self.scene_path / "into_past" / self.stereo_sel
        )
        focal = 450.0 if "15mm" in self.scene_path else 1050.0
        self.intrinsics = np.array(
            [[focal, 0, 479.5], [0, focal, 269.5], [0, 0, 1.0]]
        )
        cam_file = self.data_dir / "camera_data" / self.scene_path / "camera_data.txt"
        self.cam_info = read_sceneflow_camdata(cam_file) if cam_file.exists() else []
        self.n_frames = len(self.cam_info)

    def _frame_file(self, i: int) -> int:
        return self.cam_info[i]["frame_id"]

    def load_video(self, frame_ids=None) -> np.ndarray:
        import cv2

        frame_ids = list(frame_ids) if frame_ids is not None else list(range(self.n_frames))
        rgbs = []
        for i in frame_ids:
            img = cv2.imread(str(self.rgb_path / f"{self._frame_file(i):04d}.png"))
            rgbs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        rgbs = np.stack(rgbs).astype(np.float32) / 255.0
        return _process_frames(rgbs, self.h, self.w)

    def _load_frames_depths_poses(self, frame_ids):
        rgbs = self.load_video(frame_ids)
        depths, c2ws = [], []
        for i in frame_ids:
            fid = self._frame_file(i)
            disp, _ = read_pfm(self.disparity_path / f"{fid:04d}.pfm")
            depths.append(self.intrinsics[0, 0] / np.maximum(disp, 1e-6))
            c2ws.append(self.cam_info[i][self.stereo_sel])
        depths = _process_frames(np.stack(depths).astype(np.float32)[..., None],
                                 self.h, self.w)[..., 0]
        return rgbs, depths, self.intrinsics, np.stack(c2ws)

    def _load_gt_flows(self, frame_ids):
        tag = "L" if self.stereo_sel == "left" else "R"
        n = len(frame_ids)
        shape = None
        future = past = None
        for j, i in enumerate(frame_ids):
            fid = self._frame_file(i)
            ff = self.future_flow_path / f"OpticalFlowIntoFuture_{fid:04d}_{tag}.pfm"
            pf = self.past_flow_path / f"OpticalFlowIntoPast_{fid:04d}_{tag}.pfm"
            for path, kind in ((ff, "future"), (pf, "past")):
                if not path.exists():
                    continue
                arr, _ = read_pfm(path)
                arr = arr[..., :2].astype(np.float32)
                arr = _process_frames(arr[None], self.h, self.w)[0]
                if shape is None:
                    shape = arr.shape
                    future = np.zeros((n,) + shape, np.float32)
                    past = np.zeros((n,) + shape, np.float32)
                if kind == "future":
                    future[j] = arr
                else:
                    past[j] = arr
        if future is None:
            raise FileNotFoundError(f"no GT flows under {self.future_flow_path}")
        return future, past


class CarlaDataParser(_SyntheticParserBase):
    """CARLA sim dumps: rgb/NNNN.png + depth/NNNN.npy + poses.npz with
    'intrinsics' (3,3) and 'c2ws' (N,4,4); GT flow as flow/{future,past}/
    NNNN.flo (carla_dataparsers.py:14-146)."""

    def __init__(self, cfg, **_):
        self.data_dir = Path(cfg.get("data_dir", "data/carla"))
        self.voxel_size = cfg.get("voxel_size")
        self.fps = cfg.get("fps", 10)
        self.h = cfg.get("height")
        self.w = cfg.get("width")
        poses = np.load(self.data_dir / "poses.npz")
        self.intrinsics = poses["intrinsics"]
        self.c2ws = poses["c2ws"]
        self.n_frames = len(self.c2ws)

    def load_video(self, frame_ids=None) -> np.ndarray:
        import cv2

        frame_ids = list(frame_ids) if frame_ids is not None else list(range(self.n_frames))
        rgbs = [
            cv2.cvtColor(cv2.imread(str(self.data_dir / "rgb" / f"{i:04d}.png")),
                         cv2.COLOR_BGR2RGB)
            for i in frame_ids
        ]
        return _process_frames(np.stack(rgbs).astype(np.float32) / 255.0,
                               self.h, self.w)

    def _load_frames_depths_poses(self, frame_ids):
        rgbs = self.load_video(frame_ids)
        depths = np.stack([
            np.load(self.data_dir / "depth" / f"{i:04d}.npy") for i in frame_ids
        ]).astype(np.float32)
        depths = _process_frames(depths[..., None], self.h, self.w)[..., 0]
        return rgbs, depths, self.intrinsics, self.c2ws[list(frame_ids)]

    def _load_gt_flows(self, frame_ids):
        n = len(frame_ids)
        sample = read_flo(self.data_dir / "flow" / "future" / f"{frame_ids[0]:04d}.flo")
        sample = _process_frames(sample[None], self.h, self.w)[0]
        future = np.zeros((n,) + sample.shape, np.float32)
        past = np.zeros_like(future)
        for j, i in enumerate(frame_ids):
            ff = self.data_dir / "flow" / "future" / f"{i:04d}.flo"
            pf = self.data_dir / "flow" / "past" / f"{i:04d}.flo"
            if ff.exists():
                future[j] = _process_frames(read_flo(ff)[None], self.h, self.w)[0]
            if pf.exists():
                past[j] = _process_frames(read_flo(pf)[None], self.h, self.w)[0]
        return future, past


def parse_visim_trajectory(path: str | Path) -> np.ndarray:
    """InteriorNet visim cam0 trajectory: lines
    `ts, tx, ty, tz, qw, qx, qy, qz` -> (N, 4, 4) c2w matrices
    (interiornet_dataparsers.py:38-60)."""
    mats = []
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.replace(",", " ").split()]
        _, tx, ty, tz, qw, qx, qy, qz = vals[:8]
        n = qw * qw + qx * qx + qy * qy + qz * qz
        s = 2.0 / n if n > 0 else 0.0
        rot = np.array([
            [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw), s * (qx * qz + qy * qw)],
            [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz), s * (qy * qz - qx * qw)],
            [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw), 1 - s * (qx * qx + qy * qy)],
        ])
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = [tx, ty, tz]
        mats.append(mat)
    return np.stack(mats)


class InteriorNetDataParser(_SyntheticParserBase):
    """InteriorNet: cam0/data PNGs + depth0/data PNGs (mm uint16) +
    intrinsics file + visim trajectory; no GT flow shipped -> flows via a
    flow backend, spatial voxelization from RGB-D
    (interiornet_dataparsers.py:68-200)."""

    def __init__(self, cfg, flow_backend: str = "farneback", raft=None, **_):
        self.data_dir = Path(cfg.get("data_dir", "data/interiornet"))
        self.voxel_size = cfg.get("voxel_size")
        self.fps = cfg.get("fps", 25)
        self.h = cfg.get("height")
        self.w = cfg.get("width")
        self.flow_backend = flow_backend
        self.raft = raft
        intr_file = self.data_dir / "intrinsics.txt"
        if intr_file.exists():
            vals = [float(v) for v in intr_file.read_text().split()]
            self.intrinsics = np.array(
                [[vals[0], 0, vals[2]], [0, vals[1], vals[3]], [0, 0, 1]]
            )
        else:
            self.intrinsics = np.eye(3)
        traj = self.data_dir / "cam0.visim"
        self.c2ws = parse_visim_trajectory(traj) if traj.exists() else None
        self.rgb_files = sorted((self.data_dir / "cam0" / "data").glob("*.png"))
        self.n_frames = len(self.rgb_files)

    def load_video(self, frame_ids=None) -> np.ndarray:
        import cv2

        frame_ids = list(frame_ids) if frame_ids is not None else list(range(self.n_frames))
        rgbs = [
            cv2.cvtColor(cv2.imread(str(self.rgb_files[i])), cv2.COLOR_BGR2RGB)
            for i in frame_ids
        ]
        return _process_frames(np.stack(rgbs).astype(np.float32) / 255.0,
                               self.h, self.w)

    def _load_frames_depths_poses(self, frame_ids):
        import cv2

        rgbs = self.load_video(frame_ids)
        depth_dir = self.data_dir / "depth0" / "data"
        depths = None
        if depth_dir.exists():
            ds = []
            for i in frame_ids:
                d = cv2.imread(
                    str(depth_dir / self.rgb_files[i].name), cv2.IMREAD_UNCHANGED
                )
                ds.append(d.astype(np.float32) / 1000.0)
            depths = _process_frames(np.stack(ds)[..., None], self.h, self.w)[..., 0]
        c2ws = self.c2ws[list(frame_ids)] if self.c2ws is not None else None
        return rgbs, depths, self.intrinsics, c2ws

    def _load_gt_flows(self, frame_ids):
        from tclight_torch.data.flow_backends import compute_flow_pairs

        rgbs = self.load_video(frame_ids)
        future = compute_flow_pairs(rgbs, "future", self.flow_backend, raft=self.raft)
        past = compute_flow_pairs(rgbs, "past", self.flow_backend, raft=self.raft)
        return future, past


def make_parser(scene_type: str, cfg, **kw):
    cls = {
        "sceneflow": SceneFlowDataParser,
        "carla": CarlaDataParser,
        "interiornet": InteriorNetDataParser,
    }[scene_type]
    return cls(cfg, **kw)
