"""Video / frame IO.

Covers the reference's loader/saver surface (utils/VidToMe/utils.py:
``load_video`` :115-144, ``process_frames`` :83, ``save_video`` :147-180,
``save_frames`` :182, ``get_frame_ids`` :330-346); the PyTorch port's own
copy of tclight_tpu/utils/video_io.py. Frames are numpy ``(N, H, W, 3)``
float32 in [0, 1] (NHWC, the layout at the Generator's boundary).

Supported inputs: .mp4/.avi/.mov/.gif files or a directory of image frames.
Frames are resized + center-cropped so H and W are multiples of ``base`` (8,
the VAE stride), matching the reference's semantics.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".gif", ".mkv", ".webm"}


def _round_down(x: int, base: int) -> int:
    return max(base, (x // base) * base)


def resize_center_crop(
    frame: np.ndarray, height: int | None, width: int | None, base: int = 8
) -> np.ndarray:
    """Resize (preserving aspect, covering target) then center-crop to
    (height, width) rounded down to multiples of `base`.

    If height/width are None, only crops the native size down to multiples
    of `base`. Mirrors utils/VidToMe/utils.py:115-144.
    """
    import cv2

    h0, w0 = frame.shape[:2]
    if height is None or width is None:
        th, tw = _round_down(h0, base), _round_down(w0, base)
    else:
        th, tw = _round_down(int(height), base), _round_down(int(width), base)
    if (h0, w0) != (th, tw):
        scale = max(th / h0, tw / w0)
        rh, rw = max(th, int(round(h0 * scale))), max(tw, int(round(w0 * scale)))
        interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR
        frame = cv2.resize(frame, (rw, rh), interpolation=interp)
        y0 = (rh - th) // 2
        x0 = (rw - tw) // 2
        frame = frame[y0 : y0 + th, x0 : x0 + tw]
    return frame


def _list_frame_files(path: Path) -> list[Path]:
    files = sorted(p for p in path.iterdir() if p.suffix.lower() in IMG_EXTS)
    if not files:
        raise FileNotFoundError(f"no image frames in {path}")
    return files


def load_video(
    path: str | os.PathLike,
    height: int | None = None,
    width: int | None = None,
    frame_ids: Sequence[int] | None = None,
    base: int = 8,
) -> np.ndarray:
    """Load a video file or frame directory → (N, H, W, 3) float32 in [0,1]."""
    import cv2

    path = Path(path)
    frames: list[np.ndarray] = []
    wanted = set(frame_ids) if frame_ids is not None else None
    max_wanted = max(wanted) if wanted else None

    if path.is_dir():
        files = _list_frame_files(path)
        for i, f in enumerate(files):
            if wanted is not None and i not in wanted:
                continue
            img = cv2.imread(str(f), cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"failed to read {f}")
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    elif path.suffix.lower() == ".gif":
        import imageio.v2 as imageio

        for i, img in enumerate(imageio.mimread(str(path), memtest=False)):
            if wanted is not None and i not in wanted:
                continue
            if img.ndim == 2:
                img = np.stack([img] * 3, -1)
            frames.append(np.asarray(img)[..., :3])
            if max_wanted is not None and i >= max_wanted:
                break
    else:
        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise IOError(f"failed to open video {path}")
        i = 0
        while True:
            ok, img = cap.read()
            if not ok:
                break
            if wanted is None or i in wanted:
                frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            i += 1
            if max_wanted is not None and i > max_wanted:
                break
        cap.release()

    if not frames:
        raise ValueError(f"no frames loaded from {path} (frame_ids={frame_ids})")
    frames = [resize_center_crop(f, height, width, base) for f in frames]
    arr = np.stack(frames).astype(np.float32) / 255.0
    return arr


def _open_mp4_writer(path: Path, fps: int, w: int, h: int):
    import cv2

    # prefer h264 (the reference writes x264 mp4); fall back to mp4v
    # when no h264 encoder is available in this OpenCV build
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h)
        )
        if writer.isOpened():
            return writer
        writer.release()
    raise IOError(f"no usable mp4 encoder for {path}")


def _to_uint8(frames) -> np.ndarray:
    """Float [0, 1] frames rounded to uint8; uint8 frames as they are."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return frames


def save_video(
    frames: np.ndarray,
    path: str | os.PathLike,
    fps: int = 25,
) -> None:
    """Save (N, H, W, 3) float [0,1] (or uint8) frames → mp4 (x264 via
    imageio-ffmpeg) or gif by extension."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames = _to_uint8(frames)
    if path.suffix.lower() == ".gif":
        import imageio.v2 as imageio

        imageio.mimsave(str(path), list(frames), duration=1.0 / fps, loop=0)
    else:
        import cv2

        h, w = frames.shape[1:3]
        writer = _open_mp4_writer(path, fps, w, h)
        try:
            for f in frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        finally:
            writer.release()


def save_video_stream(
    chunks: Iterable, path: str | os.PathLike, fps: int = 25
) -> None:
    """Save an iterable of (n_i, H, W, 3) frame chunks (float [0, 1] or
    uint8) to mp4, encoding on a writer thread while the caller produces
    the next chunks. The writer opens on the first chunk; an error on the
    writer thread is raised again here."""
    import queue
    import threading

    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    buf: queue.Queue = queue.Queue(maxsize=2)
    errs: list[Exception] = []

    def _write() -> None:
        writer = None
        try:
            while (chunk := buf.get()) is not None:
                if errs:
                    continue  # drain, so that the producer never blocks on a full queue
                try:
                    chunk = _to_uint8(chunk)
                    if writer is None:
                        writer = _open_mp4_writer(path, fps, chunk.shape[2], chunk.shape[1])
                    for f in chunk:
                        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
                except Exception as e:  # noqa: BLE001 — raised again on the caller
                    errs.append(e)
        finally:
            if writer is not None:
                writer.release()

    thread = threading.Thread(target=_write, name="mp4-writer")
    thread.start()
    try:
        for chunk in chunks:
            if errs:
                break
            buf.put(chunk)
    finally:
        buf.put(None)
        thread.join()
    if errs:
        raise errs[0]


def save_frames(
    frames: np.ndarray, out_dir: str | os.PathLike, ext: str = "png"
) -> list[Path]:
    """Save frames as numbered images `00000.png`, ..."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    frames = _to_uint8(frames)
    paths = []
    for i, f in enumerate(frames):
        p = out_dir / f"{i:05d}.{ext}"
        cv2.imwrite(str(p), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        paths.append(p)
    return paths


def get_frame_ids(
    frame_range: Sequence[int] | None,
    frame_ids: Sequence[int] | None = None,
    n_total: int | None = None,
) -> list[int]:
    """frame_range [start, end, interval] → explicit id list; explicit
    frame_ids override (reference: utils.py:330-346)."""
    if frame_ids is not None:
        return list(int(i) for i in frame_ids)
    if frame_range is None:
        if n_total is None:
            raise ValueError("need frame_range, frame_ids, or n_total")
        return list(range(n_total))
    start, end, interval = (list(frame_range) + [1])[:3]
    if end is None or (end is not None and int(end) < 0):
        # [0, -1, 1] / null end = "all frames" (reference example configs)
        if n_total is None:
            raise ValueError("open-ended frame_range needs n_total")
        end = n_total
    if n_total is not None:
        end = min(end, n_total)
    return list(range(int(start), int(end), int(interval or 1)))


def count_frames(path: str | os.PathLike) -> int:
    import cv2

    path = Path(path)
    if path.is_dir():
        return len(_list_frame_files(path))
    if path.suffix.lower() == ".gif":
        import imageio.v2 as imageio

        return len(imageio.mimread(str(path), memtest=False))
    cap = cv2.VideoCapture(str(path))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
