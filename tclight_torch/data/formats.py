"""File formats of the synthetic datasets (the port's copy of
tclight_tpu/data/formats.py, numpy only): PFM (disparity / depth, and
SceneFlow's flows), Middlebury .flo flow and .float3 blobs.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

__all__ = ["read_pfm", "write_pfm", "read_flo", "write_flo", "read_float3"]

_FLO_MAGIC = 202021.25


def read_pfm(path: str | Path) -> tuple[np.ndarray, float]:
    """PFM -> (array (H, W[, 3]) float32, scale). PFM stores rows
    bottom-to-top, so the image is flipped vertically on read."""
    with open(path, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not m:
            raise ValueError("malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip().decode("ascii"))
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def write_pfm(path: str | Path, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF\n"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf\n"
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def read_flo(path: str | Path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"bad .flo magic in {path}: {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_float3(path: str | Path) -> np.ndarray:
    """'.float3' blob: ascii header 'float\\n<ndim>\\n<dims...>' + raw f32."""
    with open(path, "rb") as f:
        if f.readline().decode("ascii").strip() != "float":
            raise ValueError(f"bad float3 header in {path}")
        ndim = int(f.readline())
        dims = [int(f.readline()) for _ in range(ndim)]
        data = np.fromfile(f, np.float32)
    return data.reshape(dims[::-1]).transpose()
