"""ctypes bindings for the port's host-side track code (`flowid.cpp`, a
copy of tclight_tpu/native/flowid.cpp).

The library is built with g++ at first use into `build/tclight_torch/` at
the repository root, under a name that carries a hash of the source, so an
edited source never loads a stale library. A failed build raises: the data
layer numbers tracks with this code and has no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["get_flowid_native", "unique_inverse_native", "segment_mean_native",
           "library"]

_SRC = Path(__file__).resolve().parent / "flowid.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tclight_torch"
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"native-{h.hexdigest()[:12]}.so"


def library() -> ctypes.CDLL:
    """The loaded track library, built with g++ on first use."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ build of {_SRC} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    f32p, i32p, i64 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                       ctypes.c_int64)
    lib.tcl_flowid_propagate.restype = i64
    lib.tcl_flowid_propagate.argtypes = [f32p, f32p, f32p, i32p, i64, i64, i64, i64,
                                         ctypes.c_float]
    lib.tcl_unique_inverse.restype = i64
    lib.tcl_unique_inverse.argtypes = [i32p, i32p, i64]
    lib.tcl_segment_mean.restype = None
    lib.tcl_segment_mean.argtypes = [f32p, i32p, f32p, i64, i64, i64]
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def get_flowid_native(frames: np.ndarray, flows: np.ndarray, masks: np.ndarray,
                      rgb_threshold: float = 0.01) -> np.ndarray:
    """frames (N, H, W, C) f32, flows (>= N-1, H, W, 2) f32, masks
    (N, H, W) f32 -> int32 (N, H, W) track ids."""
    lib = library()
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w, c = frames.shape
    flows_full = np.zeros((n, h, w, 2), np.float32)
    flows_full[: flows.shape[0]] = flows[:n]
    masks = np.ascontiguousarray(masks, np.float32)
    out = np.empty((n, h, w), np.int32)
    lib.tcl_flowid_propagate(_fptr(frames), _fptr(flows_full), _fptr(masks), _iptr(out),
                             n, h, w, c, ctypes.c_float(rgb_threshold))
    return out


def unique_inverse_native(ids: np.ndarray) -> tuple[np.ndarray, int]:
    """(inverse into the sorted unique ids, number of unique ids)."""
    lib = library()
    ids = np.ascontiguousarray(ids.reshape(-1), np.int32)
    inv = np.empty_like(ids)
    n_unique = lib.tcl_unique_inverse(_iptr(ids), _iptr(inv), ids.size)
    return inv, int(n_unique)


def segment_mean_native(vals: np.ndarray, inv: np.ndarray, n_unique: int) -> np.ndarray:
    """Per-track mean of vals (count, C) over inv (count,)."""
    lib = library()
    vals = np.ascontiguousarray(vals, np.float32)
    inv = np.ascontiguousarray(inv, np.int32)
    count, c = vals.shape
    out = np.empty((n_unique, c), np.float32)
    lib.tcl_segment_mean(_fptr(vals), _iptr(inv), _fptr(out), count, c, n_unique)
    return out
