"""Build, load and count the port's hand-written CUDA kernels.

Each source under `tclight_torch/csrc/` is compiled on first CUDA use with
`nvcc -gencode arch=compute_90a,code=sm_90a` into a shared library with a
plain C interface, and loaded with `ctypes`. Nothing compiles at import
time. All sources build at once, one `nvcc` process each, into
`build/tclight_torch/` at the repository root; the file name carries a
hash of the source, so an edited source never loads a stale library.

Every kernel wrapper records its launches in `STATS`, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["STATS", "KernelStats", "build_all", "library", "function", "nvcc_path",
           "reset_stats", "check_launch"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tclight_torch"
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_int8": "flash_attention_int8.cu",
    "flash_attention_qk_int8": "flash_attention_qk_int8.cu",
    "match_argmax": "match_argmax.cu",
    "window_warp": "window_warp.cu",
    "banded_gather": "banded_gather.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


class KernelStats:
    """Launch count of one kernel, and the count per launch shape key."""

    def __init__(self) -> None:
        self.launches = 0
        self.shapes: collections.Counter = collections.Counter()

    def record(self, key) -> None:
        self.launches += 1
        self.shapes[key] += 1

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()


STATS = {name: KernelStats() for name in (
    "flash_attention", "flash_attention_int8", "flash_attention_int8_prepass",
    "flash_attention_int8pv", "flash_attention_int8pv_prepass", "online_argmax_scores", "window_warp", "banded_gather", "banded_gather_multi")}

_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}


def reset_stats() -> None:
    for s in STATS.values():
        s.reset()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel source that has no up-to-date library, all in
    parallel. Returns the seconds spent; raises with nvcc's output on a
    failed build."""
    t0 = time.perf_counter()
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source `name` (built on first
    use)."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return _libs[name]


def function(name: str, entry: str, argtypes, restype):
    """C entry point `entry` of kernel library `name`, its argument and
    result types set once, on first use, not on every launch."""
    key = (name, entry)
    if key not in _functions:
        fn = getattr(library(name), entry)
        fn.argtypes, fn.restype = list(argtypes), restype
        _functions[key] = fn
    return _functions[key]


def check_launch(rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
