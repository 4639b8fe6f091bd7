"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is "cuda", and without a CUDA device that default raises rather
than carrying on quietly on the CPU. `full_f32` runs a block's f32
convolutions and matmuls in full f32 (the flow networks and the evaluate
CLI run so).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tclight_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev


@contextlib.contextmanager
def full_f32(cudnn: bool = True):
    """Within the block, f32 convolutions and CUDA matmuls take full f32
    inputs (no TF32), and cuDNN serves the convolutions if `cudnn` (else
    PyTorch's own kernels); the process-wide flags are restored after.
    PyTorch's defaults are cuDNN on, TF32 on for its convolutions and off
    for matmuls."""
    flags = torch.backends.cudnn
    saved = flags.enabled, flags.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    flags.enabled, flags.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, False, False
    try:
        yield
    finally:
        flags.enabled, flags.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
