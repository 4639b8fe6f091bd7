"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is "cuda", and without a CUDA device that default raises rather
than carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tclight_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev
