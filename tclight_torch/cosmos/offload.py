"""Component offloading for the world-generation pipelines (counterpart
of tclight_tpu/cosmos/offload.py): each heavy component (the diffusion
network, the tokenizer, the text encoder, the prompt upsampler, the
guardrails) can be marked offloaded, so that it holds card memory only
while its stage runs.

JAX keeps a host copy of a parameter tree and deletes the device buffers;
here `HostParams` moves an `nn.Module` between the host and its device
(`acquire` moves it to the device, `release` back to the host and frees
the cache).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch import nn

__all__ = ["OffloadPolicy", "HostParams", "offload_component"]


@dataclasses.dataclass(frozen=True)
class OffloadPolicy:
    """Which components drop their device residency between stages (the
    reference's offload_* flags)."""

    network: bool = False
    tokenizer: bool = False
    text_encoder: bool = False
    prompt_upsampler: bool = False
    guardrails: bool = False

    @staticmethod
    def everything() -> "OffloadPolicy":
        """The low-memory preset the reference recommends for 7B models."""
        return OffloadPolicy(network=True, tokenizer=True, text_encoder=True,
                             prompt_upsampler=True, guardrails=True)


class HostParams:
    """A module with explicit device residency.

    - `offload=False`: the module stays on `device`; acquire / release do
      nothing.
    - `offload=True`: the module waits on the host; `acquire()` moves it
      to `device`, `release()` back to the host.

    Use as a context manager around a stage:

        with params.on_device() as module:
            out = module(x)
    """

    def __init__(self, module: nn.Module, offload: bool = False,
                 device: str | torch.device | None = None, name: str = ""):
        self.module, self.offload, self.name = module, bool(offload), name
        self.device = torch.device(device) if device is not None else next(
            module.parameters()).device
        if self.offload:
            self.module.to("cpu")
        else:
            self.module.to(self.device)

    def acquire(self) -> nn.Module:
        if self.offload:
            self.module.to(self.device)
        return self.module

    def release(self) -> None:
        if self.offload:
            self.module.to("cpu")
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    @contextlib.contextmanager
    def on_device(self):
        try:
            yield self.acquire()
        finally:
            self.release()

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.module.parameters())


@contextlib.contextmanager
def offload_component(obj: Any, enabled: bool = True):
    """Scope a component with optional acquire() / release() methods
    (guardrail runners, prompt upsamplers, decoders): when `enabled` and
    the object has them, its residency is taken on entry and dropped on
    exit; other objects pass through."""
    try:
        if enabled and hasattr(obj, "acquire"):
            obj.acquire()
        yield obj
    finally:
        if enabled and hasattr(obj, "release"):
            obj.release()
