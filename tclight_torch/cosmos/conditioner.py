"""Dropout-based CFG conditioning (counterpart of
tclight_tpu/cosmos/conditioner.py): each condition field has an embedder
and a dropout rate; `get_condition_uncondition` gives the (cond, uncond)
pair for classifier-free guidance, the fields with dropout nulled.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

__all__ = ["ConditionField", "GeneralConditioner", "VideoCondition"]


@dataclasses.dataclass(frozen=True)
class ConditionField:
    """One conditioning input: an embedder and its CFG dropout rate."""

    embed: Callable[[Any], torch.Tensor]
    dropout_rate: float = 0.0
    null_value: float = 0.0


@dataclasses.dataclass
class VideoCondition:
    """The assembled conditioning tensors fed to the DiT."""

    crossattn_emb: torch.Tensor | None = None
    extras: dict = dataclasses.field(default_factory=dict)

    def set(self, name: str, emb: torch.Tensor) -> None:
        if name == "crossattn":
            self.crossattn_emb = emb
        else:
            self.extras[name] = emb


class GeneralConditioner:
    """fields: {name: ConditionField}. Calling it embeds the raw inputs
    (in training, each sample's field dropped to its null value with the
    field's rate, drawn from `generator`)."""

    def __init__(self, fields: Mapping[str, ConditionField]):
        self.fields = dict(fields)

    def __call__(self, inputs: Mapping[str, Any], generator: torch.Generator | None = None,
                 train: bool = False) -> VideoCondition:
        out = VideoCondition()
        for name, field in self.fields.items():
            if name not in inputs:
                continue
            emb = field.embed(inputs[name])
            if train and field.dropout_rate > 0 and generator is not None:
                keep = torch.rand((emb.shape[0],), generator=generator,
                                  device=emb.device) < 1.0 - field.dropout_rate
                emb = torch.where(keep.reshape((-1,) + (1,) * (emb.dim() - 1)), emb,
                                  torch.full_like(emb, field.null_value))
            out.set(name, emb)
        return out

    def get_condition_uncondition(self, inputs: Mapping[str, Any]
                                  ) -> tuple[VideoCondition, VideoCondition]:
        cond = self(inputs, train=False)
        uncond = VideoCondition()
        for name, field in self.fields.items():
            if name not in inputs:
                continue
            emb = field.embed(inputs[name])
            # fields with dropout take part in CFG: nulled at inference
            uncond.set(name, torch.full_like(emb, field.null_value)
                       if field.dropout_rate > 0 else emb)
        return cond, uncond
