"""Cosmos causal video tokenizer checkpoints onto the port's tokenizer
(counterpart of tclight_tpu/cosmos/convert_dv.py).

The port's modules carry the reference's names and PyTorch's layouts
(Conv3d weights (O, I, kT, kH, kW), GroupNorm weight / bias), so a
reference state dict (the encoder / decoder checkpoint after the
captured buffers are stripped) loads key for key: `convert_dv_tokenizer`
drops the non-persistent buffers (wavelets, the FSQ tables), and refuses a
key the module does not have. `reference_state_dict` is its inverse.
`from_flax` bridges the JAX package's tokenizer tree (numpy leaves): its
module names join the reference's dotted path with underscores
(`down_1_block_0`, `mid_attn_1_0`, `conv1_0`), a conv's `conv` is
`conv3d`, kernels (kT, kH, kW, I, O) turn to (O, I, kT, kH, kW) and norm
`scale` is `weight`.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from tclight_torch.cosmos.convert_dit import _flatten, reference_state_dict

__all__ = ["convert_dv_tokenizer", "reference_state_dict", "from_flax"]

_SKIP = re.compile(r"(^|\.)(patcher3d|unpatcher3d)\.|^quantizer\.|"
                   r"\.(wavelets|_arange|patch_size_buffer)$")

_SEGMENTS = [  # flax module name -> the reference's dotted path
    (re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)_(\d+)$"), r"\1.\2.\3.\4.\5"),
    (re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$"), r"\1.\2.\3.\4"),
    (re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$"), r"\1.\2.\3"),
    (re.compile(r"^mid_(block_[12])$"), r"mid.\1"),
    (re.compile(r"^mid_attn_1_([01])$"), r"mid.attn_1.\1"),
    (re.compile(r"^(conv_in|conv_out|conv1|conv2)_([01])$"), r"\1.\2"),
    (re.compile(r"^conv$"), "conv3d"),
]


def convert_dv_tokenizer(sd: Mapping[str, Any], model: nn.Module | None = None
                         ) -> dict[str, torch.Tensor]:
    """A reference tokenizer state dict -> the port's state dict. With
    `model`, every key must be one of its keys (ValueError naming the
    others)."""
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items() if not _SKIP.search(k)}
    if model is not None:
        unknown = sorted(set(out) - set(model.state_dict()))
        if unknown:
            raise ValueError(f"unconverted DV tokenizer keys: {unknown[:8]}"
                             f"{'...' if len(unknown) > 8 else ''}")
    return out


def _segment(name: str) -> str:
    for pat, rep in _SEGMENTS:
        if pat.match(name):
            return pat.sub(rep, name)
    return name


def from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's tokenizer tree ({'params': ...} or its inside)
    -> the port's state dict."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, v in _flatten(params).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            leaf, v = "weight", v.transpose(4, 3, 0, 1, 2)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([_segment(m) for m in mods] + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(v))
    return out
