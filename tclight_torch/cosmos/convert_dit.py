"""Cosmos GeneralDIT checkpoints onto the port's DiT (counterpart of
tclight_tpu/cosmos/convert_dit.py).

The port's modules carry the reference's names (cosmos/dit.py), so a
Cosmos state dict loads key for key: `convert_general_dit` drops the
non-persistent RoPE buffers (`pos_embedder.*`, recomputed from the
config) and the training accumulators, and refuses any key it does not
know. `reference_state_dict` is its inverse, a Cosmos-layout state dict of
numpy arrays from a port module (what the tests hand to the JAX
converter). `from_flax` bridges the JAX package's parameter tree (numpy
leaves): Dense kernels (in, out) become Linear weights (out, in), the
rest copies through.

Flax path -> Cosmos key:
  x_embedder/kernel                  -> x_embedder.proj.1.weight
  t_embedder/linear_{1,2}/{kernel,bias} -> t_embedder.1.linear_{1,2}.{weight,bias}
  augment_sigma_embedder/...         -> augment_sigma_embedder.1....
  affline_norm/weight                -> affline_norm.weight
  extra_pos_embedder/pos_emb_{t,h,w} -> extra_pos_embedder.pos_emb_{t,h,w}
  block{i}/blocks_{j}/adaLN_modulation/adaLN_modulation_{k}/kernel
      -> blocks.block{i}.blocks.{j}.adaLN_modulation.{k}.weight
  block{i}/blocks_{j}/attn/to_{q,k,v}_0/kernel -> ...block.attn.to_{q,k,v}.0.weight
  block{i}/blocks_{j}/attn/to_{q,k}_1/weight   -> ...block.attn.to_{q,k}.1.weight
  block{i}/blocks_{j}/attn/to_out_0/kernel     -> ...block.attn.to_out.0.weight
  block{i}/blocks_{j}/layer{1,2}/kernel        -> ...block.layer{1,2}.weight
  final_layer/linear/kernel          -> final_layer.linear.weight
  final_layer/adaLN_modulation/adaLN_modulation_{k}/kernel
      -> final_layer.adaLN_modulation.{k}.weight
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["convert_general_dit", "convert_diffusion_decoder_dit", "reference_state_dict",
           "from_flax"]

_SKIP = re.compile(
    r"^(pos_embedder\.|accum_|.*\.seq$|.*dim_spatial_range$|.*dim_temporal_range$)")

_FLAX = [  # (flax path pattern, Cosmos key template, transpose)
    (r"x_embedder/kernel", "x_embedder.proj.1.weight", True),
    (r"(t_embedder|augment_sigma_embedder)/linear_([12])/kernel", r"\1.1.linear_\2.weight", True),
    (r"(t_embedder|augment_sigma_embedder)/linear_([12])/bias", r"\1.1.linear_\2.bias", False),
    (r"affline_norm/weight", "affline_norm.weight", False),
    (r"extra_pos_embedder/(pos_emb_[thw])", r"extra_pos_embedder.\1", False),
    (r"block(\d+)/blocks_(\d+)/adaLN_modulation/adaLN_modulation_([12])/kernel",
     r"blocks.block\1.blocks.\2.adaLN_modulation.\3.weight", True),
    (r"block(\d+)/blocks_(\d+)/attn/to_(q|k|v|out)_0/kernel",
     r"blocks.block\1.blocks.\2.block.attn.to_\3.0.weight", True),
    (r"block(\d+)/blocks_(\d+)/attn/to_(q|k)_1/weight",
     r"blocks.block\1.blocks.\2.block.attn.to_\3.1.weight", False),
    (r"block(\d+)/blocks_(\d+)/layer([12])/kernel", r"blocks.block\1.blocks.\2.block.layer\3.weight",
     True),
    (r"final_layer/linear/kernel", "final_layer.linear.weight", True),
    (r"final_layer/adaLN_modulation/adaLN_modulation_([12])/kernel",
     r"final_layer.adaLN_modulation.\1.weight", True),
]


def convert_general_dit(sd: Mapping[str, Any], model: nn.Module | None = None
                        ) -> dict[str, torch.Tensor]:
    """A reference GeneralDIT / VideoExtendGeneralDIT state dict -> the
    port's state dict. With `model`, every key must be one of its keys
    (ValueError naming the others)."""
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items() if not _SKIP.match(k)}
    if model is not None:
        unknown = sorted(set(out) - set(model.state_dict()))
        if unknown:
            raise ValueError(f"unconverted GeneralDIT keys: {unknown[:8]}"
                             f"{'...' if len(unknown) > 8 else ''}")
    return out


def convert_diffusion_decoder_dit(sd: Mapping[str, Any], model: nn.Module | None = None
                                  ) -> dict[str, torch.Tensor]:
    """A reference DiffusionDecoderGeneralDIT state dict (a GeneralDIT's keys
    and `token_embedder.weight`) -> the port's `DiffusionDecoderGeneralDIT`
    state dict: the port's decoder is a GeneralDIT with the token embedder
    beside its modules, so the keys are the reference's (JAX nests the DiT
    under `dit`)."""
    return convert_general_dit(sd, model)


def reference_state_dict(model: nn.Module) -> dict[str, np.ndarray]:
    """The module's weights as a Cosmos-layout state dict of f32 numpy arrays."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's GeneralDIT parameter tree ({'params': ...} or its
    inside, numpy leaves) -> the port's state dict."""
    if "params" in params:
        params = params["params"]
    out = {}
    for path, v in _flatten(params).items():
        for pat, key, transpose in _FLAX:
            m = re.fullmatch(pat, path)
            if m:
                out[m.expand(key)] = torch.from_numpy(np.ascontiguousarray(v.T if transpose else v))
                break
        else:
            raise ValueError(f"unconverted GeneralDIT parameter: {path}")
    return out
