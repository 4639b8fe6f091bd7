"""Diffusers / transformers checkpoints -> flax-layout parameter trees
(the port's copy of tclight_tpu/models/convert.py).

The converters map a flat {torch key: numpy array} state dict onto the
JAX package's flax parameter paths (Conv2d OIHW -> HWIO, Linear (out, in)
-> (in, out), norm weight -> scale), and `models/bridge.py` turns those
trees into the port's state dicts, so a diffusers checkpoint loads as
`bridge.unet_state_dict(convert_unet(sd))`: one key map, shared with the
JAX package's layout.

- diffusers UNet2DConditionModel -> `UNet2DCondition` (`convert_unet`)
- diffusers AutoencoderKL -> `AutoencoderKL` (`convert_vae`)
- transformers CLIPTextModel -> `CLIPTextModel` (`convert_clip_text`)
- IC-Light's weight offsets (`iclight_sd15_fc/fbc.safetensors` hold deltas
  added onto the base UNet, `merge_offsets`) and the zero-extended conv_in
  (`expand_conv_in`).

`load_torch_state_dict` reads `.safetensors` files with its own reader (an
8-byte header length, a JSON header, then the raw little-endian bytes), so
no `safetensors` package is needed; `.bin` / `.pt` files go through
`torch.load(weights_only=True)`.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = [
    "load_torch_state_dict",
    "read_safetensors",
    "expand_conv_in",
    "merge_offsets",
    "convert_unet",
    "convert_vae",
    "convert_clip_text",
]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 (which numpy lacks) widened to f32,
    which holds every bf16 value exactly."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a `.safetensors` file as a numpy array (bf16 as
    f32). The file is an 8-byte little-endian header length, a JSON header
    {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets into
    the data after the header), then the data."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                                 f"not one of {sorted(_SAFETENSORS_DTYPES)}")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            if end == begin:
                out[name] = _numpy(torch.empty(shape, dtype=dtype))
                continue
            f.seek(base + begin)
            t = torch.frombuffer(bytearray(f.read(end - begin)), dtype=dtype)
            out[name] = _numpy(t.reshape(shape))
    return out


def load_torch_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """A flat state dict from `.safetensors` (the port's reader) or a torch
    `.bin` / `.pt` file, as numpy arrays (bf16 as f32)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _numpy(v) for k, v in sd.items()}


def expand_conv_in(
    sd: Mapping[str, np.ndarray], new_in_channels: int,
    key: str = "conv_in.weight",
) -> dict[str, np.ndarray]:
    """Zero-extend conv_in input channels (model_utils.py:22-26): the first
    original channels keep the pretrained weights, new channels start at 0."""
    out = dict(sd)
    w = np.asarray(sd[key])  # OIHW
    o, i, kh, kw = w.shape
    if i >= new_in_channels:
        return out
    new_w = np.zeros((o, new_in_channels, kh, kw), dtype=w.dtype)
    new_w[:, :i] = w
    out[key] = new_w
    return out


def merge_offsets(
    base: Mapping[str, np.ndarray], offsets: Mapping[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """base + offset per key (model_utils.py:50-54). Keys present only in
    one dict are passed through / added as-is."""
    out = dict(base)
    for k, v in offsets.items():
        if k in out:
            if out[k].shape != v.shape:
                raise ValueError(
                    f"offset shape mismatch for {k}: {out[k].shape} vs {v.shape}"
                )
            out[k] = np.asarray(out[k]) + np.asarray(v)
        else:
            out[k] = np.asarray(v)
    return out


# ------------------------------------------------------------------ plumbing


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _lin(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _apply_table(
    sd: Mapping[str, np.ndarray],
    table: list[tuple[str, Callable[[re.Match], str]]],
) -> dict:
    """Map torch keys to flax paths via (regex, path_fn) rules. The first
    matching rule wins; unmatched keys raise."""
    params: dict = {}
    unmatched = []
    for k, v in sd.items():
        v = np.asarray(v)
        for pattern, path_fn in table:
            m = re.fullmatch(pattern, k)
            if m:
                path = path_fn(m)
                if path is None:
                    break
                if path.endswith("@conv"):
                    _set(params, path[:-5], _conv(v))
                elif path.endswith("@lin"):
                    _set(params, path[:-4], _lin(v))
                else:
                    _set(params, path, v)
                break
        else:
            unmatched.append(k)
    if unmatched:
        raise KeyError(f"unmatched checkpoint keys: {unmatched[:10]}"
                       f"{'...' if len(unmatched) > 10 else ''}")
    return params


def _norm_suffix(wb: str) -> str:
    return "scale" if wb == "weight" else "bias"


def _attn_block_paths(prefix: str, rest: str, wb: str) -> str | None:
    """Map diffusers transformer_blocks.0.* to our BasicTransformerBlock."""
    tb = f"{prefix}/transformer_blocks_0"
    m = re.fullmatch(r"(attn[12])\.to_(q|k|v)", rest)
    if m:
        return f"{tb}/{m.group(1)}/to_{m.group(2)}/kernel@lin"
    m = re.fullmatch(r"(attn[12])\.to_out\.0", rest)
    if m:
        return (f"{tb}/{m.group(1)}/to_out_0/kernel@lin" if wb == "weight"
                else f"{tb}/{m.group(1)}/to_out_0/bias")
    m = re.fullmatch(r"norm([123])", rest)
    if m:
        return f"{tb}/norm{m.group(1)}/{_norm_suffix(wb)}"
    if rest == "ff.net.0.proj":
        return (f"{tb}/ff/net_0/proj/kernel@lin" if wb == "weight"
                else f"{tb}/ff/net_0/proj/bias")
    if rest == "ff.net.2":
        return (f"{tb}/ff/net_2/kernel@lin" if wb == "weight"
                else f"{tb}/ff/net_2/bias")
    return None


def _resnet_path(prefix: str, part: str, wb: str) -> str:
    if part in ("norm1", "norm2"):
        return f"{prefix}/{part}/{_norm_suffix(wb)}"
    if part in ("conv1", "conv2", "conv_shortcut"):
        return (f"{prefix}/{part}/kernel@conv" if wb == "weight"
                else f"{prefix}/{part}/bias")
    if part == "time_emb_proj":
        return (f"{prefix}/{part}/kernel@lin" if wb == "weight"
                else f"{prefix}/{part}/bias")
    raise KeyError(part)


def convert_unet(sd: Mapping[str, np.ndarray], n_levels: int = 4) -> dict:
    """diffusers UNet2DConditionModel -> params for `UNet2DCondition`.
    diffusers up_blocks.i corresponds to our level (n_levels-1-i)."""

    def up_lvl(i: str) -> int:
        return n_levels - 1 - int(i)

    def attn_path(m: re.Match) -> str | None:
        where, rest, wb = m.group(1), m.group(4), m.group(5)
        if where.startswith("down_blocks"):
            i, j = re.findall(r"\d+", where)[:2]
            prefix = f"down_{i}_attn_{j}"
        elif where.startswith("up_blocks"):
            i, j = re.findall(r"\d+", where)[:2]
            prefix = f"up_{up_lvl(i)}_attn_{j}"
        else:
            prefix = "mid_attn"
        if rest == "norm":
            return f"{prefix}/norm/{_norm_suffix(wb)}"
        if rest in ("proj_in", "proj_out"):
            return (f"{prefix}/{rest}/kernel@conv" if wb == "weight"
                    else f"{prefix}/{rest}/bias")
        sub = rest[len("transformer_blocks.0."):]
        return _attn_block_paths(prefix, sub, wb)

    table = [
        (r"conv_in\.(weight|bias)",
         lambda m: "conv_in/kernel@conv" if m.group(1) == "weight" else "conv_in/bias"),
        (r"conv_out\.(weight|bias)",
         lambda m: "conv_out/kernel@conv" if m.group(1) == "weight" else "conv_out/bias"),
        (r"conv_norm_out\.(weight|bias)",
         lambda m: f"conv_norm_out/{_norm_suffix(m.group(1))}"),
        (r"time_embedding\.linear_(\d)\.(weight|bias)",
         lambda m: (f"time_embedding/linear_{m.group(1)}/kernel@lin"
                    if m.group(2) == "weight"
                    else f"time_embedding/linear_{m.group(1)}/bias")),
        (r"down_blocks\.(\d+)\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: _resnet_path(f"down_{m.group(1)}_res_{m.group(2)}",
                                m.group(3), m.group(4))),
        (r"up_blocks\.(\d+)\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: _resnet_path(f"up_{up_lvl(m.group(1))}_res_{m.group(2)}",
                                m.group(3), m.group(4))),
        (r"mid_block\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: _resnet_path(f"mid_res_{m.group(1)}", m.group(2), m.group(3))),
        (r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)",
         lambda m: (f"down_{m.group(1)}_ds/conv/kernel@conv"
                    if m.group(2) == "weight" else f"down_{m.group(1)}_ds/conv/bias")),
        (r"up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)",
         lambda m: (f"up_{up_lvl(m.group(1))}_us/conv/kernel@conv"
                    if m.group(2) == "weight" else f"up_{up_lvl(m.group(1))}_us/conv/bias")),
        (r"((down_blocks\.\d+|up_blocks\.\d+|mid_block)\.attentions\.(\d+))\.(.+)\.(weight|bias)",
         attn_path),
        # text-time embeddings etc. not present in SD1.5 — reject loudly
    ]
    return {"params": _apply_table(sd, table)}


def _vae_attn_path(prefix: str, rest: str, wb: str) -> str:
    if rest == "group_norm":
        return f"{prefix}/group_norm/{_norm_suffix(wb)}"
    mapping = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v",
               "to_out.0": "to_out_0", "query": "to_q", "key": "to_k",
               "value": "to_v", "proj_attn": "to_out_0"}
    name = mapping[rest]
    if wb == "weight":
        return f"{prefix}/{name}/kernel@lin"
    return f"{prefix}/{name}/bias"


def convert_vae(sd: Mapping[str, np.ndarray], n_levels: int = 4) -> dict:
    """diffusers AutoencoderKL -> params for our `AutoencoderKL` (the
    quant convs live inside encoder/decoder here)."""

    def up_lvl(i: str) -> int:
        return n_levels - 1 - int(i)

    def enc_dec(side: str) -> str:
        return "encoder" if side == "encoder" else "decoder"

    table = [
        (r"quant_conv\.(weight|bias)",
         lambda m: ("encoder/quant_conv/kernel@conv" if m.group(1) == "weight"
                    else "encoder/quant_conv/bias")),
        (r"post_quant_conv\.(weight|bias)",
         lambda m: ("decoder/post_quant_conv/kernel@conv" if m.group(1) == "weight"
                    else "decoder/post_quant_conv/bias")),
        (r"(encoder|decoder)\.conv_(in|out)\.(weight|bias)",
         lambda m: (f"{m.group(1)}/conv_{m.group(2)}/kernel@conv"
                    if m.group(3) == "weight"
                    else f"{m.group(1)}/conv_{m.group(2)}/bias")),
        (r"(encoder|decoder)\.conv_norm_out\.(weight|bias)",
         lambda m: f"{m.group(1)}/conv_norm_out/{_norm_suffix(m.group(2))}"),
        (r"encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: "encoder/" + _resnet_path(
             f"down_{m.group(1)}_res_{m.group(2)}", m.group(3), m.group(4))),
        (r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.(weight|bias)",
         lambda m: (f"encoder/down_{m.group(1)}_ds/kernel@conv"
                    if m.group(2) == "weight"
                    else f"encoder/down_{m.group(1)}_ds/bias")),
        (r"decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: "decoder/" + _resnet_path(
             f"up_{up_lvl(m.group(1))}_res_{m.group(2)}", m.group(3), m.group(4))),
        (r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.(weight|bias)",
         lambda m: (f"decoder/up_{up_lvl(m.group(1))}_us/kernel@conv"
                    if m.group(2) == "weight"
                    else f"decoder/up_{up_lvl(m.group(1))}_us/bias")),
        (r"(encoder|decoder)\.mid_block\.resnets\.(\d+)\.([a-z_0-9]+)\.(weight|bias)",
         lambda m: f"{m.group(1)}/" + _resnet_path(
             f"mid_res_{m.group(2)}", m.group(3), m.group(4))),
        (r"(encoder|decoder)\.mid_block\.attentions\.0\.(.+)\.(weight|bias)",
         lambda m: f"{m.group(1)}/" + _vae_attn_path(
             "mid_attn", m.group(2), m.group(3))),
    ]
    return {"params": _apply_table(sd, table)}


def convert_clip_text(sd: Mapping[str, np.ndarray]) -> dict:
    """transformers CLIPTextModel -> params for our `CLIPTextModel`."""

    def strip(k: str) -> str:
        return k[len("text_model."):] if k.startswith("text_model.") else k

    sd = {strip(k): v for k, v in sd.items()
          if "position_ids" not in k}

    table = [
        (r"embeddings\.token_embedding\.weight",
         lambda m: "token_embedding/embedding"),
        (r"embeddings\.position_embedding\.weight",
         lambda m: "position_embedding"),
        (r"final_layer_norm\.(weight|bias)",
         lambda m: f"final_layer_norm/{_norm_suffix(m.group(1))}"),
        (r"encoder\.layers\.(\d+)\.self_attn\.(q|k|v|out)_proj\.(weight|bias)",
         lambda m: (f"layers_{m.group(1)}/self_attn/{m.group(2)}_proj/kernel@lin"
                    if m.group(3) == "weight"
                    else f"layers_{m.group(1)}/self_attn/{m.group(2)}_proj/bias")),
        (r"encoder\.layers\.(\d+)\.layer_norm([12])\.(weight|bias)",
         lambda m: f"layers_{m.group(1)}/layer_norm{m.group(2)}/{_norm_suffix(m.group(3))}"),
        (r"encoder\.layers\.(\d+)\.mlp\.fc([12])\.(weight|bias)",
         lambda m: (f"layers_{m.group(1)}/mlp_fc{m.group(2)}/kernel@lin"
                    if m.group(3) == "weight"
                    else f"layers_{m.group(1)}/mlp_fc{m.group(2)}/bias")),
    ]
    return {"params": _apply_table(sd, table)}
