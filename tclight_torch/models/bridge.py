"""Parameter bridge: the JAX package's flax parameter trees, as numpy
arrays, into the port's state dicts.

The port's modules carry the flax module names as attribute names, so a
flax path ``down_0_res_0/conv1/kernel`` becomes ``down_0_res_0.conv1.weight``.
Leaves change layout as follows:

- ``Conv`` kernel HWIO -> ``Conv2d`` weight OIHW;
- ``Dense`` kernel (in, out) -> ``Linear`` weight (out, in);
- norm ``scale`` -> ``weight``; ``Embed`` ``embedding`` -> ``weight``;
- ``bias`` and plain parameters (``position_embedding``) as they are.

`module_to_flax` goes the other way, from a port module to a flax tree.
This is how the tests hand the same weights to both packages. Checkpoints
load through the same map: a converter of the JAX package's (copied into
the port) turns a reference state dict into a flax tree, and the
functions here turn the tree into the port's state dict.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["flax_to_state_dict", "unet_state_dict", "vae_state_dict",
           "clip_text_state_dict", "raft_state_dict", "memflow_sk_state_dict",
           "memflow_state_dict", "clip_vision_state_dict", "vgg16_state_dict",
           "controlnet_state_dict", "rmbg_state_dict", "vlm_state_dicts",
           "dpt_state_dict", "hed_state_dict", "lineart_state_dict", "bodypose_state_dict",
           "t5_encoder_state_dict", "siglip_state_dict", "safety_classifier_state_dict",
           "retinaface_state_dict", "diffusion_decoder_state_dict",
           "module_to_flax"]


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def flax_to_state_dict(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flatten a flax parameter tree (with or without the top-level
    ``params`` collection) into a torch state dict (f32 copies)."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
            else:
                name, arr = _leaf(key, np.array(value, dtype=np.float32))
                out[".".join(prefix + (name,))] = torch.from_numpy(
                    np.ascontiguousarray(arr))

    walk(tree, ())
    return out


def unet_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`UNet2DCondition` parameters (tclight_tpu/models/unet.py)."""
    return flax_to_state_dict(params)


def vae_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`AutoencoderKL` parameters (tclight_tpu/models/vae.py): the encoder
    and decoder subtrees."""
    sd = flax_to_state_dict(params)
    if not all(k.startswith(("encoder.", "decoder.")) for k in sd):
        raise ValueError("VAE parameter tree must hold encoder/decoder only")
    return sd


def clip_text_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`CLIPTextModel` parameters (tclight_tpu/models/clip_text.py)."""
    return flax_to_state_dict(params)


def raft_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`RAFT` parameters (tclight_tpu/models/raft.py; `convert_raft_params`'s
    tree). FrozenAffine's `scale` becomes its `weight`."""
    return flax_to_state_dict(params)


def memflow_sk_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`MemFlowNetSK` parameters (tclight_tpu/models/memflow_sk.py;
    `convert_memflow_params`' tree). Depthwise kernels (k, k, 1, C) become
    (C, 1, k, k)."""
    return flax_to_state_dict(params)


def memflow_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`MemFlowNet` parameters (tclight_tpu/models/memflow.py)."""
    return flax_to_state_dict(params)


def clip_vision_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`CLIPVisionModel` parameters (tclight_tpu/models/clip_vision.py;
    `convert_clip_vision`'s tree)."""
    return flax_to_state_dict(params)


def vgg16_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`VGG16Features` parameters (tclight_tpu/models/vgg_lpips.py;
    `convert_vgg16_features`' tree)."""
    return flax_to_state_dict(params)


def controlnet_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`ControlNetModel` parameters (tclight_tpu/models/controlnet.py;
    `convert_controlnet`'s tree)."""
    return flax_to_state_dict(params)


def rmbg_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`BriaRMBG` variables (tclight_tpu/models/briarmbg.py;
    `convert_rmbg_params`' {"params", "batch_stats"}): the BatchNorm
    statistics `mean` / `var` become `running_mean` / `running_var`, and
    each BatchNorm gets a `num_batches_tracked` of 0."""
    sd = flax_to_state_dict(variables["params"])
    for key, arr in flax_to_state_dict(variables["batch_stats"]).items():
        prefix, leaf = key.rsplit(".", 1)
        sd[f"{prefix}.running_{leaf}"] = arr
        sd.setdefault(f"{prefix}.num_batches_tracked", torch.zeros((), dtype=torch.long))
    return sd


def vlm_state_dicts(text_params: Mapping[str, Any], vit_params: Mapping[str, Any],
                    proj_params: Mapping[str, Any]) -> dict[str, dict[str, torch.Tensor]]:
    """The Pixtral VLM's three trees (tclight_tpu/models/pixtral.py: the
    decoder's `Transformer`, `PixtralViT`, `MultimodalProjector`) as the
    state dicts {"text", "vit", "projector"} of `pixtral.build_vlm`. The
    flax Embed's `embedding` becomes the embedding's `weight`, the patch
    conv's HWIO kernel an OIHW weight."""
    return {"text": flax_to_state_dict(text_params), "vit": flax_to_state_dict(vit_params),
            "projector": flax_to_state_dict(proj_params)}


def dpt_state_dict(params: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """`DPTForDepthEstimation` parameters (tclight_tpu/models/dpt.py;
    `convert_dpt`'s tree, `cfg` its DPTConfig); group norms' and layer
    norms' `scale` become their `weight`. The transposed-conv resizes'
    (kh, kw, in, out) kernels become (in, out, kh, kw) weights turned by
    180 degrees: flax's ConvTranspose (transpose_kernel=False) reads its
    kernel flipped against ConvTranspose2d's, and `convert_dpt` stores the
    checkpoint's kernel unflipped, so this is the kernel the JAX model
    applies (ROADMAP C8)."""
    sd = flax_to_state_dict(params)
    for i, f in enumerate(cfg.reassemble_factors):
        key = f"reassemble_resize_{i}.weight"
        if f > 1 and key in sd:
            sd[key] = sd[key].transpose(0, 1).flip(2, 3).contiguous()
    return sd


def hed_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`ControlNetHED` parameters (tclight_tpu/models/hed.py; `convert_hed`'s
    tree): `norm` keeps its (1, 1, 1, 3) shape."""
    return flax_to_state_dict(params)


def lineart_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`LineartAnimeUNet` parameters (tclight_tpu/models/lineart.py;
    `convert_lineart_anime`'s tree). Its transposed convs' kernels are in
    flax's transpose_kernel layout (kh, kw, out, in), which the HWIO ->
    OIHW map turns into ConvTranspose2d's (in, out, kh, kw)."""
    return flax_to_state_dict(params)


def bodypose_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`BodyPoseNet` parameters (tclight_tpu/models/openpose.py;
    `convert_bodypose`'s tree, one entry per named conv)."""
    return flax_to_state_dict(params)


def t5_encoder_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`T5Encoder` parameters (tclight_tpu/models/t5_encoder.py)."""
    return flax_to_state_dict(params)


def siglip_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`SiglipVisionTower` parameters (tclight_tpu/models/siglip.py;
    `convert_siglip_vision`'s tree)."""
    return flax_to_state_dict(params)


def safety_classifier_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`SafetyClassifier` parameters (the BN-folded scale / bias as they are)."""
    return flax_to_state_dict(params)


def retinaface_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`RetinaFace` parameters (tclight_tpu/models/retinaface.py;
    `convert_retinaface`'s tree, BN folded)."""
    return flax_to_state_dict(params)


def diffusion_decoder_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`DiffusionDecoderGeneralDIT` (tclight_tpu/cosmos/diffusion_decoder.py):
    the GeneralDIT under `dit` through `cosmos.convert_dit.from_flax`, the
    token table beside it."""
    from tclight_torch.cosmos.convert_dit import from_flax

    if "params" in params:
        params = params["params"]
    out = from_flax(params["dit"])
    if "token_embedder" in params:
        out["token_embedder.weight"] = torch.from_numpy(
            np.array(params["token_embedder"]["embedding"], dtype=np.float32))
    return out


def module_to_flax(module: nn.Module) -> dict[str, Any]:
    """A port module's parameters as a flax tree {"params": ...} of f32
    numpy arrays (the inverse of `flax_to_state_dict`)."""
    tree: dict[str, Any] = {}
    for mod_name, m in module.named_modules():
        for p_name, p in m.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            key = p_name
            if p_name == "weight":
                if isinstance(m, nn.Linear):
                    key, arr = "kernel", arr.T
                elif isinstance(m, nn.Conv2d):
                    key, arr = "kernel", arr.transpose(2, 3, 1, 0)
                elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                    key = "scale"
                elif isinstance(m, nn.Embedding):
                    key = "embedding"
            node = tree
            for part in filter(None, mod_name.split(".")):
                node = node.setdefault(part, {})
            node[key] = np.ascontiguousarray(arr)
    return {"params": tree}
