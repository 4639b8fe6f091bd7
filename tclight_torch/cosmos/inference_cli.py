"""The text2world / video2world command lines: shared arguments, pipeline
assembly and the prompt loop (counterpart of
tclight_tpu/cosmos/inference_cli.py).

With a converted checkpoint under `--checkpoint_dir` (`<dit_dir>/model.pt`,
a Cosmos GeneralDIT state dict; `<tokenizer_dir>/model.pt`, a tokenizer
state dict) the models load through the converters; otherwise they take
random weights from seeds: `--model_size tiny` (the default) the tiny
DiT and tokenizer, `7b` / `14b` the published widths (`faditv2_7b` /
`_14b`, the CV8x8x8 tokenizer), built directly on the device in bf16 (f32
on the CPU). The text features are the JAX package's stand-in for T5: a
Gaussian draw seeded by Python's `hash(prompt)`, which is salted per
process.

For `--model_size 7b|14b`, video2world widens the DiT by one input
channel and adds the augment-sigma embedder, as the JAX CLI does (released
checkpoints carry no such embedder); the pipeline then feeds the
condition mask (pipelines.py, ROADMAP C10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import get_logger

__all__ = ["add_common_arguments", "read_prompts_from_file", "build_pipeline",
           "run_generation", "random_tokenizer_"]

log = get_logger()


def add_common_arguments(p: argparse.ArgumentParser) -> None:
    """The reference's add_common_arguments."""
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints",
                   help="base directory with converted checkpoints")
    p.add_argument("--tokenizer_dir", type=str, default="",
                   help="tokenizer subdir (defaults per pipeline)")
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--batch_input_path", type=str, default=None,
                   help="JSONL file with one {'prompt': ...} per line")
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--num_video_frames", type=int, default=121)
    p.add_argument("--height", type=int, default=704)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--disable_prompt_upsampler", action="store_true")
    p.add_argument("--disable_guardrail", action="store_true")
    p.add_argument("--offload_diffusion_transformer", action="store_true")
    p.add_argument("--offload_tokenizer", action="store_true")
    p.add_argument("--offload_text_encoder_model", action="store_true")
    p.add_argument("--offload_prompt_upsampler", action="store_true")
    p.add_argument("--offload_guardrail_models", action="store_true")
    p.add_argument("--model_size", choices=("tiny", "7b", "14b"), default="tiny",
                   help="DiT size; 'tiny' = random-weight demo models")


def read_prompts_from_file(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in (ln.strip() for ln in f) if line]


def _maybe_load_torch_state(path: str) -> Optional[dict]:
    if not os.path.isfile(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


@torch.no_grad()
def random_tokenizer_(module: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """Random tokenizer weights with flax's default scales, drawn from
    `gen` on the module's device: N(0, 1 / fan_in) convolutions, zero
    biases, unit norms."""
    for m in module.modules():
        if isinstance(m, torch.nn.Conv3d):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
            m.bias.zero_()
        elif isinstance(m, torch.nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def _on_device(cls, cfg, dev: torch.device) -> torch.nn.Module:
    """A module built on the meta device, then allocated on `dev`
    (nothing is materialised on the host)."""
    with torch.device("meta"):
        module = cls(cfg)
    return module.to_empty(device=dev)


def build_pipeline(args, video2world: bool = False, device="cuda", mesh=None):
    """A DiffusionText2WorldPipeline and its VideoTokenizer from CLI args."""
    from tclight_torch.cosmos.convert_dit import convert_general_dit
    from tclight_torch.cosmos.convert_dv import convert_dv_tokenizer
    from tclight_torch.cosmos.cv_tokenizer import (CausalContinuousVideoTokenizer,
                                                   VideoTokenizer, cv_config_8x8x8)
    from tclight_torch.cosmos.dit import DiTConfig, GeneralDIT, init_dit_
    from tclight_torch.cosmos.guardrails import presets_text
    from tclight_torch.cosmos.offload import HostParams, OffloadPolicy
    from tclight_torch.cosmos.pipelines import DiffusionText2WorldPipeline

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if args.model_size == "tiny":
        dit_cfg = DiTConfig.tiny(dtype=dtype)
        cv_cfg = cv_config_8x8x8(
            channels=16, channels_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64, patch_size=2, spatial_compression=8, temporal_compression=4,
            z_channels=8, embedding_dim=dit_cfg.in_channels, dtype=dtype)
        pcd, tcf = 5, 4
    else:
        dit_cfg = (DiTConfig.faditv2_7b if args.model_size == "7b" else
                   DiTConfig.faditv2_14b)(dtype=dtype)
        if video2world:
            dit_cfg = dataclasses.replace(dit_cfg, in_channels=dit_cfg.in_channels + 1,
                                          add_augment_sigma_embedding=True)
        cv_cfg = cv_config_8x8x8(dtype=dtype)
        pcd, tcf = 121, 8
    lcd = (pcd - 1) // tcf + 1
    t_lat = max(args.num_video_frames // pcd, 1) * lcd
    latent_ch = cv_cfg.embedding_dim
    latent_shape = (1, t_lat, args.height // 8, args.width // 8, latent_ch)

    dit = _on_device(GeneralDIT, dit_cfg, dev)
    dit_dir = os.path.join(args.checkpoint_dir, getattr(args, "diffusion_transformer_dir", ""))
    sd = _maybe_load_torch_state(os.path.join(dit_dir, "model.pt"))
    if sd is not None:
        dit.load_state_dict(convert_general_dit(sd, dit))
        log.info("loaded DiT checkpoint from %s", dit_dir)
    else:
        init_dit_(dit, torch.Generator(device=dev).manual_seed(0))
        log.info("no DiT checkpoint at %s - using random init", dit_dir)
    dit.eval().requires_grad_(False)

    cv = _on_device(CausalContinuousVideoTokenizer, cv_cfg, dev)
    tok_dir = os.path.join(args.checkpoint_dir,
                           args.tokenizer_dir or "Cosmos-1.0-Tokenizer-CV8x8x8")
    tok_sd = _maybe_load_torch_state(os.path.join(tok_dir, "model.pt"))
    if tok_sd is not None:
        cv.load_state_dict(convert_dv_tokenizer(tok_sd, cv))
        log.info("loaded tokenizer checkpoint from %s", tok_dir)
    else:
        random_tokenizer_(cv, torch.Generator(device=dev).manual_seed(1))
        log.info("no tokenizer checkpoint at %s - using random init", tok_dir)
    cv.eval().requires_grad_(False)
    tokenizer = VideoTokenizer(cv, pixel_chunk_duration=pcd, temporal_compression_factor=tcf)

    def encode_text(prompt: str) -> np.ndarray:
        # the JAX package's stand-in for T5: a draw seeded by the prompt
        seed = abs(hash(prompt)) % (2 ** 31)
        return np.random.default_rng(seed).standard_normal(
            (1, 32, dit_cfg.context_dim)).astype(np.float32)

    class _ChunkedDecode:
        """Latents -> frames in [0, 1] (numpy) through the chunked
        tokenizer; offloadable (acquire / release)."""

        def __init__(self, tok, offload: bool):
            self.tok, self.params = tok, HostParams(tok.module, offload, dev, "tokenizer")

        def __call__(self, latents):
            video = self.tok.decode(latents)
            return torch.clamp((video + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()

        def acquire(self):
            self.params.acquire()

        def release(self):
            self.params.release()

    policy = OffloadPolicy(network=args.offload_diffusion_transformer,
                           tokenizer=args.offload_tokenizer,
                           text_encoder=args.offload_text_encoder_model,
                           prompt_upsampler=args.offload_prompt_upsampler,
                           guardrails=args.offload_guardrail_models)
    pipeline = DiffusionText2WorldPipeline(
        dit=HostParams(dit, offload=policy.network, device=dev, name="dit"),
        encode_text=encode_text, decode_fn=_ChunkedDecode(tokenizer, policy.tokenizer),
        text_guardrail=None if args.disable_guardrail else presets_text(device=dev),
        guidance=args.guidance, n_steps=args.num_steps, latent_shape=latent_shape,
        offload=policy, device=dev, mesh=mesh)
    return pipeline, tokenizer


def run_generation(args, pipeline, tokenizer, condition_video: np.ndarray | None = None,
                   ) -> int:
    """The prompt loop and the saving: `<video_save_name>.mp4` and `.txt`
    (or `<i>.mp4` per line of --batch_input_path). Returns 0 when at least
    one video was written."""
    from tclight_torch.utils.video_io import save_video

    prompts = (read_prompts_from_file(args.batch_input_path) if args.batch_input_path
               else [{"prompt": args.prompt or ""}])
    os.makedirs(args.video_save_folder, exist_ok=True)
    cond_latent = None
    if condition_video is not None:
        video = torch.as_tensor(condition_video, dtype=torch.float32, device=pipeline.device)
        cond_latent = tokenizer.encode(video)[:, :1]
    n_ok = 0
    for i, item in enumerate(prompts):
        prompt = item.get("prompt")
        if prompt is None:
            log.error("prompt missing, skipping")
            continue
        video = pipeline(prompt, seed=args.seed, condition_latent=cond_latent)
        if video is None:
            log.error("guardrail blocked generation for prompt %d", i)
            continue
        stem = f"{i}" if args.batch_input_path else args.video_save_name
        path = os.path.join(args.video_save_folder, f"{stem}.mp4")
        save_video(video[0], path, fps=args.fps)
        with open(os.path.join(args.video_save_folder, f"{stem}.txt"), "w") as f:
            f.write(prompt)
        log.info("saved video to %s", path)
        n_ok += 1
    return 0 if n_ok else 1
