"""DDIM inversion, the first stage of the generic-SD editing path
(counterpart of tclight_tpu/pipeline/invert.py).

The frames are VAE-encoded, then run through the reversed DDIM schedule
(no CFG, the frames in batches) to noise; `noisy_latents_{t}` is saved at
the timesteps of a `save_steps`-step schedule (with `save_intermediate`)
and at the first generation timestep, and optionally the latents are
sampled back and decoded as a check (`recon`). On the sd-depth stack
(a 5-channel UNet) every UNet call takes the frames' DPT depth maps as
its fifth channel (`_prepare_depth`: an injected `depth_fn`, else the DPT
of `generation.depth_ckpt`). The cache is the JAX
package's, so a cache written by either package is read by the other: one
`noisy_latents_{round(t)}.npy` per timestep, an (N, h, w, 4) f32 numpy
array (NHWC), indexed by frame id when loaded.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tclight_torch.diffusion.schedulers import DDIMScheduler
from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import get_logger

__all__ = ["latent_filename", "check_latent_exists", "load_latent", "Inverter"]

log = get_logger()


def latent_filename(save_path: str | Path, t: float | int) -> Path:
    return Path(save_path) / f"noisy_latents_{int(round(float(t)))}.npy"


def check_latent_exists(save_path, t, frame_ids: Sequence[int] | None = None) -> bool:
    f = latent_filename(save_path, t)
    if not f.exists():
        return False
    if frame_ids is not None:
        return np.load(f, mmap_mode="r").shape[0] >= len(frame_ids)
    return True


def load_latent(save_path, t, frame_ids: Sequence[int] | None = None) -> np.ndarray:
    """The cached latents at timestep t; with `frame_ids`, the rows of
    those frame ids (not positions)."""
    arr = np.load(latent_filename(save_path, t))
    return arr if frame_ids is None else arr[list(frame_ids)]


class Inverter:
    """DDIM inversion of a video; `config.inversion` holds steps, batch_size,
    save_steps, save_intermediate, recon, force and prompt. A call that
    inverts records its wall time in `stage_times["inversion"]`."""

    def __init__(self, models, config, data_parser=None,
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        if models.device.type != self.device.type:
            raise ValueError(f"models are on {models.device}, the Inverter runs on "
                             f"{self.device}")
        self.models = models
        self.config = config
        inv = config.get("inversion", {})
        self.steps = int(inv.get("steps", 50) or 50)
        self.batch_size = int(inv.get("batch_size", 8) or 8)
        self.save_steps = int(inv.get("save_steps", 50) or 50)
        self.save_intermediate = bool(inv.get("save_intermediate", False))
        self.recon = bool(inv.get("recon", False))
        self.force = bool(inv.get("force", False))
        self.prompt = inv.get("prompt", "") or ""
        self.data_parser = data_parser
        self.stage_times: dict = {}
        self.scheduler = DDIMScheduler(num_inference_steps=self.steps)
        # the timesteps of a save_steps-step schedule: with leading spacing
        # and save_steps dividing steps, a subset of the inversion's, and
        # every latent PnP needs when n_timesteps == save_steps
        self.timesteps_to_save = {
            int(t) for t in DDIMScheduler(num_inference_steps=self.save_steps).timesteps()}
        # (frames, latent_hw) -> (N, lh, lw, 1) depth maps in place of the DPT
        self.depth_fn = None

    @torch.inference_mode()
    def _encode_text(self, prompt: str) -> torch.Tensor:
        """One 77-token chunk: BOS, at most 75 ids, EOS, EOS padding."""
        tok = self.models.tokenizer
        n = tok.model_max_length
        ids = tok(prompt, truncation=False, add_special_tokens=False)["input_ids"]
        ids = [tok.bos_token_id] + ids[: n - 2] + [tok.eos_token_id]
        ids = ids + [tok.eos_token_id] * (n - len(ids))
        return self.models.text_encoder(torch.tensor([ids], device=self.device))

    def _prepare_depth(self, frames: np.ndarray, latent_hw) -> torch.Tensor:
        """The sd-depth stack's depth channel (N, lh, lw, 1) on the device:
        `depth_fn`, else the DPT checkpoint of `generation.depth_ckpt`
        (FileNotFoundError without one)."""
        if self.depth_fn is not None:
            depth = self.depth_fn(frames, latent_hw)
        else:
            from tclight_torch.models.dpt import load_dpt, prepare_depth_maps

            ckpt = (self.config.get("generation", {}) or {}).get("depth_ckpt")
            if not ckpt or not Path(str(ckpt)).exists():
                raise FileNotFoundError("sd-depth inversion needs generation.depth_ckpt")
            depth = prepare_depth_maps(load_dpt(ckpt, self.device), frames, latent_hw)
        return torch.as_tensor(np.asarray(depth), dtype=torch.float32, device=self.device)

    def _unet_eps(self, x: torch.Tensor, t: float, cond: torch.Tensor,
                  depth: torch.Tensor | None = None) -> torch.Tensor:
        unet = self.models.unet
        dtype = unet.config.dtype
        if depth is not None:
            x = torch.cat([x, depth.to(x.dtype)], dim=-1)
        eps, _ = unet(x.to(dtype), t, cond.expand(x.shape[0], -1, -1).to(dtype))
        return eps

    def _run(self, x: torch.Tensor, cond: torch.Tensor, i: int, inversion: bool,
             depth: torch.Tensor | None = None):
        t = float(self.scheduler.timesteps()[i])
        bs = self.batch_size
        outs = [self.scheduler.step(
            self._unet_eps(x[j: j + bs], t, cond, None if depth is None else depth[j: j + bs]),
            i, x[j: j + bs], inversion=inversion) for j in range(0, x.shape[0], bs)]
        return torch.cat(outs)

    @torch.inference_mode()
    def ddim_inversion(self, latents: torch.Tensor, cond: torch.Tensor,
                       save_path: str | Path, depth: torch.Tensor | None = None
                       ) -> torch.Tensor:
        """x0 latents (N, h, w, 4) -> noise by the reversed DDIM steps, low t
        to high t; saves the cache along the way."""
        ts = self.scheduler.timesteps()
        save_path = Path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        x = latents
        for i in reversed(range(len(ts))):
            x = self._run(x, cond, i, inversion=True, depth=depth)
            if self.save_intermediate and int(ts[i]) in self.timesteps_to_save:
                np.save(latent_filename(save_path, ts[i]), x.float().cpu().numpy())
        np.save(latent_filename(save_path, ts[0]), x.float().cpu().numpy())
        return x

    @torch.inference_mode()
    def ddim_sample(self, x: torch.Tensor, cond: torch.Tensor,
                    depth: torch.Tensor | None = None) -> torch.Tensor:
        """Plain DDIM sampling back from the inverted noise."""
        for i in range(len(self.scheduler.timesteps())):
            x = self._run(x, cond, i, inversion=False, depth=depth)
        return x

    @torch.inference_mode()
    def encode_imgs_batch(self, frames: np.ndarray) -> torch.Tensor:
        vae, scale = self.models.vae, self.models.latent_scale
        outs = []
        for i in range(0, len(frames), self.batch_size):
            x = torch.from_numpy(np.ascontiguousarray(frames[i: i + self.batch_size]))
            mean, _ = vae.encode(2.0 * x.to(self.device) - 1.0)
            outs.append(mean * scale)
        return torch.cat(outs)

    @torch.inference_mode()
    def __call__(self, save_path: str | Path, frame_ids: Sequence[int]) -> None:
        t0 = float(self.scheduler.timesteps()[0])
        if not self.force and check_latent_exists(save_path, t0, frame_ids):
            log.info("inverted latents found at %s; skipping", save_path)
            return
        t_s = time.perf_counter()
        frames = self.data_parser.load_video(frame_ids=frame_ids)
        cond = self._encode_text(self.prompt)
        latents = self.encode_imgs_batch(frames)
        depth = None
        if self.models.unet.config.in_channels == 5:
            depth = self._prepare_depth(frames, tuple(latents.shape[1:3]))
        noisy = self.ddim_inversion(latents, cond, save_path, depth)
        if self.recon:
            from tclight_torch.utils.video_io import save_frames

            recon = self.ddim_sample(noisy, cond, depth)
            imgs = self.models.vae.decode(recon / self.models.latent_scale)
            imgs = torch.clamp(imgs / 2 + 0.5, 0, 1).float().cpu().numpy()
            save_frames(imgs, Path(save_path) / "recon")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_times["inversion"] = time.perf_counter() - t_s
