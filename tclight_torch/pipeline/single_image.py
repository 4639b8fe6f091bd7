"""Single-image IC-Light relighting, the demos' compute path (counterpart of
tclight_tpu/pipeline/single_image.py).

`SingleImageRelighter.process` is the fc demo (8-channel UNet: the
foreground on grey, lit by the prompt and an initial-latent light
direction, then a high-resolution img2img pass); `process_bg` the fbc demo
(12-channel UNet: foreground and background latents). The UI wrappers are
`tclight_torch.gradio_demo_iclight` / `gradio_demo_bg_iclight`.

Noise: every pass (the low-resolution pass, then the high-resolution one)
takes an init noise and one SDE noise per step. A `noises` list of
(init, [step noises]) per pass injects them (the tests inject the JAX
package's draws); without it they are drawn from `torch.Generator`s seeded
`seed` (low-resolution) and `seed + 1` (high-resolution) on the models'
device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from tclight_torch.pipeline.iclight import ICLightModels, encode_prompt_pair

__all__ = ["BGSource", "BGSourceFBC", "gradient_background", "fbc_background",
           "resize_and_center_crop", "run_rmbg_composite", "normals_from_relights",
           "SingleImageRelighter"]


class BGSource(enum.Enum):
    """fc demo's initial-latent light directions."""

    NONE = "None"
    LEFT = "Left Light"
    RIGHT = "Right Light"
    TOP = "Top Light"
    BOTTOM = "Bottom Light"


class BGSourceFBC(enum.Enum):
    """fbc demo's background sources."""

    UPLOAD = "Use Background Image"
    UPLOAD_FLIP = "Use Flipped Background Image"
    LEFT = "Left Light"
    RIGHT = "Right Light"
    TOP = "Top Light"
    BOTTOM = "Bottom Light"
    GREY = "Ambient"


def gradient_background(h: int, w: int, source: BGSource) -> np.ndarray:
    """fc light-direction ramp in [0, 1] (black for NONE), (h, w, 3) f32."""
    if source == BGSource.LEFT:
        g = np.linspace(1.0, 0.0, w)[None, :, None]
    elif source == BGSource.RIGHT:
        g = np.linspace(0.0, 1.0, w)[None, :, None]
    elif source == BGSource.TOP:
        g = np.linspace(1.0, 0.0, h)[:, None, None]
    elif source == BGSource.BOTTOM:
        g = np.linspace(0.0, 1.0, h)[:, None, None]
    else:
        g = np.full((h, w, 1), 0.0)
    return np.broadcast_to(g, (h, w, 3)).astype(np.float32)


def fbc_background(h: int, w: int, source: BGSourceFBC,
                   input_bg: Optional[np.ndarray] = None) -> np.ndarray:
    """fbc background in [0, 1]: the given image (or its mirror), ramps
    from 224 to 32 in uint8 terms, or a flat 64 (GREY)."""
    hi, lo = 224.0 / 255.0, 32.0 / 255.0
    if source in (BGSourceFBC.UPLOAD, BGSourceFBC.UPLOAD_FLIP):
        if input_bg is None:
            raise ValueError(f"{source.value} needs a background image")
        return input_bg if source == BGSourceFBC.UPLOAD else np.fliplr(input_bg)
    if source == BGSourceFBC.GREY:
        return np.full((h, w, 3), 64.0 / 255.0, np.float32)
    if source == BGSourceFBC.LEFT:
        g = np.linspace(hi, lo, w)[None, :, None]
    elif source == BGSourceFBC.RIGHT:
        g = np.linspace(lo, hi, w)[None, :, None]
    elif source == BGSourceFBC.TOP:
        g = np.linspace(hi, lo, h)[:, None, None]
    else:
        g = np.linspace(lo, hi, h)[:, None, None]
    return np.broadcast_to(g, (h, w, 3)).astype(np.float32)


def resize_and_center_crop(img: np.ndarray, tw: int, th: int) -> np.ndarray:
    """Aspect-preserving Lanczos resize to cover (th, tw), then a centre crop."""
    import cv2

    h, w = img.shape[:2]
    k = max(tw / w, th / h)
    rw, rh = int(round(w * k)), int(round(h * k))
    r = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LANCZOS4)
    top, left = (rh - th) // 2, (rw - tw) // 2
    return r[top: top + th, left: left + tw]


def run_rmbg_composite(rmbg, img: np.ndarray, sigma: float = 0.0):
    """The foreground of a [0, 1] image on grey through BriaRMBG's matte:
    127 + (img - 127 + sigma) * alpha in uint8 terms. Returns (composite,
    alpha (H, W, 1))."""
    from tclight_torch.models.briarmbg import compute_alpha_mattes

    alpha = compute_alpha_mattes(rmbg, img[None])[0][..., None]
    grey = 127.0 / 255.0
    out = grey + (img - grey + sigma / 255.0) * alpha
    return np.clip(out, 0.0, 1.0).astype(np.float32), alpha


def normals_from_relights(left: np.ndarray, right: np.ndarray, bottom: np.ndarray,
                          top: np.ndarray, matting: np.ndarray, sigma: float = 10.0):
    """Photometric-stereo normals from four directional relights: each
    image over the four's mean, the horizontal and vertical ratios as the
    normal's u and v, z sharpened by `sigma`; outside the matte the normal
    faces the camera. Returns (normal in [-1, 1], [l, r, b, t] ratios)."""
    ambient = (left + right + bottom + top) / 4.0

    def safe_divide(a, b):
        e = 1e-5
        return ((a + e) / (b + e)) - 1.0

    l, r = safe_divide(left, ambient), safe_divide(right, ambient)
    b, t = safe_divide(bottom, ambient), safe_divide(top, ambient)
    u = np.mean((r - l) * 0.5, axis=2)
    v = np.mean((t - b) * 0.5, axis=2)
    h = (1.0 - u ** 2.0 - v ** 2.0).clip(0, 1e5) ** (0.5 * sigma)
    z = np.zeros_like(h)
    normal = np.stack([u, v, h], axis=2)
    normal /= np.sum(normal ** 2.0, axis=2, keepdims=True) ** 0.5
    normal = normal * matting + np.stack([z, z, 1 - z], axis=2) * (1 - matting)
    return normal, [l, r, b, t]


@dataclasses.dataclass
class SingleImageRelighter:
    """process(): fc relighting with the optional high-resolution pass;
    process_bg(): fbc relighting with a background condition. The models'
    scheduler is IC-Light's DPM-Solver++ (SDE)."""

    models: ICLightModels
    steps: int = 25
    guidance_scale: float = 2.0
    negative_prompt: str = "lowres, bad anatomy, bad hands, cropped, worst quality"
    added_prompt: str = "best quality"

    @property
    def device(self) -> torch.device:
        return self.models.device

    @property
    def _factor(self) -> int:
        return 2 ** (len(self.models.vae.config.block_out_channels) - 1)

    @torch.inference_mode()
    def _vae_encode(self, img: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(img[None], dtype=np.float32))
        mean, _ = self.models.vae.encode(2.0 * x.to(self.device) - 1.0)
        return mean * self.models.latent_scale

    @torch.inference_mode()
    def _vae_decode(self, z: torch.Tensor) -> np.ndarray:
        img = self.models.vae.decode(z / self.models.latent_scale)
        return torch.clamp(img / 2 + 0.5, 0, 1).float().cpu().numpy()[0]

    def _noise(self, noise, shape, generator: torch.Generator) -> torch.Tensor:
        if noise is None:
            return torch.randn(shape, generator=generator, device=self.device)
        return torch.from_numpy(np.array(noise, np.float32)).to(self.device)

    def _pass_noises(self, noises, index: int, seed: int):
        """(init, step noises, generator) of pass `index`: injected, or
        drawn from a generator seeded `seed`."""
        if noises is not None:
            init, steps = noises[index]
            return init, list(steps), None
        return None, None, torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def _sample(self, x, concat_latent, cond, uncond, step_noises, generator,
                start_step: int = 0, total_steps: Optional[int] = None) -> torch.Tensor:
        """CFG sampling of `x` from ladder position `start_step` of a
        `total_steps`-step schedule (`steps` by default)."""
        sched = dataclasses.replace(self.models.scheduler,
                                    num_inference_steps=total_steps or self.steps)
        unet = self.models.unet
        dtype = unet.config.dtype
        cc = torch.cat([concat_latent, concat_latent])
        ctx = torch.cat([uncond, cond]).to(dtype)
        state = sched.init_state(x)._replace(step_index=start_step)
        for j, t in enumerate(sched.timesteps()[start_step:]):
            inp = torch.cat([torch.cat([x, x]), cc], dim=-1).to(dtype)
            eps, _ = unet(inp, float(t), ctx)
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + self.guidance_scale * (eps_c - eps_u)
            noise = self._noise(None if step_noises is None else step_noises[j], x.shape,
                                generator)
            state, x = sched.step(state, eps, x, noise)
        return x

    def _img2img(self, image_latent, concat_latent, cond, uncond, denoise: float,
                 noises, index: int, seed: int) -> torch.Tensor:
        """img2img as the demos call diffusers' pipeline (strength=denoise,
        num_inference_steps=round(steps / denoise)): the latent noised to
        the (1 - denoise) point of that stretched schedule, then about
        `steps` denoising steps."""
        n = int(round(self.steps / denoise))
        start = max(n - min(int(n * denoise), n), 0)
        sched = dataclasses.replace(self.models.scheduler, num_inference_steps=n)
        init, step_noises, gen = self._pass_noises(noises, index, seed)
        x0 = sched.add_noise(image_latent, self._noise(init, image_latent.shape, gen), start)
        return self._sample(x0, concat_latent, cond, uncond, step_noises, gen,
                            start_step=start, total_steps=n)

    def _size(self, input_fg, lowres_size, image_width, image_height):
        """(fg at the working size, h, w): the demos' sliders rounded to
        64, or the longer side at `lowres_size`."""
        import cv2

        if image_width and image_height:
            w = int(round(image_width / 64)) * 64
            h = int(round(image_height / 64)) * 64
            return resize_and_center_crop(input_fg, w, h), h, w
        h0, w0 = input_fg.shape[:2]
        scale = lowres_size / max(h0, w0)
        h = int(round(h0 * scale / 64)) * 64
        w = int(round(w0 * scale / 64)) * 64
        return cv2.resize(input_fg, (w, h)), h, w

    def _highres(self, img, h, w, highres_scale, highres_denoise, encode_concat, cond,
                 uncond, noises, seed):
        """The high-resolution img2img pass (pass 1) from the upscaled result."""
        import cv2

        hh = int(round(h * highres_scale / 64)) * 64
        ww = int(round(w * highres_scale / 64)) * 64
        concat_hi = encode_concat(ww, hh)
        latent_hi = self._vae_encode(cv2.resize(img, (ww, hh)))
        x = self._img2img(latent_hi, concat_hi, cond, uncond, highres_denoise, noises, 1,
                          seed + 1)
        return self._vae_decode(x)

    def process(self, input_fg: np.ndarray, prompt: str, bg_source: BGSource = BGSource.NONE,
                seed: int = 12345, highres_scale: float = 1.5, highres_denoise: float = 0.5,
                lowres_denoise: float = 0.9, lowres_size: int = 512,
                image_width: Optional[int] = None, image_height: Optional[int] = None,
                noises=None) -> np.ndarray:
        """fc relighting of a [0, 1] foreground on grey (H, W, 3): a text-to-
        image pass from noise (NONE), or img2img from the light direction's
        ramp at `lowres_denoise`; then, with `highres_scale` > 1, img2img at
        the upscaled size. Returns the relit image in [0, 1]."""
        import cv2

        if self.models.unet.config.in_channels != 8:
            raise ValueError("fc relighting needs the 8-channel UNet")
        fg, h, w = self._size(input_fg, lowres_size, image_width, image_height)
        cond, uncond = encode_prompt_pair(self.models, f"{prompt}, {self.added_prompt}",
                                          self.negative_prompt)
        concat = self._vae_encode(fg)
        if bg_source == BGSource.NONE:
            init, step_noises, gen = self._pass_noises(noises, 0, seed)
            shape = (1, h // self._factor, w // self._factor,
                     self.models.vae.config.latent_channels)
            x = self._sample(self._noise(init, shape, gen), concat, cond, uncond,
                             step_noises, gen)
        else:
            # the ramp's latent is the initial latent: it steers the light
            bg_latent = self._vae_encode(gradient_background(h, w, bg_source))
            x = self._img2img(bg_latent, concat, cond, uncond, lowres_denoise, noises, 0,
                              seed)
        img = self._vae_decode(x)
        if highres_scale and highres_scale > 1.0:
            img = self._highres(
                img, h, w, highres_scale, highres_denoise,
                lambda ww, hh: self._vae_encode(cv2.resize(fg, (ww, hh))),
                cond, uncond, noises, seed)
        return img

    def process_bg(self, input_fg: np.ndarray, input_bg: Optional[np.ndarray], prompt: str,
                   bg_source: BGSourceFBC = BGSourceFBC.UPLOAD, seed: int = 12345,
                   highres_scale: float = 1.5, highres_denoise: float = 0.5,
                   lowres_size: int = 512, image_width: Optional[int] = None,
                   image_height: Optional[int] = None, noises=None) -> np.ndarray:
        """fbc relighting: the foreground and the background of `bg_source`
        as concat conditions, a text-to-image pass from noise, then the
        high-resolution img2img pass with both re-encoded at its size."""
        import cv2

        if self.models.unet.config.in_channels != 12:
            raise ValueError("fbc relighting needs the 12-channel UNet")
        fg, h, w = self._size(input_fg, lowres_size, image_width, image_height)
        bg = resize_and_center_crop(fbc_background(h, w, bg_source, input_bg), w, h)
        cond, uncond = encode_prompt_pair(self.models, f"{prompt}, {self.added_prompt}",
                                          self.negative_prompt)

        def enc_pair(f, b):
            return torch.cat([self._vae_encode(f), self._vae_encode(b)], dim=-1)

        init, step_noises, gen = self._pass_noises(noises, 0, seed)
        shape = (1, h // self._factor, w // self._factor, self.models.vae.config.latent_channels)
        x = self._sample(self._noise(init, shape, gen), enc_pair(fg, bg), cond, uncond,
                         step_noises, gen)
        img = self._vae_decode(x)
        if highres_scale and highres_scale > 1.0:
            img = self._highres(
                img, h, w, highres_scale, highres_denoise,
                lambda ww, hh: enc_pair(cv2.resize(fg, (ww, hh)), cv2.resize(bg, (ww, hh))),
                cond, uncond, noises, seed)
        return img
