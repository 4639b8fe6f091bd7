"""The diffusion world-generation pipeline: prompt -> guardrail -> text
features -> EDM sampling of the video DiT -> tokenizer decode -> video
guardrail (counterpart of `DiffusionText2WorldPipeline` in
tclight_tpu/cosmos/pipelines.py).

Every component is injected (built from checkpoints or random weights);
the pipeline owns the orchestration and the offloading. Video2world
passes `condition_latent`: its latent frames are clamped into every x0
prediction, and a DiT with one input channel more than the latent (the
7B / 14B video2world net) also gets `condition_video_input_mask`, ones on
the conditioning frames and zeros after, the input the reference's
VideoExtendGeneralDIT concatenates (general_dit_video_conditioned.py:
100-104). The JAX package leaves that mask out, so its widened DiT fails
at the first call (ROADMAP C10); a DiT of the latent's width gets no mask,
as in JAX.

`ARVideo2WorldPipeline` is the autoregressive world model: the context
video's tokens (the video tokenizer's `encode` unpacks to (indices,
codes), as `cosmos/fsq.py`'s tokenizer gives them) prefill an
`ARGenerator`, which samples at temperature 1.0 and top-p 0.9; the new
tokens, cut to whole latent frames, are appended to the context's and
decoded; an optional `diffusion_decoder` then maps the decoded pixels.
The checkpoint-faithful DV tokenizer's `encode` returns three values, so
it needs an adapter to be handed in (ROADMAP C12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from tclight_torch.cosmos.conditioner import GeneralConditioner
from tclight_torch.cosmos.dit import make_edm_denoiser
from tclight_torch.cosmos.edm import rho_timesteps, sample_edm
from tclight_torch.cosmos.guardrails import GuardrailRunner
from tclight_torch.cosmos.offload import HostParams, OffloadPolicy, offload_component
from tclight_torch.utils.logging import get_logger

__all__ = ["DiffusionText2WorldPipeline", "ARVideo2WorldPipeline", "draw_noise",
           "condition_mask"]

log = get_logger()


def draw_noise(seed: int, shape: tuple, device) -> torch.Tensor:
    """The initial latent noise, N(0, I) f32 from a generator seeded with
    `seed` (the JAX package draws it from PRNGKey(seed))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def condition_mask(latent_shape: tuple, n_cond: int, device) -> torch.Tensor:
    """(B, T, H, W, 1): ones on the first n_cond latent frames, zeros after."""
    b, t, h, w, _ = latent_shape
    mask = torch.zeros((b, t, h, w, 1), dtype=torch.float32, device=device)
    mask[:, :n_cond] = 1.0
    return mask


@dataclasses.dataclass
class DiffusionText2WorldPipeline:
    """Text (and, for video2world, a condition latent) -> frames.
    `dit` is the GeneralDIT (or a HostParams around it); `encode_text`
    maps a prompt to cross-attention features, `decode_fn` latents to
    frames. With `mesh`, the DiT runs context-parallel."""

    dit: Any
    encode_text: Callable[[str], np.ndarray]
    decode_fn: Callable[[torch.Tensor], np.ndarray]
    conditioner: Optional[GeneralConditioner] = None
    text_guardrail: Optional[GuardrailRunner] = None
    video_guardrail: Optional[GuardrailRunner] = None
    guidance: float = 7.0
    n_steps: int = 35
    latent_shape: tuple = (1, 8, 16, 16, 16)   # (B, T, H, W, C)
    offload: OffloadPolicy = dataclasses.field(default_factory=OffloadPolicy)
    device: Any = "cuda"
    mesh: Any = None

    def __post_init__(self):
        if not isinstance(self.dit, HostParams):
            self.dit = HostParams(self.dit, offload=self.offload.network, device=self.device,
                                  name="dit")
        self.device = self.dit.device
        self.stage_times: dict = {}

    def _cfg_x0_fn(self, model, context, null_context, extra):
        cond_fn = make_edm_denoiser(model, context, mesh=self.mesh, **extra)
        uncond_fn = make_edm_denoiser(model, null_context, mesh=self.mesh, **extra)

        def x0_fn(x, sigma):
            c = cond_fn(x, sigma)
            u = uncond_fn(x, sigma)
            return u + self.guidance * (c - u)

        return x0_fn

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _sample(self, context, seed: int, condition_latent: torch.Tensor | None):
        """The network stage: with offload.network, the DiT is on the
        device only inside it."""
        null_context = torch.zeros_like(context)
        with self.dit.on_device() as model:
            extra = {}
            if model.cfg.in_channels == self.latent_shape[-1] + 1:
                n_cond = 0 if condition_latent is None else condition_latent.shape[1]
                extra["condition_video_input_mask"] = condition_mask(
                    self.latent_shape, n_cond, self.device)
            x0_fn = self._cfg_x0_fn(model, context, null_context, extra)
            if condition_latent is not None:
                # video2world: the conditioning frames clamped at every step
                n_cond, base_fn = condition_latent.shape[1], x0_fn

                def x0_fn(x, sigma):  # noqa: F811
                    out = base_fn(x, sigma).clone()
                    out[:, :n_cond] = condition_latent
                    return out

            noise = draw_noise(seed, self.latent_shape, self.device)
            steps = []
            t0 = time.perf_counter()

            def on_step(i):
                self._sync()
                steps.append(time.perf_counter() - t0 - sum(steps))

            latents = sample_edm(x0_fn, noise, rho_timesteps(n=self.n_steps), solver="heun",
                                 on_step=on_step)
            self.stage_times["step_seconds"] = steps
        return latents

    def __call__(self, prompt: str, seed: int = 0,
                 condition_latent: torch.Tensor | None = None) -> np.ndarray | None:
        if self.text_guardrail is not None:
            with offload_component(self.text_guardrail, self.offload.guardrails) as gr:
                res = gr.is_safe(prompt)
            if not res.is_safe:
                log.warning("prompt rejected by guardrail: %s", res.message)
                return None
        with offload_component(self.encode_text, self.offload.text_encoder) as enc:
            context = torch.as_tensor(np.asarray(enc(prompt)), dtype=torch.float32,
                                      device=self.device)
        if condition_latent is not None:
            condition_latent = condition_latent.to(self.device, torch.float32)
        t0 = time.perf_counter()
        latents = self._sample(context, seed, condition_latent)
        self._sync()
        self.stage_times["sample"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with offload_component(self.decode_fn, self.offload.tokenizer) as dec:
            frames = dec(latents)
        self._sync()
        self.stage_times["decode"] = time.perf_counter() - t0
        if self.video_guardrail is not None:
            with offload_component(self.video_guardrail, self.offload.guardrails) as gr:
                res = gr.is_safe(frames)
                if not res.is_safe:
                    log.warning("video rejected by guardrail: %s", res.message)
                    return None
                frames = gr.postprocess(frames)
        return frames


@dataclasses.dataclass
class ARVideo2WorldPipeline:
    """Video tokens -> prefill -> decode -> detokenize. `generator` is an
    `ARGenerator`; `video_tokenizer` a module whose `encode(video)` gives
    (indices (B, t, h, w), codes) and whose `decode_indices` gives
    (B, T, H, W, 3). `stage_times` holds the last call's encode,
    generate (with the generator's prefill and decode) and decode
    seconds."""

    generator: Any
    video_tokenizer: Any
    text_guardrail: Optional[GuardrailRunner] = None
    diffusion_decoder: Optional[Callable] = None
    max_gen_tokens: int = 256

    def __post_init__(self):
        self.stage_times: dict = {}

    def _device(self) -> torch.device:
        return next(self.video_tokenizer.parameters()).device

    def _clock(self) -> float:
        if self._device().type == "cuda":
            torch.cuda.synchronize(self._device())
        return time.perf_counter()

    @torch.inference_mode()
    def encode_video(self, video: np.ndarray) -> np.ndarray:
        idx, _ = self.video_tokenizer.encode(torch.as_tensor(np.asarray(video),
                                                             device=self._device()))
        return idx.cpu().numpy()

    @torch.inference_mode()
    def __call__(self, context_video: np.ndarray, prompt: str = "", seed: int = 0,
                 gumbel=None) -> np.ndarray | None:
        """`gumbel[i]` (B, vocab), when given, is decode step i's noise (JAX
        draws it from PRNGKey(seed)); else a generator seeded with `seed`
        draws it."""
        if prompt and self.text_guardrail is not None:
            res = self.text_guardrail.is_safe(prompt)
            if not res.is_safe:
                log.warning("prompt rejected: %s", res.message)
                return None
        device = self._device()
        t0 = self._clock()
        idx = self.encode_video(context_video)
        t1 = self._clock()
        b = idx.shape[0]
        gen = torch.Generator(device=device).manual_seed(seed)
        gen_tokens = self.generator.generate(
            prompt_tokens=idx.reshape(b, -1), max_gen_len=self.max_gen_tokens,
            temperature=1.0, top_p=0.9, generator=gen, gumbel=gumbel)
        t2 = self._clock()
        self.stage_times = {"encode": t1 - t0, "generate": t2 - t1,
                            **self.generator.last_times}
        # the new tokens as whole latent frames, after the context's
        t, h, w = idx.shape[1:]
        n_new = gen_tokens.shape[1] // (h * w)
        if n_new == 0:
            log.warning("generated fewer tokens than one latent frame")
            return None
        new_idx = gen_tokens[:, : n_new * h * w].reshape(b, n_new, h, w)
        self.tokens = np.concatenate([idx, new_idx], axis=1)
        video = self.video_tokenizer.decode_indices(
            torch.as_tensor(self.tokens, device=device))
        self.stage_times["decode"] = self._clock() - t2
        if self.diffusion_decoder is not None:
            video = self.diffusion_decoder(video)
        if isinstance(video, torch.Tensor):
            video = video.float().cpu().numpy()
        return np.asarray(video)
