"""The TC-Light relighting pipeline, xy-only sampling without the
post-optimization (counterpart of tclight_tpu/pipeline/generator.py).

Stages: load the video, VAE-encode the frames as IC-Light concat
conditions, CLIP-encode the prompts, run the DPM++ (SDE) steps over random
chunk plans with VidToMe token merging, VAE-decode, write the mp4s.

Each step runs its chunk slots in order in a Python loop that carries the
global token banks from slot to slot, as `_slot0_core` / `_group_core` do
in JAX. Random choices come from host numpy generators seeded like the JAX
package's, so both packages draw the same chunk plans, dst frames and
flips; the Gaussian noise comes from `torch.Generator`s, or from the
caller (`init_noise`, `step_noises`).

Not ported in this slice, and refused with NotImplementedError: the yt
pass (`alpha_t > 0`), the post-optimization (`apply_opt: true`), PnP and
ControlNet (`control != none`), background conditioning, the int8
attention variants and the prompt upsampler (a missing prompt).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from tclight_torch.config import ConfigDict, save_config
from tclight_torch.models.unet import ToMeSpec
from tclight_torch.pipeline import chunks as chunklib
from tclight_torch.pipeline.iclight import ICLightModels
from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import CostTracker, get_logger
from tclight_torch.utils.video_io import save_frames, save_video

log = get_logger()


def _cfg_get(cfg, key, default=None):
    if cfg is None:
        return default
    v = cfg.get(key, default)
    return default if v is None else v


class Generator:
    def __init__(self, models: ICLightModels, config, data_parser=None,
                 device: str | torch.device | None = "cuda"):
        self.device = resolve_device(device)
        if models.device.type != self.device.type:
            raise ValueError(f"models are on {models.device}, the Generator "
                             f"runs on {self.device}")
        self.config = config
        gen = config.get("generation", {})
        self.guidance_scale = _cfg_get(gen, "guidance_scale", 2.0)
        self.n_timesteps = _cfg_get(gen, "n_timesteps", 25)
        self.chunk_size = _cfg_get(gen, "chunk_size", 4)
        self.chunk_ord = _cfg_get(gen, "chunk_ord", "mix-4")
        self.negative_prompt = _cfg_get(gen, "negative_prompt", "")
        self.noise_mode = _cfg_get(gen, "noise_mode", "same")
        self.alpha_t = _cfg_get(gen, "alpha_t", 0.0)
        self.save_frame = _cfg_get(gen, "save_frame", True)
        self.prompts = dict(_cfg_get(gen, "prompt", {"default": None}))
        self.seed = int(config.get("seed", 12345))
        control = str(_cfg_get(gen, "control", "none") or "none")
        post = config.get("post_opt", {})
        self.apply_opt = _cfg_get(post, "apply_opt", True)
        refused = {
            "generation.alpha_t > 0 (the yt pass)": self.alpha_t > 0,
            "post_opt.apply_opt: true (the post-optimization)": self.apply_opt,
            f"generation.control: {control} (PnP / ControlNet)": control != "none",
            "generation.background_cond": bool(_cfg_get(gen, "background_cond", False)),
            "generation.attn_qk_int8 (int8 attention)": bool(_cfg_get(gen, "attn_qk_int8", False)),
        }
        for what, hit in refused.items():
            if hit:
                raise NotImplementedError(f"{what} is not ported yet")

        self.tome_spec = ToMeSpec(
            n_frames=self.chunk_size,
            local_ratio=_cfg_get(gen, "local_merge_ratio", 0.6),
            merge_global=_cfg_get(gen, "merge_global", True),
            global_ratio=_cfg_get(gen, "global_merge_ratio", 0.5),
            align_batch=bool(_cfg_get(gen, "align_batch", True)),
            max_downsample=_cfg_get(gen, "max_downsample", 2),
        )
        self.global_rand = _cfg_get(gen, "global_rand", 0.5)
        self.cfg_dedup = bool(_cfg_get(gen, "cfg_dedup", True))
        self.models = models.with_tome(self.tome_spec)
        self.scheduler = dataclasses.replace(
            models.scheduler, num_inference_steps=self.n_timesteps)
        self.data_parser = data_parser
        self._vae_batch = 8
        self.stage_times: dict = {}
        self._last_step_times: list[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ prompts

    @torch.inference_mode()
    def encode_prompt_inner(self, txt: str) -> torch.Tensor:
        """Chunked >77-token CLIP encoding. Returns (1, k*77, hidden)."""
        tok = self.models.tokenizer
        max_length = tok.model_max_length
        chunk_length = max_length - 2
        ids = tok(txt, truncation=False, add_special_tokens=False)["input_ids"]
        chunks_ = [[tok.bos_token_id] + ids[i: i + chunk_length] + [tok.eos_token_id]
                   for i in range(0, max(len(ids), 1), chunk_length)]
        chunks_ = [c + [tok.eos_token_id] * (max_length - len(c)) for c in chunks_]
        token_ids = torch.tensor(chunks_, dtype=torch.long, device=self.device)
        conds = self.models.text_encoder(token_ids)
        return conds.reshape(1, -1, conds.shape[-1])

    def encode_prompt_pair(self, positive: str, negative: str):
        """(cond, uncond), both (1, S, hidden), repeated to equal chunk
        counts."""
        c = self.encode_prompt_inner(positive)
        uc = self.encode_prompt_inner(negative)
        lc, luc = c.shape[1] // 77, uc.shape[1] // 77
        max_chunk = max(lc, luc)
        if lc < max_chunk:
            c = torch.cat([c] * math.ceil(max_chunk / lc), dim=1)[:, : max_chunk * 77]
        if luc < max_chunk:
            uc = torch.cat([uc] * math.ceil(max_chunk / luc), dim=1)[:, : max_chunk * 77]
        return c, uc

    # ---------------------------------------------------------------- VAE

    @property
    def vae_factor(self) -> int:
        return 2 ** (len(self.models.vae.config.block_out_channels) - 1)

    def _vae_batch_for(self, h: int, w: int) -> int:
        """Resolution-scaled VAE batch (8 at 512x512, 3 at 960x720)."""
        return max(1, min(self._vae_batch,
                          int(self._vae_batch * (512 * 512) / max(h * w, 1))))

    @torch.inference_mode()
    def encode_imgs_batch(self, frames: np.ndarray) -> torch.Tensor:
        """[0, 1] frames (N, H, W, 3) -> scaled latents (posterior mean *
        0.18215), (N, h, w, 4) f32 on the device."""
        bs = self._vae_batch_for(frames.shape[1], frames.shape[2])
        vae, scale = self.models.vae, self.models.latent_scale
        outs = []
        for i in range(0, len(frames), bs):
            x = torch.from_numpy(np.ascontiguousarray(frames[i: i + bs])).to(self.device)
            mean, _ = vae.encode(2.0 * x - 1.0)
            outs.append(mean * scale)
        return torch.cat(outs)

    @torch.inference_mode()
    def decode_latents_batch(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> frames (N, H, W, 3) in [0, 1], f32 on the device."""
        f = self.vae_factor
        bs = self._vae_batch_for(latents.shape[1] * f, latents.shape[2] * f)
        vae, scale = self.models.vae, self.models.latent_scale
        outs = [torch.clamp(vae.decode(latents[i: i + bs] / scale) / 2.0 + 0.5, 0.0, 1.0)
                for i in range(0, len(latents), bs)]
        return torch.cat(outs)

    # ------------------------------------------------------------ denoise

    def _pred_chunk(self, x_c, cc_c, embeds, t, randf, flip, banks, use_global):
        """CFG batch [uncond frames | cond frames]. With `cfg_dedup` the
        UNet takes the single shared half and duplicates it where the pair
        first diverges (models/unet.py)."""
        unet = self.models.unet
        dtype = unet.config.dtype
        cs = x_c.shape[0]
        uncond, cond = embeds
        ctx = torch.cat([uncond.expand(cs, -1, -1), cond.expand(cs, -1, -1)]).to(dtype)
        if self.cfg_dedup:
            inp = torch.cat([x_c, cc_c], dim=-1).to(dtype)
        else:
            inp = torch.cat([torch.cat([x_c, x_c]), torch.cat([cc_c, cc_c])],
                            dim=-1).to(dtype)
        eps, banks = unet(inp, t, ctx, tome_spec=self.models.tome_spec,
                          randf=randf, flip=flip, banks=banks,
                          use_global=use_global, cfg_dedup=self.cfg_dedup)
        eps_u, eps_c = eps.chunk(2)
        return eps_u + self.guidance_scale * (eps_c - eps_u), banks

    @staticmethod
    def _scatter_noise(noises, e, idx: np.ndarray, valid: np.ndarray) -> None:
        """Write the valid frames of one slot into the noise buffer (in
        place; padded and empty positions are dropped)."""
        sel = np.flatnonzero(valid)
        if sel.size:
            pos = torch.as_tensor(sel, device=e.device)
            noises[torch.as_tensor(idx[sel], device=e.device)] = e[pos]

    def _step_core(self, x, concat_conds, embeds, t, plan, randfs, flips):
        """One xy denoising pass: the chunk slots in order, slot 0 starting
        the global token banks and every later slot merging against them
        and carrying them on. Empty slots run too: they update the banks."""
        noises = torch.zeros_like(x)
        banks = None
        for s in range(plan.n_slots):
            idx = torch.as_tensor(plan.indices[s], dtype=torch.long, device=x.device)
            e, banks = self._pred_chunk(x[idx], concat_conds[idx], embeds, t,
                                        int(randfs[s]), bool(flips[s]), banks,
                                        use_global=s > 0)
            self._scatter_noise(noises, e, plan.indices[s], plan.valid[s])
        return noises

    @torch.inference_mode()
    def ddim_sample(self, x, embeds, concat_conds, seed=None, step_noises=None,
                    generator: torch.Generator | None = None):
        """The sampling loop (xy only). The SDE noise of step i is
        `step_noises[i]` when given, else drawn from `generator` (a
        generator seeded apart from the init noise by default)."""
        seed = self.seed if seed is None else seed
        n = x.shape[0]
        sched = self.scheduler
        plan_rng = np.random.default_rng(seed)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        state = sched.init_state(x)
        self._last_step_times = []
        timesteps = sched.timesteps()
        for i, t in enumerate(timesteps):
            t_step0 = time.perf_counter()
            plan = chunklib.make_chunk_plan(n, self.chunk_size, plan_rng,
                                            self.chunk_ord,
                                            self.tome_spec.merge_global)
            randfs = plan_rng.integers(0, 4, size=plan.n_slots)
            flips = plan_rng.random(plan.n_slots) <= self.global_rand
            noises = self._step_core(x, concat_conds, embeds, float(t), plan,
                                     randfs, flips)
            if step_noises is not None:
                noise = step_noises[i]
                if not torch.is_tensor(noise):
                    noise = torch.from_numpy(np.array(noise, dtype=np.float32))
                noise = noise.to(device=x.device, dtype=x.dtype)
            else:
                noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                    device=x.device)
            state, x = sched.step(state, noises, x, noise)
            self._sync()
            self._last_step_times.append(time.perf_counter() - t_step0)
            log.info("step %d/%d t=%.1f", i + 1, len(timesteps), float(t))
        return x

    # ------------------------------------------------------------ __call__

    def prepare_init_noise(self, n_frames: int, h: int, w: int,
                           generator: torch.Generator) -> torch.Tensor:
        lat = (h // self.vae_factor, w // self.vae_factor, 4)
        mode = self.noise_mode.lower()
        if mode == "same":
            noise = torch.randn((1,) + lat, generator=generator, device=self.device)
            return noise.repeat(n_frames, 1, 1, 1)
        if mode == "vanilla":
            return torch.randn((n_frames,) + lat, generator=generator,
                               device=self.device)
        raise NotImplementedError(self.noise_mode)

    @torch.inference_mode()
    def __call__(self, latents_path, output_path, frame_ids, init_noise=None,
                 step_noises=None):
        """Relight the video; writes output.mp4 and output_gt.mp4 for each
        prompt and returns {prompt name: frames (N, H, W, 3) in [0, 1]}.
        `latents_path` is unused on the IC-Light path."""
        frames = self.data_parser.load_video(frame_ids=frame_ids)
        n, h, w, _ = frames.shape
        tracker = CostTracker(self.device)
        if init_noise is None:
            init_noise = self.prepare_init_noise(
                n, h, w, torch.Generator(device=self.device).manual_seed(self.seed))
        init_noise = torch.as_tensor(init_noise, dtype=torch.float32, device=self.device)

        t_s = time.perf_counter()
        concat_conds = self.encode_imgs_batch(frames)
        if self.models.unet.config.in_channels == 12:
            # fbc without a background: zero background latents
            concat_conds = torch.cat([concat_conds, torch.zeros_like(concat_conds)], -1)
        self._sync()
        self.stage_times["encode"] = time.perf_counter() - t_s

        results = {}
        for edit_name, edit_prompt in self.prompts.items():
            if edit_prompt is None:
                raise NotImplementedError(
                    "no prompt given: the prompt upsampler is not ported yet")
            log.info("prompt [%s]: %s", edit_name, edit_prompt)
            cond, uncond = self.encode_prompt_pair(edit_prompt, self.negative_prompt)
            t_s = time.perf_counter()
            clean_latent = self.ddim_sample(init_noise, (uncond, cond), concat_conds,
                                            step_noises=step_noises)
            self.stage_times["sampling"] = time.perf_counter() - t_s
            if not torch.isfinite(clean_latent).all():
                raise FloatingPointError("sampling produced non-finite latents")
            self.stage_times["step_times"] = list(self._last_step_times)
            t_s = time.perf_counter()
            clean_frames = self.decode_latents_batch(clean_latent).cpu().numpy()
            self.stage_times["decode"] = time.perf_counter() - t_s

            t_s = time.perf_counter()
            save_name = (f"lmr_{self.tome_spec.local_ratio}_gmr_"
                         f"{self.tome_spec.global_ratio}_alpha_t_{self.alpha_t}"
                         f"_opt_{edit_name}")
            out_dir = Path(output_path) / save_name
            out_dir.mkdir(parents=True, exist_ok=True)
            fps = getattr(self.data_parser, "fps", 25)
            save_video(clean_frames, out_dir / "output.mp4", fps=fps)
            save_video(frames, out_dir / "output_gt.mp4", fps=fps)
            if self.save_frame:
                save_frames(clean_frames, out_dir / "frames")
            self.stage_times["output_save"] = time.perf_counter() - t_s
            cost = tracker.finish(n, h, w)
            self._save_run_config(out_dir, cost, edit_name, edit_prompt)
            results[edit_name] = clean_frames
            log.info("done [%s]: %.1fs total, %.2fs/frame", edit_name,
                     cost["total_time"], cost["sec_per_frame"])
        return results

    def _save_run_config(self, out_dir: Path, cost, edit_name, edit_prompt):
        cfg = ConfigDict(self.config.copy() if isinstance(self.config, ConfigDict)
                         else dict(self.config))
        for k, v in cost.items():
            cfg[k] = v
        cfg["stage_times"] = dict(self.stage_times)
        if "generation" in cfg:
            cfg["generation"]["prompt"] = {edit_name: edit_prompt}
        save_config(cfg, out_dir / "config.yaml")
