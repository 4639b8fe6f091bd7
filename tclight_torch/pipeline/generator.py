"""The TC-Light relighting pipeline: xy sampling, the multi-axis yt pass and
the post-optimization (counterpart of tclight_tpu/pipeline/generator.py).

Stages: load the video, and with `post_opt.apply_opt` its flows, soft
masks and pixel tracks (`load_data`); VAE-encode the frames as IC-Light
concat conditions, CLIP-encode the prompts, run the DPM++ (SDE) steps over
random chunk plans with VidToMe token merging, VAE-decode; then the
exposure alignment and the UVT refinement (pipeline/postopt.py); write the
mp4s, as the JAX package's non-TPU branch does: `output_gt.mp4` is encoded
on a thread while the output is fetched to the host and encoded (their
wall is `stage_times["output_fetch"]`, the host-only tail after it
`output_save`). JAX's TPU output branches (the on-device uint8 quantize
and streamed fetch, the uint8 and f16 uploads) are left out: the frames
stay exact f32.

Each step runs its chunk slots in order in a Python loop that carries the
global token banks from slot to slot, as `_slot0_core` / `_group_core` do
in JAX. With `alpha_t > 0` each step also runs the yt pass: the width
columns become the chunked frame axis of (time, height) images, over
overlapping temporal windows, and its noise prediction is fused into the
xy one (AdaIN, then a decayed weight). The TPU's dispatch split of many
slots into groups (`max_fused_slots`) is left out; the slot order and the
bank carry are kept. `generation.attn_qk_int8` (and `attn_pv_int8`) pick
the int8 attention kernels for every self-attention of both passes.

Random choices come from host numpy generators seeded like the JAX
package's, so both packages draw the same chunk plans, dst frames and
flips (each step's xy draws, then each yt window's); the Gaussian noise
comes from `torch.Generator`s, or from the caller (`init_noise`,
`step_noises`).

The post-optimization follows the device: on the card the warps are the
window sums at `flow_radius` (K3) and the UVT palette takes the banded
route where the ids allow it (K4/K5); on the CPU the warps are gather warps
and the palette adjoint the dense route, as the JAX package does off the
TPU. A failure in it raises.

Background conditioning (`generation.background_cond`): before encoding,
the frames are composited over the background video of
`background_image_path` through BriaRMBG's alpha mattes
(`composite_background`; without an `rmbg_ckpt` on disk the frames stay as
they are, with a warning, as in JAX).

The generic-SD editing path (a stack from `load_sd` / `build_tiny_sd`,
DDIM updates, no concat conditions): the init latents come from the
inversion cache at `latents_path` (pipeline/invert.py) when it holds the
first timestep. `generation.control: pnp` runs Plug-and-Play: each chunk
is a [source | uncond | cond] batch whose source third is the cached
latents of that timestep, with the UNet's Q/K injection for the first
`int(T * pnp_attn_t)` steps and its conv-feature injection for the first
`int(T * pnp_f_t)`; it needs the cache at every timestep, and merges
batch-aligned. A ControlNet type runs the stack's ControlNet on the control
images of the frames, its residuals scaled by `control_scale`: canny, tile
and ip2p need no network; softedge, lineart / lineart_anime and openpose
run the annotator of `generation.annotator_ckpt` (HED, the lineart U-Net,
the OpenPose body net), and depth the DPT depth maps. Neither path runs
the yt pass. The sd-depth stack (a 5-channel UNet) takes the DPT depth
maps of the frames at latent size as its fifth channel (`prepare_depth`,
from `generation.depth_ckpt`, cached under the output directory in JAX's
file, or from an injected `depth_fn`).

`parallel: {n_devices, model_parallel}` with n_devices > 1 runs one
process per device over torch.distributed (launched by torchrun, which
the config's world size must match; parallel/mesh.py): the UNet's
column-parallel Linear and Conv modules split over the model ranks for
sampling, each chunk's UNet batch over the data ranks (gathered again
wherever frames mix), and the post-optimization's batches
over the data ranks. Every rank ends with the same frames; rank 0 writes
the files.

A missing prompt is written by the Pixtral prompt upsampler of
`generation.prompt_upsampler_ckpt` from the last frame when that directory
exists (models/pixtral.py), else it takes JAX's generic fallback prompt,
with a warning.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tclight_torch.config import ConfigDict, save_config
from tclight_torch.data.controlnet_utils import CONTROLNET_DICT, control_preprocess
from tclight_torch.models.unet import ToMeSpec
from tclight_torch.ops.color import adaptive_instance_normalization
from tclight_torch.parallel.mesh import (gather_rows, make_mesh, shard_params, split_rows,
                                         unshard_params)
from tclight_torch.pipeline import chunks as chunklib
from tclight_torch.pipeline.iclight import ICLightModels, encode_prompt, encode_prompt_pair
from tclight_torch.pipeline.invert import check_latent_exists, load_latent
from tclight_torch.pipeline.postopt import (PostOptConfig, flow_radius,
                                            run_exposure_align, run_uvt)
from tclight_torch.utils.device import resolve_device
from tclight_torch.utils.logging import CostTracker, get_logger, span
from tclight_torch.utils.video_io import save_frames, save_video

log = get_logger()


# JAX's prompt when none is given and no upsampler checkpoint exists
DEFAULT_PROMPT = "high quality, detailed, realistic lighting"


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
        self.final_factor_t = _cfg_get(gen, "final_factor_t", 0.01)
        self.win_size_t = _cfg_get(gen, "win_size_t", 64)
        # yt-pass chunk size (0 = auto: the xy chunk size, see _yt_chunk_size)
        self.chunk_size_t = int(_cfg_get(gen, "chunk_size_t", 0))
        self.prompt_t = _cfg_get(gen, "prompt_t", "best quality")
        self.negative_prompt_t = _cfg_get(gen, "negative_prompt_t", "jittery")
        self.save_frame = _cfg_get(gen, "save_frame", True)
        self.prompts = dict(_cfg_get(gen, "prompt", {"default": None}))
        self.seed = int(config.get("seed", 12345))
        # the editing path's modes: PnP, or a ControlNet type
        self.control = str(_cfg_get(gen, "control", "none") or "none")
        self.use_pnp = self.control == "pnp"
        self.pnp_attn_t = float(_cfg_get(gen, "pnp_attn_t", 0.5))
        self.pnp_f_t = float(_cfg_get(gen, "pnp_f_t", 0.8))
        self.use_controlnet = self.control in CONTROLNET_DICT
        if self.use_controlnet and models.controlnet is None:
            raise ValueError(f"control={self.control} requires a ControlNet model "
                             f"(load_sd(..., control={self.control!r}))")
        self.control_scale = float(_cfg_get(gen, "control_scale", 1.0))
        post = config.get("post_opt", {})
        self.apply_opt = bool(_cfg_get(post, "apply_opt", True))
        self.post_cfg = PostOptConfig(
            epochs_exposure=_cfg_get(post, "epochs_exposure", 35),
            epochs=_cfg_get(post, "epochs", 70),
            batch_size=_cfg_get(post, "batch_size", 16),
            lambda_dssim=_cfg_get(post, "lambda_dssim", 0.2),
            lambda_flow=_cfg_get(post, "lambda_flow", 0.8),
            lambda_tv=_cfg_get(post, "lambda_tv", 0.05),
            feature_lr=_cfg_get(post, "feature_lr", 0.05),
            exposure_lr_init=_cfg_get(post, "exposure_lr_init", 0.01),
            exposure_lr_final=_cfg_get(post, "exposure_lr_final", 0.001),
            exposure_lr_delay_steps=_cfg_get(post, "exposure_lr_delay_steps", 0),
            exposure_lr_delay_mult=_cfg_get(post, "exposure_lr_delay_mult", 0.0),
            ms_ssim_levels=_cfg_get(post, "ms_ssim_levels", 5),
        )
        self.tome_spec = ToMeSpec(
            n_frames=self.chunk_size,
            local_ratio=_cfg_get(gen, "local_merge_ratio", 0.6),
            merge_global=_cfg_get(gen, "merge_global", True),
            global_ratio=_cfg_get(gen, "global_merge_ratio", 0.5),
            # PnP merges batch-aligned, so the [src | uncond | cond] batch
            # merges alike (as the reference forces it)
            align_batch=bool(_cfg_get(gen, "align_batch", True)) or self.use_pnp,
            max_downsample=_cfg_get(gen, "max_downsample", 2),
        )
        self.global_rand = _cfg_get(gen, "global_rand", 0.5)
        self.cfg_dedup = bool(_cfg_get(gen, "cfg_dedup", True))
        # int8 QK / QK+PV attention (kernels K6 / K7); attn_pv_int8 counts
        # only together with attn_qk_int8, as in JAX
        qk_int8 = bool(_cfg_get(gen, "attn_qk_int8", False))
        pv_int8 = bool(_cfg_get(gen, "attn_pv_int8", False)) and qk_int8
        self.attn_backend = "int8pv" if pv_int8 else "int8" if qk_int8 else None
        self.models = models.with_tome(self.tome_spec, attn_backend=self.attn_backend)
        self._yt_models: tuple[int, ICLightModels] | None = None
        self.scheduler = dataclasses.replace(
            models.scheduler, num_inference_steps=self.n_timesteps)
        self.data_parser = data_parser
        # the multi-device mesh (`parallel: {n_devices, model_parallel}`)
        par = config.get("parallel", {}) or {}
        n_dev = int(_cfg_get(par, "n_devices", 0) or 0)
        self.mesh = None
        self._params_on_mesh = False
        if n_dev > 1:
            world = dist.get_world_size() if dist.is_initialized() else None
            if world != n_dev:
                found = "no process group" if world is None else f"a world of {world}"
                raise ValueError(
                    f"parallel.n_devices={n_dev} runs one process per device: launch "
                    f"{n_dev} ranks (torchrun --nproc_per_node {n_dev}); found {found}")
            self.mesh = make_mesh(n_dev, int(_cfg_get(par, "model_parallel", 1)))
        self._vae_batch = 8
        self.stage_times: dict = {}
        self._last_step_times: list[float] = []
        self.last_postopt_losses: dict = {}
        self._pnp_latents_dir = None
        self._frame_ids = None
        self._control_images = None
        # (frames, latent_hw) -> (N, lh, lw, 1) depth maps in place of the
        # DPT of generation.depth_ckpt (`prepare_depth`)
        self.depth_fn = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def _pred_chunk(self, models, x_c, cc_c, embeds, t, randf, flip, banks, use_global):
        """CFG batch [uncond frames | cond frames]. With `cfg_dedup` the
        UNet takes the single shared half and duplicates it where the pair
        first diverges (models/unet.py)."""
        unet = models.unet
        dtype = unet.config.dtype
        cs = x_c.shape[0]
        uncond, cond = embeds
        ctx = torch.cat([uncond.expand(cs, -1, -1), cond.expand(cs, -1, -1)]).to(dtype)
        if self.cfg_dedup:
            inp = torch.cat([x_c, cc_c], dim=-1).to(dtype)
        else:
            inp = torch.cat([torch.cat([x_c, x_c]), torch.cat([cc_c, cc_c])],
                            dim=-1).to(dtype)
        # JAX's _shard_batch: this data rank's share of the batch (which
        # must split evenly over the data ranks)
        inp = split_rows(inp, self.mesh)
        eps, banks = unet(inp, t, ctx, tome_spec=models.tome_spec,
                          randf=randf, flip=flip, banks=banks,
                          use_global=use_global, cfg_dedup=self.cfg_dedup,
                          attn_backend=models.attn_backend, mesh=self.mesh)
        eps_u, eps_c = gather_rows(eps, self.mesh).chunk(2)
        return eps_u + self.guidance_scale * (eps_c - eps_u), banks

    def _pred_chunk_pnp(self, x_c, src_c, cc_c, embeds3, t, randf, flip, banks,
                        use_global, pnp_attn: bool, pnp_conv: bool):
        """PnP batch [source | uncond | cond] with the UNet's Q/K and
        conv-feature injection as the step's schedule says."""
        unet = self.models.unet
        dtype = unet.config.dtype
        cs = x_c.shape[0]
        inp = torch.cat([torch.cat([src_c, x_c, x_c]), torch.cat([cc_c, cc_c, cc_c])],
                        dim=-1).to(dtype)
        ctx = torch.cat([e.expand(cs, -1, -1) for e in embeds3]).to(dtype)
        eps, banks = unet(inp, t, ctx, tome_spec=self.models.tome_spec, randf=randf,
                          flip=flip, banks=banks, use_global=use_global,
                          attn_backend=self.models.attn_backend, pnp_attn=pnp_attn,
                          pnp_conv=pnp_conv)
        _, eps_u, eps_c = eps.chunk(3)
        return eps_u + self.guidance_scale * (eps_c - eps_u), banks

    def _pred_chunk_ctrl(self, x_c, cc_c, ctrl_c, embeds, t, randf, flip, banks,
                         use_global):
        """CFG batch with the ControlNet's residuals (each times
        `control_scale`) added in the UNet."""
        unet = self.models.unet
        dtype = unet.config.dtype
        cs = x_c.shape[0]
        inp = torch.cat([torch.cat([x_c, x_c]), torch.cat([cc_c, cc_c])], dim=-1).to(dtype)
        uncond, cond = embeds
        ctx = torch.cat([uncond.expand(cs, -1, -1), cond.expand(cs, -1, -1)]).to(dtype)
        down, mid = self.models.controlnet(inp, t, ctx, torch.cat([ctrl_c, ctrl_c]))
        s = self.control_scale
        eps, banks = unet(inp, t, ctx, tome_spec=self.models.tome_spec, randf=randf,
                          flip=flip, banks=banks, use_global=use_global,
                          attn_backend=self.models.attn_backend,
                          down_residuals=[r * s for r in down], mid_residual=mid * s)
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

    def _step_core(self, x, concat_conds, embeds, t, plan, randfs, flips, models=None):
        """One denoising pass over a chunk plan of x's first axis (frames,
        or the width columns of the yt pass): the chunk slots in order,
        slot 0 starting the global token banks and every later slot
        merging against them and carrying them on. Empty slots run too:
        they update the banks."""
        models = self.models if models is None else models
        return self._run_plan(x, plan, randfs, flips, lambda idx, *rest: self._pred_chunk(
            models, x[idx], concat_conds[idx], embeds, t, *rest))

    def _run_plan(self, x, plan, randfs, flips, pred):
        """The chunk slots of `plan` in order into a noise buffer shaped
        like x: `pred(idx, randf, flip, banks, use_global)` gives a slot's
        noise and the banks it carries on."""
        noises = torch.zeros_like(x)
        banks = None
        for s in range(plan.n_slots):
            with span("slot"):
                idx = torch.as_tensor(plan.indices[s], dtype=torch.long, device=x.device)
                e, banks = pred(idx, int(randfs[s]), bool(flips[s]), banks, s > 0)
                self._scatter_noise(noises, e, plan.indices[s], plan.valid[s])
        return noises

    # ------------------------------------------------------------ yt pass

    def _yt_windows(self, n: int):
        """Overlapping temporal windows (generate.py:246-258): (window
        length, window starts, overlap of each window with the one
        before)."""
        win = min(self.win_size_t, n)
        n_slices = math.ceil((n - 1) / (win - 1)) if win > 1 else 1
        if n_slices > 1:
            total_overlap = n_slices * win - n
            overlap = total_overlap // (n_slices - 1)
            last_overlap = overlap + total_overlap % (n_slices - 1)
            overlap_list = [overlap] * (n_slices - 2) + [last_overlap]
            cum = np.cumsum(overlap_list)
            starts = [0] + [(i + 1) * win - cum[i] for i in range(n_slices - 1)]
        else:
            starts, overlap_list = [0], [0]
        return win, starts, overlap_list

    def _yt_chunk_size(self, w: int, win: int) -> int:
        """Chunk size of the yt pass: `chunk_size_t`, or the xy chunk size
        when it is 0, at most the number of width columns."""
        if self.chunk_size_t > 0:
            return min(self.chunk_size_t, w)
        return min(self.chunk_size, w)

    def _yt_bind(self, cs_t: int) -> ICLightModels:
        """The models of the yt pass: the xy ones when cs_t is the xy chunk
        size, else the same modules with a ToMeSpec of cs_t frames and the
        same attention backend (kept for the next step)."""
        if cs_t == self.chunk_size:
            return self.models
        if self._yt_models is None or self._yt_models[0] != cs_t:
            spec_t = dataclasses.replace(self.tome_spec, n_frames=cs_t)
            self._yt_models = (cs_t, self.models.with_tome(
                spec_t, attn_backend=self.attn_backend))
        return self._yt_models[1]

    def _temporal_noises(self, x, concat_conds, embeds_t, t, rng):
        """yt-plane noise prediction (generate.py:241-278): the width
        columns become the chunked frame axis of (time, height) images;
        windows slide over time. Each window draws its chunk plan, randfs
        and flips from `rng` after the step's xy draws. A window's
        prediction overwrites its overlap with the window before, which
        is then scaled by sqrt(0.5)."""
        n, h, w, c = x.shape
        win, starts, overlaps = self._yt_windows(n)
        cs_t = self._yt_chunk_size(w, win)
        models = self._yt_bind(cs_t)
        noises_t = torch.zeros_like(x)
        for widx, sl in enumerate(starts):
            with span("yt_window"):
                plan = chunklib.make_chunk_plan(w, cs_t, rng, self.chunk_ord,
                                                self.tome_spec.merge_global)
                randfs = rng.integers(0, 4, size=plan.n_slots)
                flips = rng.random(plan.n_slots) <= self.global_rand
                # (win, H, W, C) -> (W, win, H, C)
                xt = x[sl: sl + win].permute(2, 0, 1, 3).contiguous()
                cct = concat_conds[sl: sl + win].permute(2, 0, 1, 3).contiguous()
                pred = self._step_core(xt, cct, embeds_t, t, plan, randfs, flips, models)
                noises_t[sl: sl + win] = pred.permute(1, 2, 0, 3)  # back to (win, H, W, C)
                if sl > 0:
                    ov = overlaps[widx - 1]
                    noises_t[sl: sl + ov] *= math.sqrt(0.5)
        return noises_t

    @staticmethod
    def _fuse_yt(noises, noises_t, alpha: float):
        """AdaIN of the yt prediction onto the xy one's statistics, then
        sqrt(alpha) * yt + sqrt(1 - alpha) * xy, with alpha in f32."""
        noises_t = adaptive_instance_normalization(noises_t, noises)
        a = torch.tensor(alpha, dtype=torch.float32, device=noises.device)
        return torch.sqrt(a) * noises_t + torch.sqrt(1.0 - a) * noises

    @torch.inference_mode()
    def ddim_sample(self, x, embeds, concat_conds, embeds_t=None, seed=None,
                    step_noises=None, generator: torch.Generator | None = None):
        """The sampling loop. `embeds` is the (uncond, cond) pair of the
        prompt; `embeds_t` that of `prompt_t`, which the yt pass needs
        (alpha_t > 0). An SDE scheduler's noise of step i is
        `step_noises[i]` when given, else drawn from `generator` (a
        generator seeded apart from the init noise by default): one draw
        per step in either pass. PnP and ControlNet steps run their own
        chunk batches (`_editing_noises`) and no yt pass."""
        editing = self.use_pnp or self.use_controlnet
        if self.alpha_t > 0 and embeds_t is None and not editing:
            raise ValueError("alpha_t > 0: the yt pass needs embeds_t")
        seed = self.seed if seed is None else seed
        if self.mesh is not None and not self._params_on_mesh:
            shard_params(self.models.unet, self.mesh)
            self._params_on_mesh = True
        n = x.shape[0]
        sched = self.scheduler
        plan_rng = np.random.default_rng(seed)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        if self.use_pnp:
            if self._pnp_latents_dir is None:
                raise FileNotFoundError(
                    "control=pnp requires inverted latents: pass a latents_path holding "
                    "noisy_latents_{t} for every generation timestep (run the Inverter "
                    "with save_intermediate and save_steps=n_timesteps)")
            uncond, cond = embeds
            src_e = encode_prompt(self.models, "")  # the source's guidance embedding
            sq = uncond.shape[1]
            if src_e.shape[1] < sq:
                src_e = torch.cat([src_e] * math.ceil(sq / src_e.shape[1]), dim=1)[:, :sq]
            embeds = (src_e, uncond, cond)
        elif self.use_controlnet and self._control_images is None:
            raise RuntimeError("control images not prepared; call the Generator via __call__")
        state = sched.init_state(x)
        self._last_step_times = []
        timesteps = sched.timesteps()
        for i, t in enumerate(timesteps):
            # the step's stopwatch is its span's clock: one start, one end
            t_step0 = time.perf_counter_ns()
            with span("step", step=i, t0=t_step0) as step_span:
                plan = chunklib.make_chunk_plan(n, self.chunk_size, plan_rng,
                                                self.chunk_ord,
                                                self.tome_spec.merge_global)
                randfs = plan_rng.integers(0, 4, size=plan.n_slots)
                flips = plan_rng.random(plan.n_slots) <= self.global_rand
                if editing:
                    noises = self._editing_noises(x, concat_conds, embeds, t, i,
                                                  len(timesteps), plan, randfs, flips)
                else:
                    with span("xy"):
                        noises = self._step_core(x, concat_conds, embeds, float(t), plan,
                                                 randfs, flips)
                if self.alpha_t > 0 and not editing:
                    alpha = self.alpha_t * self.final_factor_t ** min(i / len(timesteps), 1.0)
                    with span("yt"):
                        noises_t = self._temporal_noises(x, concat_conds, embeds_t, float(t),
                                                         plan_rng)
                        noises = self._fuse_yt(noises, noises_t, alpha)
                noise = None
                if sched.sde and step_noises is not None:
                    noise = step_noises[i]
                    if not torch.is_tensor(noise):
                        noise = torch.from_numpy(np.array(noise, dtype=np.float32))
                    noise = noise.to(device=x.device, dtype=x.dtype)
                elif sched.sde:
                    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                        device=x.device)
                with span("scheduler"):
                    state, x = sched.step(state, noises, x, noise)
                self._sync()
                self._last_step_times.append((step_span.end() - t_step0) * 1e-9)
            log.info("step %d/%d t=%.1f [%s]", i + 1, len(timesteps), float(t), self.control)
        return x

    def _editing_noises(self, x, concat_conds, embeds, t, i: int, n_steps: int,
                        plan, randfs, flips):
        """One step's noise prediction on the editing path. PnP: `embeds`
        is (source, uncond, cond), the source third the cached latents at
        t (by frame id), Q/K injection while i < int(T * pnp_attn_t) and
        conv injection while i < int(T * pnp_f_t). ControlNet: the control
        images go through the same chunk plan."""
        t = float(t)
        if self.use_pnp:
            src = torch.from_numpy(load_latent(self._pnp_latents_dir, t, self._frame_ids))
            src = src.to(device=x.device, dtype=x.dtype)
            attn = i < int(n_steps * self.pnp_attn_t)
            conv = i < int(n_steps * self.pnp_f_t)
            return self._run_plan(x, plan, randfs, flips, lambda idx, *rest: self._pred_chunk_pnp(
                x[idx], src[idx], concat_conds[idx], embeds, t, *rest, attn, conv))
        ctrl = self._control_images
        return self._run_plan(x, plan, randfs, flips, lambda idx, *rest: self._pred_chunk_ctrl(
            x[idx], concat_conds[idx], ctrl[idx], embeds, t, *rest))

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

    def encode_conditions(self, frames: np.ndarray, output_path=None) -> torch.Tensor:
        """IC-Light's concat conditions: the frames' latents, and on a
        12-channel (fbc) UNet the background's latents after them, from
        `generation.background_image_path` tiled to the frame count, or
        zeros without one (tclight_tpu/pipeline/generator.py:1090-1101).
        The sd-depth stack (5-channel UNet) has the frames' depth maps at
        latent size (`prepare_depth`); a generic SD stack none: a
        zero-width tensor."""
        if self.models.model_key != "iclight":
            n, h, w, _ = frames.shape
            f = self.vae_factor
            if self.models.unet.config.in_channels == 5:
                depth = self.prepare_depth(frames, (h // f, w // f), output_path)
                return torch.as_tensor(depth, dtype=torch.float32, device=self.device)
            return torch.zeros((n, h // f, w // f, 0), device=self.device)
        conds = self.encode_imgs_batch(frames)
        if self.models.unet.config.in_channels != 12:
            return conds
        bg_path = _cfg_get(self.config.get("generation", {}), "background_image_path", None)
        if bg_path:
            n = len(frames)
            bg = self.data_parser.load_video(path=str(bg_path))
            if len(bg) < n:
                bg = np.concatenate([bg] * (n // len(bg) + 1))[:n]
            bg_lat = self.encode_imgs_batch(bg[:n])
        else:
            bg_lat = torch.zeros_like(conds)
        return torch.cat([conds, bg_lat], -1)

    @torch.inference_mode()
    def __call__(self, latents_path, output_path, frame_ids, init_noise=None,
                 step_noises=None):
        """Relight the video; writes output.mp4 and output_gt.mp4 for each
        prompt and returns {prompt name: frames (N, H, W, 3) in [0, 1]}.
        `latents_path` is the inversion cache of the generic-SD path (unused
        on the IC-Light path)."""
        frames = self.data_parser.load_video(frame_ids=frame_ids)
        if _cfg_get(self.config.get("generation", {}), "background_cond", False):
            frames = self.composite_background(frames)
        n, h, w, _ = frames.shape
        tracker = CostTracker(self.device)
        self._frame_ids = list(frame_ids) if frame_ids is not None else None
        if init_noise is None:
            init_noise = self.prepare_init_noise(
                n, h, w, torch.Generator(device=self.device).manual_seed(self.seed))
        init_noise = torch.as_tensor(init_noise, dtype=torch.float32, device=self.device)
        if self.use_controlnet:
            self._control_images = self.control_images(frames)
        if self.models.model_key != "iclight" and latents_path:
            # the inversion's latents at the first timestep replace the
            # init noise
            init_noise = self._load_inverted_latents(latents_path, frame_ids, init_noise)

        t_s = time.perf_counter()
        concat_conds = self.encode_conditions(frames, output_path)
        self._sync()
        self.stage_times["encode"] = time.perf_counter() - t_s

        # flows, masks and tracks up front (prompt-independent; the flows
        # are cached on disk)
        optimize = self.apply_opt and self.data_parser is not None
        if optimize:
            t_s = time.perf_counter()
            _, _, _, _, past_flows, mask_bwds = self._rank0_first(
                lambda: self.data_parser.load_data(frame_ids, device=self.device))
            self.stage_times["flow_data"] = time.perf_counter() - t_s

        results = {}
        for edit_name, edit_prompt in self.prompts.items():
            if edit_prompt is None:
                edit_prompt = self._handle_missing_prompt(frames, output_path)
                self.prompts[edit_name] = edit_prompt
            log.info("prompt [%s]: %s", edit_name, edit_prompt)
            cond, uncond = encode_prompt_pair(self.models, edit_prompt, self.negative_prompt)
            cond_t, uncond_t = encode_prompt_pair(self.models, self.prompt_t,
                                                  self.negative_prompt_t)
            t_s = time.perf_counter()
            clean_latent = self.ddim_sample(init_noise, (uncond, cond), concat_conds,
                                            embeds_t=(uncond_t, cond_t),
                                            step_noises=step_noises)
            self.stage_times["sampling"] = time.perf_counter() - t_s
            if self._params_on_mesh:  # whole again for the next user of the UNet
                unshard_params(self.models.unet, self.mesh)
                self._params_on_mesh = False
            if not torch.isfinite(clean_latent).all():
                raise FloatingPointError("sampling produced non-finite latents")
            self.stage_times["step_times"] = list(self._last_step_times)
            t_s = time.perf_counter()
            clean_frames = self.decode_latents_batch(clean_latent)
            if not torch.isfinite(clean_frames).all():
                raise FloatingPointError("decoding produced non-finite frames")
            self.stage_times["decode"] = time.perf_counter() - t_s
            losses_exposure = losses_uvt = np.zeros(0)
            if optimize:
                clean_frames, losses_exposure, losses_uvt = self._post_optimize(
                    clean_frames, past_flows, mask_bwds)
            if self.mesh is not None and self.mesh.rank != 0:
                results[edit_name] = clean_frames.cpu().numpy()
                continue  # rank 0 writes the files

            t_out = time.perf_counter()
            save_name = (f"lmr_{self.tome_spec.local_ratio}_gmr_"
                         f"{self.tome_spec.global_ratio}_alpha_t_{self.alpha_t}"
                         f"_opt_{edit_name}")
            out_dir = Path(output_path) / save_name
            out_dir.mkdir(parents=True, exist_ok=True)
            fps = getattr(self.data_parser, "fps", 25)
            # the GT encode needs only the host's input frames: it runs on a
            # thread while the output is fetched and encoded (the copy to the
            # host and cv2's encode release the GIL)
            with ThreadPoolExecutor(1, thread_name_prefix="gt-mp4") as pool:
                gt_saved = pool.submit(save_video, frames, out_dir / "output_gt.mp4", fps=fps)
                clean_frames = clean_frames.cpu().numpy()
                save_video(clean_frames, out_dir / "output.mp4", fps=fps)
                # the fetch and both encodes overlap: their wall is
                # output_fetch, the host-only tail after it output_save
                self.stage_times["output_fetch"] = time.perf_counter() - t_out
                gt_saved.result()
            results[edit_name] = clean_frames
            if self.save_frame:
                save_frames(clean_frames, out_dir / "frames")
            self.last_postopt_losses = {"exposure": losses_exposure, "uvt": losses_uvt}
            if optimize:  # the loss curves, as arrays and as plots
                np.save(out_dir / "loss_exposure.npy", losses_exposure)
                np.save(out_dir / "loss_unique_tensor.npy", losses_uvt)
                self._save_loss_curves(out_dir, losses_exposure, losses_uvt)
            self.stage_times["output_save"] = (time.perf_counter() - t_out
                                               - self.stage_times["output_fetch"])
            cost = tracker.finish(n, h, w)
            self._save_run_config(out_dir, cost, edit_name, edit_prompt)
            log.info("done [%s]: %.1fs total, %.2fs/frame", edit_name,
                     cost["total_time"], cost["sec_per_frame"])
        return results

    def _rank0_first(self, fn):
        """fn() on rank 0 before the other ranks (which then read what it
        cached on disk, the flows); fn() alone without a mesh."""
        first = self.mesh is None or self.mesh.rank == 0
        if not first:
            dist.barrier()
        out = fn()
        if self.mesh is not None and first:
            dist.barrier()
        return out

    def composite_background(self, frames: np.ndarray) -> np.ndarray:
        """Background conditioning: BriaRMBG's alpha mattes of the frames
        (`generation.rmbg_ckpt`, a reference checkpoint) composite them over
        the video or image of `background_image_path`, tiled to the frame
        count. Without a background path the frames stay as they are; so
        they do, with a warning, without an RMBG checkpoint on disk (JAX's
        behaviour)."""
        from tclight_torch.models.briarmbg import compute_alpha_mattes, load_rmbg

        gen_cfg = self.config.get("generation", {})
        bg_path = _cfg_get(gen_cfg, "background_image_path")
        if not bg_path:
            return frames
        ckpt = _cfg_get(gen_cfg, "rmbg_ckpt")
        if not (ckpt and Path(str(ckpt)).exists()):
            log.warning("no RMBG checkpoint; skipping background compositing")
            return frames
        alpha = compute_alpha_mattes(load_rmbg(ckpt, self.device), frames)[..., None]
        bg = self.data_parser.load_video(path=str(bg_path))
        if len(bg) < len(frames):
            bg = np.concatenate([bg] * (len(frames) // len(bg) + 1))[: len(frames)]
        return alpha * frames + (1 - alpha) * bg[: len(frames)]

    def annotator_fn(self, frames: np.ndarray):
        """The `model_fn` of a model-backed control type, or None: HED
        (softedge), the lineart U-Net (lineart, lineart_anime) or the
        OpenPose body net (openpose) from an existing
        `generation.annotator_ckpt`; for depth, the frames' DPT depth maps
        (`prepare_depth` at latent size, uncached) resized to the frames
        (cv2 bilinear), mapped to [0, 1] and repeated over three
        channels."""
        import cv2

        ann = _cfg_get(self.config.get("generation", {}), "annotator_ckpt")
        have = bool(ann) and Path(str(ann)).exists()
        if self.control in ("softedge", "scribble") and have:
            from tclight_torch.models.hed import softedge_model_fn

            return softedge_model_fn(ann, self.device)
        if self.control in ("lineart", "lineart_anime") and have:
            from tclight_torch.models.lineart import lineart_model_fn

            return lineart_model_fn(ann, device=self.device)
        if self.control == "openpose" and have:
            from tclight_torch.models.openpose import openpose_model_fn

            return openpose_model_fn(ann, device=self.device)
        if self.control == "depth":
            n, h, w, _ = frames.shape
            f = self.vae_factor

            def depth_model_fn(fr):
                d = np.asarray(self.prepare_depth(fr, (h // f, w // f), None))
                d = np.stack([cv2.resize(x, (w, h)) for x in d])
                d = d[..., None] if d.ndim == 3 else d
                return np.repeat((d + 1.0) / 2.0, 3, axis=-1).astype(np.float32)

            return depth_model_fn
        return None

    def control_images(self, frames: np.ndarray) -> torch.Tensor:
        """The ControlNet's conditioning images of the frames, (N, H, W, 3)
        on the device (a model-backed type through `annotator_fn`). The
        embedder downsamples by 8 (SD1.5's VAE); with another VAE factor
        (the tiny stacks) the images are resized to 8x the latent size, so
        the residuals land at latent resolution."""
        import cv2

        ctrl = control_preprocess(frames, self.control, model_fn=self.annotator_fn(frames))
        if self.vae_factor != 8:
            n, h, w, _ = frames.shape
            size = (w // self.vae_factor * 8, h // self.vae_factor * 8)
            ctrl = np.stack([cv2.resize(f, size) for f in ctrl])
        return torch.from_numpy(np.ascontiguousarray(ctrl, dtype=np.float32)).to(self.device)

    def _load_inverted_latents(self, latents_path, frame_ids, init_noise):
        """The inversion cache's latents at the first timestep, as init
        latents; PnP needs the cache at every timestep (FileNotFoundError
        otherwise). Outside PnP a missing latent keeps the fresh init noise,
        with a warning."""
        ts = self.scheduler.timesteps()
        need = list(ts) if self.use_pnp else [ts[0]]
        missing = [float(t) for t in need
                   if not check_latent_exists(latents_path, float(t), frame_ids)]
        if missing:
            msg = (f"inverted latents missing at {latents_path} for timesteps "
                   f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
            if self.use_pnp:
                raise FileNotFoundError(msg + " - PnP needs latents at every generation "
                                        "timestep (Inverter save_intermediate with "
                                        "save_steps == n_timesteps)")
            log.warning("%s; using fresh init noise", msg)
            return init_noise
        self._pnp_latents_dir = latents_path
        loaded = load_latent(latents_path, float(ts[0]), frame_ids)
        log.info("loaded inverted init latents %s from %s", loaded.shape, latents_path)
        return torch.from_numpy(loaded).to(device=self.device, dtype=torch.float32)

    @torch.inference_mode(False)
    def _post_optimize(self, frames: torch.Tensor, past_flows: np.ndarray,
                       mask_bwds: np.ndarray):
        """Exposure alignment, then the UVT refinement, of the decoded
        frames (N, H, W, 3) on the device. Returns (frames, exposure loss
        history, UVT loss history)."""
        cfg = self.post_cfg
        with torch.enable_grad():
            # a clone outside inference mode is a tensor autograd may save
            frames = frames.clone()
            radius = flow_radius(past_flows) if self.device.type == "cuda" else None
            flows = torch.from_numpy(np.ascontiguousarray(past_flows)).to(self.device)
            masks = torch.from_numpy(np.ascontiguousarray(mask_bwds)).to(self.device)
            log.info("exposure alignment (%d epochs)...", cfg.epochs_exposure)
            t_s = time.perf_counter()
            frames, _, losses_exposure, exp_times = run_exposure_align(
                frames, flows, masks, cfg, seed=self.seed, warp_radius=radius,
                mesh=self.mesh)
            self._sync()
            self.stage_times["exposure"] = time.perf_counter() - t_s
            self.stage_times["exposure_epochs"] = exp_times.tolist()
            log.info("UVT optimization (%d epochs)...", cfg.epochs)
            t_s = time.perf_counter()
            frames, losses_uvt, uvt_times = run_uvt(
                frames, flows, masks, self.data_parser.unq_inv,
                self.data_parser.n_unique, cfg, seed=self.seed, warp_radius=radius,
                mesh=self.mesh)
            self._sync()
            self.stage_times["uvt"] = time.perf_counter() - t_s
            self.stage_times["uvt_epochs"] = uvt_times.tolist()
        for name, hist in (("exposure", losses_exposure), ("uvt", losses_uvt)):
            if not np.isfinite(hist).all():
                raise FloatingPointError(f"the {name} loss history is not finite")
        return frames.detach(), losses_exposure, losses_uvt

    def _handle_missing_prompt(self, frames: np.ndarray, output_path) -> str:
        """A missing prompt: with an existing `prompt_upsampler_ckpt`
        directory, the prompt the Pixtral upsampler writes for the last
        frame (`pixtral.upsample_prompt_from_frames`, on the Generator's
        device); without one, a warning and JAX's generic prompt."""
        ckpt = _cfg_get(self.config.get("generation", {}), "prompt_upsampler_ckpt")
        if ckpt and Path(str(ckpt)).exists():
            from tclight_torch.models.pixtral import upsample_prompt_from_frames

            return upsample_prompt_from_frames(ckpt, frames, device=self.device)
        log.warning("no prompt given and no upsampler checkpoint; using default")
        return DEFAULT_PROMPT

    def prepare_depth(self, frames: np.ndarray, latent_hw, output_path) -> np.ndarray:
        """The sd-depth UNet's depth channel (N, lh, lw, 1) in [-1, 1], from
        `self.depth_fn(frames, latent_hw)` when set (a numpy array), else
        the DPT checkpoint of `generation.depth_ckpt` (transformers keys;
        FileNotFoundError without one). With an output path it is cached
        as JAX caches it, `output_path/depth/depth_{n}_{lh}x{lw}.npy`, and
        read back from there (by either package)."""
        cache = None
        if output_path:
            cache = (Path(output_path) / "depth"
                     / f"depth_{len(frames)}_{latent_hw[0]}x{latent_hw[1]}.npy")
            if cache.exists():
                log.info("loaded depth maps from %s", cache)
                return np.load(cache)
        if self.depth_fn is not None:
            depth = np.asarray(self.depth_fn(frames, latent_hw))
        else:
            from tclight_torch.models.dpt import load_dpt, prepare_depth_maps

            ckpt = _cfg_get(self.config.get("generation", {}), "depth_ckpt")
            if not ckpt or not Path(str(ckpt)).exists():
                raise FileNotFoundError(
                    "sd-depth needs generation.depth_ckpt pointing at a local DPT checkpoint "
                    "(transformers DPTForDepthEstimation state dict)")
            depth = prepare_depth_maps(load_dpt(ckpt, self.device), frames, latent_hw)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache, depth)
        return depth

    @staticmethod
    def _save_loss_curves(out_dir: Path, losses_exposure, losses_uvt) -> None:
        """loss_exposure.png and loss_unique_tensor.png, as JAX draws them;
        best-effort: a failure is logged, not raised."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            for name, arr in (("loss_exposure", losses_exposure),
                              ("loss_unique_tensor", losses_uvt)):
                if arr.size:
                    fig = plt.figure()
                    plt.plot(arr)
                    plt.xlabel("iter")
                    plt.ylabel("loss")
                    fig.savefig(out_dir / f"{name}.png", dpi=80)
                    plt.close(fig)
        except Exception as e:  # loss curves are best-effort
            log.warning("loss curve saving failed: %s", e)

    def _save_run_config(self, out_dir: Path, cost, edit_name, edit_prompt):
        cfg = ConfigDict(self.config.copy() if isinstance(self.config, ConfigDict)
                         else dict(self.config))
        for k, v in cost.items():
            cfg[k] = v
        cfg["stage_times"] = dict(self.stage_times)
        if "generation" in cfg:
            cfg["generation"]["prompt"] = {edit_name: edit_prompt}
        save_config(cfg, out_dir / "config.yaml")
