"""The sampling stage: `Generator.ddim_sample` of tclight_torch on one clip.

Set-up builds the program's UNet from the configuration's sizes, loads the
seeded weights into it under diffusers' keys (as a checkpoint loads), makes
the clip's conditions and the prompt embeddings from the seed, and runs
one step of the cell's own shapes. The window then samples clip after clip
with the configuration's 25-step schedule, each with its own init noise and
plan seed, and closes at the first step boundary at or after its length.
Every step's sample, noise prediction and output are copied to pinned host
memory as the step ends, so that the check can read them once the program
is gone.

The check follows the program step by step: for a sample of the window's
steps drawn from the seed, the reference (tcbench/reference) recomputes the
step from the program's sample at that step, with the data prediction of
the step before worked out from the program's sample and noise prediction
there (the sampler's carry), and the same SDE noise. Step 0 of a clip
starts from the benchmark's own init noise. The number compared is, per
frame, the distance between the program's output and the reference's,
over the length of the reference's update (`update_gap`).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from tcbench import seeds
from tcbench.reference import dpm, step as ref_step, weights as ref_weights
from tcbench.reference import unet as ref_unet_mod
from tcbench.reference.unet import UNet as RefUNet

class StopWindow(Exception):
    """Raised at the step boundary that closes the window."""


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _context_tokens(chunk: int, pair: tuple[str, str]) -> int:
    """The prompt pair's embedding length: chunks of `chunk` tokens, two of
    them BOS and EOS, a word a token (the hash tokenizer), the longer's
    count for both."""
    words = [len((p or "").split()) for p in pair]
    return chunk * max(max(1, math.ceil(w / (chunk - 2))) for w in words)


class Recorder:
    """Pinned host slots: per step its sample, noise prediction and output."""

    def __init__(self, slots: int, shape: tuple, pin: bool) -> None:
        self.buf = torch.empty((slots, 3) + tuple(shape), dtype=torch.float32, pin_memory=pin)
        self.keys: list[tuple[int, int]] = []  # (clip, step) of each filled slot
        self.dropped = 0

    def record(self, key, sample, eps, out) -> None:
        k = len(self.keys)
        if k >= len(self.buf):
            self.dropped += 1
            return
        for j, t in enumerate((sample, eps, out)):
            self.buf[k, j].copy_(t, non_blocking=True)
        self.keys.append(key)

    def get(self, key, j: int) -> torch.Tensor:
        return self.buf[self.keys.index(key), j]


class Matchings:
    """The program's ToMe matchings of every step, in call order, copied to
    pinned host memory: what `online_argmax_scores`, the matcher that
    tclight_torch.ops.tome calls (K2 on the card), returns: each src
    token's maximum similarity and the index of its argmax. Until
    `allocate`, a step's calls are only sized."""

    def __init__(self) -> None:
        self.pool = None
        self.cur: list | None = []
        self.sizes: list = []
        self.steps: dict = {}
        self.dropped = 0

    def install(self) -> None:
        from tclight_torch.ops import tome

        self._orig = tome.online_argmax_scores

        def wrapped(*args, **kwargs):
            node_max, node_idx = self._orig(*args, **kwargs)
            self.add(node_max, node_idx)
            return node_max, node_idx
        tome.online_argmax_scores = wrapped

    def uninstall(self) -> None:
        from tclight_torch.ops import tome

        tome.online_argmax_scores = self._orig

    def add(self, node_max: torch.Tensor, node_idx: torch.Tensor) -> None:
        n = node_max.shape[0]
        if self.pool is None:
            self.cur.append(n)
            return
        if self.cur is None or self.off + 2 * n > len(self.pool):
            self.cur = None
            return
        packed = torch.cat([node_max.float().view(torch.int32), node_idx.to(torch.int32)])
        self.pool[self.off: self.off + 2 * n].copy_(packed, non_blocking=True)
        self.cur.append((self.off, n))
        self.off += 2 * n

    def close_step(self, key) -> None:
        if self.pool is None:
            self.sizes = self.cur
        elif self.cur:
            self.steps[key] = self.cur
        else:
            self.dropped += 1
        self.cur = []

    def allocate(self, steps: int, pin: bool) -> None:
        self.pool = torch.empty(2 * sum(self.sizes) * steps, dtype=torch.int32, pin_memory=pin)
        self.off = 0
        self.cur = []

    def get(self, key) -> list:
        from tcbench.reference.tome import Matching

        return [Matching(self.pool[o: o + n].view(torch.float32), self.pool[o + n: o + 2 * n])
                for o, n in self.steps[key]]


class RecordingScheduler:
    """The program's scheduler, its every step copied to a Recorder and its
    matchings closed in `Matchings`."""

    def __init__(self, inner, matchings: Matchings, clip: list) -> None:
        self._inner, self._dec, self._clip = inner, matchings, clip
        self._rec = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self, state, eps, sample, noise=None):
        state2, out = self._inner.step(state, eps, sample, noise)
        key = (self._clip[0], state.step_index)
        self._dec.close_step(key)
        if self._rec is not None:
            self._rec.record(key, sample, eps, out)
        return state2, out


class StepNoises:
    """The SDE noise of each step of one clip, drawn from the seed in step
    order (the sampler asks for step i's at step i)."""

    def __init__(self, seed: int, shape: tuple, device) -> None:
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.shape, self.device = shape, device

    def __getitem__(self, i: int) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.gen, device=self.device)


def step_noise(seed: int, shape: tuple, device, i: int) -> torch.Tensor:
    noises = StepNoises(seed, shape, device)
    for _ in range(i):
        noises[0]
    return noises[i]


@dataclasses.dataclass
class Inputs:
    conds: torch.Tensor
    embeds: tuple
    embeds_t: tuple


class Stage:
    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int, device,
                 variant: str | None = None) -> None:
        self.workload, self.traffic = workload, traffic
        self.seed, self.device = seed, torch.device(device)
        self.model, self.settings = config["model"], config["settings"]
        # controls, for the readings that set the limits of `correct`: the
        # program's int8 attention path, or the reference in fp8 put in the
        # program's place at the steps checked
        self.variant = variant
        if variant == "int8pv":
            gen = self.settings["generation"]
            gen["attn_qk_int8"] = gen["attn_pv_int8"] = True
        elif variant not in (None, "fp8"):
            raise ValueError(f"unknown variant {variant!r}")
        g = self.settings["generation"]
        self.n_steps = g["n_timesteps"]
        f = self.model["vae_factor"]
        self.shape = (traffic["frames"], traffic["height"] // f, traffic["width"] // f,
                      self.model["latent_channels"])
        self.gen = None
        self.recorder = None
        self.timings: dict = {}

    # ------------------------------------------------------------ inputs

    def inputs(self) -> Inputs:
        """The clip's conditions and the prompt embeddings, from the seed."""
        from tcbench import traffic as traffic_mod

        m, g = self.model, self.settings["generation"]
        conds = traffic_mod.generator(self.traffic).latents(
            self.traffic, seeds.derive(self.seed, "clip"), m["vae_factor"], m["latent_channels"])
        conds = torch.from_numpy(np.ascontiguousarray(conds)).to(self.device)
        chunk = m["text_chunk_tokens"]
        # without a prompt the program takes a generic one of five words
        prompt = next(iter((g.get("prompt") or {}).values()), None) or "generic prompt"
        n = _context_tokens(chunk, (prompt, g["negative_prompt"]))
        n_t = _context_tokens(chunk, (g["prompt_t"], g["negative_prompt_t"]))
        gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "text"))
        e = [torch.randn((1, k, m["context_dim"]), generator=gen, device=self.device)
             for k in (n, n, n_t, n_t)]
        return Inputs(conds, (e[0], e[1]), (e[2], e[3]))

    def init_noise(self, clip: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            seeds.derive(self.seed, "init", clip))
        one = torch.randn((1,) + self.shape[1:], generator=gen, device=self.device)
        if self.settings["generation"]["noise_mode"] != "same":
            raise ValueError("the stage draws the noise_mode 'same' init noise")
        return one.repeat(self.shape[0], 1, 1, 1)

    def clip_seed(self, clip: int) -> int:
        return seeds.derive(self.seed, "plans", clip)

    def sde_seed(self, clip: int) -> int:
        return seeds.derive(self.seed, "sde", clip)

    # ------------------------------------------------------------ program

    def setup(self) -> None:
        """Build the program and run one step of the cell's shapes."""
        from tclight_torch.diffusion.schedulers import DPMSolverMultistepScheduler
        from tclight_torch.models.convert import unet_reference_state_dict
        from tclight_torch.models.unet import UNet2DCondition, UNetConfig
        from tclight_torch.pipeline.generator import Generator
        from tclight_torch.pipeline.iclight import ICLightModels

        m = self.model
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from tclight_torch.ops import kernels

            self.timings["build_s"] = kernels.build_all()
        cfg = UNetConfig(in_channels=m["in_channels"], out_channels=m["out_channels"],
                         block_out_channels=tuple(m["block_out_channels"]),
                         layers_per_block=m["layers_per_block"], num_heads=m["num_heads"],
                         context_dim=m["context_dim"], norm_groups=m["norm_groups"],
                         dtype=_dtype(m["dtype"]))
        with torch.device("meta"):
            unet = UNet2DCondition(cfg)
        unet.to_empty(device=self.device)
        w = ref_weights.make(m, seeds.derive(self.seed, "weights"), self.device, cfg.dtype)
        names = dict(zip(unet_reference_state_dict(unet).keys(), unet.state_dict().keys()))
        if set(names) != set(w):
            raise KeyError(f"weights and UNet differ: {sorted(set(names) ^ set(w))[:5]}")
        params = unet.state_dict()
        with torch.no_grad():
            for ref_name, port_name in names.items():
                params[port_name].copy_(w[ref_name])
        del w, params
        unet.eval().requires_grad_(False)
        self.timings["model_s"] = time.perf_counter() - t0
        models = ICLightModels(unet=unet, vae=None, text_encoder=None, tokenizer=None,
                               scheduler=DPMSolverMultistepScheduler(
                                   num_inference_steps=self.n_steps))
        self.gen = Generator(models, self.settings, device=self.device)
        self._clip = [0]
        self.matchings = Matchings()
        self.matchings.install()
        self.gen.scheduler = RecordingScheduler(self.gen.scheduler, self.matchings, self._clip)
        self.inp = self.inputs()
        t0 = time.perf_counter()
        # one step of the cell's shapes, unrecorded
        self._sample(clip=-1, boundary=lambda: True)
        self.timings["warm_s"] = time.perf_counter() - t0

    def _sample(self, clip: int, boundary) -> bool:
        """One clip through ddim_sample; True when `boundary` closed it."""
        gen = self.gen

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if boundary():
                raise StopWindow

        self._clip[0] = clip
        gen._sync = sync
        try:
            gen.ddim_sample(self.init_noise(clip), self.inp.embeds, self.inp.conds,
                            embeds_t=self.inp.embeds_t, seed=self.clip_seed(clip),
                            step_noises=StepNoises(self.sde_seed(clip), self.shape, self.device))
        except StopWindow:
            return True
        return False

    def record(self, slots: int) -> None:
        """Pinned host slots for `slots` steps of the window."""
        pin = self.device.type == "cuda"
        self.recorder = Recorder(slots, self.shape, pin)
        self.matchings.allocate(slots, pin)
        self.gen.scheduler._rec = self.recorder

    def window(self, boundary) -> None:
        """Clips until `boundary()` closes the window at a step's end."""
        clip = 0
        while not self._sample(clip, boundary):
            clip += 1

    def end_to_end(self, steps: int, window_s: float) -> dict:
        """The window's seconds over the frames of a relit clip its steps
        make (a step is 1 / n_timesteps of a clip), under the cell's name
        for it."""
        frames = self.shape[0]
        return {self.workload["rate_metric"]: window_s / (frames * steps / self.n_steps)}

    def failed(self) -> int:
        """Recorded steps whose output is not finite."""
        n = len(self.recorder.keys)
        return int((~torch.isfinite(self.recorder.buf[:n, 2]).flatten(1).all(1)).sum())

    def free(self) -> None:
        self.matchings.uninstall()
        self.gen = self.inp = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ reference

    def _ref_unet(self, device, attention_calls=None, match_calls=None) -> RefUNet:
        g = self.settings["generation"]
        tome_cfg = {"chunk_size": g["chunk_size"], "local_ratio": g["local_merge_ratio"],
                    "merge_global": g["merge_global"], "global_ratio": g["global_merge_ratio"],
                    "max_downsample": g["max_downsample"]}
        if torch.device(device).type == "meta":
            w = {k: torch.empty(s, device="meta") for k, s in ref_weights.unet_shapes(self.model)}
        else:
            w = ref_weights.make(self.model, seeds.derive(self.seed, "weights"), device,
                                 _dtype(self.model["dtype"]))
            w = {k: v.float() for k, v in w.items()}
        return RefUNet(w, self.model, tome_cfg, attention_calls, match_calls)

    def step_work(self) -> dict:
        """The model FLOPs of one step and the shapes of its attentions and
        matchings, counted over the reference's step on the meta device
        (with the configuration's CFG dedup)."""
        from torch.utils.flop_counter import FlopCounterMode

        attention_calls, match_calls = [], []
        unet = self._ref_unet("meta", attention_calls, match_calls)
        x = torch.empty(self.shape, device="meta")
        conds = torch.empty(self.shape, device="meta")
        inp = self.inputs()
        e = tuple(torch.empty(t.shape, device="meta") for t in inp.embeds)
        e_t = tuple(torch.empty(t.shape, device="meta") for t in inp.embeds_t)
        d = ref_step.draws(self.settings, self.shape[0], self.shape[2], self.clip_seed(0), 0)[0]
        counter = FlopCounterMode(display=False)
        with counter:
            ref_step.noise_prediction(unet, self.settings, x, conds, e, e_t, 0, d,
                                      dedup=bool(self.settings["generation"]["cfg_dedup"]))
        return {"flops_per_step": counter.get_total_flops(),
                "attention_calls": attention_calls, "match_calls": match_calls}

    def check(self, rng: np.random.Generator) -> dict:
        """{name: (value, limit)} of the numbers compared, over a sample of
        the window's steps drawn from `rng`."""
        rec, dec = self.recorder, self.matchings
        done = set(rec.keys)
        keys = [k for k in rec.keys if k in dec.steps and (k[1] == 0 or (k[0], k[1] - 1) in done)]
        n = min(self.workload["check_steps"], len(keys))
        chosen = [keys[j] for j in sorted(rng.choice(len(keys), size=n, replace=False))]
        dev = self.device
        unet = self._ref_unet(dev)
        unet.tol = self.workload["match_tolerance"]
        inp = self.inputs()
        gaps, eps_gaps = [], []
        t0 = time.perf_counter()
        for clip, i in chosen:
            x, eps_p, out_p = (rec.get((clip, i), j).to(dev) for j in range(3))
            if i == 0 and not torch.equal(x, self.init_noise(clip)):
                raise RuntimeError("step 0 did not start from the clip's init noise")
            prev = None
            if i > 0:
                prev = dpm.x0_of(rec.get((clip, i - 1), 0).to(dev),
                                 rec.get((clip, i - 1), 1).to(dev), i - 1, self.n_steps)
            d = ref_step.draws(self.settings, self.shape[0], self.shape[2], self.clip_seed(clip), i)
            noise = step_noise(self.sde_seed(clip), self.shape, dev, i)
            matchings = dec.get((clip, i))
            if self.variant == "fp8":
                eps_p, matchings = self._fp8_control(unet, x, inp, i, d[i])
                out_p = dpm.step(i, self.n_steps, x, eps_p, prev, noise)
            unet.matchings = iter(matchings)
            eps_r = ref_step.noise_prediction(unet, self.settings, x, inp.conds, inp.embeds,
                                              inp.embeds_t, i, d[i])
            if next(unet.matchings, None) is not None:
                raise ValueError("the program made more matchings than the reference")
            unet.matchings = None
            out_r = dpm.step(i, self.n_steps, x, eps_r, prev, noise)
            gaps.append(_frame_rel(out_p - out_r, out_r - x))
            eps_gaps.append(_frame_rel(eps_p - eps_r, eps_r))
        limit = self.workload["limits"]["update_gap"]
        return {"checked": chosen,
                "numbers": {"update_gap": (max(gaps) if gaps else math.inf, limit)},
                "info": {"eps_gap": max(eps_gaps) if eps_gaps else math.inf,
                         "update_gap_median": float(np.median(gaps)) if gaps else math.inf,
                         "check_s": time.perf_counter() - t0, "dropped": rec.dropped + dec.dropped,
                         **self.timings, **unet.stats}}


    def _fp8_control(self, unet: RefUNet, x, inp, i: int, draws):
        """The control's noise prediction: the reference with every
        product's operands in fp8, and its own matchings."""
        unet.quant, unet.record = ref_unet_mod.fp8, []
        try:
            eps = ref_step.noise_prediction(unet, self.settings, x, inp.conds, inp.embeds,
                                            inp.embeds_t, i, draws)
            return eps, unet.record
        finally:
            unet.quant, unet.record, unet._qcache = None, None, {}


def _frame_rel(diff: torch.Tensor, ref: torch.Tensor) -> float:
    """max over frames of |diff| / |ref| (Frobenius norms per frame)."""
    num = diff.flatten(1).norm(dim=1)
    den = ref.flatten(1).norm(dim=1)
    return float((num / den).max())
