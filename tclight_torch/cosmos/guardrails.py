"""Guardrails: text and video safety checks around generation (counterpart
of tclight_tpu/cosmos/guardrails.py).

A `GuardrailRunner` composes checkers and postprocessors. The blocklist
(exact and lemmatized word or phrase match) is plain Python. The
model-backed checkers load their model from a checkpoint directory that
exists and run it, as JAX's do: `AegisChecker` the LlamaGuard-7B + Aegis
LoRA prompt classifier (`cosmos/aegis.py`), `VideoContentSafetyChecker`
SigLIP-so400m and the 7-class head over frames sampled at 2 fps
(`models/siglip.py`; `siglip_vision.safetensors` and `safety_filter.pt`),
`FaceBlurFilter` RetinaFace-R50 and the pixelation
(`models/retinaface.py`; the first `*.pth` / `*.safetensors`). Without a
checkpoint each passes everything through; a `predict` callable always
wins. The models are built on `device` (the card unless the caller asks
for the CPU) when first used.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Protocol, Sequence

import numpy as np

__all__ = ["GuardrailRunner", "Blocklist", "SafetyResult", "presets_text", "presets_video",
           "AegisChecker", "VideoContentSafetyChecker", "FaceBlurFilter", "SAFETY_CLASS_NAMES"]


@dataclasses.dataclass
class SafetyResult:
    is_safe: bool
    message: str = ""


class Checker(Protocol):
    def __call__(self, item) -> SafetyResult: ...


_DEFAULT_BLOCKED = (
    # a minimal seed list; deployments load a full blocklist file
    "gore", "beheading", "nsfw", "child abuse",
)


def _simple_lemma(word: str) -> str:
    """A cheap lemmatizer (the reference uses nltk's WordNet): strips
    common suffixes."""
    for suf in ("ing", "ed", "es", "s"):
        if word.endswith(suf) and len(word) > len(suf) + 2:
            return word[: -len(suf)]
    return word


class Blocklist:
    """Exact and lemmatized word / phrase matching."""

    def __init__(self, words: Sequence[str] | None = None,
                 blocklist_file: str | Path | None = None):
        words = list(words or _DEFAULT_BLOCKED)
        if blocklist_file and Path(blocklist_file).exists():
            words += [w.strip().lower() for w in Path(blocklist_file).read_text().splitlines()
                      if w.strip()]
        self.phrases = {w for w in words if " " in w}
        self.words = {w for w in words if " " not in w}
        self.lemmas = {_simple_lemma(w) for w in self.words}

    def __call__(self, text: str) -> SafetyResult:
        lower = text.lower()
        for p in self.phrases:
            if p in lower:
                return SafetyResult(False, f"blocked phrase: {p}")
        for t in re.findall(r"[a-z']+", lower):
            if t in self.words or _simple_lemma(t) in self.lemmas:
                return SafetyResult(False, f"blocked word: {t}")
        return SafetyResult(True)


class ModelBackedChecker:
    """A checkpoint-gated checker: without a checkpoint (and without a
    `predict` callable) it passes everything through."""

    name = "model-backed"

    def __init__(self, ckpt_dir=None, predict: Callable | None = None, device="cuda"):
        self.ckpt_dir = ckpt_dir
        self.predict = predict
        self.device = device

    def available(self) -> bool:
        return self.predict is not None or bool(
            self.ckpt_dir and Path(str(self.ckpt_dir)).exists())

    def __call__(self, item) -> SafetyResult:
        if self.predict is not None:
            return self.predict(item)
        return SafetyResult(True, f"{self.name}: no checkpoint, pass-through")


class AegisChecker(ModelBackedChecker):
    """The LlamaGuard-7B + Aegis-Defensive LoRA prompt checker: with a
    checkpoint directory, the merged model on the port's AR decoder with
    the reference's moderation template and category parse."""

    name = "aegis"

    def _load(self) -> bool:
        if getattr(self, "_model", None) is not None:
            return True
        if self.ckpt_dir is None or not Path(str(self.ckpt_dir)).exists():
            return False
        from tclight_torch.cosmos.aegis import AegisLlamaGuard

        self._model = AegisLlamaGuard(self.ckpt_dir, device=self.device)
        return True

    def __call__(self, item) -> SafetyResult:
        if self.predict is not None:
            return self.predict(item)
        if self._load():
            safe, msg = self._model.is_safe(str(item))
            return SafetyResult(safe, msg)
        return SafetyResult(True, f"{self.name}: no checkpoint, pass-through")


# the 7-way video safety head's classes
SAFETY_CLASS_NAMES = {
    0: "Safe", 1: "Sexual_Content", 2: "Violence", 3: "Drugs",
    4: "Child_Abuse", 5: "Hate_and_Harassment", 6: "Self-Harm",
}


class VideoContentSafetyChecker(ModelBackedChecker):
    """SigLIP-so400m and the 7-class head over frames sampled at 2 fps
    (`fps`, default 25): any frame not "Safe" marks the video unsafe. The
    checkpoint directory holds `siglip_vision.safetensors` (a transformers
    SiglipVisionModel state dict) and `safety_filter.pt` (the Cosmos
    classifier)."""

    name = "video-safety-siglip"

    def _load(self) -> bool:
        if getattr(self, "_fn", None) is not None:
            return True
        if not self.available() or self.ckpt_dir is None:
            return False
        import torch

        from tclight_torch.models.convert import load_torch_state_dict
        from tclight_torch.models.siglip import (SafetyClassifier, SiglipVisionConfig,
                                                 SiglipVisionTower, convert_safety_classifier,
                                                 convert_siglip_vision)
        from tclight_torch.utils.device import resolve_device

        d = Path(str(self.ckpt_dir))
        vis, clf = d / "siglip_vision.safetensors", d / "safety_filter.pt"
        if not vis.exists() or not clf.exists():
            return False
        device = resolve_device(self.device)
        cfg = SiglipVisionConfig.so400m()
        with torch.device(device):
            tower = SiglipVisionTower(cfg)
            head = SafetyClassifier(input_size=cfg.hidden_size, num_classes=7)
        tower.load_state_dict(convert_siglip_vision(load_torch_state_dict(vis)))
        head.load_state_dict(convert_safety_classifier(load_torch_state_dict(clf)))
        tower.eval().requires_grad_(False)
        head.eval().requires_grad_(False)
        self._image_size = cfg.image_size

        @torch.inference_mode()
        def fn(frames: np.ndarray) -> np.ndarray:
            emb = tower(torch.as_tensor(frames, device=device))
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
            return head(emb).float().cpu().numpy()

        self._fn = fn
        return True

    def __call__(self, frames) -> SafetyResult:
        if self.predict is not None:
            return self.predict(frames)
        if not self._load():
            return SafetyResult(True, f"{self.name}: no checkpoint, pass-through")
        from tclight_torch.models.siglip import preprocess_siglip

        frames = np.asarray(frames)
        step = max(1, int(getattr(self, "fps", 25.0) / 2))
        logits = self._fn(preprocess_siglip(frames[::step], self._image_size))
        for fi, cls in zip(range(0, len(frames), step), logits.argmax(-1)):
            if int(cls) != 0:
                return SafetyResult(False, f"frame {fi}: "
                                    f"{SAFETY_CLASS_NAMES.get(int(cls), 'Unknown')}")
        return SafetyResult(True)


class FaceBlurFilter(ModelBackedChecker):
    """Postprocessor pixelating RetinaFace detections; the identity
    without a checkpoint. `ckpt_dir` names a `Resnet50_Final.pth`-layout
    file, or a directory whose first `*.pth` / `*.safetensors` is one."""

    name = "face-blur"

    def _load(self) -> bool:
        if getattr(self, "_detector", None) is not None:
            return True
        if not self.available() or self.ckpt_dir is None:
            return False
        ckpt = Path(str(self.ckpt_dir))
        if ckpt.is_dir():
            cands = list(ckpt.glob("*.pth")) + list(ckpt.glob("*.safetensors"))
            if not cands:
                return False
            ckpt = cands[0]
        from tclight_torch.models.convert import load_torch_state_dict
        from tclight_torch.models.retinaface import RetinaFaceDetector, convert_retinaface

        self._detector = RetinaFaceDetector(convert_retinaface(load_torch_state_dict(ckpt)),
                                            device=self.device)
        return True

    def process(self, frames: np.ndarray) -> np.ndarray:
        if self.predict is not None:
            return self.predict(frames)
        if not self._load():
            return frames
        return self._detector.blur_faces(np.asarray(frames))


class GuardrailRunner:
    def __init__(self, checkers: Sequence[Checker], postprocessors=()):
        self.checkers = list(checkers)
        self.postprocessors = list(postprocessors)

    def is_safe(self, item) -> SafetyResult:
        for checker in self.checkers:
            res = checker(item)
            if not res.is_safe:
                return res
        return SafetyResult(True)

    def postprocess(self, frames: np.ndarray) -> np.ndarray:
        for post in self.postprocessors:
            frames = post.process(frames)
        return frames


def presets_text(blocklist_file=None, aegis_ckpt=None, device="cuda") -> GuardrailRunner:
    """Text preset: the blocklist, then Aegis."""
    return GuardrailRunner([Blocklist(blocklist_file=blocklist_file),
                            AegisChecker(aegis_ckpt, device=device)])


def presets_video(siglip_ckpt=None, retinaface_ckpt=None, device="cuda") -> GuardrailRunner:
    """Video preset: the safety filter, then the face blur."""
    return GuardrailRunner([VideoContentSafetyChecker(siglip_ckpt, device=device)],
                           postprocessors=[FaceBlurFilter(retinaface_ckpt, device=device)])
