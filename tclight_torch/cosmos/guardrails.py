"""Guardrails: text and video safety checks around generation (counterpart
of tclight_tpu/cosmos/guardrails.py).

A `GuardrailRunner` composes checkers and postprocessors. The blocklist
(exact and lemmatized word or phrase match) is plain Python. The
model-backed checkers (the Aegis prompt classifier, the SigLIP video
content filter, the RetinaFace face blur) pass everything through when no
checkpoint is configured, as in JAX, and take any `predict` callable; the
models themselves are not ported yet, so an existing checkpoint raises
NotImplementedError rather than passing unchecked.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Protocol, Sequence

import numpy as np

__all__ = ["GuardrailRunner", "Blocklist", "SafetyResult", "presets_text", "presets_video",
           "AegisChecker", "VideoContentSafetyChecker", "FaceBlurFilter"]


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

    def __init__(self, ckpt_dir=None, predict: Callable | None = None):
        self.ckpt_dir = ckpt_dir
        self.predict = predict

    def _refuse_checkpoint(self) -> None:
        """An existing checkpoint raises: its model is not ported."""
        if self.ckpt_dir is not None and Path(str(self.ckpt_dir)).exists():
            raise NotImplementedError(
                f"{self.name}: the checkpoint-backed model is not ported to tclight_torch "
                f"yet; run without {self.ckpt_dir} or pass a predict callable")

    def __call__(self, item) -> SafetyResult:
        if self.predict is not None:
            return self.predict(item)
        self._refuse_checkpoint()
        return SafetyResult(True, f"{self.name}: no checkpoint, pass-through")


class AegisChecker(ModelBackedChecker):
    """The LlamaGuard-7B + Aegis LoRA prompt checker."""

    name = "aegis"


class VideoContentSafetyChecker(ModelBackedChecker):
    """The SigLIP-so400m encoder and 7-class safety head over frames."""

    name = "video-safety-siglip"


class FaceBlurFilter(ModelBackedChecker):
    """Postprocessor pixelating RetinaFace detections; the identity
    without a checkpoint."""

    name = "face-blur"

    def process(self, frames: np.ndarray) -> np.ndarray:
        if self.predict is not None:
            return self.predict(frames)
        self._refuse_checkpoint()
        return frames


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


def presets_text(blocklist_file=None, aegis_ckpt=None) -> GuardrailRunner:
    """Text preset: the blocklist, then Aegis."""
    return GuardrailRunner([Blocklist(blocklist_file=blocklist_file), AegisChecker(aegis_ckpt)])


def presets_video(siglip_ckpt=None, retinaface_ckpt=None) -> GuardrailRunner:
    """Video preset: the safety filter, then the face blur."""
    return GuardrailRunner([VideoContentSafetyChecker(siglip_ckpt)],
                           postprocessors=[FaceBlurFilter(retinaface_ckpt)])
