"""Config system: YAML + recursive base-config merge + ``${a.b}`` interpolation
+ CLI overrides.

Reproduces the behavior of the reference's OmegaConf-based loader
(utils/VidToMe/config_utils.py:6-74 in Linketic/TC-Light): a config YAML may
name a ``base_config``; bases are merged recursively (leaf config wins),
string values may interpolate other keys with ``${dotted.path}``, the CLI
offers fast-path flags (``-i/-p/-n/--multi_axis``) plus dotted
``key=value`` overrides, prompts are normalized to a ``{name: prompt}`` dict,
and the work dir is auto-versioned as ``<work_dir>/<date>/<video>/<tag>-NNNNN``.

The PyTorch port's own copy of tclight_tpu/config.py. Implementation is
self-contained (no OmegaConf): a lightweight attribute-access
dict (`ConfigDict`) over plain YAML.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import os
import re
from pathlib import Path
from typing import Any, Iterator, Mapping

import yaml

__all__ = [
    "ConfigDict",
    "load_yaml",
    "merge",
    "resolve",
    "load_config",
    "save_config",
    "default_config_path",
    "iter_leaves",
]

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigDict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return _unwrap(self)

    def copy(self) -> "ConfigDict":  # type: ignore[override]
        return ConfigDict(copy.deepcopy(self.to_dict()))


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def load_yaml(path: str | os.PathLike) -> ConfigDict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return ConfigDict(data)


def merge(base: Mapping, override: Mapping) -> ConfigDict:
    """Recursive merge; `override` leaves win. Mirrors OmegaConf.merge."""
    out = ConfigDict(copy.deepcopy(_unwrap(base)))
    for k, v in override.items():
        if (
            k in out
            and isinstance(out[k], Mapping)
            and isinstance(v, Mapping)
        ):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(_unwrap(v))
    return out


def _load_with_bases(path: str | os.PathLike, _seen: tuple = ()) -> ConfigDict:
    """Load a YAML and recursively merge its `base_config` chain
    (reference: config_utils.py:33-37)."""
    path = Path(path)
    if str(path) in _seen:
        raise ValueError(f"base_config cycle at {path}")
    cfg = load_yaml(path)
    base = cfg.pop("base_config", None)
    if base:
        base_path = Path(base)
        if not base_path.is_absolute() and not base_path.exists():
            candidate = path.parent / base_path
            if candidate.exists():
                base_path = candidate
        base_cfg = _load_with_bases(base_path, _seen + (str(path),))
        cfg = merge(base_cfg, cfg)
    return cfg


def resolve(cfg: ConfigDict, _root: ConfigDict | None = None) -> ConfigDict:
    """Resolve ``${dotted.path}`` interpolations (OmegaConf-style)."""
    root = _root if _root is not None else cfg

    def _resolve_value(v: Any, depth: int = 0) -> Any:
        if depth > 16:
            raise ValueError("interpolation depth exceeded (cycle?)")
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v)
            if m:
                target = root.get_path(m.group(1))
                if target is None:
                    return v
                return _resolve_value(target, depth + 1)

            def repl(m: re.Match) -> str:
                target = root.get_path(m.group(1))
                if target is None:
                    return m.group(0)
                return str(_resolve_value(target, depth + 1))

            return _INTERP_RE.sub(repl, v)
        if isinstance(v, Mapping):
            return ConfigDict({k: _resolve_value(x, depth) for k, x in v.items()})
        if isinstance(v, list):
            return [_resolve_value(x, depth) for x in v]
        return v

    return _resolve_value(cfg)  # type: ignore[return-value]


def default_config_path() -> Path:
    return Path(__file__).resolve().parent.parent / "configs" / "tclight_default.yaml"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TC-Light (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help="config yaml")
    p.add_argument("--base_config", type=str, default=None, help="base config yaml")
    p.add_argument("-i", "--input", type=str, default=None, help="input video path")
    p.add_argument("-p", "--prompt", type=str, default=None, help="edit prompt")
    p.add_argument("-n", "--n_frames", type=int, default=None, help="number of frames")
    p.add_argument("--multi_axis", action="store_true", help="enable yt-plane denoising")
    p.add_argument(
        "overrides",
        nargs="*",
        default=[],
        help="dotted key=value overrides, e.g. generation.chunk_size=2",
    )
    return p


def _parse_scalar(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_config(argv: list[str] | None = None) -> ConfigDict:
    """CLI entrypoint config loader (reference: config_utils.py:6-65)."""
    args = build_argparser().parse_args(argv)

    cfg_path = args.config or str(default_config_path())
    cfg = _load_with_bases(cfg_path)
    if args.base_config:
        cfg = merge(_load_with_bases(args.base_config), cfg)

    # fast-path CLI flags (reference :40-54)
    if args.input is not None:
        cfg.set_path("data.rgb_path", args.input)
    if args.prompt is not None:
        cfg.set_path("generation.prompt", args.prompt)
    if args.n_frames is not None:
        n = args.n_frames
        cfg.set_path("generation.frame_range", [0, n, 1])
    if args.multi_axis:
        cfg.set_path("generation.alpha_t", 0.4)

    for ov in args.overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        cfg.set_path(k, _parse_scalar(v))

    cfg = resolve(cfg)
    cfg = normalize_prompts(cfg)
    cfg = assign_workdir(cfg)
    return cfg


def normalize_prompts(cfg: ConfigDict) -> ConfigDict:
    """Normalize generation.prompt to a {name: prompt} dict
    (reference: config_utils.py:56-59)."""
    gen = cfg.get("generation")
    if gen is None:
        return cfg
    prompt = gen.get("prompt")
    if prompt is None:
        gen["prompt"] = ConfigDict({"default": None})
    elif isinstance(prompt, str):
        name = prompt_tag(prompt)
        gen["prompt"] = ConfigDict({name: prompt})
    return cfg


def prompt_tag(prompt: str | None, max_words: int = 5) -> str:
    if not prompt:
        return "default"
    words = re.sub(r"[^a-zA-Z0-9 ]", "", prompt).split()
    return "_".join(words[:max_words]) or "default"


def assign_workdir(cfg: ConfigDict, now: datetime.datetime | None = None) -> ConfigDict:
    """Auto-versioned workdir `<work_dir>/<date>/<video>/<tag>-NNNNN`
    (reference: config_utils.py workdir naming)."""
    if "work_dir" not in cfg:
        return cfg
    now = now or datetime.datetime.now()
    date = now.strftime("%Y-%m-%d")
    rgb_path = cfg.get_path("data.rgb_path") or "video"
    video = Path(str(rgb_path)).stem or "video"
    prompts = cfg.get_path("generation.prompt")
    if isinstance(prompts, Mapping) and prompts:
        tag = next(iter(prompts.keys()))
    else:
        tag = "default"
    base = Path(cfg["work_dir"]) / date / video
    idx = 0
    while (base / f"{tag}-{idx:05d}").exists():
        idx += 1
    cfg["work_dir"] = str(base / f"{tag}-{idx:05d}")
    # keep dependent interpolations (already resolved) untouched
    return cfg


def save_config(cfg: ConfigDict, path: str | os.PathLike) -> None:
    """Save a run-config snapshot, dropping the inversion branch like the
    reference's save_config (config_utils.py:67-74)."""
    out = cfg.copy()
    out.pop("inversion", None)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(out.to_dict(), f, sort_keys=False)


def iter_leaves(cfg: Mapping, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(dotted key, value) of every leaf of a nested config, in order."""
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from iter_leaves(v, key)
        else:
            yield key, v
