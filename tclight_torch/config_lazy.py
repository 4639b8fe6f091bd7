"""The lazy, Python-file config system of the Cosmos tree (counterpart of
tclight_tpu/config_lazy.py):

- `L(callable)(**kwargs)` builds a declarative call spec, a `ConfigDict`
  with a `_target_` dotted path, which YAML / JSON can serialize;
- `instantiate(spec)` resolves `_target_` and builds nested specs first;
- `override(cfg, "a.b.c=value", ...)` applies dotted-path overrides (the
  values parsed as YAML scalars), refusing a path whose parent is absent;
- `freeze` / `unfreeze` toggle a mutation guard on a `ConfigDict` tree.

It builds on the port's own `ConfigDict` and scalar parser
(tclight_torch/config.py).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Mapping

from tclight_torch.config import ConfigDict, _parse_scalar

__all__ = ["L", "LazyCall", "instantiate", "locate", "override", "freeze", "unfreeze"]

_TARGET = "_target_"


def locate(dotted: str) -> Any:
    """'pkg.module.attr' -> the Python object."""
    parts = dotted.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"cannot locate {dotted!r}")


class LazyCall:
    """`L(MyClass)(a=1, b=L(Other)())` -> a serializable call spec."""

    def __init__(self, target: Callable | str):
        if callable(target):
            target = f"{target.__module__}.{target.__qualname__}"
        self.target = target

    def __call__(self, **kwargs: Any) -> ConfigDict:
        return ConfigDict({_TARGET: self.target, **kwargs})


L = LazyCall


def instantiate(spec: Any) -> Any:
    """Build the objects of call specs, innermost first."""
    if isinstance(spec, Mapping):
        kwargs = {k: instantiate(v) for k, v in spec.items() if k != _TARGET}
        if _TARGET in spec:
            return locate(spec[_TARGET])(**kwargs)
        return ConfigDict(kwargs)
    if isinstance(spec, (list, tuple)):
        return type(spec)(instantiate(v) for v in spec)
    return spec


def _path_parent_exists(cfg: ConfigDict, dotted: str) -> bool:
    parts = dotted.split(".")
    return len(parts) == 1 or cfg.get_path(".".join(parts[:-1])) is not None


def override(cfg: ConfigDict, *assignments: str) -> ConfigDict:
    """Apply 'a.b.c=value' assignments in place."""
    for a in assignments:
        if "=" not in a:
            raise ValueError(f"override must be key=value: {a!r}")
        key, val = a.split("=", 1)
        if cfg.get_path(key) is None and not _path_parent_exists(cfg, key):
            raise KeyError(f"unknown config path {key!r}")
        cfg.set_path(key, _parse_scalar(val))
    return cfg


class _FrozenConfigDict(ConfigDict):
    def __setitem__(self, k, v):
        raise TypeError("config is frozen; call unfreeze() first")


def freeze(cfg: ConfigDict) -> ConfigDict:
    """Make a ConfigDict tree raise on mutation. (ConfigDict's __setattr__
    goes through __setitem__, so the class swap bypasses it.)"""
    for v in cfg.values():
        if isinstance(v, ConfigDict):
            freeze(v)
    object.__setattr__(cfg, "__class__", _FrozenConfigDict)
    return cfg


def unfreeze(cfg: ConfigDict) -> ConfigDict:
    object.__setattr__(cfg, "__class__", ConfigDict)
    for v in cfg.values():
        if isinstance(v, ConfigDict):
            unfreeze(v)
    return cfg
