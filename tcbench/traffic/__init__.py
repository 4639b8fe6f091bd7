"""Traffic: each mix is a data file `<name>.json` in this folder whose
`generator` names a module here that makes it from the run's seed."""

from __future__ import annotations

import importlib


def generator(params: dict):
    return importlib.import_module(f"tcbench.traffic.{params['generator']}")
