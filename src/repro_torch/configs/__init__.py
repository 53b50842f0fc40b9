"""Architecture registry. Each architecture is a module with a CONFIG of
its published dims. Only olmo-1b is ported so far; the reference's other
configs are still to be ported (ROADMAP A8)."""
from __future__ import annotations

import importlib

ARCHS = ("olmo_1b",)

_ALIASES = {"olmo-1b": "olmo_1b"}


def get_config(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
