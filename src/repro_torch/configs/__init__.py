"""Architecture registry. Each architecture is a module with a CONFIG of
its published dims. Only olmo-1b is ported so far; the reference's other
configs raise ``NotImplementedError`` until they are ported (ROADMAP A8)."""
from __future__ import annotations

import importlib

ARCHS = ("olmo_1b",)

_ALIASES = {"olmo-1b": "olmo_1b"}


# the reference's other architectures: module name -> alias
_LATER = {"gemma3_27b": "gemma3-27b", "xlstm_125m": "xlstm-125m",
          "seamless_m4t_medium": "seamless-m4t-medium",
          "llama32_vision_90b": "llama-3.2-vision-90b", "starcoder2_15b": "starcoder2-15b",
          "zamba2_7b": "zamba2-7b", "minitron_4b": "minitron-4b",
          "mixtral_8x22b": "mixtral-8x22b", "dbrx_132b": "dbrx-132b",
          "progressivenet_cnn": "progressivenet-cnn"}


def get_config(name: str):
    if name in _LATER or name in _LATER.values():
        raise NotImplementedError(f"arch {name!r} is still to be ported (ROADMAP A8)")
    mod_name = _ALIASES.get(name, name.replace("-", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
