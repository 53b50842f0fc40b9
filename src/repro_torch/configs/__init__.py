"""Architecture registry. Each architecture is a module with a CONFIG of
its published dims. The dense decoders are ported (olmo-1b, minitron-4b,
starcoder2-15b, and gemma3-27b with its sliding windows), the
mixture-of-experts decoders (mixtral-8x22b, dbrx-132b), the recurrent
ones (xlstm-125m, zamba2-7b) and the cross-attention ones
(seamless-m4t-medium, an encoder-decoder; llama-3.2-vision-90b, a vision
decoder), and the paper's own CNN (progressivenet-cnn: its ``CONFIG`` is
the reference's ``ArchConfig``, the CNN ``cnn_init``/``cnn_apply`` in its
module)."""
from __future__ import annotations

import importlib

ARCHS = ("olmo_1b", "minitron_4b", "starcoder2_15b", "gemma3_27b", "mixtral_8x22b",
         "dbrx_132b", "xlstm_125m", "zamba2_7b", "seamless_m4t_medium", "llama32_vision_90b",
         "progressivenet_cnn")

_ALIASES = {"olmo-1b": "olmo_1b", "minitron-4b": "minitron_4b",
            "starcoder2-15b": "starcoder2_15b", "gemma3-27b": "gemma3_27b",
            "mixtral-8x22b": "mixtral_8x22b", "dbrx-132b": "dbrx_132b",
            "xlstm-125m": "xlstm_125m", "zamba2-7b": "zamba2_7b",
            "seamless-m4t-medium": "seamless_m4t_medium",
            "llama-3.2-vision-90b": "llama32_vision_90b",
            "progressivenet-cnn": "progressivenet_cnn"}


def get_config(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
