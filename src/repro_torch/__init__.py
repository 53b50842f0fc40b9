"""PyTorch and CUDA port of ``repro``: progressive transmission and
inference of deep learning models on an NVIDIA H100.

The package imports ``torch`` and numpy only; it keeps ``repro``'s
sub-layout (``core``, ``kernels``, ``models``, ``serving``, ``configs``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions")
    return dev
