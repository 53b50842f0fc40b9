"""Parameters from the JAX package, for tests that hold the port against it.

``params_from_numpy`` takes the JAX package's parameter tree after the
caller has converted every leaf to a numpy array (``jax.tree.map(np.asarray,
params)``) and returns the port's tree: the same nested dicts, each
array a tensor on ``device``. Both packages then compute on the same
bytes. A leaf that is already a tensor (weights drawn on the host) is
copied to ``device`` as it is. This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree, *, device="cuda"):
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return torch.from_numpy(np.array(tree)).to(device)
