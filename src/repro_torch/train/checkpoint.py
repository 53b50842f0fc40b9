"""Progressive checkpointing: the paper's technique on the path from a
checkpoint store to the device.

Counterpart of ``src/repro/train/checkpoint.py``, writing the same
files::

    header.bin           wire header (tensor metadata, schedule)
    stage_01.bin ...     bit-packed planes, MSB stage first
    passthrough.npz      non-float leaves (step counters and the like)

``save`` divides the params on their device (B6 ``plane_extract``, 8
launches a tensor on the card) and packs each stage with
``wire.encode_stage``; ``load_flat`` feeds the files through a
``ProgressiveClient`` (B1 ``plane_or_segments``, one launch a stage), so a
cold-starting server can begin from ``stage_01`` alone (2 bits a weight
under the paper's schedule) and upgrade as the later files land.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core import wire
from repro_torch.core.policy import DivisionPolicy
from repro_torch.core.progressive import (ProgressiveModel, divide, tree_flatten_with_path,
                                          tree_skeleton, tree_unflatten)
from repro_torch.transmission.client import ProgressiveClient


def save(params, ckpt_dir: str, policy: DivisionPolicy | None = None) -> ProgressiveModel:
    """Divide ``params`` (no gradient is recorded) and write the header,
    a file a stage and the passthrough leaves into ``ckpt_dir``. Returns
    the divided model."""
    os.makedirs(ckpt_dir, exist_ok=True)
    with torch.no_grad():
        model = divide(params, policy)
    with open(os.path.join(ckpt_dir, "header.bin"), "wb") as f:
        f.write(wire.encode_header(model))
    for s in range(1, model.n_stages + 1):
        with open(os.path.join(ckpt_dir, f"stage_{s:02d}.bin"), "wb") as f:
            f.write(wire.encode_stage(model, s))
    passthrough = {wire.path_str(p): leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf) for p, leaf in model.passthrough}
    np.savez(os.path.join(ckpt_dir, "passthrough.npz"), **passthrough)
    return model


def feed(ckpt_dir: str, stages: int | None = None, *, device="cuda") -> ProgressiveClient:
    """A ``ProgressiveClient`` on ``device`` fed the header and the first
    ``stages`` stage files (all of them by default): its store holds the
    stages' accumulators."""
    client = ProgressiveClient(device=resolve_device(device))
    with open(os.path.join(ckpt_dir, "header.bin"), "rb") as f:
        client.feed(f.read())
    s = 1
    while True:
        p = os.path.join(ckpt_dir, f"stage_{s:02d}.bin")
        if not os.path.exists(p) or (stages is not None and s > stages):
            break
        with open(p, "rb") as f:
            client.feed(f.read())
        s += 1
    return client


def load_flat(ckpt_dir: str, stages: int | None = None, *, device="cuda") -> dict:
    """The checkpoint as a flat ``{path: tensor}`` on ``device``: the
    client of :func:`feed` materialised, the passthrough leaves beside."""
    device = resolve_device(device)
    flat = feed(ckpt_dir, stages, device=device).materialize()
    with np.load(os.path.join(ckpt_dir, "passthrough.npz")) as pt:
        for k in pt.files:
            flat[k] = to_device(pt[k], device)
    return flat


def load_into(ckpt_dir: str, params_like, stages: int | None = None, *, device="cuda"):
    """The checkpoint in the tree of ``params_like`` (params, or ``meta``
    tensors of their shapes and dtypes), each leaf reshaped to its
    counterpart's shape and cast to its dtype, on ``device``."""
    flat = load_flat(ckpt_dir, stages, device=device)
    out = {}
    for path, leaf in tree_flatten_with_path(params_like):
        key = wire.path_str(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor {key}")
        out[path] = flat[key].reshape(leaf.shape).to(leaf.dtype)
    return tree_unflatten(tree_skeleton(params_like), out)


def manifest(ckpt_dir: str) -> dict:
    """Stage sizes: what a transfer scheduler needs."""
    with open(os.path.join(ckpt_dir, "header.bin"), "rb") as f:
        meta, hdr = wire.decode_header(f.read())
    sizes = {}
    s = 1
    while os.path.exists(os.path.join(ckpt_dir, f"stage_{s:02d}.bin")):
        sizes[s] = os.path.getsize(os.path.join(ckpt_dir, f"stage_{s:02d}.bin"))
        s += 1
    return {"header_bytes": hdr, "stage_bytes": sizes, "n_tensors": len(meta["tensors"])}
