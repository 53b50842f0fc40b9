"""Sharding rules of sharded serving.

Counterpart of ``serving_spec_for_param`` and its helpers in
``src/repro/launch/sharding.py``. A spec is a tuple with one entry per
dim of the tensor, each an axis name or None: the counterpart of a
``PartitionSpec``, whose entries it equals. Paths are the ``a/b/c``
strings of ``wire.path_str``, which the wire header carries. The
training rules (``spec_for_param`` and the batch, cache and optimizer
shardings) wait for the training port (ROADMAP A12).
"""
from __future__ import annotations

import re

from repro_torch.launch.mesh import Mesh, model_axis

# The leaves sharded serving gathers whole on the home device, when an
# ingest touched them, on the device and without a host sync, because
# the model reads them other than as a dense weight split on its output
# dim:
# * the tied embedding (vocab, d_model), split on d_model, whose
#   unembedding ``x @ embed.T`` sums over the split dim (sharded serving
#   never adds partial sums: they would reorder the float adds);
# * a Mamba-2 block's ``conv_w`` (conv_width, d_inner), split on d_inner,
#   and an sLSTM block's ``r`` (H, hd, 4 hd), split on 4 hd, which the
#   recurrences read elementwise (the depthwise conv's taps; the per-head
#   recurrent einsum). The reference reads them whole through GSPMD's
#   gather. The rule matches the block slot, never a bare leaf name.
GATHERED_LEAVES = (
    re.compile(r"^embed$"),
    re.compile(r"(^|/)\d+_mamba2/(.+/)?conv_w$"),
    re.compile(r"(^|/)\d+_slstm/(.+/)?r$"),
)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def serving_spec_for_param(path: str, shape: tuple, mesh: Mesh) -> tuple:
    """The spec of one serving weight: only dims that are never reduced
    are sharded, the expert dim of an MoE bank or else the output (last)
    dim, so that every collective is a gather and a sharded server stays
    token-identical to a single device. 1-D and indivisible leaves, and
    every leaf of a 1-wide model axis, are replicated (``()``)."""
    tp = model_axis(mesh)
    tp_size = _axis_size(mesh, tp)
    if tp_size <= 1 or len(shape) < 2:
        return ()
    # stacked cycle params carry a leading n_cycles dim: never shard it
    start = 1 if "cycles/" in path else 0
    if len(shape) - start < 2:
        return ()
    spec: list = [None] * len(shape)
    if re.search(r"we_(gate|up|down)", path) and _divides(shape[start], tp_size):
        spec[start] = tp   # expert dim: indexed per expert, never reduced
        return tuple(spec)
    if _divides(shape[-1], tp_size):
        spec[-1] = tp      # output dim: concatenated, never reduced
        return tuple(spec)
    return ()


def gathered_for_serving(path: str) -> bool:
    """Whether sharded serving gathers this leaf (an ``a/b/c`` path) on
    the home device (:data:`GATHERED_LEAVES`)."""
    return any(rule.search(path) for rule in GATHERED_LEAVES)
