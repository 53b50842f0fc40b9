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

# The leaves whose split dim the model contracts: the tied embedding
# (vocab, d_model) is split on d_model, and the unembedding
# ``x @ embed.T`` sums over d_model. Sharded serving never adds partial
# sums (they would reorder the float adds), so it gathers such a leaf
# whole on the home device after each upgrade that touches it.
GATHERED_LEAVES = frozenset({"embed"})


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


_RECURRENT_SLOT = re.compile(r"(^|/)\d+_(mamba2|mlstm|slstm)/")
_CROSS_SLOT = re.compile(r"(^|/)\d+_(enc_attn|cross|selfcross)/")


def check_shardable(paths) -> None:
    """Raise for a model sharded serving does not take yet (ROADMAP A13):
    one with recurrent blocks, whose ``conv_w`` and ``r`` the rules above
    would split on their last dim while the recurrences read them
    elementwise; one with an encoder or cross-attention blocks, whose
    memory caches and encoder pass no sharded engine builds yet."""
    paths = list(paths)
    for pattern, what in ((_RECURRENT_SLOT, "recurrent"), (_CROSS_SLOT, "cross-attention")):
        kinds = sorted({m.group(2) for p in paths if (m := pattern.search(p))})
        if kinds:
            raise NotImplementedError(f"sharded serving of {what} blocks {kinds} is still "
                                      "to be ported (ROADMAP A13)")


def gathered_for_serving(path: str) -> bool:
    """Whether sharded serving gathers this leaf on the home device
    (:data:`GATHERED_LEAVES`)."""
    return path.rsplit("/", 1)[-1] in GATHERED_LEAVES
