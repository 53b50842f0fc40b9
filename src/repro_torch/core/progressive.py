"""ProgressiveModel: the paper's pipeline (Fig. 3) over parameter trees.

Counterpart of ``src/repro/core/progressive.py``.

Server side, once: ``divide(params, policy)`` quantizes every float leaf
(eq. 2), bit-divides it (eq. 3) and organizes the planes into stages.

Client side, per stage: ``ReceiverState.receive(stage)`` ORs the planes
into the device-resident accumulators (eq. 4); ``materialize()``
dequantizes them into the float parameter tree (eq. 5, incremental) and
``materialize_resident()`` hands out the quantized-resident tree, whose
weights stay views of the accumulators.

A parameter tree is a nested dict of tensors. Leaves are visited in the
order of ``jax.tree_util.tree_flatten_with_path`` (sorted keys, empty
dicts contribute nothing), so a tree converted from the JAX package
divides into the same tensors, in the same order, with the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core import bitplanes
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.policy import DivisionPolicy, TensorPlan, UniformPolicy
from repro_torch.core.quantize import quantize


def tree_flatten_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_skeleton(tree, prefix: tuple = ()):
    """The tree's structure: the same nested dicts with each leaf
    replaced by its path."""
    if isinstance(tree, dict):
        return {k: tree_skeleton(v, prefix + (k,)) for k, v in tree.items()}
    return prefix


def tree_unflatten(skeleton, leaves: Mapping[tuple, Any]):
    """Inverse of :func:`tree_skeleton`: fill each path with its leaf."""
    if isinstance(skeleton, dict):
        return {k: tree_unflatten(v, leaves) for k, v in skeleton.items()}
    return leaves[skeleton]


@dataclasses.dataclass
class TensorPlanes:
    """Server-side per-tensor artifact: metadata plus all planes."""

    path: tuple
    plan: TensorPlan
    lo: torch.Tensor
    hi: torch.Tensor
    shape: tuple
    orig_dtype: Any
    planes: list[torch.Tensor]  # MSB-first, len == n_planes
    # the reference's slice fields, for the wire header; divide slices
    # nothing yet (ROADMAP A8)
    slice_axis: int | None = None
    slice_idx: int = 0
    n_slices: int = 1

    @property
    def bits(self) -> int:
        return self.plan.schedule.bits


@dataclasses.dataclass
class ProgressiveModel:
    """The divided model, ready for staged transmission."""

    tensors: list[TensorPlanes]
    treedef: Any                          # tree_skeleton of the params
    n_stages: int
    passthrough: list[tuple[tuple, Any]]  # (path, non-float leaf)

    def stage(self, s: int) -> list[tuple[int, torch.Tensor]]:
        """Planes shipped in stage s (1-indexed): [(tensor_idx, plane)],
        ordered by the policy's priority."""
        if not (1 <= s <= self.n_stages):
            raise ValueError(f"stage {s} outside [1, {self.n_stages}]")
        out = [(i, t.planes[s - 1]) for i, t in enumerate(self.tensors)
               if s <= t.plan.schedule.n_planes]
        out.sort(key=lambda it: (self.tensors[it[0]].plan.priority, it[0]))
        return out


def divide(params, policy: DivisionPolicy | None = None) -> ProgressiveModel:
    """Quantize and bit-divide a parameter tree (paper steps 1-2). The
    planes stay on the device the parameters lie on."""
    policy = policy or UniformPolicy()
    tensors: list[TensorPlanes] = []
    passthrough: list[tuple[tuple, Any]] = []
    for path, leaf in tree_flatten_with_path(params):
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            passthrough.append((path, leaf))
            continue
        if policy.slice_spec(path, tuple(leaf.shape)) is not None:
            raise NotImplementedError(
                "sliced tensors (per-expert ranges) are still to be ported "
                "(ROADMAP A8)")
        plan = policy.plan(path, tuple(leaf.shape), leaf.dtype)
        qt = quantize(leaf, plan.schedule.bits)
        tensors.append(TensorPlanes(
            path=path, plan=plan, lo=qt.lo, hi=qt.hi, shape=tuple(leaf.shape),
            orig_dtype=leaf.dtype, planes=bitplanes.split(qt, plan.schedule.widths)))
    return ProgressiveModel(tensors=tensors, treedef=tree_skeleton(params),
                            n_stages=policy.n_stages, passthrough=passthrough)


@dataclasses.dataclass
class ReceiverState:
    """Client-side accumulator (paper steps 3-4), a thin functional shell
    over :class:`~repro_torch.core.plane_store.PlaneStore`. ``receive``
    is the eq. (4) OR, one kernel launch per container dtype."""

    model_meta: ProgressiveModel  # planes unused client-side; meta only
    store: PlaneStore
    received_stages: int = 0

    @classmethod
    def init(cls, model: ProgressiveModel, *, device="cuda") -> "ReceiverState":
        return cls(model_meta=model, store=PlaneStore.from_model(model, device=device))

    def receive(self, stage_planes: Sequence[tuple[int, torch.Tensor]]) -> "ReceiverState":
        store = self.store.copy()
        store.ingest(stage_planes)
        return dataclasses.replace(self, store=store,
                                   received_stages=self.received_stages + 1)

    def effective_bits(self, tensor_idx: int) -> int:
        return self.store.effective_bits(tensor_idx)

    def materialize(self):
        """The float parameter tree at the current precision (eq. 5):
        only tensors touched since the last call are dequantized again."""
        return rebuild_params(self.model_meta, self.store.materialize_leaves())

    def materialize_resident(self, eligible=None, *, bits=None):
        """The quantized-resident parameter tree: eligible weight leaves
        stay :class:`~repro_torch.core.quantize.QuantizedTensor` views of
        the store's accumulators (no float copy); the rest dequantize.
        ``eligible`` defaults to the model dispatch's matmul-leaf
        predicate."""
        if eligible is None:
            from repro_torch.models.common import quantized_resident_eligible
            eligible = quantized_resident_eligible
        return rebuild_params(self.model_meta,
                              self.store.quantized_leaves(eligible=eligible, bits=bits))


def rebuild_params(model: ProgressiveModel, tensor_leaves: Mapping,
                   *, key_fn: Callable[[tuple], Any] | None = None):
    """Rebuild the parameter tree from per-leaf values keyed by
    ``key_fn(path)`` (default: the path itself); non-float passthrough
    leaves come from the model meta."""
    key_fn = key_fn or (lambda p: p)
    leaves = dict(model.passthrough)
    for t in model.tensors:
        leaves[t.path] = tensor_leaves[key_fn(t.path)]
    return tree_unflatten(model.treedef, leaves)


def transmit_reconstruct(params, policy: DivisionPolicy | None = None,
                         upto_stage: int | None = None, *, device="cuda"):
    """Divide, receive stages 1..``upto_stage`` (default: all) into a
    receiver on ``device``, and materialize: the float parameters a
    client holds after that many stages."""
    model = divide(params, policy)
    upto = model.n_stages if upto_stage is None else upto_stage
    st = ReceiverState.init(model, device=device)
    for s in range(1, upto + 1):
        st = st.receive(model.stage(s))
    return st.materialize()
