"""Single-tensor view of the quantized-resident serving path.

Counterpart of ``src/repro/serving/quantized.py``. The whole-model path
is ``ProgressiveServer(resident="quantized")``, which decodes every
matmul of the transformer straight from the accumulators; this module is
the tensor-level view over the same :class:`PlaneStore`, for
microbenchmarks and tests of one weight matrix.

* ``upgrade()`` ingests in place into the store it views, so every other
  consumer of a shared store (a server, a client) sees the plane at once;
  nothing forks a snapshot of the flat buffer.
* ``matmul`` is ``ops.dequant_matmul`` (eq. 5 inside the kernel) with
  the affine of :func:`~repro_torch.core.quantize.dequant_affine`, the
  helper the engine's views use too.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.progressive import ProgressiveModel
from repro_torch.core.quantize import dequant_affine
from repro_torch.kernels import ops


@dataclasses.dataclass
class QuantizedLinearState:
    """One weight matrix, resident as a view into a PlaneStore segment."""

    store: PlaneStore
    idx: int = 0

    def __post_init__(self):
        if len(self.store.slots[self.idx].shape) != 2:
            raise ValueError("dequant matmul path needs a 2-D weight, got "
                             f"{self.store.slots[self.idx].shape}")

    @property
    def acc(self) -> torch.Tensor:
        return self.store.acc(self.idx)

    @property
    def lo(self) -> torch.Tensor:
        return self.store.slots[self.idx].lo

    @property
    def hi(self) -> torch.Tensor:
        return self.store.slots[self.idx].hi

    @property
    def schedule(self) -> PlaneSchedule:
        return self.store.slots[self.idx].schedule

    @property
    def received(self) -> int:
        return self.store.received[self.idx]

    @property
    def received_bits(self) -> int:
        return self.store.effective_bits(self.idx)

    def upgrade(self, plane: torch.Tensor) -> "QuantizedLinearState":
        """OR the next plane into the store (eq. 4), in place: one ingest
        that every consumer of a shared store sees. Returns ``self``."""
        self.store.ingest([(self.idx, plane)])
        return self

    def matmul(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x @ dequant(acc)`` without a float weight: eq. (5) inside
        ``ops.dequant_matmul`` (keywords go to it). The affine is computed
        where ``lo`` lies and placed on x's device."""
        scale, offset = dequant_affine(self.lo, self.hi, self.schedule.bits,
                                       self.received_bits)
        return ops.dequant_matmul(x, self.acc, scale.to(x.device), offset.to(x.device), **kw)

    @property
    def resident_bytes(self) -> int:
        """Device bytes of this tensor's segment, block padding included."""
        t = self.store.slots[self.idx]
        return t.padded * torch.tensor([], dtype=t.container).element_size()


def from_progressive(model: ProgressiveModel, tensor_idx: int, planes_upto: int = 0,
                     store: PlaneStore | None = None) -> QuantizedLinearState:
    """View one 2-D tensor of a divided model as a resident linear state.
    Pass an existing ``store`` to share residency with other consumers
    (engine, client); ``planes_upto`` planes are then ingested into that
    store, visible to every consumer. Without ``store`` a private store of
    this one tensor is built where its planes lie."""
    t = model.tensors[tensor_idx]
    if store is None:
        store = PlaneStore.from_model(model, indices=[tensor_idx],
                                      device=t.planes[0].device)
        idx = 0
    else:
        # by (key, slice), never by position: a subset store (from_model
        # with indices=) has a compacted slot space
        idx = next((i for i, s in enumerate(store.slots)
                    if s.key == t.path and s.slice_idx == t.slice_idx), None)
        if idx is None:
            raise ValueError(f"store holds no slot for tensor {tensor_idx} "
                             f"(path {t.path})")
    # "at least this many planes resident": planes the store already holds
    # are never ORed again (that would corrupt the accumulator)
    for s in range(store.received[idx], planes_upto):
        store.ingest([(idx, t.planes[s])])
    return QuantizedLinearState(store=store, idx=idx)
