"""PlaneStore: the device-resident receiver runtime (eqs. 4 and 5).

Counterpart of ``src/repro/core/plane_store.py`` ``PlaneStore``, on one
device. The multi-device store is still to be ported.

Layout
------
All tensors sharing a container dtype live in ONE flat 1-D uint buffer;
each tensor occupies a block-aligned segment ``[offset, offset+size)``
(the reference's layout, so ``fingerprint()`` CRCs match it byte for
byte). Per-tensor metadata lives in :class:`TensorSlot` views.

Upgrades (eq. 4)
----------------
``ingest([(tensor_idx, plane), ...])`` assembles one flat plane buffer
plus a per-block int32 shift table and issues ONE ``plane_or_segments``
launch per container dtype. A shipment that touches only some tensors
gathers their segments into a compact buffer, ORs that, and writes the
results into a copy of the buffer. Either way the result is a new
buffer: a store made by :meth:`copy` before the ingest keeps its own.

Float leaves (eq. 5)
-------------------
``materialize_leaves`` dequantizes into float leaves incrementally: only
tensors an ingest touched since the last call are recomputed (one
batched ``dequantize_buffers`` call), the rest come from a leaf cache.

Quantized-resident views (eq. 5)
--------------------------------
``quantized_leaves`` hands out each weight as a live
:class:`QuantizedTensor` whose ``q`` is a view of the flat buffer and
whose affine is a few float32 scalars on the device: no float weight.
``acc(i)`` is one tensor's accumulator view (the single-tensor view of
``serving/quantized.py`` reads it), cached until an ingest replaces the
buffer it lies in.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.quantize import (QuantizedTensor, affine_span, container_dtype,
                                       dequant_affine, dequant_constants,
                                       dequantize_buffers)
from repro_torch.kernels import ops

# Elements per shift-table entry of plane_or_segments.
DEFAULT_BLOCK = 1024


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype: 'uint16' for torch.uint16 (the
    reference's buffer keys), 'bfloat16' for torch.bfloat16 (the wire
    header's names, which ml_dtypes gives numpy)."""
    return str(dtype).rsplit(".", 1)[-1]


# the wire header's dtype names of float leaves -> torch dtypes
FLOAT_DTYPES = {dtype_name(d): d for d in (torch.float32, torch.bfloat16, torch.float16,
                                           torch.float64)}


def next_plane_shift(schedule: PlaneSchedule, received: int) -> int:
    """Eq. (4) shift for the next arriving plane: after ``received``
    planes, plane ``received+1`` lands at ``bits - c_{received+1}``."""
    if received >= schedule.n_planes:
        raise ValueError(f"all {schedule.n_planes} planes already received")
    return schedule.bits - schedule.cumulative_bits[received]


def received_bits(schedule: PlaneSchedule, received: int) -> int:
    """Effective precision m = sum of the first ``received`` widths."""
    return schedule.cumulative_bits[received - 1] if received > 0 else 0


def _entries_from_model(model, indices: Sequence[int] | None = None) -> list[dict]:
    """Per-tensor descriptor dicts from a server-side ProgressiveModel
    (keys are leaf paths), optionally restricted to ``indices``."""
    tensors = (model.tensors if indices is None
               else [model.tensors[i] for i in indices])
    return [{"key": t.path, "schedule": t.plan.schedule, "lo": t.lo, "hi": t.hi,
             "shape": tuple(t.shape), "orig_dtype": t.orig_dtype,
             "slice_axis": t.slice_axis, "slice_idx": t.slice_idx} for t in tensors]


@dataclasses.dataclass(frozen=True)
class TensorSlot:
    """Static per-tensor metadata: a view descriptor into a flat buffer."""

    key: Any                  # leaf path (tuple of keys)
    schedule: PlaneSchedule
    lo: torch.Tensor
    hi: torch.Tensor
    shape: tuple
    orig_dtype: Any
    offset: int               # element offset within the dtype's buffer
    size: int                 # n elements
    padded: int               # block-aligned span (size rounded up)
    slice_axis: int | None = None
    slice_idx: int = 0

    @property
    def bits(self) -> int:
        return self.schedule.bits

    @property
    def container(self) -> torch.dtype:
        return container_dtype(self.bits)


class PlaneStore:
    """Device-resident accumulators for one progressive model."""

    def __init__(self, slots: list[TensorSlot], *, block: int = DEFAULT_BLOCK,
                 device="cuda"):
        self.block = block
        self.slots = slots
        self.device = resolve_device(device)
        self.received = [0] * len(slots)
        # dtype name -> flat uint buffer (length: multiple of block)
        self.buffers: dict[str, torch.Tensor] = {}
        sizes: dict[str, tuple[int, torch.dtype]] = {}
        for t in slots:
            dt = dtype_name(t.container)
            sizes[dt] = (max(sizes.get(dt, (0,))[0], t.offset + t.padded), t.container)
        for dt, (n, dtype) in sizes.items():
            self.buffers[dt] = torch.zeros((n,), dtype=dtype, device=self.device)
        # float leaves: slots touched since the last materialization, and
        # the leaves of the untouched ones
        self._dirty: set[int] = set(range(len(slots)))
        self._leaf_cache: dict[Any, torch.Tensor] = {}
        # stacked eq.-(5) constants per batch of slots; lo/hi/bits never
        # change after the header, so never invalidated
        self._consts_cache: dict[tuple, tuple] = {}
        self._qleaf_cache: dict[Any, QuantizedTensor] = {}
        # truncated views by (key, bits), dropped with the key's full view
        self._qtrunc_cache: dict[tuple, QuantizedTensor] = {}
        # slot -> accumulator view, filled by acc() only, dropped by ingest
        self._acc_cache: dict[int, torch.Tensor] = {}
        # per-key affine constants that no upgrade changes (lo/hi/scale on
        # the device, host float32 copies of lo and span for the offsets)
        self._qmeta_cache: dict[Any, dict] = {}

    # -- construction ------------------------------------------------------
    @staticmethod
    def _layout(entries, block):
        """Assign (offset, size, padded) per entry, grouped by container dtype."""
        cursors: dict[str, int] = {}
        out = []
        for e in entries:
            dt = dtype_name(container_dtype(e["schedule"].bits))
            size = int(np.prod(e["shape"])) if e["shape"] else 1
            padded = -(-size // block) * block
            off = cursors.get(dt, 0)
            cursors[dt] = off + padded
            out.append((off, size, padded))
        return out

    @classmethod
    def _from_entries(cls, entries: list[dict], *, block: int, device) -> "PlaneStore":
        """Build from per-tensor descriptor dicts (key, schedule, lo, hi,
        shape, orig_dtype), laid out in order."""
        slots = [TensorSlot(**e, offset=off, size=size, padded=padded)
                 for e, (off, size, padded) in zip(entries, cls._layout(entries, block))]
        return cls(slots, block=block, device=device)

    @classmethod
    def from_model(cls, model, *, block: int = DEFAULT_BLOCK,
                   indices: Sequence[int] | None = None, device="cuda") -> "PlaneStore":
        """Build from a server-side :class:`ProgressiveModel` (keys are
        leaf paths). ``indices`` restricts the store to those tensors:
        slot i is then ``model.tensors[indices[i]]``, and only their
        buffers are allocated."""
        return cls._from_entries(_entries_from_model(model, indices), block=block,
                                 device=device)

    @classmethod
    def from_wire_meta(cls, meta, *, block: int = DEFAULT_BLOCK, device="cuda"
                       ) -> "PlaneStore":
        """Build from a decoded wire header (keys are path strings; lo and
        hi stay on the host, where the quantized views read them)."""
        if any(t.get("slice_axis") is not None for t in meta["tensors"]):
            raise NotImplementedError("sliced tensors (per-expert ranges) are still to "
                                      "be ported (ROADMAP A8)")
        return cls._from_entries(
            [{"key": t["path"],
              "schedule": PlaneSchedule(bits=t["bits"], widths=tuple(t["widths"])),
              "lo": torch.tensor(t["lo"], dtype=torch.float32),
              "hi": torch.tensor(t["hi"], dtype=torch.float32),
              "shape": tuple(t["shape"]), "orig_dtype": FLOAT_DTYPES[t["dtype"]]}
             for t in meta["tensors"]],
            block=block, device=device)

    def copy(self) -> "PlaneStore":
        """Cheap snapshot: ingest never writes into a buffer, it replaces
        it, so sharing the buffers is safe; bookkeeping is shallow-copied."""
        new = object.__new__(PlaneStore)
        new.block = self.block
        new.slots = self.slots
        new.device = self.device
        new.received = list(self.received)
        new.buffers = dict(self.buffers)
        new._dirty = set(self._dirty)
        new._leaf_cache = dict(self._leaf_cache)
        new._consts_cache = dict(self._consts_cache)
        new._qleaf_cache = dict(self._qleaf_cache)
        new._qtrunc_cache = dict(self._qtrunc_cache)
        new._acc_cache = dict(self._acc_cache)
        new._qmeta_cache = self._qmeta_cache
        return new

    # -- views -------------------------------------------------------------
    def _slice_acc(self, i: int) -> torch.Tensor:
        t = self.slots[i]
        buf = self.buffers[dtype_name(t.container)]
        return buf[t.offset:t.offset + t.size].reshape(t.shape)

    def acc(self, i: int) -> torch.Tensor:
        """Tensor i's accumulator: a view into the flat buffer, cached
        until an ingest replaces that buffer (a view kept across the
        tensor's own ingest would read the old bits). One-shot readers
        slice without caching."""
        got = self._acc_cache.get(i)
        if got is None:
            got = self._slice_acc(i)
            self._acc_cache[i] = got
        return got

    def quantized(self, i: int) -> QuantizedTensor:
        t = self.slots[i]
        return QuantizedTensor(q=self._slice_acc(i), lo=t.lo, hi=t.hi, bits=t.bits,
                               orig_dtype=t.orig_dtype)

    def effective_bits(self, i: int) -> int:
        return received_bits(self.slots[i].schedule, self.received[i])

    @property
    def n_tensors(self) -> int:
        return len(self.slots)

    def resident_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers.values())

    def fingerprint(self) -> dict[str, int]:
        """CRC32 of each flat accumulator buffer's bytes, keyed by
        container dtype: equal to the reference store's iff the
        accumulator state is bit-identical. Copies to the host; an audit,
        not a hot path."""
        return {dt: int(zlib.crc32(buf.cpu().numpy()))
                for dt, buf in sorted(self.buffers.items())}

    # -- eq. (4): batched upgrade -----------------------------------------
    def ingest(self, items: Sequence[tuple[int, torch.Tensor]]) -> None:
        """OR a shipment of planes into the store. ``items`` holds
        ``(tensor_idx, plane_values)`` pairs; each plane is the *next*
        plane of its tensor's schedule. One ``plane_or_segments`` launch
        per container dtype per round; several planes of one tensor go
        in successive rounds. The shipment is validated up front, so a
        bad item leaves the store untouched."""
        pending = list(items)
        counts: dict[int, int] = {}
        for idx, plane in pending:
            t = self.slots[idx]
            n = plane.numel()
            if n != t.size:
                raise ValueError(f"plane for tensor {idx} has {n} elements, "
                                 f"expected {t.size}")
            counts[idx] = counts.get(idx, 0) + 1
        for idx, c in counts.items():
            have, total = self.received[idx], self.slots[idx].schedule.n_planes
            if have + c > total:
                raise ValueError(f"tensor {idx}: {have} planes received + {c} "
                                 f"arriving exceeds schedule of {total}")
        while pending:
            round_items: dict[int, torch.Tensor] = {}
            rest = []
            for idx, plane in pending:
                if idx in round_items:
                    rest.append((idx, plane))
                else:
                    round_items[idx] = plane
            self._ingest_round(round_items)
            pending = rest

    def round_operands(self, items: dict[int, torch.Tensor]
                       ) -> dict[str, tuple[list[int], torch.Tensor, torch.Tensor]]:
        """The operands of one OR round, per container dtype: the touched
        slots in buffer order, the flat plane buffer (each plane cast to
        the container dtype at its slot's place in a compact layout) and
        the int32 shift table, one entry per block."""
        by_dtype: dict[str, list[int]] = {}
        for idx in items:
            by_dtype.setdefault(dtype_name(self.slots[idx].container), []).append(idx)
        out = {}
        for dt, idxs in by_dtype.items():
            idxs.sort(key=lambda i: self.slots[i].offset)
            total = sum(self.slots[i].padded for i in idxs)
            shifts = np.empty((total // self.block,), np.int32)
            plane = torch.zeros((total,), dtype=self.buffers[dt].dtype, device=self.device)
            pos = 0
            for idx in idxs:
                t = self.slots[idx]
                shifts[pos // self.block:(pos + t.padded) // self.block] = \
                    next_plane_shift(t.schedule, self.received[idx])
                plane[pos:pos + t.size].copy_(items[idx].reshape(-1))
                pos += t.padded
            out[dt] = (idxs, plane, to_device(shifts, self.device))
        return out

    def _ingest_round(self, items: dict[int, torch.Tensor]) -> None:
        operands = self.round_operands(items)
        # every cached accumulator view of a replaced buffer goes (the
        # reference drops only the touched tensors'; an untouched view
        # would still read equal bits, but would pin the old buffer)
        self._acc_cache = {i: v for i, v in self._acc_cache.items()
                           if dtype_name(self.slots[i].container) not in operands}
        for dt, (idxs, plane, shifts_t) in operands.items():
            buf = self.buffers[dt]
            total = plane.shape[0]
            if total == buf.shape[0]:
                # whole buffer touched: segments are dense by layout
                self.buffers[dt] = ops.plane_or_segments(buf, plane, shifts_t,
                                                         block=self.block)
                continue
            # sparse shipment: OR only the touched segments, gathered into
            # a compact buffer, then write them into a copy of the buffer
            compact = torch.cat([buf[self.slots[i].offset:
                                     self.slots[i].offset + self.slots[i].padded]
                                 for i in idxs])
            out = ops.plane_or_segments(compact, plane, shifts_t, block=self.block)
            new = buf.clone()
            pos = 0
            for idx in idxs:
                t = self.slots[idx]
                new[t.offset:t.offset + t.padded] = out[pos:pos + t.padded]
                pos += t.padded
            self.buffers[dt] = new
        for idx in items:
            self.received[idx] += 1
            self._dirty.add(idx)
            key = self.slots[idx].key
            self._leaf_cache.pop(key, None)
            self._qleaf_cache.pop(key, None)
            for tk in [t for t in self._qtrunc_cache if t[0] == key]:
                del self._qtrunc_cache[tk]

    # -- eq. (5): incremental float leaves -----------------------------------
    def _refresh_fp_leaves(self, jobs: list[int]) -> None:
        """Dequantize the given slots in one :func:`dequantize_buffers`
        call and refill the leaf cache. Each leaf is ``(q * scale) +
        offset`` in float32, cast to its dtype: byte-equal to the
        reference's leaf on the CPU."""
        if not jobs:
            return
        consts = self._consts_cache.get(tuple(jobs))
        if consts is None:
            consts = dequant_constants([self.slots[i].lo for i in jobs],
                                       [self.slots[i].hi for i in jobs],
                                       [self.slots[i].bits for i in jobs])
            self._consts_cache[tuple(jobs)] = consts
        vals = dequantize_buffers(
            self.buffers,
            [(dtype_name(self.slots[i].container), self.slots[i].offset,
              self.slots[i].size, self.slots[i].shape) for i in jobs],
            [self.slots[i].bits for i in jobs],
            [self.effective_bits(i) for i in jobs],
            [self.slots[i].orig_dtype for i in jobs], constants=consts)
        for i, leaf in zip(jobs, vals):
            self._leaf_cache[self.slots[i].key] = leaf

    def _fp_leaf(self, i: int) -> torch.Tensor:
        """Slot i dequantized at its received precision, from the leaf
        cache when no ingest touched it since (an ingest drops the key)."""
        key = self.slots[i].key
        if key not in self._leaf_cache or i in self._dirty:
            self._refresh_fp_leaves([i])
        return self._leaf_cache[key]

    def materialize_leaves(self) -> dict[Any, torch.Tensor]:
        """Every tensor dequantized, ``{key: float tensor}``. Only slots
        touched since the last call are recomputed, in one batched call;
        the rest come from the leaf cache as the same tensors."""
        self._refresh_fp_leaves([i for i, s in enumerate(self.slots)
                                 if s.key not in self._leaf_cache or i in self._dirty])
        self._dirty.clear()
        return {s.key: self._leaf_cache[s.key] for s in self.slots}

    def dirty_keys(self) -> set:
        return {self.slots[i].key for i in self._dirty}

    # -- quantized-resident views ------------------------------------------
    def _quantized_leaf(self, i: int) -> QuantizedTensor | None:
        """Slot i as a live :class:`QuantizedTensor`: ``q`` is a view of
        the flat buffer and the eq.-(5) affine rides along as float32
        tensors shaped ``q.shape[:-2] + (1, 1)`` on the device, the shape
        a stacked leaf slices to one ``(1, 1)`` per layer. None when the
        leaf cannot feed a dequant matmul (ndim < 2)."""
        s = self.slots[i]
        q = self._slice_acc(i)
        if q.ndim < 2:
            return None
        meta_shape = tuple(q.shape[:-2]) + (1, 1)

        def place(value: np.ndarray, dtype) -> torch.Tensor:
            arr = np.array(np.broadcast_to(value.astype(dtype), meta_shape))
            return to_device(arr, self.device)

        const = self._qmeta_cache.get(s.key)
        if const is None:
            # exact float32 values of the tensor ops, pulled to the host once
            lo = s.lo.detach().cpu().to(torch.float32).reshape(1).numpy()
            hi = s.hi.detach().cpu().to(torch.float32).reshape(1).numpy()
            scale = dequant_affine(torch.from_numpy(lo), torch.from_numpy(hi), s.bits)[0]
            const = {"lo": place(lo, np.float32), "hi": place(hi, np.float32),
                     "scale": place(scale.numpy(), np.float32), "lo_np": lo,
                     "span_np": affine_span(torch.from_numpy(lo),
                                            torch.from_numpy(hi)).numpy()}
            self._qmeta_cache[s.key] = const
        # offset = lo + span * 0.5**(m+1): the same two float32 operations
        # as dequant_affine (whose m == 0 branch equals this at m = 0)
        m = np.asarray([self.effective_bits(i)], np.int32)
        half_lsb = np.ldexp(np.float32(1.0), -(m + 1)).astype(np.float32)
        off = const["lo_np"] + const["span_np"] * half_lsb
        return QuantizedTensor(q=q, lo=const["lo"], hi=const["hi"], bits=s.bits,
                               orig_dtype=s.orig_dtype, scale=const["scale"],
                               offset=place(off, np.float32),
                               received_bits=place(m, np.int32))

    def quantized_leaves(self, eligible=None, *, bits: int | None = None
                         ) -> dict[Any, Any]:
        """The param pytree's leaves with weight tensors as live
        :class:`QuantizedTensor` views over the flat accumulators.
        ``eligible`` is an optional ``key -> bool`` predicate restricting
        which leaves go quantized; every other leaf, and any leaf a
        dequant matmul cannot consume, is dequantized to float. Views of
        tensors untouched since the last call come back from a cache.

        ``bits=b`` hands out the truncated-precision views instead
        (:meth:`QuantizedTensor.truncate` at ``min(b, leaf.bits)``: the
        same ``q`` tensors, a deferred plane mask and a recomputed
        offset), cached by ``(key, b)`` until an ingest touches the key;
        ineligible leaves stay the shared float leaf. A self-speculative
        draft built from them adds no resident weight bytes."""
        out: dict[Any, Any] = {}
        for i, s in enumerate(self.slots):
            if eligible is None or eligible(s.key):
                got = self._qleaf_cache.get(s.key)
                if got is None:
                    got = self._quantized_leaf(i)
                    if got is not None:
                        self._qleaf_cache[s.key] = got
                if got is not None:
                    if bits is not None:
                        # clamped per leaf: bits at or above the leaf's
                        # width is its full precision in masked form
                        b_eff = min(bits, got.bits)
                        trunc = self._qtrunc_cache.get((s.key, b_eff))
                        if trunc is None:
                            trunc = got.truncate(b_eff)
                            self._qtrunc_cache[(s.key, b_eff)] = trunc
                        got = trunc
                    out[s.key] = got
                    continue
            out[s.key] = self._fp_leaf(i)
        self._dirty.clear()
        return out
