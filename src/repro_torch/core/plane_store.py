"""PlaneStore: the device-resident receiver runtime (eqs. 4 and 5).

Counterpart of ``src/repro/core/plane_store.py``: ``PlaneStore`` on one
device, and :class:`ShardedPlaneStore`, one sub-store a model shard of a
serving mesh (at the end of this module).

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
leaves an ingest touched since the last call are recomputed (one
batched ``dequantize_buffers`` call), the rest come from a leaf cache.
A leaf divided in slices (expert banks, one slot a slice) is restacked
along its slice axis.

Quantized-resident views (eq. 5)
--------------------------------
``quantized_leaves`` hands out each weight as a live
:class:`QuantizedTensor` whose ``q`` is a view of the flat buffer and
whose affine is a few float32 scalars on the device: no float weight.
A sliced leaf's ``q`` is one strided view over its slices' slots (the
layout puts them one after another, a padded span apart), and its
affine varies along the slice axis: each expert keeps its own range,
and no second uint buffer exists.
``acc(i)`` is one tensor's accumulator view (the single-tensor view of
``serving/quantized.py`` reads it), cached until an ingest replaces the
buffer it lies in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
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


def _entries_from_wire_meta(meta) -> list[dict]:
    """Per-tensor descriptor dicts from a decoded wire header."""
    return [{"key": t["path"],
             "schedule": PlaneSchedule(bits=t["bits"], widths=tuple(t["widths"])),
             "lo": torch.tensor(t["lo"], dtype=torch.float32),
             "hi": torch.tensor(t["hi"], dtype=torch.float32),
             "shape": tuple(t["shape"]), "orig_dtype": FLOAT_DTYPES[t["dtype"]],
             "slice_axis": t.get("slice_axis"), "slice_idx": t.get("slice_idx", 0)}
            for t in meta["tensors"]]


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
        # leaf key -> its slots in slice order (one slot for an unsliced leaf)
        self.groups: dict[Any, list[int]] = {}
        for i, t in enumerate(slots):
            self.groups.setdefault(t.key, []).append(i)
        for idxs in self.groups.values():
            idxs.sort(key=lambda i: slots[i].slice_idx)
        # dtype name -> flat uint buffer (length: multiple of block)
        self.buffers: dict[str, torch.Tensor] = {}
        sizes: dict[str, tuple[int, torch.dtype]] = {}
        for t in slots:
            dt = dtype_name(t.container)
            sizes[dt] = (max(sizes.get(dt, (0,))[0], t.offset + t.padded), t.container)
        for dt, (n, dtype) in sizes.items():
            self.buffers[dt] = torch.zeros((n,), dtype=dtype, device=self.device)
        # float leaves: slots touched since the last materialization, and
        # the leaves (by key) of the untouched ones
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
        return cls._from_entries(_entries_from_wire_meta(meta), block=block, device=device)

    def copy(self) -> "PlaneStore":
        """Cheap snapshot: ingest never writes into a buffer, it replaces
        it, so sharing the buffers is safe; bookkeeping is shallow-copied."""
        new = object.__new__(PlaneStore)
        new.block = self.block
        new.slots = self.slots
        new.groups = self.groups
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
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.counter("store_or_rounds_total", "batched plane-OR rounds").inc()
            reg.histogram("store_or_round_planes", "planes per OR round").observe(len(items))
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
    def _refresh_fp_leaves(self, keys: list) -> None:
        """Dequantize every slot of the given leaves in one
        :func:`dequantize_buffers` call and refill the leaf cache. Each
        slot is ``(q * scale) + offset`` in float32, cast to its dtype:
        byte-equal to the reference's on the CPU; a sliced leaf's slots
        are stacked along their slice axis, as the reference stacks
        them."""
        jobs = [i for key in keys for i in self.groups[key]]
        if not jobs:
            return
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.counter("store_refresh_dispatches_total",
                        "batched eq.-(5) refresh dispatches").inc()
            reg.histogram("store_refresh_slots",
                          "tensor slots per refresh dispatch").observe(len(jobs))
        consts = self._consts_cache.get(tuple(jobs))
        if consts is None:
            consts = dequant_constants([self.slots[i].lo for i in jobs],
                                       [self.slots[i].hi for i in jobs],
                                       [self.slots[i].bits for i in jobs])
            self._consts_cache[tuple(jobs)] = consts
        vals = iter(dequantize_buffers(
            self.buffers,
            [(dtype_name(self.slots[i].container), self.slots[i].offset,
              self.slots[i].size, self.slots[i].shape) for i in jobs],
            [self.slots[i].bits for i in jobs],
            [self.effective_bits(i) for i in jobs],
            [self.slots[i].orig_dtype for i in jobs], constants=consts))
        for key in keys:
            idxs = self.groups[key]
            ax = self.slots[idxs[0]].slice_axis
            parts = [next(vals) for _ in idxs]
            self._leaf_cache[key] = parts[0] if ax is None else torch.stack(parts, dim=ax)

    def _stale(self, key) -> bool:
        return key not in self._leaf_cache or any(i in self._dirty for i in self.groups[key])

    def _fp_leaf(self, key) -> torch.Tensor:
        """One leaf dequantized at its received precision, from the leaf
        cache when no ingest touched it since (an ingest drops the key)."""
        if self._stale(key):
            self._refresh_fp_leaves([key])
        return self._leaf_cache[key]

    def materialize_leaves(self) -> dict[Any, torch.Tensor]:
        """Every leaf dequantized, ``{key: float tensor}``, sliced leaves
        restacked. Only leaves touched since the last call are recomputed,
        in one batched call; the rest come from the leaf cache as the same
        tensors."""
        self._refresh_fp_leaves([k for k in self.groups if self._stale(k)])
        self._dirty.clear()
        return {k: self._leaf_cache[k] for k in self.groups}

    def dirty_keys(self) -> set:
        return {self.slots[i].key for i in self._dirty}

    # -- quantized-resident views ------------------------------------------
    def _stacked_acc(self, idxs: list[int], ax: int) -> torch.Tensor:
        """The slices' accumulators stacked along ``ax`` as one strided view
        of the flat buffer: the layout puts a leaf's slices one after
        another, one padded span apart. Slots laid out otherwise raise,
        since stacking them would copy a second uint buffer."""
        s0 = self.slots[idxs[0]]
        buf = self.buffers[dtype_name(s0.container)]
        if not all(self.slots[i].offset == s0.offset + n * s0.padded
                   and self.slots[i].shape == s0.shape for n, i in enumerate(idxs)):
            raise ValueError(f"the slices of {s0.key!r} are not laid out one after "
                             "another; a strided view cannot stack them")
        inner = [math.prod(s0.shape[d + 1:]) for d in range(len(s0.shape))]
        return buf.as_strided(s0.shape[:ax] + (len(idxs),) + s0.shape[ax:],
                              inner[:ax] + [s0.padded] + inner[ax:],
                              buf.storage_offset() + s0.offset)

    def _quantized_leaf(self, key) -> QuantizedTensor | None:
        """A leaf as a live :class:`QuantizedTensor`: ``q`` is a view of
        the flat buffer (:meth:`_stacked_acc` for a sliced leaf) and the
        eq.-(5) affine rides along as float32 tensors shaped ``q.shape[:-2]
        + (1, 1)`` on the device, the shape a stacked leaf slices to one
        ``(1, 1)`` per layer; a sliced leaf's values vary along its slice
        axis, one a slice. None when the leaf cannot feed a dequant matmul
        (ndim < 2); a sliced leaf that one strided view of one width
        cannot express (slices of several widths, or slices along one of
        the two matrix dims) raises."""
        idxs = self.groups[key]
        slots = [self.slots[i] for i in idxs]
        ax = slots[0].slice_axis
        if ax is None:
            q = self._slice_acc(idxs[0])
            if q.ndim < 2:
                return None
        else:
            if (len({s.bits for s in slots}) != 1 or any(s.slice_axis != ax for s in slots)
                    or ax >= len(slots[0].shape) - 1):
                raise ValueError(f"sliced leaf {key!r}: slices of one width along an "
                                 "axis before the two matrix dims are required")
            q = self._stacked_acc(idxs, ax)
        meta_shape = tuple(q.shape[:-2]) + (1, 1)
        along = [1] * len(meta_shape)
        if ax is not None:
            along[ax] = len(idxs)

        def place(values: np.ndarray) -> torch.Tensor:
            """One value a slice, varying along the slice axis."""
            arr = np.array(np.broadcast_to(values.reshape(along), meta_shape))
            return to_device(arr, self.device)

        const = self._qmeta_cache.get(key)
        if const is None:
            # exact float32 values of the tensor ops, pulled to the host once
            lo = torch.stack([s.lo.detach().cpu().to(torch.float32).reshape(())
                              for s in slots])
            hi = torch.stack([s.hi.detach().cpu().to(torch.float32).reshape(())
                              for s in slots])
            scale = dequant_affine(lo, hi, slots[0].bits)[0]
            const = {"lo": place(lo.numpy()), "hi": place(hi.numpy()),
                     "scale": place(scale.numpy()), "lo_np": lo.numpy(),
                     "span_np": affine_span(lo, hi).numpy()}
            self._qmeta_cache[key] = const
        # offset = lo + span * 0.5**(m+1): the same two float32 operations
        # as dequant_affine (whose m == 0 branch equals this at m = 0)
        m = np.asarray([self.effective_bits(i) for i in idxs], np.int32)
        half_lsb = np.ldexp(np.float32(1.0), -(m + 1)).astype(np.float32)
        off = (const["lo_np"] + const["span_np"] * half_lsb).astype(np.float32)
        return QuantizedTensor(q=q, lo=const["lo"], hi=const["hi"], bits=slots[0].bits,
                               orig_dtype=slots[0].orig_dtype, scale=const["scale"],
                               offset=place(off), received_bits=place(m))

    def quantized_leaves(self, eligible=None, *, bits: int | None = None
                         ) -> dict[Any, Any]:
        """The param pytree's leaves with weight tensors as live
        :class:`QuantizedTensor` views over the flat accumulators.
        ``eligible`` is an optional ``key -> bool`` predicate restricting
        which leaves go quantized; every other leaf, and any leaf a
        dequant matmul cannot consume, is dequantized to float. Views of
        leaves untouched since the last call come back from a cache.

        ``bits=b`` hands out the truncated-precision views instead
        (:meth:`QuantizedTensor.truncate` at ``min(b, leaf.bits)``: the
        same ``q`` tensors, a deferred plane mask and a recomputed
        offset, per slice for a sliced leaf, whose slices may hold
        different received bits mid-stream), cached by ``(key, b)`` until
        an ingest touches the key; ineligible leaves stay the shared float
        leaf. A self-speculative draft built from them adds no resident
        weight bytes."""
        out: dict[Any, Any] = {}
        for key in self.groups:
            if eligible is None or eligible(key):
                got = self._qleaf_cache.get(key)
                if got is None:
                    got = self._quantized_leaf(key)
                    if got is not None:
                        self._qleaf_cache[key] = got
                if got is not None:
                    if bits is not None:
                        # clamped per leaf: bits at or above the leaf's
                        # width is its full precision in masked form
                        b_eff = min(bits, got.bits)
                        trunc = self._qtrunc_cache.get((key, b_eff))
                        if trunc is None:
                            trunc = got.truncate(b_eff)
                            self._qtrunc_cache[(key, b_eff)] = trunc
                        got = trunc
                    out[key] = got
                    continue
            out[key] = self._fp_leaf(key)
        self._dirty.clear()
        return out


# ---------------------------------------------------------------------------
# The sharded store
# ---------------------------------------------------------------------------

def _path(key) -> str:
    """A leaf key as the 'a/b/c' string of ``wire.path_str`` (wire keys
    already are)."""
    return key if isinstance(key, str) else "/".join(str(k) for k in key)


def on_device(device: torch.device):
    """Make ``device`` current while kernels launch on it: the C launchers
    launch on the current card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def leaf_to(leaf, device: torch.device):
    """A leaf, a quantized view or a float tensor, with every tensor on
    ``device`` (no copy where they lie there already)."""
    def move(t):
        return t if t is None or t.device == device else t.to(device, non_blocking=True)
    if not isinstance(leaf, QuantizedTensor):
        return move(leaf)
    return dataclasses.replace(leaf, q=move(leaf.q), lo=move(leaf.lo), hi=move(leaf.hi),
                               scale=move(leaf.scale), offset=move(leaf.offset),
                               received_bits=move(leaf.received_bits),
                               keep_bits=move(leaf.keep_bits))


# the eq.-(5) fields of a quantized view, shaped q.shape[:-2] + (1, 1)
_META_FIELDS = ("lo", "hi", "scale", "offset", "received_bits", "keep_bits")


@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """A parameter leaf split on one dim over a mesh's model shards:
    ``parts[j]`` lies on ``mesh.model_devices[j]``, a live
    :class:`QuantizedTensor` view of that shard's accumulator (its
    eq.-(5) constants shard-local) or a float tensor. ``axis`` counts
    from the end, so it survives taking one layer of a stacked leaf: -1,
    the output dim of a dense weight, whose parts share one affine; -3,
    the expert dim of an ``(E, d, f)`` bank, whose part j holds its
    experts with their constants shaped ``(E/n, 1, 1)``, one range an
    expert for a bank divided in slices. The model's ``dense`` runs a
    dense weight through ``ops.sharded_dequant_matmul`` (quantized) or a
    matmul a shard (float), ``expert_dense`` a bank a shard, and each
    gathers the outputs.

    Those two are its only reads. A leaf the model reads any other way
    (elementwise, indexed, cast) is gathered whole by the store
    (``launch.sharding.GATHERED_LEAVES``); a ``ShardedLeaf`` that reaches
    such a read anyway raises ``TypeError`` naming the leaf (``name``,
    its ``a/b/c`` path), from any torch function, operator, index or
    tensor method, rather than being gathered quietly."""

    parts: tuple
    axis: int
    mesh: Any
    name: str = ""

    def _refuse(self, *_args, **_kwargs):
        raise TypeError(
            f"sharded leaf {self.name or '<unnamed>'!r} (split on axis {self.axis} over "
            f"{len(self.parts)} shards) reached a read other than common.dense or "
            "common.expert_dense; a leaf the model reads whole must be gathered "
            "(launch.sharding.GATHERED_LEAVES)")

    __getitem__ = __setitem__ = __iter__ = __array__ = _refuse
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _refuse
    __truediv__ = __rtruediv__ = __matmul__ = __rmatmul__ = __neg__ = __pow__ = _refuse

    def __getattr__(self, attr):
        # only for attributes the dataclass lacks: a tensor's raise
        # TypeError, anything else the usual AttributeError
        if not attr.startswith("__") and hasattr(torch.Tensor, attr):
            self._refuse()
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {attr!r}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        stack = [*args, *(kwargs or {}).values()]
        while stack:
            a = stack.pop()
            if isinstance(a, cls):
                a._refuse()
            if isinstance(a, (list, tuple)):
                stack.extend(a)
        return NotImplemented

    @property
    def quantized(self) -> bool:
        return isinstance(self.parts[0], QuantizedTensor)

    @property
    def shape(self) -> tuple:
        shape = list(self._t(self.parts[0]).shape)
        shape[self.axis] = sum(self.sizes())
        return tuple(shape)

    def sizes(self) -> list[int]:
        """Each part's extent along ``axis``."""
        return [self._t(p).shape[self.axis] for p in self.parts]

    def _t(self, part) -> torch.Tensor:
        return part.q if isinstance(part, QuantizedTensor) else part

    def truncate(self, b: int) -> "ShardedLeaf":
        """The truncated-precision view of every part (``QuantizedTensor.truncate``)."""
        return dataclasses.replace(self, parts=tuple(p.truncate(b) for p in self.parts))

    def gather(self, device=None):
        """The whole leaf on ``device`` (default: the mesh's home device):
        the parts concatenated along ``axis``. A quantized view's eq.-(5)
        constants are concatenated along ``axis`` too where it is one of
        their dims (an expert dim: each part's experts keep their own
        ranges); split on a matrix dim, the parts share part 0's."""
        device = self.mesh.home if device is None else torch.device(device)

        def cat(ts):
            return torch.cat([t if t.device == device else t.to(device, non_blocking=True)
                              for t in ts], dim=self.axis)

        whole = cat([self._t(p) for p in self.parts])
        if not self.quantized:
            return whole
        p0 = self.parts[0]
        if self.axis >= -2:
            return dataclasses.replace(leaf_to(p0, device), q=whole)
        return dataclasses.replace(p0, q=whole, **{
            f: None if getattr(p0, f) is None else cat([getattr(p, f) for p in self.parts])
            for f in _META_FIELDS})


class ShardedPlaneStore:
    """Per-model-shard sub-stores, shard-local ingest, sharded leaves.

    Counterpart of the reference's ``ShardedPlaneStore``
    (``src/repro/core/plane_store.py:658``). Model shard ``j`` owns an
    ordinary :class:`PlaneStore` on ``mesh.model_devices[j]``: the same
    flat accumulators and batched ``plane_or_segments`` upgrade. The
    tensors of one leaf key (the slices of a bank divided per expert, or
    one tensor) route together, by the reference's rules in its order:

    * **expert** (more than one slice, all along one ``slice_axis``, the
      slice count divisible by the shard count n): slice r, in
      ``slice_idx`` order, goes whole to shard ``r // (len / n)``. A
      shard's slices lie one after another in its sub-store, so its part
      of the bank is the sub-store's strided view, with no plane surgery
      and no second uint buffer;
    * **split** (one unsliced tensor whose spec,
      ``launch.sharding.serving_spec_for_param``, shards a dim): each
      arriving plane is cut along that dim and each piece is ORed on its
      owning shard only (an unsliced ``we_*`` bank splits on its expert
      dim);
    * **whole** (anything else: 1-D, indivisible, a slice count n does
      not divide): round-robin to one sub-store, every slice of a key on
      the same owner; its leaf is moved to the home device.

    Every plane element is ORed exactly once, on one device (one
    ``plane_or_segments`` launch a sub-store a container dtype a stage).
    Leaves come back as :class:`ShardedLeaf` objects (``axis`` the split
    dim, or the slice axis, counted from the end), except the ones
    sharded serving gathers (``launch.sharding.GATHERED_LEAVES``: the
    tied embedding, whose split dim the unembedding contracts, and a
    Mamba-2 block's ``conv_w`` and an sLSTM block's ``r``, which the
    recurrences read elementwise), which are concatenated into one tensor
    on the home device when an ingest touched them, on the device,
    without a host sync, in either residency. The eq.-(5) constants stay
    shard-local: each sub-store computes its own. The routes do not
    depend on a block's family: every arch the single-device store takes
    shards, as the reference's does.

    Left for later, raising ``NotImplementedError``: replica rows (a mesh
    with ``data`` > 1), ROADMAP A13."""

    def __init__(self, entries: list[dict], mesh, *, block: int = DEFAULT_BLOCK):
        from repro_torch.launch.mesh import check_serving_mesh
        from repro_torch.launch.sharding import gathered_for_serving, serving_spec_for_param

        check_serving_mesh(mesh)
        self.mesh = mesh
        self.block = block
        self.device = mesh.home
        self._n_model = n = mesh.shape["model"]
        self.keys = [e["key"] for e in entries]
        self.schedules = [e["schedule"] for e in entries]
        self.shapes = [tuple(e["shape"]) for e in entries]
        self.received = [0] * len(entries)
        # key -> its tensors (slices group under one key), in entry order
        self._groups: dict[Any, list[int]] = {}
        for i, k in enumerate(self.keys):
            self._groups.setdefault(k, []).append(i)
        # key -> ("expert", slice axis) | ("split", axis) | ("whole", owner shard)
        self._route: dict[Any, tuple[str, int]] = {}
        # idx -> [(shard, local slot)] in shard order
        self._placement: list[list[tuple[int, int]]] = [[] for _ in entries]
        self._gathered = {k: gathered_for_serving(_path(k)) for k in self._groups}
        per_shard: list[list[dict]] = [[] for _ in range(n)]

        def place(i: int, j: int, entry: dict) -> None:
            self._placement[i].append((j, len(per_shard[j])))
            per_shard[j].append(entry)

        rr = 0   # round-robin cursor of whole-routed keys
        for key, idxs in self._groups.items():
            e0 = entries[idxs[0]]
            ax = e0.get("slice_axis")
            if (ax is not None and len(idxs) > 1 and len(idxs) % n == 0
                    and all(entries[i].get("slice_axis") == ax for i in idxs)):
                per = len(idxs) // n
                for r, i in enumerate(sorted(idxs, key=lambda i: entries[i]["slice_idx"])):
                    place(i, r // per, entries[i])
                self._route[key] = ("expert", ax)
                continue
            spec = (serving_spec_for_param(_path(key), tuple(e0["shape"]), mesh)
                    if len(idxs) == 1 and ax is None and len(e0["shape"]) >= 2 else ())
            split = next((d for d, name in enumerate(spec) if name == "model"), None)
            if split is not None:
                shape = list(e0["shape"])
                shape[split] //= n
                for j in range(n):
                    place(idxs[0], j, dict(e0, shape=tuple(shape)))
                self._route[key] = ("split", split)
                continue
            for i in idxs:
                place(i, rr % n, entries[i])
            self._route[key] = ("whole", rr % n)
            rr += 1
        # key -> the shards that hold a part of it, in shard order
        self._shards = {k: sorted({j for i in idxs for j, _ in self._placement[i]})
                        for k, idxs in self._groups.items()}
        self.substores = [PlaneStore._from_entries(per_shard[j], block=block,
                                                   device=mesh.model_devices[j])
                          for j in range(n)]
        self._dirty: set[int] = set(range(len(entries)))
        self._leaf_cache: dict[Any, Any] = {}
        self._qleaf_cache: dict[Any, Any] = {}
        self._qtrunc_cache: dict[tuple, Any] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_model(cls, model, mesh, *, block: int = DEFAULT_BLOCK) -> "ShardedPlaneStore":
        return cls(_entries_from_model(model), mesh, block=block)

    @classmethod
    def from_wire_meta(cls, meta, mesh, *, block: int = DEFAULT_BLOCK
                       ) -> "ShardedPlaneStore":
        return cls(_entries_from_wire_meta(meta), mesh, block=block)

    def copy(self) -> "ShardedPlaneStore":
        """Cheap snapshot: each sub-store's :meth:`PlaneStore.copy`."""
        new = object.__new__(ShardedPlaneStore)
        for attr in ("mesh", "block", "device", "_n_model", "keys", "schedules", "shapes",
                     "_groups", "_route", "_placement", "_gathered", "_shards"):
            setattr(new, attr, getattr(self, attr))
        new.received = list(self.received)
        new.substores = [s.copy() for s in self.substores]
        new._dirty = set(self._dirty)
        new._leaf_cache = dict(self._leaf_cache)
        new._qleaf_cache = dict(self._qleaf_cache)
        new._qtrunc_cache = dict(self._qtrunc_cache)
        return new

    # -- views -------------------------------------------------------------
    @property
    def n_tensors(self) -> int:
        return len(self.keys)

    def effective_bits(self, i: int) -> int:
        return received_bits(self.schedules[i], self.received[i])

    def resident_bytes(self) -> int:
        """The sub-stores' accumulator bytes (see :meth:`gathered_bytes`
        for the copies the store holds beside them)."""
        return sum(s.resident_bytes() for s in self.substores)

    def gathered_bytes(self) -> int:
        """Device bytes of the leaves the store holds as copies on the home
        device beside its sub-stores: the gathered leaves
        (``launch.sharding.GATHERED_LEAVES``: the tied embedding, a whole
        (vocab, d_model) tensor on top of its split accumulators, and the
        recurrent blocks' ``conv_w`` and ``r``) and whole-routed
        leaves owned by another device. Each tensor counts once; a
        truncated view shares its tensor. ``resident_bytes() +
        gathered_bytes()`` is what the store holds on all its devices,
        against one device's ``resident_bytes()`` alone in quantized
        residency."""
        seen: set[tuple] = set()
        total = 0
        for key in self._groups:
            kind, owner = self._route[key]
            if not (self._gathered[key] or (kind == "whole" and
                                            self.substores[owner].device != self.device)):
                continue
            for leaf in (self._leaf_cache.get(key), self._qleaf_cache.get(key)):
                t = leaf.q if isinstance(leaf, QuantizedTensor) else leaf
                if t is not None and (t.device, t.data_ptr()) not in seen:
                    seen.add((t.device, t.data_ptr()))
                    total += t.numel() * t.element_size()
        return total

    def fingerprint(self) -> dict[str, int]:
        """Per-shard accumulator CRCs, keyed ``shard<j>/<dtype>``: the
        sharded counterpart of :meth:`PlaneStore.fingerprint`."""
        return {f"shard{j}/{dt}": crc for j, s in enumerate(self.substores)
                for dt, crc in s.fingerprint().items()}

    def dirty_keys(self) -> set:
        return {self.keys[i] for i in self._dirty}

    def placement(self, i: int) -> list[tuple[int, int]]:
        """Tensor i's ``[(shard, local slot)]``, in shard order."""
        return list(self._placement[i])

    def acc(self, i: int) -> torch.Tensor:
        """Tensor i's accumulator: an expert slice's or a whole-routed
        tensor's sub-store view, a split one's pieces joined on the home
        device (an audit and test surface: serving reads the sharded
        leaves)."""
        kind, ax = self._route[self.keys[i]]
        if kind != "split":
            j, lidx = self._placement[i][0]
            return self.substores[j].acc(lidx)
        return torch.cat([self.substores[j].acc(lidx).to(self.device, non_blocking=True)
                          for j, lidx in self._placement[i]], dim=ax)

    def quantized(self, i: int) -> QuantizedTensor:
        j, lidx = self._placement[i][0]
        t = self.substores[j].slots[lidx]
        return QuantizedTensor(q=self.acc(i), lo=t.lo, hi=t.hi, bits=t.bits,
                               orig_dtype=t.orig_dtype)

    # -- eq. (4): shard-local batched upgrade --------------------------------
    def ingest(self, items: Sequence[tuple[int, torch.Tensor]]) -> None:
        """Route a shipment to the owning shards and OR it there. The
        shipment is validated whole up front (a bad item leaves every
        sub-store untouched); each sub-store then runs its own batched
        rounds on its own device. A split tensor's plane is cut on the
        device it lies on and each piece copied to its shard (no copy
        for logical shards of that device); an expert slice's or a
        whole-routed tensor's plane goes to its one owner."""
        pending = list(items)
        counts: dict[int, int] = {}
        for idx, plane in pending:
            size = math.prod(self.shapes[idx])
            if plane.numel() != size:
                raise ValueError(f"plane for tensor {idx} has {plane.numel()} elements, "
                                 f"expected {size}")
            counts[idx] = counts.get(idx, 0) + 1
        for idx, c in counts.items():
            have, total = self.received[idx], self.schedules[idx].n_planes
            if have + c > total:
                raise ValueError(f"tensor {idx}: {have} planes received + {c} arriving "
                                 f"exceeds schedule of {total}")
        sub_items: list[list[tuple[int, torch.Tensor]]] = [[] for _ in self.substores]
        for idx, plane in pending:
            kind, ax = self._route[self.keys[idx]]
            if kind == "split":
                pieces = torch.chunk(plane.reshape(self.shapes[idx]), self._n_model, dim=ax)
            else:
                pieces = (plane,)
            for (j, lidx), piece in zip(self._placement[idx], pieces):
                dev = self.substores[j].device
                sub_items[j].append((lidx, piece if piece.device == dev
                                     else piece.to(dev, non_blocking=True)))
        for sub, its in zip(self.substores, sub_items):
            if its:
                with on_device(sub.device):
                    sub.ingest(its)
        for idx, _ in pending:
            self.received[idx] += 1
            self._dirty.add(idx)
            key = self.keys[idx]
            self._leaf_cache.pop(key, None)
            self._qleaf_cache.pop(key, None)
            for tk in [t for t in self._qtrunc_cache if t[0] == key]:
                del self._qtrunc_cache[tk]

    # -- eq. (5): float leaves -------------------------------------------------
    def _stale(self, key) -> bool:
        return key not in self._leaf_cache or any(i in self._dirty for i in self._groups[key])

    def _refresh_fp(self, keys: list) -> None:
        """Dequantize the given leaves, one batched call a sub-store
        (shard-local constants), and assemble them."""
        if not keys:
            return
        for j, sub in enumerate(self.substores):
            stale = [k for k in keys if j in self._shards[k]]
            if stale:
                with on_device(sub.device):
                    sub._refresh_fp_leaves(stale)
                sub._dirty.difference_update(i for k in stale for i in sub.groups[k])
        for key in keys:
            parts = tuple(self.substores[j]._leaf_cache[key] for j in self._shards[key])
            self._leaf_cache[key] = self._assemble(key, parts)

    def _assemble(self, key, parts: tuple):
        """A leaf from its parts: moved home (whole), gathered home
        (:data:`GATHERED_LEAVES`), or a :class:`ShardedLeaf` whose axis
        counts from the end (a sliced leaf has one dim more than its
        slices)."""
        kind, ax = self._route[key]
        if kind == "whole":
            return leaf_to(parts[0], self.device)
        ndim = len(self.shapes[self._groups[key][0]]) + (kind == "expert")
        leaf = ShardedLeaf(parts=parts, axis=ax - ndim, mesh=self.mesh, name=_path(key))
        return leaf.gather() if self._gathered[key] else leaf

    def _fp_leaf(self, key):
        if self._stale(key):
            self._refresh_fp([key])
        return self._leaf_cache[key]

    def materialize_leaves(self) -> dict[Any, Any]:
        """Every leaf dequantized, ``{key: leaf}``; only leaves touched
        since the last call are recomputed, the rest come back as the same
        objects."""
        self._refresh_fp([k for k in self._groups if self._stale(k)])
        self._dirty.clear()
        return {k: self._leaf_cache[k] for k in self._groups}

    # -- quantized-resident views ------------------------------------------
    def _quantized_leaf(self, key):
        parts = []
        for j in self._shards[key]:
            got = self.substores[j]._quantized_leaf(key)
            if got is None:
                return None
            parts.append(got)
        return self._assemble(key, tuple(parts))

    def quantized_leaves(self, eligible=None, *, bits: int | None = None) -> dict[Any, Any]:
        """The sharded mirror of :meth:`PlaneStore.quantized_leaves`:
        eligible weight leaves are live views over the sub-stores'
        accumulators (:class:`ShardedLeaf`, or one tensor on the home
        device for a gathered or whole-routed leaf); ``bits=b`` gives the
        truncated views, sharing the same accumulators (a gathered
        leaf's view shares the gathered tensor)."""
        out: dict[Any, Any] = {}
        for key, idxs in self._groups.items():
            if eligible is None or eligible(key):
                got = self._qleaf_cache.get(key)
                if got is None:
                    got = self._quantized_leaf(key)
                    if got is not None:
                        self._qleaf_cache[key] = got
                if got is not None:
                    if bits is not None:
                        b_eff = min(bits, self.schedules[idxs[0]].bits)
                        trunc = self._qtrunc_cache.get((key, b_eff))
                        if trunc is None:
                            trunc = got.truncate(b_eff)
                            self._qtrunc_cache[(key, b_eff)] = trunc
                        got = trunc
                    out[key] = got
                    continue
            out[key] = self._fp_leaf(key)
        self._dirty.clear()
        return out
