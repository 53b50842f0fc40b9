"""Importance calibration: measured accuracy-per-byte plane ordering.

Counterpart of ``src/repro/core/calibrate.py``. The v1 wire ships planes
stage-major: stage s carries plane s of every tensor, so every byte of a
stage buys the same "importance" whichever tensor it refines.
Calibration measures instead: truncate one tensor's planes at a time
against a calibration loss, price each plane by the loss it recovers per
byte, and ship planes globally in that order.

The result is a :class:`TransmissionSchedule`: a global (tensor, plane)
order that is MSB-first *within* each tensor (``PlaneStore.ingest``
requires each tensor's planes in order; eq. (5)'s affine assumes a
contiguous prefix) and interleaves freely *across* tensors. Checkpoints
partition the unit list into as many "stages" as the uniform ladder, at
the uniform ladder's cumulative byte marks, so timeline algebra and
serving stage semantics carry over.

* :func:`measure_plane_gains` + :func:`build_schedule`: one leaf at a
  time against everything else at full precision, per-tensor rates
  convexified, bundles merged by rate (``calibrate_schedule(method=
  "marginal")``);
* :func:`greedy_schedule`: context-aware forward selection in waves (the
  default ``calibrate_schedule``);
* :func:`weight_sse_schedule`: no calibration data, each plane priced
  by the squared weight error it removes.

``eval_loss(leaves)`` maps ``{path: float tensor}`` (the keys of
``PlaneStore.materialize_leaves``) to a scalar, lower is better. The
float leaves are the same bytes as the reference's on the CPU, so under
the same loss the gains and schedules are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.quantize import affine_span, dequantize, truncate

FRAME_BYTES = 2  # per-unit wire frame (entropy mode flag); see core.wire


def plane_payload_bytes(shape: Sequence[int], width: int) -> int:
    """Raw packed bytes of one plane (ceil(n_elements * width / 8))."""
    return -(-math.prod(shape) * width // 8)


@dataclasses.dataclass(frozen=True)
class TransmissionSchedule:
    """A global ordering of (tensor, plane) shipment units.

    ``units[k] = (tensor_idx, plane_idx)`` with ``plane_idx`` 0-based
    into the tensor's :class:`~repro_torch.core.bitplanes.PlaneSchedule`;
    ``checkpoints`` is an ascending list of prefix unit counts, the v2
    analogue of stage boundaries (clients flush and report "stage
    complete" when a checkpoint's last unit lands). The last checkpoint
    covers every unit."""

    units: tuple[tuple[int, int], ...]
    checkpoints: tuple[int, ...]

    @property
    def n_stages(self) -> int:
        return len(self.checkpoints)

    def validate(self, plane_counts: Sequence[int]) -> None:
        """Raise unless this is a complete, MSB-first-per-tensor
        ordering of every plane of every tensor (``plane_counts[i]`` =
        tensor i's plane count) with well-formed checkpoints."""
        want = sum(plane_counts)
        if len(self.units) != want:
            raise ValueError(
                f"{len(self.units)} units for {want} planes")
        next_plane = [0] * len(plane_counts)
        for t, p in self.units:
            if not (0 <= t < len(plane_counts)):
                raise ValueError(f"unit references tensor {t} of "
                                 f"{len(plane_counts)}")
            if p != next_plane[t]:
                raise ValueError(
                    f"tensor {t}: plane {p} shipped out of order "
                    f"(expected {next_plane[t]} — schedules must be "
                    f"MSB-first within each tensor)")
            next_plane[t] += 1
        for t, got in enumerate(next_plane):
            if got != plane_counts[t]:
                raise ValueError(
                    f"tensor {t}: {got} of {plane_counts[t]} planes "
                    f"scheduled")
        if not self.checkpoints or list(self.checkpoints) != \
                sorted(set(self.checkpoints)):
            raise ValueError("checkpoints must be strictly ascending")
        if self.checkpoints[0] < 1 or self.checkpoints[-1] != len(self.units):
            raise ValueError(
                f"checkpoints must end at {len(self.units)} "
                f"(got {self.checkpoints})")

    # -- wire serialization (the v2 header's "units" and "checkpoints") -----
    def to_meta(self) -> dict:
        return {"units": [[t, p] for t, p in self.units],
                "checkpoints": list(self.checkpoints)}

    @classmethod
    def from_meta(cls, meta: Mapping) -> "TransmissionSchedule":
        return cls(units=tuple((int(t), int(p)) for t, p in meta["units"]),
                   checkpoints=tuple(int(c) for c in meta["checkpoints"]))


def uniform_schedule(model) -> TransmissionSchedule:
    """The v1 stage-major order as a TransmissionSchedule: stage s
    ships plane s of every tensor in priority order; checkpoints at
    stage ends."""
    units: list[tuple[int, int]] = []
    checkpoints: list[int] = []
    for s in range(1, model.n_stages + 1):
        units.extend((i, s - 1) for i, _ in model.stage(s))
        checkpoints.append(len(units))
    sched = TransmissionSchedule(units=tuple(units),
                                 checkpoints=tuple(checkpoints))
    sched.validate([t.plan.schedule.n_planes for t in model.tensors])
    return sched


# ---------------------------------------------------------------------------
# sensitivity measurement
# ---------------------------------------------------------------------------

def _full_store(model) -> PlaneStore:
    """Every plane of ``model`` ingested into a store where the planes lie."""
    store = PlaneStore.from_model(model, device=model.tensors[0].planes[0].device)
    for s in range(1, model.n_stages + 1):
        store.ingest(model.stage(s))
    return store


def _truncated_leaf(store: PlaneStore, idxs: list[int], bits: int) -> torch.Tensor:
    """One float leaf with every slot truncated to ``bits`` received bits
    (eq. (5) at the full width's offset, as the reference dequantizes its
    truncation oracle); slices restack along their slice axis."""
    parts = []
    for i in idxs:
        t = store.slots[i]
        qt = truncate(store.quantized(i), bits)
        parts.append((t.slice_idx, t.slice_axis, dequantize(qt)))
    if len(parts) == 1 and parts[0][1] is None:
        return parts[0][2]
    axis = parts[0][1]
    parts.sort(key=lambda x: x[0])
    return torch.stack([v for _, _, v in parts], dim=axis)


def measure_plane_gains(model, eval_loss: Callable[[dict], float]
                        ) -> dict[int, list[float]]:
    """Per-tensor marginal loss gain of each plane, measured one leaf at a
    time against everything else at full precision. Returns
    ``{tensor_idx: [gain_plane_1, ..., gain_plane_P]}``; slices of one
    leaf share their key's measurement."""
    store = _full_store(model)
    full = dict(store.materialize_leaves())
    base = float(eval_loss(full))
    gains: dict[int, list[float]] = {}
    for key, idxs in store.groups.items():
        sched = store.slots[idxs[0]].schedule
        levels = [0] + list(sched.cumulative_bits)  # c_0 = 0 .. c_P = bits
        losses = []
        for m in levels[:-1]:
            leaves = dict(full)
            leaves[key] = _truncated_leaf(store, idxs, m)
            losses.append(float(eval_loss(leaves)))
        losses.append(base)  # full precision is the baseline
        per_plane = [max(losses[p] - losses[p + 1], 0.0) for p in range(sched.n_planes)]
        for i in idxs:
            gains[i] = list(per_plane)
    return gains


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------

def _convexify(gains: Sequence[float], costs: Sequence[int]
               ) -> list[tuple[int, int, float, int]]:
    """Merge consecutive planes of one tensor into bundles of
    non-increasing gain per byte: a later plane that scores higher than
    its predecessor can only be bought with it (MSB-first). Returns
    ``[(p_start, p_end_exclusive, gain_sum, byte_sum), ...]``."""
    out: list[list] = []
    for p, (g, c) in enumerate(zip(gains, costs)):
        cur = [p, p + 1, float(g), int(c)]
        while out and cur[2] * out[-1][3] > out[-1][2] * cur[3]:
            prev = out.pop()
            cur = [prev[0], cur[1], prev[2] + cur[2], prev[3] + cur[3]]
        out.append(cur)
    return [tuple(b) for b in out]


def _checkpoints_at(unit_bytes: Sequence[int], targets: Sequence[int]) -> tuple[int, ...]:
    """Prefix unit counts whose cumulative bytes first reach each target
    (the uniform ladder's stage byte marks), strictly increasing, the
    last covering every unit."""
    cum = np.cumsum(unit_bytes)
    cps: list[int] = []
    for t in targets[:-1]:
        k = int(np.searchsorted(cum, t)) + 1
        k = min(k, len(unit_bytes))
        if cps and k <= cps[-1]:
            k = cps[-1] + 1
        if k >= len(unit_bytes):
            break
        cps.append(k)
    cps.append(len(unit_bytes))
    return tuple(cps)


def _finalize(model, units: Sequence[tuple[int, int]],
              n_checkpoints: int | None) -> TransmissionSchedule:
    """Attach the uniform ladder's byte-mark checkpoints to a unit order
    and validate it."""
    n_cp = n_checkpoints or model.n_stages
    uni_targets = np.cumsum([model.stage_payload_bytes(s) + FRAME_BYTES * len(model.stage(s))
                             for s in range(1, model.n_stages + 1)])
    if n_cp != model.n_stages:
        total = float(uni_targets[-1])
        uni_targets = np.asarray([total * (k + 1) / n_cp for k in range(n_cp)])
    unit_bytes = [plane_payload_bytes(model.tensors[t].shape,
                                      model.tensors[t].plan.schedule.widths[p]) + FRAME_BYTES
                  for t, p in units]
    sched = TransmissionSchedule(units=tuple(units),
                                 checkpoints=_checkpoints_at(unit_bytes, list(uni_targets)))
    sched.validate([t.plan.schedule.n_planes for t in model.tensors])
    return sched


def build_schedule(model, gains: Mapping[int, Sequence[float]], *,
                   n_checkpoints: int | None = None) -> TransmissionSchedule:
    """Greedy gain-per-byte global order under the MSB-first-per-tensor
    constraint: each tensor's planes convexified into bundles, bundles
    merged across tensors by rate."""
    bundles: list[tuple[float, int, int, list[tuple[int, int]]]] = []
    for i, t in enumerate(model.tensors):
        sched = t.plan.schedule
        costs = [plane_payload_bytes(t.shape, w) + FRAME_BYTES for w in sched.widths]
        g = list(gains.get(i, [0.0] * sched.n_planes))
        if len(g) != sched.n_planes:
            raise ValueError(f"tensor {i}: {len(g)} gains for {sched.n_planes} planes")
        for (p0, p1, gsum, csum) in _convexify(g, costs):
            bundles.append((gsum / max(csum, 1), i, p0, [(i, p) for p in range(p0, p1)]))
    # stable descending-rate merge; the (tensor, plane) tie-break keeps the
    # order deterministic and each tensor's bundles MSB-first
    bundles.sort(key=lambda b: (-b[0], b[1], b[2]))
    units: list[tuple[int, int]] = []
    for _, _, _, us in bundles:
        units.extend(us)
    return _finalize(model, units, n_checkpoints)


def greedy_schedule(model, eval_loss: Callable[[dict], float], *,
                    n_checkpoints: int | None = None) -> TransmissionSchedule:
    """Context-aware greedy forward selection in waves: from every tensor
    at zero bits, evaluate each leaf's next plane against the current
    partial model and ship the one with the best loss drop per byte. A
    leaf runs at most one level ahead of the slowest unfinished leaf
    (complementary tensors measure no gain alone), so gain per byte
    orders the planes within each wave.

    Each truncated leaf is computed once; a key's leaves below its
    current level are dropped, since levels only rise (the reference
    keeps every level: nine float copies of the model at full width)."""
    store = _full_store(model)
    by_key = store.groups
    keys = list(by_key)
    leaf_cache: dict = {}

    def leaf_at(key, level: int) -> torch.Tensor:
        if (key, level) not in leaf_cache:
            sched = store.slots[by_key[key][0]].schedule
            bits = ([0] + list(sched.cumulative_bits))[level]
            leaf_cache[(key, level)] = _truncated_leaf(store, by_key[key], bits)
        return leaf_cache[(key, level)]

    def level_bytes(key, level: int) -> int:
        # wire cost of plane `level` of every slice of key
        return sum(plane_payload_bytes(model.tensors[i].shape,
                                       model.tensors[i].plan.schedule.widths[level])
                   + FRAME_BYTES for i in by_key[key])

    levels = {key: 0 for key in keys}
    current = {key: leaf_at(key, 0) for key in keys}
    cur_loss = float(eval_loss(current))
    units: list[tuple[int, int]] = []
    while True:
        active = [k for k in keys if levels[k] < store.slots[by_key[k][0]].schedule.n_planes]
        if not active:
            break
        wave = min(levels[k] for k in active)
        active = [k for k in active if levels[k] == wave]
        best = None
        for key in active:
            cand = dict(current)
            cand[key] = leaf_at(key, levels[key] + 1)
            loss = float(eval_loss(cand))
            rate = (cur_loss - loss) / level_bytes(key, levels[key])
            if best is None or rate > best[0]:
                best = (rate, key, loss)
        _, key, loss = best
        units.extend((i, levels[key]) for i in by_key[key])
        leaf_cache.pop((key, levels[key]), None)
        levels[key] += 1
        current[key] = leaf_at(key, levels[key])
        cur_loss = loss
    return _finalize(model, units, n_checkpoints)


def _plane_sse(t) -> list[float]:
    """``SSE(p) = sum (scale * sum_{j >= p} plane_j << shift_j)^2`` for
    p = 0..P (SSE(P) = 0), in float64 on the planes' device, which holds
    the plane sums of bits <= 16 exactly (the reference sweeps in numpy;
    the float64 sums may round in another order)."""
    sched = t.plan.schedule
    bits, cum = sched.bits, list(sched.cumulative_bits)
    span = affine_span(torch.as_tensor(t.lo).detach().cpu(),
                       torch.as_tensor(t.hi).detach().cpu())
    dev = t.planes[0].device
    sc = torch.tensor(float(span) * 0.5 ** bits, dtype=torch.float64, device=dev)
    resid = torch.zeros(t.shape, dtype=torch.float64, device=dev)
    sums = []
    for p in range(sched.n_planes - 1, -1, -1):
        resid.add_(t.planes[p].to(torch.float64) * 2.0 ** (bits - cum[p]))
        sums.append(torch.sum(torch.square(sc * resid)))
    return torch.stack(sums).flip(0).tolist() + [0.0]


def weight_sse_schedule(model, *, n_checkpoints: int | None = None) -> TransmissionSchedule:
    """Proxy calibration without data: price each plane by the summed
    squared weight error it removes against the fully received model.
    Truncating at plane boundary p drops exactly the value of planes
    p..P-1, and the affine intercept cancels in the difference, so the
    SSE has a closed form over the server's planes: no store, no ingest."""
    gains: dict[int, list[float]] = {}
    for i, t in enumerate(model.tensors):
        sse = _plane_sse(t)
        gains[i] = [max(sse[p] - sse[p + 1], 0.0) for p in range(t.plan.schedule.n_planes)]
    return build_schedule(model, gains, n_checkpoints=n_checkpoints)


def calibrate_schedule(model, eval_loss: Callable[[dict], float], *,
                       n_checkpoints: int | None = None, method: str = "greedy"
                       ) -> TransmissionSchedule:
    """Measure and build in one call: ``method="greedy"`` (default) is
    :func:`greedy_schedule`, ``method="marginal"`` the cheaper
    :func:`measure_plane_gains` + :func:`build_schedule`."""
    if method == "greedy":
        return greedy_schedule(model, eval_loss, n_checkpoints=n_checkpoints)
    if method == "marginal":
        gains = measure_plane_gains(model, eval_loss)
        return build_schedule(model, gains, n_checkpoints=n_checkpoints)
    raise ValueError(f"unknown calibration method {method!r}")
