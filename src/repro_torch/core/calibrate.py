"""Transmission schedules: the global (tensor, plane) order of wire v2/v3.

Counterpart of the schedule half of ``src/repro/core/calibrate.py``:
:class:`TransmissionSchedule` and :func:`uniform_schedule`. A schedule is
MSB-first *within* each tensor (``PlaneStore.ingest`` requires each
tensor's planes in order) and interleaves freely *across* tensors;
checkpoints partition the unit list into "stages". The calibration pass
that measures per-plane gains and builds importance-ordered schedules is
still to be ported (ROADMAP A11); a hand-built schedule goes on the wire
as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


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
