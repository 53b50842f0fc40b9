"""Division policies: how a model's tensors are cut into transmission
stages. Counterpart of ``src/repro/core/policy.py``; the paper's uniform
policy only (the priority and expert-popularity policies are still to
be ported)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.bitplanes import PAPER_DEFAULT, PlaneSchedule


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """Per-tensor plan: the plane schedule plus a priority within a
    stage (lower ships earlier)."""

    schedule: PlaneSchedule
    priority: float = 0.0


class DivisionPolicy:
    """Maps a tensor path (tuple of keys) to a TensorPlan."""

    def plan(self, path: tuple, shape: tuple, dtype, slice_idx: int | None = None
             ) -> TensorPlan:  # pragma: no cover - interface
        raise NotImplementedError

    def slice_spec(self, path: tuple, shape: tuple) -> int | None:
        """An axis to slice this tensor along (one sub-tensor per index),
        or None to keep it whole."""
        return None

    @property
    def n_stages(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformPolicy(DivisionPolicy):
    """The paper's policy: one PlaneSchedule shared by every tensor."""

    schedule: PlaneSchedule = PAPER_DEFAULT

    def plan(self, path, shape, dtype, slice_idx=None) -> TensorPlan:
        return TensorPlan(schedule=self.schedule)

    @property
    def n_stages(self) -> int:
        return self.schedule.n_planes
