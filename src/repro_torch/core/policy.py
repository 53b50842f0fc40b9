"""Division policies: how a model's tensors are cut into transmission
stages, and the self-speculative draft's controller. Counterpart of
``src/repro/core/policy.py``: the paper's uniform policy, the two
policies beyond the paper (:class:`LayerPriorityPolicy` orders tensors
within a stage by a score of their path; :class:`ExpertPopularityPolicy`
slices expert banks per expert, each slice with its own range, and ships
the most-routed experts' planes first), and
:class:`SpeculationController`, which picks the draft length k and the
draft's precision from the observed acceptance rate (pure Python, the
reference's decisions), and :func:`schedule_from_stages`."""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping, Sequence

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
        """An axis to slice this tensor along (one sub-tensor per index,
        each with its own quantization range and priority), or None to
        keep it whole."""
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


def _path_str(path: tuple) -> str:
    from repro_torch.core.wire import path_str

    return path_str(path)


@dataclasses.dataclass(frozen=True)
class LayerPriorityPolicy(DivisionPolicy):
    """Uniform widths, tensors ordered within a stage by ``score`` of
    their 'a/b/c' path (lower first)."""

    schedule: PlaneSchedule = PAPER_DEFAULT
    score: Callable[[str], float] = staticmethod(lambda p: 0.0)

    def plan(self, path, shape, dtype, slice_idx=None) -> TensorPlan:
        return TensorPlan(schedule=self.schedule, priority=self.score(_path_str(path)))

    @property
    def n_stages(self) -> int:
        return self.schedule.n_planes


def embeddings_first_score(path: str) -> float:
    """Embeddings, the final norm and the head first (0), then layers by
    the first number in their path (1 + n), so that a truncated first
    stage covers the input and output surfaces."""
    p = path.lower()
    if "embed" in p or "head" in p or "final" in p:
        return 0.0
    m = re.search(r"(\d+)", p)
    return 1.0 + (int(m.group(1)) if m else 0)


_EXPERT_BANK_RE = r"we_(gate|up|down)"


@dataclasses.dataclass(frozen=True)
class ExpertPopularityPolicy(DivisionPolicy):
    """For MoE models: expert banks (``we_gate``, ``we_up``, ``we_down``)
    are sliced along the first axis of size ``n_experts``, each slice
    quantized with its own (min, max) and given priority
    ``expert_base_priority - popularity[slice]``, so the most-routed
    experts' planes ship first, after the other tensors (priority 0).
    ``popularity`` maps a slice index to its routing fraction. A
    layer-stacked bank is (n_cycles, E, d, f): where n_cycles equals E
    the layer axis comes first and is the one sliced, as in the
    reference."""

    schedule: PlaneSchedule = PAPER_DEFAULT
    popularity: Mapping[int, float] = dataclasses.field(default_factory=dict)
    n_experts: int = 0
    expert_base_priority: float = 1.0

    def slice_spec(self, path, shape) -> int | None:
        if not self.n_experts or not re.search(_EXPERT_BANK_RE, _path_str(path)):
            return None
        return next((ax for ax, d in enumerate(shape) if d == self.n_experts), None)

    def plan(self, path, shape, dtype, slice_idx=None) -> TensorPlan:
        prio = 0.0
        if slice_idx is not None:
            prio = self.expert_base_priority - float(self.popularity.get(slice_idx, 0.0))
        return TensorPlan(schedule=self.schedule, priority=prio)

    @property
    def n_stages(self) -> int:
        return self.schedule.n_planes


# ---------------------------------------------------------------------------
# Speculative-decoding control: the precision ladder as a draft-model knob
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpeculationController:
    """Tunes the self-speculative draft (length k, draft bits) from the
    observed acceptance rate, which changes as planes arrive: while the
    received precision is at most the draft's, the draft equals the
    target and a round degenerates to plain decode (k = 0); once the
    received precision pulls ahead, long drafts pay off as long as the
    coarse view keeps predicting the refined one.

    k moves over a ladder (0, then powers of two up to ``k_max``) on an
    EWMA of each round's acceptance fraction: high acceptance climbs,
    low acceptance steps down, never to 0. When rejection persists at
    k = 1 the draft climbs ``bits_step`` bits instead (up to
    ``max_draft_bits``): a finer prefix of the same accumulators, whose
    view swap changes device values only. Upgrades relax the EWMA toward
    its prior (:meth:`on_upgrade`)."""

    draft_bits: int = 4
    k_max: int = 8
    k_init: int = 4
    bits_step: int = 2         # draft-precision increment on rejection
    max_draft_bits: int = 8    # never draft finer than this
    ewma: float = 0.6          # weight of history in the acceptance EWMA
    raise_at: float = 0.8      # climb the ladder above this rate
    lower_at: float = 0.4      # step down below this rate
    rate: float = 0.5          # EWMA state (prior: an even coin)
    k: int = dataclasses.field(default=-1)

    def __post_init__(self):
        if self.k < 0:
            self.k = min(self.k_init, self.k_max)
        self._ladder = [0] + [2 ** i for i in range(0, 32) if 2 ** i <= self.k_max]
        # snap k onto the ladder (a k_max that is no power of two would
        # leave it between rungs)
        self.k = max(v for v in self._ladder[1:] if v <= max(self.k, 1))

    def choose_k(self, received_bits: int) -> int:
        """Draft length for the next round: 0 while the received precision
        is no finer than the draft's."""
        if received_bits <= self.draft_bits:
            return 0
        return self.k

    def update(self, accepted: int, proposed: int) -> None:
        """Fold one round's outcome (``accepted`` of ``proposed`` draft
        tokens) into the EWMA and move k along the ladder, or, when
        rejection persists at k = 1, move the draft's precision up."""
        if proposed <= 0:
            return
        r = accepted / proposed
        self.rate = self.ewma * self.rate + (1.0 - self.ewma) * r
        i = self._ladder.index(self.k)
        if self.rate >= self.raise_at and self.k < self.k_max:
            self.k = self._ladder[min(i + 1, len(self._ladder) - 1)]
        elif self.rate <= self.lower_at:
            if i > 1:
                # k = 0 belongs to the no-gap regime (choose_k), not to
                # a streak of rejections
                self.k = self._ladder[i - 1]
            elif self.draft_bits < self.max_draft_bits:
                self.draft_bits = min(self.draft_bits + self.bits_step,
                                      self.max_draft_bits)
                self.rate = 0.5   # evidence against the old draft is void

    def on_upgrade(self) -> None:
        """A precision stage landed: the draft/target gap changed, so past
        acceptance evidence is stale; relax toward the prior."""
        self.rate = 0.5 * (self.rate + 0.5)


def schedule_from_stages(bits: int, stage_bits: Sequence[int]) -> PlaneSchedule:
    """The paper's '2 -> 4 -> 6 -> ... -> 16' notation (cumulative bits)
    as a :class:`PlaneSchedule` of widths."""
    widths, prev = [], 0
    for c in stage_bits:
        widths.append(c - prev)
        prev = c
    return PlaneSchedule(bits=bits, widths=tuple(widths))
