"""The paper's Fig.-4 timeline algebra: concurrent transmission and
inference.

Three schedules are modelled:

* ``singleton``      — download everything, then concat+dequant+infer once.
* ``progressive, w/o concurrency`` — stages download and are processed
  *serially*: stage s+1's download starts only after stage s's
  concat+dequant+inference finished (the naive implementation the paper
  measures at +20..80%).
* ``progressive, w/ concurrency`` — stage s+1 downloads in the
  background while stage s is processed; total time is
  ``max(download_total, download_1 + Σ process) ≈ download_total``
  whenever per-stage processing fits inside the next stage's download
  window — the paper's headline claim (Table I, +0%).

The schedule is pure algebra over byte counts and per-step costs: every
download milestone is a :meth:`BandwidthTrace.time_to_deliver` query, so
it works unchanged for constant links *and* fluctuating traces, and
times are derived, never measured. The same byte->time mapping drives
the co-simulation harness (:mod:`repro_torch.transmission.session`), which
executes the real client/server against the same clock — a test pins
the two to <1e-9 s. Latency is a one-time shift of the byte clock, paid
exactly once per connection in every branch (including
``header_bytes=0``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.transmission.simulator import TraceLike, as_trace


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Client-side processing cost of one stage (seconds)."""

    concat_s: float
    dequant_s: float
    inference_s: float

    @property
    def total(self) -> float:
        return self.concat_s + self.dequant_s + self.inference_s


@dataclasses.dataclass
class Timeline:
    """Per-stage milestones: when its bytes landed, when its (approx)
    inference result became visible, plus the grand total."""

    download_done: list[float]
    result_ready: list[float]

    @property
    def total_s(self) -> float:
        return self.result_ready[-1]

    @property
    def first_result_s(self) -> float:
        return self.result_ready[0]


def singleton_timeline(total_bytes: int, link: TraceLike, cost: StageCost) -> Timeline:
    """Download whole file, process once."""
    trace, latency = as_trace(link)
    dl = latency + trace.time_to_deliver(total_bytes)
    return Timeline(download_done=[dl], result_ready=[dl + cost.total])


def progressive_timeline(
    stage_bytes: Sequence[int],
    link: TraceLike,
    stage_costs: Sequence[StageCost],
    concurrent: bool,
    header_bytes: int = 0,
) -> Timeline:
    """Timeline of an n-stage progressive transfer.

    w/ concurrency: downloads proceed back-to-back on the link
    (the link never idles); processing of stage s runs as soon as both
    (a) its bytes are in and (b) the previous stage's processing is done
    (single compute queue, like the paper's JS main thread + WebGL).

    w/o concurrency: the link idles while the client processes; stage
    s+1's download starts only after stage s's result is shown. With a
    trace-driven link the idle window consumes *wall* time, so the
    resumed download sees whatever bandwidth the trace has then.
    """
    if len(stage_bytes) != len(stage_costs):
        raise ValueError("stage_bytes and stage_costs length mismatch")
    trace, latency = as_trace(link)
    n = len(stage_bytes)
    download_done: list[float] = []
    result_ready: list[float] = []
    # trace-clock time of the last delivered byte (wall = latency + tt)
    tt = trace.time_to_deliver(header_bytes)
    if concurrent:
        proc_free = 0.0
        for s in range(n):
            tt = trace.time_to_deliver(stage_bytes[s], start_s=tt)
            dl = latency + tt
            download_done.append(dl)
            start = max(dl, proc_free)
            proc_free = start + stage_costs[s].total
            result_ready.append(proc_free)
    else:
        for s in range(n):
            tt = trace.time_to_deliver(stage_bytes[s], start_s=tt)
            dl = latency + tt
            download_done.append(dl)
            ready = dl + stage_costs[s].total
            result_ready.append(ready)
            # link idles until this stage's result is shown
            tt = ready - latency
    return Timeline(download_done=download_done, result_ready=result_ready)


def overhead_pct(progressive: Timeline, singleton: Timeline) -> float:
    """Paper Table-I metric: (progressive_total - singleton_total) / singleton_total."""
    return 100.0 * (progressive.total_s - singleton.total_s) / singleton.total_s


def time_to_first_useful(
    timeline: Timeline, useful_stage: int
) -> float:
    """Table-III proxy: when the first *useful* (non-garbage) approximate
    result appears. ``useful_stage`` is 1-indexed (the paper finds 6-bit,
    i.e. stage 3 of the 2-bit schedule, is the first useful one)."""
    return timeline.result_ready[useful_stage - 1]
