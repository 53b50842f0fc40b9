"""Dual-clock span tracer.

The co-simulation runs on two clocks at once: the **simulated
byte clock** (seconds of the bandwidth trace — deterministic, the
clock stage arrivals and session events are stamped with) and **host
wall time** (``time.perf_counter`` — what decode windows and upgrade
enqueues actually cost on this machine). A single latency number is
meaningless without saying which clock it lives on, so a
:class:`SpanRecord` carries both sides explicitly and either may be
absent: engines record wall-only spans (they never see the byte
clock), the session records sim-only spans (its work is charged by the
trace, not measured), and ``repro-telemetry`` reports always name the
clock.

Spans also feed the metrics registry (histograms
``span_<name>_wall_s`` / ``span_<name>_sim_s``) so the Prometheus and
summary exports carry the same percentiles the span list does. Like
everything in :mod:`repro_torch.obs`, a tracer over a disabled registry
records nothing at all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span. ``wall_s`` is host-measured duration;
    ``sim_t0``/``sim_t1`` bound the span on the simulated byte clock.
    Either clock (not both) may be absent."""

    name: str
    labels: dict
    wall_s: float | None = None
    sim_t0: float | None = None
    sim_t1: float | None = None

    @property
    def sim_s(self) -> float | None:
        if self.sim_t0 is None or self.sim_t1 is None:
            return None
        return self.sim_t1 - self.sim_t0

    def to_dict(self) -> dict:
        d = {"name": self.name, **self.labels}
        if self.wall_s is not None:
            d["wall_s"] = self.wall_s
        if self.sim_t0 is not None:
            d["sim_t0"] = self.sim_t0
        if self.sim_t1 is not None:
            d["sim_t1"] = self.sim_t1
            if self.sim_t0 is not None:
                d["sim_s"] = self.sim_s
        return d


class Tracer:
    """Span sink bound to a registry. Inert while the registry is
    disabled: ``record`` drops the span, ``span()`` skips even the
    clock reads, so tracing a disabled session allocates nothing."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.spans: list[SpanRecord] = []

    def record(self, name: str, *, wall_s: float | None = None,
               sim_t0: float | None = None, sim_t1: float | None = None,
               **labels) -> SpanRecord | None:
        if not self.registry.enabled:
            return None
        rec = SpanRecord(name=name, labels=labels, wall_s=wall_s,
                         sim_t0=sim_t0, sim_t1=sim_t1)
        self.spans.append(rec)
        if wall_s is not None:
            self.registry.histogram(
                f"span_{name}_wall_s",
                f"host wall seconds of {name} spans").observe(
                    wall_s, **labels)
        if rec.sim_s is not None:
            self.registry.histogram(
                f"span_{name}_sim_s",
                f"simulated byte-clock seconds of {name} spans").observe(
                    rec.sim_s, **labels)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, *, sim_t0: float | None = None,
             sim_t1: float | None = None, **labels):
        """Measure a wall-clock span around a block; the caller may
        additionally stamp the byte-clock bounds it knows."""
        if not self.registry.enabled:
            yield None
            return
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            self.record(name, wall_s=time.perf_counter() - t0,
                        sim_t0=sim_t0, sim_t1=sim_t1, **labels)

    def of(self, name: str) -> list[SpanRecord]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans.clear()
