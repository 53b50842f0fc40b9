"""Unified telemetry for the progressive-transmission stack.

The package owns one module-global :class:`MetricsRegistry` and one
:class:`Tracer`, both **default-off**: until :func:`configure` (or the
``REPRO_TELEMETRY=1`` environment variable) enables them, every
instrumented call site gets the shared no-op metric and the tracer
drops spans, so the byte clock, token streams, and event logs are
bit-for-bit what they were before instrumentation existed (pinned in
``tests/test_telemetry_invariant.py``).

Call-site contract: fetch metrics at observation time —

    from repro_torch import obs
    obs.get_registry().counter("planes_ored_total").inc(n, dtype=dt)

never cache the metric object across the enable/disable boundary.
"""
from __future__ import annotations

import contextlib
import os

from repro_torch.obs.registry import (NULL_METRIC, Counter, Gauge, Histogram,
                                MetricsRegistry, percentile)
from repro_torch.obs.tracer import SpanRecord, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRIC",
    "SpanRecord", "Tracer", "configure", "enabled", "get_registry",
    "get_tracer", "percentile", "reset", "telemetry",
]

_REGISTRY = MetricsRegistry(
    enabled=os.environ.get("REPRO_TELEMETRY", "") not in ("", "0"))
_TRACER = Tracer(_REGISTRY)


def get_registry() -> MetricsRegistry:
    """The process-global registry instrumented code reports into."""
    return _REGISTRY


def get_tracer() -> Tracer:
    """The process-global span tracer (bound to the global registry)."""
    return _TRACER


def enabled() -> bool:
    return _REGISTRY.enabled


def configure(enabled: bool) -> MetricsRegistry:
    """Flip the global registry on or off. Takes effect at the next
    observation (call sites fetch metrics per-call, never cache)."""
    _REGISTRY.enabled = enabled
    return _REGISTRY


def reset() -> None:
    """Drop all accumulated metrics and spans (enable state is kept)."""
    _REGISTRY.clear()
    _TRACER.clear()


@contextlib.contextmanager
def telemetry(enabled: bool = True):
    """Scoped enable/disable: restores the prior state and, on enable,
    clears anything recorded inside the block on the way out. The
    invariant tests run each engine once inside ``telemetry(True)`` and
    once inside ``telemetry(False)`` and diff the outputs."""
    prior = _REGISTRY.enabled
    _REGISTRY.enabled = enabled
    try:
        yield _REGISTRY
    finally:
        _REGISTRY.enabled = prior
        if enabled and not prior:
            reset()
