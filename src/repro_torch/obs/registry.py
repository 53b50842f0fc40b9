"""Labeled metrics registry: counters, gauges, histograms.

One source of truth for everything the serving stack measures. Metrics
are interned by name (``registry.counter("x")`` always returns the same
object), carry free-form labels per sample, and histograms keep their
*exact* observations — percentiles are computed from the full sample
set with numpy's linear-interpolation semantics (pinned against
``np.percentile`` by test), not approximated from fixed bucket bounds.
Sessions here are small (thousands of events, not billions), so exact
beats clever.

The registry is **default-off**: the module-global instance created by
:mod:`repro_torch.obs` starts disabled, and a disabled registry hands every
caller the shared :data:`NULL_METRIC` whose operations are no-ops. The
hard invariant this buys (pinned in ``tests/test_telemetry_invariant``)
is that instrumented hot paths — plane ingest, decode windows, the
byte-clock session loop — behave *identically* with telemetry off, and
enabling it only ever observes values the code already computed: no
device syncs, no extra host transfers, no byte-clock perturbation.
"""
from __future__ import annotations

import math
from typing import Any, Iterable

LabelSet = tuple[tuple[str, str], ...]


def _labelset(labels: dict[str, Any]) -> LabelSet:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(values: list[float] | tuple[float, ...], q: float) -> float:
    """Exact percentile with numpy's default (linear-interpolation)
    semantics, implemented locally so the registry stays importable
    without numpy on a metrics-only consumer. ``q`` in [0, 100].
    Pinned against ``np.percentile`` oracles by test."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    if not values:
        return math.nan
    vs = sorted(values)
    rank = (len(vs) - 1) * (q / 100.0)
    lo = int(math.floor(rank))
    frac = rank - lo
    if frac == 0.0 or lo + 1 >= len(vs):
        return float(vs[lo])
    return float(vs[lo] + (vs[lo + 1] - vs[lo]) * frac)


class _NullMetric:
    """Shared do-nothing stand-in a disabled registry hands out. Every
    mutator accepts any arguments and returns None; reads return inert
    zeros so accidental reads on the disabled path never raise."""

    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def dec(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0

    def count(self, **labels) -> int:
        return 0

    def sum(self, **labels) -> float:
        return 0.0

    def percentile(self, q: float, **labels) -> float:
        return math.nan

    def samples(self) -> list:
        return []


NULL_METRIC = _NullMetric()


class Metric:
    """Base: name + help + per-labelset storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._data: dict[LabelSet, Any] = {}

    def labelsets(self) -> list[LabelSet]:
        return sorted(self._data)


class Counter(Metric):
    """Monotonically increasing count (``inc`` rejects negatives)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        ls = _labelset(labels)
        self._data[ls] = self._data.get(ls, 0.0) + amount

    def value(self, **labels) -> float:
        return self._data.get(_labelset(labels), 0.0)

    def samples(self) -> list[tuple[LabelSet, float]]:
        return [(ls, self._data[ls]) for ls in self.labelsets()]


class Gauge(Metric):
    """Last-written value per labelset."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._data[_labelset(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        ls = _labelset(labels)
        self._data[ls] = self._data.get(ls, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._data.get(_labelset(labels), 0.0)

    def samples(self) -> list[tuple[LabelSet, float]]:
        return [(ls, self._data[ls]) for ls in self.labelsets()]


class Histogram(Metric):
    """Exact-sample histogram: every observation is kept, so
    ``percentile`` is exact (numpy linear-interpolation semantics) and
    the exporter can emit any quantile without pre-chosen buckets."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        self._data.setdefault(_labelset(labels), []).append(float(value))

    def count(self, **labels) -> int:
        return len(self._data.get(_labelset(labels), ()))

    def sum(self, **labels) -> float:
        return float(sum(self._data.get(_labelset(labels), ())))

    def values(self, **labels) -> list[float]:
        return list(self._data.get(_labelset(labels), ()))

    def percentile(self, q: float, **labels) -> float:
        return percentile(self._data.get(_labelset(labels), ()), q)

    def stats(self, quantiles: Iterable[float] = (50, 90, 99),
              **labels) -> dict:
        vs = self._data.get(_labelset(labels), [])
        out = {"count": len(vs), "sum": float(sum(vs))}
        if vs:
            out["min"] = float(min(vs))
            out["max"] = float(max(vs))
            out["mean"] = out["sum"] / len(vs)
        for q in quantiles:
            out[f"p{q:g}"] = percentile(vs, q)
        return out

    def samples(self) -> list[tuple[LabelSet, list[float]]]:
        return [(ls, list(self._data[ls])) for ls in self.labelsets()]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Interned, labeled metrics with a master enable switch.

    ``enabled=False`` (how the global registry starts) turns every
    accessor into a constant-time no-op: ``counter()``/``gauge()``/
    ``histogram()`` return the shared :data:`NULL_METRIC` without
    creating anything. Instrumented code therefore fetches its metric
    at the call site (``get_registry().counter(...)``) rather than
    caching it, so flipping ``enabled`` mid-process takes effect on the
    next observation.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str):
        if not self.enabled:
            return NULL_METRIC
        got = self._metrics.get(name)
        if got is None:
            got = cls(name, help)
            self._metrics[name] = got
        elif not isinstance(got, cls):
            raise TypeError(
                f"metric {name!r} already registered as {got.kind}, "
                f"requested {cls.kind}")
        return got

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def collect(self) -> list[Metric]:
        """All registered metrics, name-sorted (export order)."""
        return [self._metrics[n] for n in sorted(self._metrics)]

    def clear(self) -> None:
        self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)
