"""Exporters: Prometheus text format, JSONL, and a structured summary.

One registry, three faithful views:

* :func:`to_prometheus` — the Prometheus text exposition format
  (counters and gauges as-is; histograms as ``summary`` families with
  exact ``quantile`` labels, ``_sum`` and ``_count``). A minimal
  parser, :func:`parse_prometheus`, round-trips the export — CI uses
  it as the "is this actually scrapeable" check.
* :func:`to_summary` — a JSON-able nested dict (counters/gauges by
  labelset, histogram stats with exact percentiles, span records),
  what ``launch/serve.py --metrics`` writes next to the ``.prom`` file.
* :func:`to_jsonl` — one JSON object per sample, for log pipelines.
"""
from __future__ import annotations

import json
import math
import re

from repro_torch.obs.registry import (Counter, Gauge, Histogram, LabelSet,
                                MetricsRegistry)
from repro_torch.obs.tracer import Tracer

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_QUANTILES = (50.0, 90.0, 99.0)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(ls: LabelSet, extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = [*ls, *extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    out: list[str] = []
    for m in registry.collect():
        if not _NAME_RE.match(m.name):
            raise ValueError(f"invalid metric name {m.name!r}")
        if isinstance(m, (Counter, Gauge)):
            out.append(f"# HELP {m.name} {m.help or m.name}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for ls, v in m.samples():
                out.append(f"{m.name}{_fmt_labels(ls)} {_fmt_value(v)}")
        elif isinstance(m, Histogram):
            # exact-sample histograms export as Prometheus summaries:
            # the quantiles are computed, not bucket-approximated
            out.append(f"# HELP {m.name} {m.help or m.name}")
            out.append(f"# TYPE {m.name} summary")
            for ls, vs in m.samples():
                for q in _QUANTILES:
                    qv = m.percentile(q, **dict(ls))
                    lab = _fmt_labels(ls, (("quantile", f"{q / 100:g}"),))
                    out.append(f"{m.name}{lab} {_fmt_value(qv)}")
                out.append(
                    f"{m.name}_sum{_fmt_labels(ls)} "
                    f"{_fmt_value(float(sum(vs)))}")
                out.append(f"{m.name}_count{_fmt_labels(ls)} {len(vs)}")
    return "\n".join(out) + ("\n" if out else "")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text format back into
    ``{name: {"type": str, "help": str, "samples": {labelstr: value}}}``.
    Strict enough to catch a malformed export (unknown line shapes,
    samples for undeclared families, bad floats all raise
    ``ValueError``) — the CI round-trip check."""
    families: dict[str, dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"samples": {}})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            if kind not in ("counter", "gauge", "summary", "histogram",
                            "untyped"):
                raise ValueError(f"line {lineno}: unknown TYPE {kind!r}")
            families.setdefault(name, {"samples": {}})["type"] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name = m.group("name")
        base = re.sub(r"_(sum|count)$", "", name)
        fam = families.get(name) or families.get(base)
        if fam is None:
            raise ValueError(
                f"line {lineno}: sample {name!r} before its TYPE line")
        labels = {}
        raw = m.group("labels")
        if raw:
            consumed = sum(
                len(mm.group(0)) for mm in _LABEL_RE.finditer(raw))
            if consumed < len(raw.replace(",", "")):
                raise ValueError(f"line {lineno}: malformed labels {raw!r}")
            labels = {k: v for k, v in _LABEL_RE.findall(raw)}
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}") from e
        key = name + _fmt_labels(tuple(sorted(labels.items())))
        fam["samples"][key] = value
    for name, fam in families.items():
        if "type" not in fam:
            raise ValueError(f"family {name!r} has no TYPE line")
    return families


def to_summary(registry: MetricsRegistry,
               tracer: Tracer | None = None) -> dict:
    """Structured one-source-of-truth summary: every metric with its
    labeled samples; histograms with exact count/sum/min/max/mean and
    p50/p90/p99; span records when a tracer is supplied."""
    def lkey(ls: LabelSet) -> str:
        return ",".join(f"{k}={v}" for k, v in ls) or "_"

    counters, gauges, hists = {}, {}, {}
    for m in registry.collect():
        if isinstance(m, Counter):
            counters[m.name] = {lkey(ls): v for ls, v in m.samples()}
        elif isinstance(m, Gauge):
            gauges[m.name] = {lkey(ls): v for ls, v in m.samples()}
        elif isinstance(m, Histogram):
            hists[m.name] = {
                lkey(ls): m.stats(quantiles=_QUANTILES, **dict(ls))
                for ls, _ in m.samples()}
    out = {"counters": counters, "gauges": gauges, "histograms": hists}
    if tracer is not None:
        out["spans"] = [s.to_dict() for s in tracer.spans]
    return out


def to_jsonl(registry: MetricsRegistry) -> str:
    """One JSON object per sample: ``{"metric", "type", "labels",
    "value"}`` (histograms carry their stats dict as the value)."""
    lines = []
    for m in registry.collect():
        if isinstance(m, Histogram):
            for ls, _ in m.samples():
                lines.append(json.dumps(
                    {"metric": m.name, "type": m.kind, "labels": dict(ls),
                     "value": m.stats(quantiles=_QUANTILES, **dict(ls))},
                    sort_keys=True))
        else:
            for ls, v in m.samples():
                lines.append(json.dumps(
                    {"metric": m.name, "type": m.kind, "labels": dict(ls),
                     "value": v}, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")
