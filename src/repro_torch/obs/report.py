"""``repro-telemetry`` — analyze session event logs.

Reads one or more ``SessionResult`` JSONL logs (what
``launch/serve.py --event-log`` and the tier-2 CI job write) and
renders the paper's user-experience curve as tables:

* **per-stage**: arrival time on the byte clock, cumulative bytes,
  goodput (bytes/s to that stage), and — when an accuracy table is
  supplied via ``--accuracy`` — accuracy-per-MB;
* **latency**: TTFT (cold start → first emitted token) and
  decode/window cadence;
* **stalls** with p50/p99: upgrade lag (stage arrival → engine
  upgrade), inter-chunk gaps, and fault-channel backoff
  (retry/nack/reconnect).

Everything is computed from the log alone — the analyzer never needs
the model, the registry, or a live session, so it runs on any archived
artifact. ``--check-prom`` additionally round-trips a Prometheus
export through :func:`repro_torch.obs.exporters.parse_prometheus` (the CI
scrapeability check), and ``--validate`` runs every event through the
:mod:`repro_torch.obs.schema` registry.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs.registry import percentile


def load_events(path: str | Path) -> list[dict]:
    """Parse a JSONL log into event records ordered by (t_s, seq)."""
    events = []
    for lineno, line in enumerate(Path(path).read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{lineno}: not JSON ({e})") from e
        if "kind" not in rec or "t_s" not in rec:
            raise ValueError(f"{path}:{lineno}: not a session event record")
        events.append(rec)
    events.sort(key=lambda e: (e["t_s"], e.get("seq", 0)))
    return events


def _pcts(vals: list[float]) -> dict:
    return {"count": len(vals),
            "p50": percentile(vals, 50), "p99": percentile(vals, 99)}


def analyze(events: list[dict],
            accuracy: dict[int, float] | None = None) -> dict:
    """Reduce an event stream to the report structure. ``accuracy``
    maps stage -> task accuracy (e.g. from an evaluation sweep) and
    enables the accuracy-per-byte column."""
    by_kind: dict[str, list[dict]] = {}
    for e in events:
        by_kind.setdefault(e["kind"], []).append(e)

    # -- per-stage table ------------------------------------------------
    stages = []
    arrival: dict[int, float] = {}
    for e in by_kind.get("stage_complete", ()):
        s = e["stage"]
        if s in arrival:  # a repair can re-announce; keep first arrival
            continue
        arrival[s] = e["t_s"]
        bytes_through = e.get("through")
        row = {"stage": s, "t_s": e["t_s"], "bytes": bytes_through,
               "via_repair": "repair" in e}
        if bytes_through and e["t_s"] > 0:
            row["goodput_bps"] = bytes_through / e["t_s"]
        if accuracy and s in accuracy:
            row["accuracy"] = accuracy[s]
            if bytes_through:
                row["acc_per_mb"] = accuracy[s] / (bytes_through / 2**20)
        stages.append(row)

    # -- latency --------------------------------------------------------
    latency: dict = {}
    cold = by_kind.get("cold_start", ())
    if cold:
        t0 = cold[0]["t_s"]
        latency["cold_start_s"] = t0
        first_tok = None
        for e in events:
            if e["kind"] == "decode_step":
                first_tok = e["t_s"]
                break
            if e["kind"] == "pool_window" and e.get("tokens", 0) > 0:
                first_tok = e["t_s"]
                break
        if first_tok is not None:
            latency["first_token_s"] = first_tok
            latency["ttft_s"] = first_tok - t0
    results = by_kind.get("result_ready", ())
    if results:
        latency["result_ready"] = {
            e["stage"]: e["t_s"] for e in results}
    decode_ts = [e["t_s"] for e in by_kind.get("decode_step", ())]
    if len(decode_ts) > 1:
        gaps = [b - a for a, b in zip(decode_ts, decode_ts[1:])]
        latency["decode_gap_s"] = _pcts(gaps)
    windows = by_kind.get("pool_window", ())
    if windows:
        latency["pool_windows"] = {
            "count": len(windows),
            "tokens": sum(e.get("tokens", 0) for e in windows),
            "steps": sum(e.get("steps", 0) for e in windows)}

    # -- stalls ---------------------------------------------------------
    stalls: dict = {}
    upgrade_lags = []
    for e in by_kind.get("upgrade", ()):
        s = e.get("stage")
        if s in arrival:
            upgrade_lags.append(e["t_s"] - arrival[s])
    if upgrade_lags:
        stalls["upgrade_lag_s"] = _pcts(upgrade_lags)
    chunk_ts = [e["t_s"] for e in by_kind.get("chunk", ())]
    if len(chunk_ts) > 1:
        stalls["chunk_gap_s"] = _pcts(
            [b - a for a, b in zip(chunk_ts, chunk_ts[1:])])
    backoffs = [e["backoff_s"] for k in ("retry", "reconnect")
                for e in by_kind.get(k, ()) if "backoff_s" in e]
    backoffs += [e["rerequest_backoff_s"] for e in by_kind.get("nack", ())]
    if backoffs:
        stalls["backoff_s"] = _pcts(backoffs)

    # -- speculation / transport ---------------------------------------
    extras: dict = {}
    accepts = by_kind.get("accept_round", ())
    if accepts:
        rates = [e["rate"] for e in accepts if "rate" in e]
        extras["speculation"] = {"rounds": len(accepts),
                                 "accept_rate": _pcts(rates)}
    ts = by_kind.get("transport_summary", ())
    if ts:
        extras["transport"] = {
            k: v for k, v in ts[-1].items()
            if k not in ("t_s", "kind", "seq")}

    return {"events": len(events),
            "kinds": {k: len(v) for k, v in sorted(by_kind.items())},
            "stages": stages, "latency": latency, "stalls": stalls,
            **extras}


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _table(headers: list[str], rows: list[list]) -> str:
    cells = [[_fmt(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    def line(parts):
        return "  ".join(p.ljust(w) for p, w in zip(parts, widths)).rstrip()
    return "\n".join([line(headers),
                      line(["-" * w for w in widths]),
                      *[line(r) for r in cells]])


def render(report: dict, title: str = "") -> str:
    out = []
    if title:
        out += [f"== {title} ==", ""]
    out.append(f"events: {report['events']}  "
               + "  ".join(f"{k}={v}" for k, v in report["kinds"].items()))
    if report["stages"]:
        has_acc = any("accuracy" in r for r in report["stages"])
        headers = ["stage", "t_s", "bytes", "goodput_B/s"]
        if has_acc:
            headers += ["accuracy", "acc/MB"]
        headers += ["repair"]
        rows = []
        for r in report["stages"]:
            row = [r["stage"], r["t_s"], r.get("bytes"),
                   r.get("goodput_bps")]
            if has_acc:
                row += [r.get("accuracy"), r.get("acc_per_mb")]
            row += [r["via_repair"]]
            rows.append(row)
        out += ["", "per-stage arrivals:", _table(headers, rows)]
    lat = report["latency"]
    if lat:
        out += ["", "latency:"]
        if "ttft_s" in lat:
            out.append(f"  ttft_s={_fmt(lat['ttft_s'])} "
                       f"(cold_start_s={_fmt(lat.get('cold_start_s'))}, "
                       f"first_token_s={_fmt(lat.get('first_token_s'))})")
        if "result_ready" in lat:
            out.append("  result_ready: " + "  ".join(
                f"stage{s}@{_fmt(t)}s"
                for s, t in sorted(lat["result_ready"].items())))
        if "decode_gap_s" in lat:
            g = lat["decode_gap_s"]
            out.append(f"  decode_gap_s: n={g['count']} "
                       f"p50={_fmt(g['p50'])} p99={_fmt(g['p99'])}")
        if "pool_windows" in lat:
            w = lat["pool_windows"]
            out.append(f"  pool_windows: n={w['count']} "
                       f"tokens={w['tokens']} steps={w['steps']}")
    if report["stalls"]:
        rows = [[name, s["count"], s["p50"], s["p99"]]
                for name, s in sorted(report["stalls"].items())]
        out += ["", "stalls:", _table(["metric", "n", "p50", "p99"], rows)]
    if "speculation" in report:
        sp = report["speculation"]
        r = sp["accept_rate"]
        out += ["", f"speculation: rounds={sp['rounds']} accept_rate "
                    f"p50={_fmt(r['p50'])} p99={_fmt(r['p99'])}"]
    if "transport" in report:
        out += ["", "transport: " + "  ".join(
            f"{k}={v}" for k, v in report["transport"].items()
            if not isinstance(v, dict))]
    return "\n".join(out)


def _parse_accuracy(spec: str | None) -> dict[int, float] | None:
    """``--accuracy 1=0.31,2=0.52,4=0.66`` or a path to a JSON file
    mapping stage -> accuracy."""
    if not spec:
        return None
    p = Path(spec)
    if p.exists():
        raw = json.loads(p.read_text())
        return {int(k): float(v) for k, v in raw.items()}
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        out[int(k)] = float(v)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-telemetry",
        description="Analyze session event logs (JSONL) into per-stage "
                    "goodput/TTFT/stall tables with p50/p99.")
    ap.add_argument("logs", nargs="*", help="session JSONL log files")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    ap.add_argument("--accuracy", default=None,
                    help="stage accuracies: '1=0.31,4=0.66' or a JSON "
                         "file path; enables the accuracy-per-MB column")
    ap.add_argument("--validate", action="store_true",
                    help="validate every event against the schema "
                         "registry before analyzing")
    ap.add_argument("--check-prom", default=None, metavar="PATH",
                    help="parse a Prometheus text export and exit "
                         "(round-trip scrapeability check)")
    args = ap.parse_args(argv)

    if args.check_prom:
        from repro_torch.obs.exporters import parse_prometheus
        text = Path(args.check_prom).read_text()
        families = parse_prometheus(text)
        n = sum(len(f["samples"]) for f in families.values())
        print(f"{args.check_prom}: OK — {len(families)} families, "
              f"{n} samples")
        if not args.logs:
            return 0

    if not args.logs:
        ap.error("no logs given (and no --check-prom)")

    accuracy = _parse_accuracy(args.accuracy)
    reports = {}
    for log in args.logs:
        events = load_events(log)
        if args.validate:
            from repro_torch.obs.schema import validate_event
            for e in events:
                validate_event(e)
        reports[log] = analyze(events, accuracy=accuracy)

    if args.json:
        print(json.dumps(reports, indent=2, sort_keys=True))
    else:
        for i, (log, rep) in enumerate(reports.items()):
            if i:
                print()
            print(render(rep, title=log))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # e.g. `repro-telemetry ... | head`; devnull stdout so the
        # interpreter's exit flush doesn't raise a second time
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
