"""Deterministic co-simulation: real bytes, simulated clock.

Counterpart of ``src/repro/transmission/session.py``: the same byte
clock, feed plan, fault runner and event log (``to_jsonl`` is
byte-identical to the reference's for the same blob, trace and seed),
driving the port's client and engines on ``device`` (the card unless the
caller passes ``device="cpu"``). ``run_serving`` and ``run_serving_pool``
take a serving mesh (``mesh=``, whose home device is ``device``): the
client's store is then sharded and the engines decode through sharded
dispatch, token-identical to one device.

A :class:`Session` couples the byte clock of a
:class:`~repro_torch.transmission.simulator.BandwidthTrace` to the *real*
receive path: the serialized ``wire`` stream is cut into
transport-sized chunks, each chunk is fed to a real
:class:`~repro_torch.transmission.client.ProgressiveClient` (which ingests
planes into the device-resident PlaneStore), and every milestone is
stamped with the exact time the trace says those bytes landed
(``time_to_deliver`` — derived, never measured). Processing costs come
from a supplied cost model, so runs are bit- and time-deterministic on
any machine.

Two run modes:

* :meth:`Session.run_timeline` — the Fig.-4 schedules *executed*: the
  real client decodes the stream while a single simulated compute queue
  charges per-stage costs. Its Timeline must agree with the pure
  algebra in :mod:`~repro_torch.transmission.scheduler` to <1e-9 s (pinned by
  tests) — the algebra and the execution can no longer silently
  diverge.
* :meth:`Session.run_serving` — the operational path: a real
  :class:`~repro_torch.serving.engine.ProgressiveServer` sits on the *same*
  store the client fills (no second ingest) and greedy-decodes real
  tokens, upgrading precision between steps exactly when the trace
  delivered each stage.

Every run produces a single auditable event log (bytes fed, header,
stage completions, upgrades, decode steps, per-step stage) that can be
dumped as JSONL for CI artifacts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch import obs as _obs
from repro_torch import resolve_device
from repro_torch.core import wire
from repro_torch.transmission.client import ProgressiveClient
from repro_torch.transmission.scheduler import StageCost, Timeline
from repro_torch.transmission.simulator import BandwidthTrace, FaultTrace

DEFAULT_CHUNK_BYTES = 64 * 1024


class TransportError(RuntimeError):
    """The fault policy's retry budget is exhausted: a unit (or the
    stream itself) could not be delivered intact within
    ``max_retries`` attempts. Clean, typed failure — never a silent
    partial model."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Retry/timeout/backoff policy for a faulty transport.

    * ``chunk_timeout_s`` — a delivery whose trace time exceeds this is
      abandoned (connection presumed dead) and retried after backoff.
    * ``max_retries`` — per-target attempt budget (each quarantined
      unit, and each stream reconnect burst, counts its own attempts);
      exceeding it raises :class:`TransportError`.
    * backoff — capped exponential ``min(cap, base * 2**attempt)``
      with seeded multiplicative jitter, so retry schedules are
      deterministic for a fixed seed yet decorrelated across targets.
    """

    chunk_timeout_s: float = 30.0
    max_retries: int = 8
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.chunk_timeout_s <= 0:
            raise ValueError("chunk_timeout_s must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not (0.0 <= self.jitter_frac < 1.0):
            raise ValueError("jitter_frac must be in [0, 1)")

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        d = min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * (2.0 * float(rng.random()) - 1.0)
        return d


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    """One entry of the audit log. ``data`` is JSON-able. ``seq`` is
    the emission-order tiebreak: events are sorted by ``(t_s, seq)``,
    so logs with equal timestamps are reproducibly ordered."""

    t_s: float
    kind: str   # see repro_torch.obs.schema.EVENT_SCHEMAS for the registry
    data: dict
    seq: int = 0


class _EventRecorder(list):
    """Event sink for a session run: stamps each appended
    :class:`SessionEvent` with a monotonic ``seq`` and, when the global
    telemetry registry is enabled, mirrors the event into it (counters
    for chunks/faults/retries, byte-clock spans for stage arrivals).
    A plain ``list`` still works wherever events are collected
    (``seq`` stays 0) — this class only adds bookkeeping."""

    def __init__(self, iterable=()):
        super().__init__()
        self._seq = 0
        for e in iterable:
            self.append(e)

    def append(self, event: SessionEvent) -> None:
        event = dataclasses.replace(event, seq=self._seq)
        self._seq += 1
        super().append(event)
        if _obs.enabled():
            _observe_event(event)


def _observe_event(event: SessionEvent) -> None:
    """Mirror one session event into the metrics registry. Runs only
    when telemetry is enabled; observes values the event already
    carries — it never touches the byte clock or the client."""
    reg, tracer = _obs.get_registry(), _obs.get_tracer()
    kind, d, t = event.kind, event.data, event.t_s
    if kind == "chunk":
        reg.counter("session_chunks_total", "transport chunks fed").inc()
        reg.counter("session_bytes_total",
                    "wire bytes delivered").inc(d["bytes"])
    elif kind == "stage_complete":
        reg.counter("session_stage_completions_total",
                    "stage arrivals").inc(stage=d["stage"])
        tracer.record("stage_arrival", sim_t0=0.0, sim_t1=t,
                      stage=d["stage"])
    elif kind == "result_ready":
        tracer.record("stage_process", sim_t0=d["process_start_s"],
                      sim_t1=t, stage=d["stage"])
    elif kind == "upgrade":
        reg.counter("session_upgrades_total",
                    "precision upgrades applied").inc(stage=d["stage"])
    elif kind == "decode_step":
        reg.counter("session_decode_steps_total", "decode steps").inc()
    elif kind == "fault":
        reg.counter("transport_faults_total",
                    "injected faults observed").inc(fault=d["fault"])
    elif kind == "retry":
        reg.counter("transport_retries_total", "delivery retries").inc()
        reg.histogram("transport_backoff_s",
                      "byte-clock backoff waits").observe(
                          d["backoff_s"], cause="retry")
    elif kind == "nack":
        reg.counter("transport_nacks_total", "unit NACKs sent").inc()
        reg.histogram("transport_backoff_s",
                      "byte-clock backoff waits").observe(
                          d["rerequest_backoff_s"], cause="nack")
    elif kind == "reconnect":
        reg.counter("transport_reconnects_total",
                    "stream reconnects").inc(reason=d["reason"])
        reg.histogram("transport_backoff_s",
                      "byte-clock backoff waits").observe(
                          d["backoff_s"], cause="reconnect")
    elif kind == "quarantine":
        reg.counter("transport_quarantined_total",
                    "units quarantined").inc()
    elif kind == "repair":
        reg.counter("transport_repairs_total",
                    "repair deliveries").inc(ok=d["ok"])
    elif kind == "accept_round":
        reg.counter("speculation_rounds_total",
                    "speculative accept rounds").inc()
    elif kind == "pool_window":
        reg.histogram("pool_window_tokens",
                      "tokens emitted per pool window").observe(
                          d["tokens"])


@dataclasses.dataclass
class SessionResult:
    """Outcome of a session run: milestones + the audit log + the live
    endpoints (client always; server in serving mode)."""

    events: list[SessionEvent]
    client: ProgressiveClient
    timeline: Timeline | None = None
    server: Any = None
    tokens: Any = None                # serving: (B, steps) array;
                                      # pool: {rid: [token, ...]}
    upgrades: list | None = None      # (decode step, new stage)
    stage_at_step: list | None = None
    admissions: list | None = None    # pool: (wall_s, rid) admission log
    transport: dict | None = None     # fault runs: injected/repaired stats

    def to_jsonl(self) -> str:
        return "\n".join(
            json.dumps({"t_s": e.t_s, "kind": e.kind, "seq": e.seq,
                        **e.data}, sort_keys=True)
            for e in self.events) + "\n"

    def events_of(self, kind: str) -> list[SessionEvent]:
        return [e for e in self.events if e.kind == kind]

    def speculation_summary(self) -> dict:
        """Aggregate the run's ``accept_round`` events (empty-safe):
        rounds, drafts proposed/accepted, overall acceptance rate."""
        rounds = self.events_of("accept_round")
        drafted = sum(e.data["k"] * len(e.data["accepted"]) for e in rounds)
        accepted = sum(sum(e.data["accepted"]) for e in rounds)
        return {"rounds": len(rounds), "drafted": drafted,
                "accepted": accepted,
                "rate": accepted / drafted if drafted else 0.0}


class Session:
    """Streams a serialized progressive model through a bandwidth trace
    into the real client, on a deterministic discrete-event clock.

    The stream is cut at transport-chunk boundaries (``chunk_bytes``
    grid) *and* at header/stage ends, so stage completions are stamped
    with the exact byte-clock time of their final byte while the client
    still sees arbitrary mid-plane chunk boundaries in between.

    ``device`` is where every run's client store and engine live.
    """

    def __init__(self, blob: bytes, trace: BandwidthTrace, *,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 latency_s: float = 0.0, name: str = "", device="cuda"):
        if chunk_bytes < 1:
            raise ValueError("chunk_bytes must be >= 1")
        self.device = resolve_device(device)
        self.blob = bytes(blob)
        self.trace = trace
        self.chunk_bytes = chunk_bytes
        self.latency_s = latency_s
        self.name = name or getattr(trace, "name", "")
        meta, hdr = wire.decode_header(self.blob)
        self.meta = meta
        self.layout = wire.layout_from_header(meta, hdr)
        if self.layout.total_bytes != len(self.blob):
            raise ValueError(
                f"blob is {len(self.blob)} bytes but header declares "
                f"{self.layout.total_bytes}")
        ends = []
        off = hdr
        for sb in self.layout.stage_bytes:
            off += sb
            ends.append(off)
        self._stage_ends = ends           # wire offset at each stage's end
        self._header_end = hdr
        self._feed_plan_cache: list[tuple[int, int, float]] | None = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_model(cls, prog, trace: BandwidthTrace, *, schedule=None,
                   entropy_coded: bool = False, **kw) -> "Session":
        """Serialize a server-side ProgressiveModel and stream it.
        ``schedule``/``entropy_coded`` select the v2 accuracy-per-byte
        wire (see :mod:`repro_torch.core.calibrate`); stage semantics carry
        over — v2 checkpoints play the role of stage ends."""
        return cls(wire.encode(prog, schedule=schedule,
                               entropy_coded=entropy_coded), trace, **kw)

    @classmethod
    def from_scenario(cls, blob: bytes, scenario, *, seed: int = 0,
                      **overrides) -> "Session":
        """Build from a named scenario (see
        :mod:`repro_torch.transmission.scenarios`): trace, latency and chunk
        size come from the catalog entry; ``overrides`` win."""
        kw = dict(chunk_bytes=scenario.chunk_bytes,
                  latency_s=scenario.latency_s,
                  name=f"{scenario.name}@{seed}")
        kw.update(overrides)
        return cls(blob, scenario.make_trace(seed), **kw)

    @property
    def n_stages(self) -> int:
        return len(self._stage_ends)

    # -- byte plan ---------------------------------------------------------
    def _pieces(self) -> list[tuple[int, int]]:
        """(start, end) byte ranges: the chunk grid split additionally at
        the header end and every stage end."""
        total = len(self.blob)
        cuts = set(range(self.chunk_bytes, total, self.chunk_bytes))
        cuts.add(self._header_end)
        cuts.update(self._stage_ends)
        cuts.add(total)
        bounds = sorted(c for c in cuts if 0 < c <= total)
        pieces, prev = [], 0
        for b in bounds:
            if b > prev:
                pieces.append((prev, b))
                prev = b
        return pieces

    def _feed_plan(self) -> list[tuple[int, int, float]]:
        """(start, end, wall_arrival_s) per piece for a link that never
        idles (concurrent / serving mode). Chained
        ``time_to_deliver`` queries, so milestones are exact."""
        if self._feed_plan_cache is None:
            tt = 0.0
            plan = []
            for a, b in self._pieces():
                tt = self.trace.time_to_deliver(b - a, start_s=tt)
                plan.append((a, b, self.latency_s + tt))
            self._feed_plan_cache = plan
        return self._feed_plan_cache

    def stage_arrival_times(self) -> list[float]:
        """Wall time each stage's last byte lands (link never idling) —
        the same floats the serving run uses for its upgrades."""
        ends = set(self._stage_ends)
        return [w for _, b, w in self._feed_plan() if b in ends]

    # -- mode 1: the Fig.-4 schedules, executed ----------------------------
    def run_timeline(self, stage_costs: Sequence[StageCost], *,
                     concurrent: bool = True) -> SessionResult:
        """Execute a progressive transfer end to end: real bytes through
        the real client, processing charged on a single simulated
        compute queue (the paper's JS main thread + WebGL).

        w/ concurrency: the link never idles. w/o: the link idles while
        the compute queue drains, so the next stage's bytes are queried
        against the trace from the moment processing finished.
        """
        if len(stage_costs) != self.n_stages:
            raise ValueError(
                f"{len(stage_costs)} costs for {self.n_stages} stages")
        client = ProgressiveClient(device=self.device)
        events: list[SessionEvent] = _EventRecorder()
        download_done: list[float] = []
        result_ready: list[float] = []
        tt = 0.0          # trace-clock time of last delivered byte
        proc_free = 0.0   # wall time the compute queue frees up
        for a, b in self._pieces():
            if not concurrent and result_ready:
                # link idles until the previous stage's result is shown
                tt = max(tt, result_ready[-1] - self.latency_s)
            tt = self.trace.time_to_deliver(b - a, start_s=tt)
            wall = self.latency_s + tt
            before = client.stages_complete
            had_header = client.header_ready
            client.feed(self.blob[a:b])
            events.append(SessionEvent(wall, "chunk",
                                       {"bytes": b - a, "through": b}))
            if not had_header and client.header_ready:
                events.append(SessionEvent(wall, "header",
                                           {"bytes": self._header_end}))
            for s in range(before + 1, client.stages_complete + 1):
                # the co-simulation audit: the real decoder must complete
                # stage s exactly at the byte the header algebra predicts
                if b != self._stage_ends[s - 1]:
                    raise AssertionError(
                        f"client completed stage {s} at byte {b}, header "
                        f"layout says {self._stage_ends[s - 1]}")
                download_done.append(wall)
                events.append(SessionEvent(
                    wall, "stage_complete",
                    {"stage": s, "through": b}))
                start = max(wall, proc_free)
                proc_free = start + stage_costs[s - 1].total
                result_ready.append(proc_free)
                events.append(SessionEvent(
                    proc_free, "result_ready",
                    {"stage": s, "process_start_s": start}))
        if client.stages_complete != self.n_stages:
            raise AssertionError(
                f"stream exhausted at stage {client.stages_complete} "
                f"of {self.n_stages}")
        events.sort(key=lambda e: (e.t_s, e.seq))
        return SessionResult(
            events=events, client=client,
            timeline=Timeline(download_done=download_done,
                              result_ready=result_ready))

    def _make_feeder(self, client, events: list) -> "Callable[[float], None]":
        """Closure feeding wire bytes to ``client`` up to a wall time,
        appending chunk/header/stage_complete events as they land."""
        plan = self._feed_plan()
        state = {"idx": 0}

        def feed_until(t_wall: float) -> None:
            while state["idx"] < len(plan) and plan[state["idx"]][2] <= t_wall:
                a, b, w = plan[state["idx"]]
                before = client.stages_complete
                had_header = client.header_ready
                client.feed(self.blob[a:b])
                events.append(SessionEvent(w, "chunk",
                                           {"bytes": b - a, "through": b}))
                if not had_header and client.header_ready:
                    events.append(SessionEvent(
                        w, "header", {"bytes": self._header_end}))
                for s in range(before + 1, client.stages_complete + 1):
                    events.append(SessionEvent(
                        w, "stage_complete", {"stage": s, "through": b}))
                state["idx"] += 1

        return feed_until

    def _make_transport(self, client, events: list,
                        faults: FaultTrace | None,
                        fault_policy: FaultPolicy | None):
        """Pick the byte-delivery engine for a serving run: the plain
        precomputed feed plan when the channel is trusted, or a
        :class:`_FaultRunner` when a fault trace / fault policy is in
        play. Returns ``(feed_until, runner_or_None)``."""
        if faults is None and fault_policy is None:
            return self._make_feeder(client, events), None
        if faults is not None and not self.layout.integrity:
            raise ValueError(
                "fault injection requires the v3 integrity wire — "
                "encode the stream with wire.encode(model, integrity=True) "
                "so corrupt units can be detected and quarantined")
        runner = _FaultRunner(self, client, events,
                              faults, fault_policy or FaultPolicy())
        return runner.feed_until, runner

    # -- mode 2: the operational serve path --------------------------------
    def run_serving(self, model, prog, *, decode_steps: int, batch: dict,
                    step_time_s: float | None = None,
                    max_len: int | None = None,
                    resident: str | None = None,
                    speculative=None, mesh=None,
                    faults: FaultTrace | None = None,
                    fault_policy: FaultPolicy | None = None) -> SessionResult:
        """Drive a real ProgressiveServer from the byte stream: the
        server sits on the client's PlaneStore (one ingest per stage,
        one batched ``plane_or_segments`` launch per container dtype)
        and decodes real tokens; the simulated decode clock ticks ``step_time_s`` per
        step, and upgrades happen between steps exactly when the trace
        delivered each stage. Tokens, upgrade steps and the event log
        are bit-deterministic for a fixed (blob, trace, seed).

        ``resident`` selects the server's weight residency (default
        ``"fp"``): ``"fp"`` re-materializes float weights per upgrade
        (the paper's client); ``"quantized"`` decodes straight from the
        client's uint accumulators (no fp weight copy, upgrades are
        metadata-only — see
        :class:`~repro_torch.serving.engine.ProgressiveServer`).

        ``speculative`` (a :class:`~repro_torch.serving.speculative.SpecConfig`
        or truthy for defaults) swaps the server for the
        self-speculative engine: a truncated-bits view of the same
        store drafts, the full view verifies, and per-round accept-rate
        events join the audit log on the byte clock. Speculation
        implies quantized residency (the draft IS a second metadata
        view over the resident accumulators), so passing ``resident``
        together with ``speculative`` is a contradiction and raises
        ``ValueError`` instead of being silently ignored.
        """
        from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
        from repro_torch.serving.speculative import SpecConfig, SpeculativeEngine

        # with a serving mesh the client's store shards over its model
        # axis (shard-local ingest) and the engine decodes through sharded
        # dispatch: token-identical to the single-device session
        client = ProgressiveClient(mesh=mesh, device=self.device)
        receiver = WireStoreReceiver(client, prog)
        if speculative:
            if resident is not None:
                raise ValueError(
                    f"resident={resident!r} conflicts with speculative "
                    f"serving: the draft is a metadata view over the "
                    f"quantized-resident accumulators, so residency is "
                    f"fixed at 'quantized' — drop the resident argument")
            spec = (speculative if isinstance(speculative, SpecConfig)
                    else SpecConfig())
            if max_len is None:
                # headroom so end-of-generation verify blocks keep full
                # k (the engine validates it and would raise otherwise)
                max_len = (batch["tokens"].shape[1] + decode_steps
                           + spec.k_max + 1)
            server = SpeculativeEngine(model, prog, max_len=max_len,
                                       receiver=receiver, spec=spec, mesh=mesh,
                                       device=self.device)
        else:
            if max_len is None:
                max_len = batch["tokens"].shape[1] + decode_steps
            server = ProgressiveServer(model, prog, max_len=max_len,
                                       receiver=receiver,
                                       resident=resident or "fp",
                                       mesh=mesh, device=self.device)
        events: list[SessionEvent] = _EventRecorder()
        arrivals = self.stage_arrival_times()
        feed_until, runner = self._make_transport(client, events,
                                                  faults, fault_policy)

        # cold start: serve as soon as stage 1 is in. On a faulty
        # channel stage 1 lands whenever its units verify, not at the
        # clean-trace arrival time — ask the runner.
        if runner is not None:
            t_cold = runner.run_until_stage(1)
        else:
            t_cold = arrivals[0]
            feed_until(t_cold)
        if client.stages_complete < 1:
            raise AssertionError("stage 1 not complete at its arrival time")
        server.receive_stage()
        server.start(batch)
        events.append(SessionEvent(
            t_cold, "cold_start",
            {"stage": server.stage, "prompt_len": int(batch["tokens"].shape[1])}))

        if step_time_s is None:
            # fixed decode cadence spanning the rest of the download
            step_time_s = max((arrivals[-1] - t_cold) / max(decode_steps, 1),
                              1e-6)

        def step_wall(i: int) -> float:
            return t_cold + (i + 1) * step_time_s

        def stage_arrival(i: int) -> bool:
            feed_until(step_wall(i))
            return receiver.stages_complete > server.stage

        if speculative:
            def on_round(rec: dict) -> None:
                # stamp the round where its last emitted token lands on
                # the byte clock; min() because slots emit raggedly
                t = step_wall(max(min(rec["emitted"]) - 1, 0))
                events.append(SessionEvent(t, "accept_round", {
                    "round": rec["round"], "k": rec["k"],
                    "accepted": rec["accepted"], "rate": rec["rate"],
                    "stage": rec["stage"],
                    "effective_bits": {
                        "draft": min(server.current_draft_bits(),
                                     server.received_bits_now()),
                        "target": server.received_bits_now()}}))

            res = server.decode(decode_steps, stage_arrival=stage_arrival,
                                on_round=on_round)
        else:
            res = server.decode(decode_steps, stage_arrival=stage_arrival)
        for i, stage in enumerate(res.stage_at_step):
            events.append(SessionEvent(
                step_wall(i), "decode_step", {"step": i, "stage": stage}))
        for step, stage in res.upgrades:
            events.append(SessionEvent(
                step_wall(step), "upgrade", {"step": step, "stage": stage}))
        transport = None
        if runner is not None:
            # converge the transport: every quarantined unit repaired,
            # every stage verified — the acceptance bar is that the
            # final store is bit-identical to a clean stream's
            runner.pump_all()
            transport = runner.summary()
            events.append(SessionEvent(
                runner.wall(), "transport_summary", transport))
        events.sort(key=lambda e: (e.t_s, e.seq))
        return SessionResult(
            events=events, client=client, server=server,
            tokens=res.tokens, upgrades=res.upgrades,
            stage_at_step=res.stage_at_step, transport=transport)

    # -- mode 3: continuous batching under a flash crowd -------------------
    def run_serving_pool(self, model, prog, *, prompts: Sequence,
                         arrival_offsets_s: Sequence[float] | None = None,
                         max_new_tokens: int = 8,
                         n_slots: int = 4,
                         max_len: int | None = None,
                         resident: str | None = None,
                         step_time_s: float | None = None,
                         dispatch_window: int = 4,
                         chunked_prefill: bool | None = None,
                         speculative=None, mesh=None,
                         faults: FaultTrace | None = None,
                         fault_policy: FaultPolicy | None = None,
                         ) -> SessionResult:
        """Flash-crowd serving: N requests join mid-download over ONE
        shared byte stream, and a :class:`~repro_torch.serving.engine.
        SlotPoolEngine` serves them all from the client's PlaneStore —
        staggered admissions into free slots, evictions on completion,
        precision upgrades between batched windows.

        ``prompts[i]`` becomes admissible ``arrival_offsets_s[i]``
        seconds after the cold start (default: all at cold start). The
        simulated decode clock ticks ``step_time_s`` per batched step;
        idle rounds (pool empty, crowd not yet arrived) advance the
        clock without dispatching. Deterministic for a fixed
        (blob, trace, prompts, offsets).

        ``chunked_prefill`` is forwarded to the engine (None = auto:
        on for every arch without cross-attention): admissions stream
        prompt KV into pooled cache rows in ``prefill_chunk``-token
        blocks interleaved with decode steps, instead of a batch-1
        prefill + cache copy per admit.

        ``speculative`` (a SpecConfig or truthy) swaps the engine for
        :class:`~repro_torch.serving.speculative.SpeculativeSlotPool`: every
        pool 'step' becomes a draft+verify round, acceptance records
        join the audit log at flush boundaries, and passing
        ``resident`` alongside raises ``ValueError`` (speculation
        implies quantized residency).

        Note: this drives the engine step/flush primitives directly
        rather than ``SlotPoolEngine.run`` because admissions and byte
        feeding are gated on the *simulated wall clock*, which only
        this session knows — keep the two loops' flush/evict
        bookkeeping in sync when changing either."""
        from repro_torch.serving.engine import (PoolRequest, SlotPoolEngine,
                                                WireStoreReceiver)

        n_req = len(prompts)
        if arrival_offsets_s is None:
            arrival_offsets_s = [0.0] * n_req
        if len(arrival_offsets_s) != n_req:
            raise ValueError("one arrival offset per prompt")

        client = ProgressiveClient(mesh=mesh, device=self.device)
        receiver = WireStoreReceiver(client, prog)
        if speculative:
            from repro_torch.serving.speculative import (SpecConfig,
                                                         SpeculativeSlotPool)

            if resident is not None:
                raise ValueError(
                    f"resident={resident!r} conflicts with speculative "
                    f"serving: the draft is a metadata view over the "
                    f"quantized-resident accumulators, so residency is "
                    f"fixed at 'quantized' — drop the resident argument")
            spec = (speculative if isinstance(speculative, SpecConfig)
                    else SpecConfig())
            if max_len is None:
                # headroom so end-of-budget verify blocks keep full k
                # (submit validates it per request and raises otherwise)
                max_len = (max(len(p) for p in prompts) + max_new_tokens
                           + spec.k_max + 1)
            engine = SpeculativeSlotPool(model, prog, n_slots=n_slots,
                                         max_len=max_len, receiver=receiver,
                                         spec=spec,
                                         dispatch_window=dispatch_window,
                                         chunked_prefill=chunked_prefill,
                                         mesh=mesh, device=self.device)
        else:
            if max_len is None:
                max_len = max(len(p) for p in prompts) + max_new_tokens
            engine = SlotPoolEngine(model, prog, n_slots=n_slots,
                                    max_len=max_len, receiver=receiver,
                                    resident=resident or "fp",
                                    dispatch_window=dispatch_window,
                                    chunked_prefill=chunked_prefill,
                                    mesh=mesh, device=self.device)
        events: list[SessionEvent] = _EventRecorder()
        arrivals = self.stage_arrival_times()
        feed_until, runner = self._make_transport(client, events,
                                                  faults, fault_policy)

        if runner is not None:
            t_cold = runner.run_until_stage(1)
        else:
            t_cold = arrivals[0]
            feed_until(t_cold)
        if client.stages_complete < 1:
            raise AssertionError("stage 1 not complete at its arrival time")
        engine.receive_stage()
        events.append(SessionEvent(
            t_cold, "cold_start",
            {"stage": engine.stage, "n_slots": n_slots, "clients": n_req}))

        total_budget = n_req * max_new_tokens
        if step_time_s is None:
            step_time_s = max(
                (arrivals[-1] - t_cold) / max(total_budget, 1), 1e-6)

        order = sorted(range(n_req), key=lambda i: (arrival_offsets_s[i], i))
        next_req = 0
        admissions: list[tuple[float, int]] = []  # actual slot admissions
        seen_admits = 0
        rounds = 0
        # every request decodes max_new_tokens steps; idle rounds are
        # bounded by the crowd span, so this cap is never the exit path
        max_rounds = total_budget + n_req + int(
            max(arrival_offsets_s) / step_time_s) + 8
        if engine.chunked_prefill:
            # chunked admission consumes prompts one block per round;
            # worst case (no decode overlap) that adds a round per chunk
            c = engine.prefill_chunk
            max_rounds += sum((len(p) + c - 1) // c for p in prompts)

        def wall() -> float:
            return t_cold + (rounds + 1) * step_time_s

        def admit_due(t: float) -> None:
            nonlocal next_req
            while next_req < n_req and \
                    t_cold + arrival_offsets_s[order[next_req]] <= t:
                rid = order[next_req]
                engine.submit(PoolRequest(
                    rid=rid, prompt=prompts[rid],
                    max_new_tokens=max_new_tokens))
                events.append(SessionEvent(t, "submit", {"rid": rid}))
                next_req += 1

        def log_admissions(t: float) -> None:
            # the 'admit' event stamps when a request actually took a
            # slot (engine._admit), not when it was submitted — a full
            # pool queues submissions until an eviction frees a slot
            nonlocal seen_admits
            for rid in engine.admitted_order[seen_admits:]:
                admissions.append((t, rid))
                events.append(SessionEvent(t, "admit", {"rid": rid}))
            seen_admits = len(engine.admitted_order)

        admit_due(t_cold)
        log_admissions(t_cold)
        evicted_logged: set[int] = set()
        accepts_logged = 0

        def log_evictions(t: float) -> None:
            for rid in sorted(engine.completed - evicted_logged):
                events.append(SessionEvent(t, "evict", {"rid": rid}))
                evicted_logged.add(rid)

        def log_accepts(t: float) -> None:
            # speculative pool: per-round acceptance records become
            # host-visible at flush; stamp them on the byte clock
            nonlocal accepts_logged
            if not speculative:
                return
            for rec in engine.accept_log[accepts_logged:]:
                events.append(SessionEvent(t, "accept_round", dict(rec)))
            accepts_logged = len(engine.accept_log)

        while (next_req < n_req or engine.queue or
               any(not s.free for s in engine.slots)):
            if rounds >= max_rounds:
                raise AssertionError("slot-pool run did not converge")
            t = wall()
            feed_until(t)
            if engine.upgrade_if_available():
                events.append(SessionEvent(
                    t, "upgrade",
                    {"step": engine._step_count, "stage": engine.stage}))
            admit_due(t)
            log_admissions(t)
            if any(not s.free for s in engine.slots):
                snapshot = engine.step()
                if len(engine._pending) >= dispatch_window:
                    stats = engine.flush()
                    events.append(SessionEvent(
                        t, "pool_window",
                        {"steps": stats.steps,
                         "tokens": stats.tokens_emitted,
                         "active": len(snapshot),
                         "stage": engine.stage}))
                    log_accepts(t)
                    engine._admit_from_queue()
                    log_admissions(t)
                    log_evictions(t)
                rounds += 1
            elif engine.queue:
                # every active slot budget-evicted mid-window: flush the
                # in-flight tail so the queue can take the freed slots
                stats = engine.flush()
                if stats is not None:
                    events.append(SessionEvent(
                        t, "pool_window",
                        {"steps": stats.steps,
                         "tokens": stats.tokens_emitted,
                         "active": 0, "stage": engine.stage}))
                log_accepts(t)
                engine._admit_from_queue()
                log_admissions(t)
                log_evictions(t)
                rounds += 1
            else:
                # idle pool, crowd still to come (queue empty + no active
                # slot implies next_req < n_req by the loop condition):
                # fast-forward the clock to the next arrival instead of
                # spinning one round per step_time_s tick (a fast link
                # makes that microscopic)
                nxt = t_cold + arrival_offsets_s[order[next_req]]
                skip = int((nxt - t_cold) / step_time_s) - 1
                rounds = max(rounds + 1, min(skip, max_rounds - 1))
        stats = engine.flush()
        t_end = wall()
        if stats is not None:
            events.append(SessionEvent(
                t_end, "pool_window",
                {"steps": stats.steps, "tokens": stats.tokens_emitted,
                 "active": 0, "stage": engine.stage}))
        log_accepts(t_end)
        log_evictions(t_end)
        transport = None
        if runner is not None:
            runner.pump_all()
            transport = runner.summary()
            events.append(SessionEvent(
                runner.wall(), "transport_summary", transport))
        events.sort(key=lambda e: (e.t_s, e.seq))
        return SessionResult(
            events=events, client=client, server=engine,
            tokens={rid: list(v) for rid, v in engine.outputs.items()},
            upgrades=list(engine.upgrades),
            admissions=admissions, transport=transport)


class _FaultRunner:
    """Stateful byte-delivery engine for a faulty channel.

    Couples three clocks/queues deterministically:

    * the stream queue — undelivered ``(a, b)`` wire ranges on the
      chunk grid (rebuilt from the client's resume cursor after a
      disconnect or desync);
    * the repair queue — quarantined units awaiting re-request, each
      with its own attempt counter and backoff-derived ready time;
    * the trace clock ``clock`` (plus ``lat``, the accumulated
      per-connection latency) — every delivery advances it via
      ``time_to_deliver`` so all fault/retry/repair events land on the
      byte clock and the whole run is replayable from
      (blob, trace, faults, policy).

    Recovery routing: isolated CRC failures -> per-unit NACK/repair;
    two consecutive stream-unit failures, any disconnect, or a dead
    header -> reconnect and replay from the client's cursor; a
    delivery exceeding ``chunk_timeout_s`` -> abandon + backoff +
    retry. Any target exceeding ``max_retries`` raises
    :class:`TransportError`.
    """

    DESYNC_AFTER = 2  # consecutive stream-unit failures -> assume desync

    def __init__(self, session: "Session", client: ProgressiveClient,
                 events: list, faults: FaultTrace | None,
                 policy: FaultPolicy):
        self.session = session
        self.client = client
        self.events = events
        self.policy = policy
        self.injector = faults.start() if faults is not None else None
        self.rng = np.random.default_rng(policy.seed)
        self.queue: list[tuple[int, int]] = list(session._pieces())
        self.clock = 0.0            # trace-clock time of last delivery
        self.lat = session.latency_s
        self.not_before = 0.0       # trace-clock floor (backoff idles)
        self.repairs: list[dict] = []
        self.known_nacks: set[int] = set()
        self.stream_attempt = 0
        self.reconnects = 0
        self.repaired_units = 0
        self.consec_stream_nacks = 0
        self.done = False
        self._last_verified = 0
        # unit seq -> absolute (a, b) wire range, for re-requests
        if session.layout.integrity:
            offs = session.layout.unit_offsets()
            sizes = [e[2] for st in session.layout.stages for e in st]
            self._unit_ranges = [(o, o + n) for o, n in zip(offs, sizes)]
        else:
            self._unit_ranges = []

    # -- clocks ------------------------------------------------------------
    def wall(self) -> float:
        return self.lat + self.clock

    def _log(self, t: float, kind: str, data: dict) -> None:
        self.events.append(SessionEvent(t, kind, data))

    # -- candidate selection -------------------------------------------------
    def _next_repair(self) -> dict | None:
        if not self.repairs:
            return None
        return min(self.repairs, key=lambda r: (r["ready_wall"], r["seq"]))

    def _peek(self):
        """Earliest deliverable item: ('repair'|'stream', item,
        start_trace, end_trace). Repairs win ties — the server is
        stalled at the last verified stage until they land."""
        trace = self.session.trace
        cands = []
        r = self._next_repair()
        if r is not None:
            a, b = self._unit_ranges[r["seq"]]
            start = max(self.clock, self.not_before,
                        r["ready_wall"] - self.lat)
            end = trace.time_to_deliver(b - a, start_s=start)
            cands.append((end, 0, "repair", r, start))
        if self.queue:
            a, b = self.queue[0]
            start = max(self.clock, self.not_before)
            end = trace.time_to_deliver(b - a, start_s=start)
            cands.append((end, 1, "stream", (a, b), start))
        if not cands:
            return None
        end, _, kind, item, start = min(cands)
        return kind, item, start, end

    def next_wall(self) -> float | None:
        """Wall time of the next event (delivery or timeout), without
        committing it."""
        got = self._peek()
        if got is None:
            if self.done or self._reconcile_end_of_stream(dry=True):
                return None
            return self.wall()  # recovery bookkeeping is due now
        _, _, start, end = got
        if end - start > self.policy.chunk_timeout_s:
            return self.lat + start + self.policy.chunk_timeout_s
        return self.lat + end

    # -- the delivery loops --------------------------------------------------
    def feed_until(self, t_wall: float) -> None:
        while True:
            nxt = self.next_wall()
            if nxt is None or nxt > t_wall:
                return
            self.step()

    def pump_all(self) -> None:
        """Drive the transport to completion (or TransportError)."""
        cap = 20_000 + len(self._unit_ranges) * (self.policy.max_retries + 2) * 4
        n = 0
        while self.step():
            n += 1
            if n > cap:
                raise AssertionError(
                    "fault transport did not converge (internal bug: "
                    f"{n} steps, cursor {self.client.resume_cursor})")

    def run_until_stage(self, k: int) -> float:
        while self.client.stages_complete < k:
            if not self.step():
                raise AssertionError(
                    f"stream ended at stage {self.client.stages_complete} "
                    f"before reaching stage {k}")
        return self.wall()

    def step(self) -> bool:
        """Perform the next transport event. Returns False when the
        stream is fully delivered and every quarantined unit repaired."""
        if self.done:
            return False
        got = self._peek()
        if got is None:
            if self._reconcile_end_of_stream(dry=False):
                self.done = True
                return False
            return True  # recovery scheduled new work
        kind, item, start, end = got
        if end - start > self.policy.chunk_timeout_s:
            self._on_timeout(kind, item, start)
            return True
        if kind == "repair":
            self._do_repair(item, end)
        else:
            self._do_stream(item, end)
        return True

    # -- timeout / reconnect --------------------------------------------------
    def _on_timeout(self, kind: str, item, start: float) -> None:
        p = self.policy
        self.clock = start + p.chunk_timeout_s
        if kind == "repair":
            item["attempt"] += 1
            attempt, target = item["attempt"], f"unit:{item['seq']}"
            if attempt > p.max_retries:
                raise TransportError(
                    f"unit {item['seq']} timed out after {p.max_retries} "
                    f"retries ({p.chunk_timeout_s}s each)")
            back = p.backoff_s(attempt, self.rng)
            item["ready_wall"] = self.wall() + back + self.session.latency_s
        else:
            self.stream_attempt += 1
            attempt, target = self.stream_attempt, "stream"
            if attempt > p.max_retries:
                raise TransportError(
                    f"stream chunk {item} timed out after {p.max_retries} "
                    f"retries ({p.chunk_timeout_s}s each)")
            back = p.backoff_s(attempt, self.rng)
            self.not_before = self.clock + back
            self.lat += self.session.latency_s  # new connection
            self.reconnects += 1
        self._log(self.wall(), "fault",
                  {"fault": "timeout", "target": target,
                   "waited_s": p.chunk_timeout_s})
        self._log(self.wall(), "retry",
                  {"target": target, "attempt": attempt,
                   "backoff_s": round(back, 6)})

    def _reconnect_from_cursor(self, reason: str, *, resync: bool) -> None:
        """Drop the dead connection and replay the stream from the
        client's durable cursor. ``resync=True`` additionally rewinds
        the client to its first unverified unit (desync recovery) and
        cancels scheduled repairs the replay will cover."""
        if resync:
            seq, off = self.client.rewind_to_gap()
            self.repairs = [r for r in self.repairs if r["seq"] < seq]
            self.known_nacks = {s for s in self.known_nacks if s < seq}
        else:
            self.client.drop_unconsumed()
            seq, off = self.client.resume_cursor
        self.stream_attempt += 1
        if self.stream_attempt > self.policy.max_retries:
            raise TransportError(
                f"stream recovery ({reason}) exhausted "
                f"{self.policy.max_retries} retries at cursor "
                f"({seq}, {off})")
        back = self.policy.backoff_s(self.stream_attempt, self.rng)
        self.not_before = self.clock + back
        self.lat += self.session.latency_s
        self.reconnects += 1
        total = len(self.session.blob)
        self.queue = [(max(a, off), b)
                      for a, b in self.session._pieces()
                      if b > off] if off < total else []
        self.consec_stream_nacks = 0
        self._log(self.wall(), "reconnect",
                  {"reason": reason, "cursor": [seq, off],
                   "attempt": self.stream_attempt,
                   "backoff_s": round(back, 6)})
        self._log(self.wall(), "resume", {"offset": off, "unit_seq": seq})

    # -- deliveries ------------------------------------------------------------
    def _feed(self, data: bytes, through: int, t: float) -> None:
        client = self.client
        before = client.stages_complete
        had_header = client.header_ready
        client.feed(data)
        self._log(t, "chunk", {"bytes": len(data), "through": through})
        if not had_header and client.header_ready:
            self._log(t, "header", {"bytes": self.session._header_end})
        for s in range(before + 1, client.stages_complete + 1):
            self._log(t, "stage_complete", {"stage": s, "through": through})

    def _do_stream(self, piece: tuple[int, int], end: float) -> None:
        a, b = piece
        data = self.session.blob[a:b]
        if self.injector is not None:
            d = self.injector.deliver(data)
        else:
            from repro_torch.transmission.simulator import ChunkDelivery
            d = ChunkDelivery(data=data)
        if d.reorder and len(self.queue) > 1:
            self.queue[0], self.queue[1] = self.queue[1], self.queue[0]
            self._log(self.wall(), "fault",
                      {"fault": "reorder", "chunk": [a, b]})
            return
        self.clock = end
        if d.kind is not None and not d.reorder:
            detail = dict(d.detail or {})
            # NB "fault", not "kind": the payload is flattened next to
            # the envelope in to_jsonl, so a payload "kind" would
            # silently overwrite the event kind in the exported log
            detail.update({"fault": d.kind, "chunk": [a, b]})
            self._log(self.wall(), "fault", detail)
        self._feed(d.data, b, self.wall())
        self.queue.pop(0)
        if d.duplicate:
            self.clock = self.session.trace.time_to_deliver(
                len(d.data), start_s=self.clock)
            self._feed(d.data, b, self.wall())
        self._after_feed(disconnected=d.disconnect)

    def _do_repair(self, r: dict, end: float) -> None:
        seq = r["seq"]
        a, b = self._unit_ranges[seq]
        data = self.session.blob[a:b]
        if self.injector is not None:
            d = self.injector.deliver(data)
            data = d.data
            if d.kind is not None:
                self._log(self.lat + end, "fault",
                          {"fault": d.kind, "target": f"unit:{seq}"})
        self.clock = end
        before = self.client.stages_complete
        ok = self.client.feed_repair(seq, data)
        t = self.wall()
        self._log(t, "repair", {"unit": seq, "attempt": r["attempt"],
                                "ok": bool(ok)})
        for s in range(before + 1, self.client.stages_complete + 1):
            self._log(t, "stage_complete", {"stage": s, "repair": seq})
        if ok:
            self.repairs.remove(r)
            self.repaired_units += 1
        else:
            r["attempt"] += 1
            if r["attempt"] > self.policy.max_retries:
                raise TransportError(
                    f"unit {seq} still corrupt after "
                    f"{self.policy.max_retries} repair attempts: "
                    f"{self.client.nacks.get(seq, 'unknown reason')}")
            back = self.policy.backoff_s(r["attempt"], self.rng)
            r["ready_wall"] = t + back + self.session.latency_s
            self._log(t, "retry", {"target": f"unit:{seq}",
                                   "attempt": r["attempt"],
                                   "backoff_s": round(back, 6)})

    # -- post-delivery bookkeeping ----------------------------------------------
    def _after_feed(self, *, disconnected: bool) -> None:
        client, t = self.client, self.wall()
        if client.header_failed:
            self._log(t, "quarantine",
                      {"target": "header",
                       "reason": client.quarantine_log[-1]["reason"]})
            self._reconnect_from_cursor("header_corrupt", resync=False)
            return
        new_nacks = [(s, r) for s, r in sorted(client.nacks.items())
                     if s not in self.known_nacks]
        for seq, reason in new_nacks:
            self.known_nacks.add(seq)
            # payload field is "unit" (not "seq"): to_jsonl flattens the
            # payload next to the envelope, where "seq" is the event
            # sequence number
            self._log(t, "quarantine", {"unit": seq, "reason": reason})
        if client.verified_units > self._last_verified:
            self._last_verified = client.verified_units
            self.consec_stream_nacks = 0
            self.stream_attempt = 0
        self.consec_stream_nacks += len(new_nacks)
        if disconnected:
            self._log(t, "fault", {"fault": "disconnect",
                                   "cursor": list(client.resume_cursor)})
            self._reconnect_from_cursor("disconnect", resync=False)
            return
        if (self.consec_stream_nacks >= self.DESYNC_AFTER
                and not client.complete):
            self._log(t, "fault",
                      {"fault": "desync",
                       "consecutive_failures": self.consec_stream_nacks})
            self._reconnect_from_cursor("desync", resync=True)
            return
        for seq, _ in new_nacks:
            back = self.policy.backoff_s(0, self.rng)
            self.repairs.append({
                "seq": seq, "attempt": 0,
                "ready_wall": t + back + self.session.latency_s})
            self._log(t, "nack", {"unit": seq,
                                  "rerequest_backoff_s": round(back, 6)})

    # -- end-of-stream reconciliation ---------------------------------------------
    def _reconcile_end_of_stream(self, *, dry: bool) -> bool:
        """Called when both queues are empty. True -> fully delivered;
        False -> scheduled recovery work (never in ``dry`` mode)."""
        client = self.client
        if client.complete:
            return True
        if dry:
            return False
        if not client.header_ready:
            # header truncated or its length field corrupted: the only
            # cure is a fresh stream from byte 0
            client._buf.clear()
            client._cursor = 0
            self._reconnect_from_cursor("header_incomplete", resync=False)
            return False
        if client.integrity:
            seq, off = client.resume_cursor
            if off < len(self.session.blob) or client.nacks:
                self._reconnect_from_cursor("tail_missing", resync=True)
                return False
        raise AssertionError(
            "stream exhausted but client incomplete at stage "
            f"{client.stages_complete} (no recovery path — is the blob "
            "truncated at the source?)")

    def summary(self) -> dict:
        inj = self.injector
        return {
            "injected": dict(inj.counts) if inj else {},
            "deliveries": inj.deliveries if inj else 0,
            "quarantined": len(self.client.quarantine_log),
            "repaired_units": self.repaired_units,
            "duplicate_units": self.client.duplicate_units,
            "reconnects": self.reconnects,
            "pending_nacks": len(self.client.nacks),
            "verified_units": self.client.verified_units,
            "framing_overhead": (
                wire.framing_overhead(self.session.meta)
                if self.session.layout.integrity else None),
        }
