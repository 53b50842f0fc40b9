"""Discrete-event bandwidth simulation: constant links and trace-driven
bandwidth profiles.

Models the byte stream of a progressive model crossing a link (the paper
uses 0.1–2.5 MB/s browser links; a TPU-pod cold-start sees
checkpoint-store->pod links; a phone on a drive test sees LTE handoffs
and tunnel outages). Deterministic: time is *derived*, never measured —
:class:`BandwidthTrace` exposes the exact inverse pair

    ``bytes_available(at_s)``   cumulative bytes delivered by time t
    ``time_to_deliver(nbytes)`` earliest t at which nbytes have landed

so every milestone in the scheduler algebra and the co-simulation
:mod:`~repro_torch.transmission.session` harness is a closed-form query, and
tests can assert equality to 1e-9 s on any machine.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Link:
    """A constant-rate link with optional per-request latency."""

    bandwidth_bytes_per_s: float
    latency_s: float = 0.0

    def transfer_time(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bytes_per_s

    def trace(self) -> "BandwidthTrace":
        return BandwidthTrace.constant(self.bandwidth_bytes_per_s)


class BandwidthTrace:
    """A piecewise-constant bandwidth profile over absolute time.

    ``segments`` is ``[(duration_s, bytes_per_s), ...]``; the last
    segment's rate is held forever past the end of the trace, so a
    finite trace always defines delivery for an arbitrarily large
    payload (unless it ends in a zero-rate tail, in which case
    ``time_to_deliver`` raises once the deliverable bytes run out).
    Rates may be zero (stalls/outages); durations must be positive and
    finite.
    """

    def __init__(self, segments: Sequence[tuple[float, float]], *, name: str = ""):
        segs = [(float(d), float(r)) for d, r in segments]
        for d, r in segs:
            if not (d > 0.0) or not np.isfinite(d):
                raise ValueError(f"segment duration must be positive/finite, got {d}")
            if r < 0.0 or not np.isfinite(r):
                raise ValueError(f"segment rate must be >= 0 and finite, got {r}")
        if not segs:
            raise ValueError("trace needs at least one segment")
        self.name = name
        self._durations = tuple(d for d, _ in segs)
        self._rates = tuple(r for _, r in segs)
        # segment start times / cumulative bytes at segment starts
        starts, cum = [0.0], [0.0]
        for d, r in segs:
            starts.append(starts[-1] + d)
            cum.append(cum[-1] + d * r)
        self._starts = tuple(starts)   # len n+1; [-1] == trace end
        self._cum = tuple(cum)         # len n+1; [-1] == bytes at trace end

    # -- introspection -----------------------------------------------------
    @property
    def segments(self) -> tuple[tuple[float, float], ...]:
        return tuple(zip(self._durations, self._rates))

    @property
    def duration_s(self) -> float:
        """End of the explicit trace (the final rate is held after it)."""
        return self._starts[-1]

    def rate_at(self, at_s: float) -> float:
        if at_s < 0:
            return 0.0
        for i, start in enumerate(self._starts[:-1]):
            if at_s < self._starts[i + 1]:
                return self._rates[i]
        return self._rates[-1]

    def __repr__(self) -> str:
        label = f" {self.name!r}" if self.name else ""
        return (f"BandwidthTrace({len(self._rates)} segments,"
                f" {self.duration_s:.3g}s{label})")

    # -- the exact query pair ----------------------------------------------
    def bytes_available(self, at_s: float) -> float:
        """Cumulative bytes delivered on [0, at_s] (float — the byte
        clock is continuous; callers quantize where they must)."""
        if at_s <= 0.0:
            return 0.0
        for i in range(len(self._rates)):
            if at_s < self._starts[i + 1]:
                return self._cum[i] + self._rates[i] * (at_s - self._starts[i])
        return self._cum[-1] + self._rates[-1] * (at_s - self._starts[-1])

    def time_to_deliver(self, nbytes: float, start_s: float = 0.0) -> float:
        """Earliest t >= start_s such that ``nbytes`` have been delivered
        on (start_s, t]. Exact inverse of :meth:`bytes_available`:
        ``time_to_deliver(bytes_available(t))`` lands on t's byte
        position, not one event later. A zero-byte payload takes zero
        time; delivery that must cross a stall jumps to the stall's end;
        if the trace ends in a zero-rate tail with bytes still owed,
        raises ``ValueError``.
        """
        if nbytes <= 0.0:
            return max(start_s, 0.0)
        target = self.bytes_available(start_s) + float(nbytes)
        for i in range(len(self._rates)):
            if self._cum[i + 1] >= target and self._rates[i] > 0.0:
                t = self._starts[i] + (target - self._cum[i]) / self._rates[i]
                return max(t, start_s)
        if self._rates[-1] > 0.0:
            t = (self._starts[-1]
                 + (target - self._cum[-1]) / self._rates[-1])
            return max(t, start_s)
        raise ValueError(
            f"trace {self.name or '<anon>'} ends in a zero-rate tail after "
            f"{self._cum[-1]:.0f} bytes; cannot deliver {nbytes:.0f} more")

    # -- constructors ------------------------------------------------------
    @classmethod
    def constant(cls, bytes_per_s: float, *, name: str = "") -> "BandwidthTrace":
        return cls([(1.0, bytes_per_s)], name=name or f"const-{bytes_per_s:g}")

    @classmethod
    def steps(cls, segments: Sequence[tuple[float, float]], *,
              name: str = "") -> "BandwidthTrace":
        return cls(segments, name=name)

    @classmethod
    def ramp(cls, from_bps: float, to_bps: float, duration_s: float, *,
             steps: int = 8, name: str = "") -> "BandwidthTrace":
        """Linear ramp approximated by ``steps`` piecewise-constant
        segments (rate sampled at each sub-interval's midpoint)."""
        if steps < 1:
            raise ValueError("ramp needs >= 1 step")
        d = duration_s / steps
        mids = (np.arange(steps) + 0.5) / steps
        rates = from_bps + (to_bps - from_bps) * mids
        return cls([(d, float(r)) for r in rates], name=name)

    @classmethod
    def jittered(cls, mean_bytes_per_s: float, jitter_frac: float, *,
                 seed: int, interval_s: float = 0.5, n_intervals: int = 128,
                 name: str = "") -> "BandwidthTrace":
        """Seeded multiplicative jitter around a mean rate: each interval
        draws rate = mean * (1 + U(-jitter, +jitter)). Deterministic in
        ``seed`` — the same seed yields the same trace on any machine."""
        if not (0.0 <= jitter_frac < 1.0):
            raise ValueError("jitter_frac must be in [0, 1)")
        rng = np.random.default_rng(seed)
        rates = mean_bytes_per_s * (
            1.0 + jitter_frac * (2.0 * rng.random(n_intervals) - 1.0))
        return cls([(interval_s, float(r)) for r in rates],
                   name=name or f"jitter-{mean_bytes_per_s:g}@{seed}")

    @classmethod
    def from_csv(cls, path: Union[str, Path], *, name: str = "") -> "BandwidthTrace":
        """Load a mobile-style trace CSV: rows ``time_s,bytes_per_s``
        (``#`` comments and a header row are skipped). Each row's rate
        applies from its timestamp until the next row; the last rate is
        held. Timestamps must start at 0 and strictly increase."""
        path = Path(path)
        rows: list[tuple[float, float]] = []
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 2:
                raise ValueError(f"{path}:{lineno}: expected 2 columns, got {len(parts)}")
            try:
                rows.append((float(parts[0]), float(parts[1])))
            except ValueError:
                if rows:
                    raise ValueError(f"{path}:{lineno}: non-numeric row {line!r}")
                continue  # header row
        if len(rows) < 2:
            raise ValueError(f"{path}: need >= 2 data rows")
        if rows[0][0] != 0.0:
            raise ValueError(f"{path}: trace must start at time 0, got {rows[0][0]}")
        segs = []
        for (t0, r), (t1, _) in zip(rows, rows[1:]):
            if t1 <= t0:
                raise ValueError(f"{path}: timestamps must strictly increase at t={t1}")
            segs.append((t1 - t0, r))
        # last row's rate held forever: represent as a 1s segment
        segs.append((1.0, rows[-1][1]))
        return cls(segs, name=name or path.stem)

    # -- transforms --------------------------------------------------------
    def with_outage(self, start_s: float, duration_s: float) -> "BandwidthTrace":
        """Overlay a zero-rate window on [start_s, start_s+duration_s):
        the channel is dead during the window; the original profile
        resumes (in absolute time) after it.

        Edge cases are pinned (tests/test_simulator.py): a window
        boundary landing exactly on a segment (or delivery-chunk)
        boundary produces no zero-length segments and delivery that
        *ends* exactly at ``start_s`` is unaffected; overlapping
        windows compose to their union (re-zeroing a dead region is a
        no-op); ``duration_s <= 0`` returns self; a negative
        ``start_s`` clamps to 0 (the window's tail still applies)."""
        if duration_s <= 0:
            return self
        end_s = start_s + duration_s
        start_s = max(start_s, 0.0)
        if end_s <= start_s:
            return self
        # ensure explicit coverage past the window (tail rate is held)
        segs = list(zip(self._durations, self._rates))
        if self.duration_s < end_s + 1.0:
            segs.append((end_s + 1.0 - self.duration_s, self._rates[-1]))
        out: list[tuple[float, float]] = []
        t = 0.0
        for d, r in segs:
            a, b = t, t + d
            for lo, hi, rate in ((a, min(b, start_s), r),
                                 (max(a, start_s), min(b, end_s), 0.0),
                                 (max(a, end_s), b, r)):
                if hi > lo:
                    out.append((hi - lo, rate))
            t = b
        return BandwidthTrace(
            out, name=f"{self.name}+outage[{start_s:g},{end_s:g})"
            if self.name else "")

    def scaled(self, factor: float) -> "BandwidthTrace":
        return BandwidthTrace(
            [(d, r * factor) for d, r in zip(self._durations, self._rates)],
            name=self.name)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

FAULT_KINDS = ("corrupt", "truncate", "duplicate", "reorder", "disconnect")


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Seeded channel-fault profile, composable with a
    :class:`BandwidthTrace`: the bandwidth trace says *when* bytes
    land, the fault trace says *what happens to them* on the way. The
    session transport applies it per delivered chunk.

    At most one fault fires per delivery, drawn from one uniform
    against the cumulative probabilities (so the kinds must sum to
    <= 1):

    * ``corrupt``     — ``flips_per_corruption`` seeded bit flips
    * ``truncate``    — the chunk's tail is silently dropped
    * ``duplicate``   — the chunk lands twice
    * ``reorder``     — the chunk swaps places with its successor
    * ``disconnect``  — the connection dies mid-chunk (a seeded prefix
      lands, the rest is lost; the transport must reconnect and resume
      from the client's cursor)

    Deterministic: an injector (:meth:`start`) consumes one RNG stream
    in delivery order, so a fixed (seed, probabilities, delivery
    sequence) reproduces the same faults on any machine. Retransmitted
    bytes pass through the injector again — repairs can themselves be
    faulted.
    """

    seed: int = 0
    p_corrupt: float = 0.0
    p_truncate: float = 0.0
    p_duplicate: float = 0.0
    p_reorder: float = 0.0
    p_disconnect: float = 0.0
    flips_per_corruption: int = 1

    def __post_init__(self):
        ps = (self.p_corrupt, self.p_truncate, self.p_duplicate,
              self.p_reorder, self.p_disconnect)
        if any(p < 0 for p in ps) or sum(ps) > 1.0 + 1e-12:
            raise ValueError(
                f"fault probabilities must be >= 0 and sum to <= 1, "
                f"got {ps}")
        if self.flips_per_corruption < 1:
            raise ValueError("flips_per_corruption must be >= 1")

    @property
    def total_p(self) -> float:
        return (self.p_corrupt + self.p_truncate + self.p_duplicate
                + self.p_reorder + self.p_disconnect)

    def start(self) -> "FaultInjector":
        """Fresh stateful injector (one per transport run)."""
        return FaultInjector(self)

    def __repr__(self) -> str:
        on = {k: getattr(self, f"p_{k}") for k in FAULT_KINDS
              if getattr(self, f"p_{k}") > 0}
        return f"FaultTrace(seed={self.seed}, {on or 'clean'})"


@dataclasses.dataclass
class ChunkDelivery:
    """What one chunk delivery looks like after the channel is done
    with it."""

    data: bytes                 # bytes that actually land
    kind: str | None = None     # fault kind, None for a clean delivery
    detail: dict | None = None  # audit payload (positions, kept bytes)
    duplicate: bool = False     # deliver `data` a second time
    reorder: bool = False       # hold this chunk; successor goes first
    disconnect: bool = False    # connection died after `data` landed


class FaultInjector:
    """Stateful per-run consumer of a :class:`FaultTrace`'s RNG stream."""

    def __init__(self, trace: FaultTrace):
        self.trace = trace
        self._rng = np.random.default_rng(trace.seed)
        self.counts: dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.deliveries = 0

    @staticmethod
    def flip_bits(data: bytes, bit_positions) -> bytes:
        out = bytearray(data)
        for b in bit_positions:
            out[b // 8] ^= 1 << (b % 8)
        return bytes(out)

    def deliver(self, chunk: bytes) -> ChunkDelivery:
        """Pass one chunk through the channel. Consumes exactly one
        uniform draw per delivery plus parameter draws when a fault
        fires."""
        self.deliveries += 1
        ft = self.trace
        u = float(self._rng.random())
        edges = [("corrupt", ft.p_corrupt), ("truncate", ft.p_truncate),
                 ("duplicate", ft.p_duplicate), ("reorder", ft.p_reorder),
                 ("disconnect", ft.p_disconnect)]
        kind, acc = None, 0.0
        for k, p in edges:
            acc += p
            if u < acc:
                kind = k
                break
        if kind is None or len(chunk) == 0:
            return ChunkDelivery(data=bytes(chunk))
        self.counts[kind] += 1
        if kind == "corrupt":
            nbits = len(chunk) * 8
            flips = sorted(int(b) for b in self._rng.integers(
                0, nbits, size=min(ft.flips_per_corruption, nbits)))
            return ChunkDelivery(data=self.flip_bits(chunk, flips),
                                 kind=kind, detail={"bit_positions": flips})
        if kind == "truncate":
            keep = int(self._rng.integers(0, len(chunk)))
            return ChunkDelivery(data=bytes(chunk[:keep]), kind=kind,
                                 detail={"kept": keep, "lost": len(chunk) - keep})
        if kind == "duplicate":
            return ChunkDelivery(data=bytes(chunk), kind=kind,
                                 detail={}, duplicate=True)
        if kind == "reorder":
            return ChunkDelivery(data=bytes(chunk), kind=kind,
                                 detail={}, reorder=True)
        keep = int(self._rng.integers(0, len(chunk)))
        return ChunkDelivery(data=bytes(chunk[:keep]), kind="disconnect",
                             detail={"kept": keep, "lost": len(chunk) - keep},
                             disconnect=True)


TraceLike = Union[Link, BandwidthTrace]


def as_trace(link: TraceLike) -> tuple[BandwidthTrace, float]:
    """Normalize a Link or BandwidthTrace to ``(trace, latency_s)``.
    The latency is a one-time shift of the byte clock (the stream's
    request/response round trip, paid once per connection)."""
    if isinstance(link, Link):
        return link.trace(), link.latency_s
    if isinstance(link, BandwidthTrace):
        return link, 0.0
    raise TypeError(f"expected Link or BandwidthTrace, got {type(link).__name__}")


@dataclasses.dataclass(frozen=True)
class TransferEvent:
    """One contiguous payload fully received."""

    label: str
    nbytes: int
    start_s: float
    end_s: float


def simulate_transfer(
    payloads: Sequence[tuple[str, int]], link: TraceLike, start_s: float = 0.0
) -> list[TransferEvent]:
    """Stream payloads back-to-back over one connection (a progressive
    model is a single HTTP stream in the paper; latency paid once).
    Zero-length payloads yield zero-duration events at the current
    clock. Accepts a constant :class:`Link` or a :class:`BandwidthTrace`
    (whose clock starts when the stream does)."""
    trace, latency = as_trace(link)
    t0 = start_s + latency
    tt = 0.0  # trace-clock time of the last delivered byte
    events: list[TransferEvent] = []
    for label, nbytes in payloads:
        begin = t0 + tt
        tt = trace.time_to_deliver(nbytes, start_s=tt)
        events.append(TransferEvent(label=label, nbytes=nbytes,
                                    start_s=begin, end_s=t0 + tt))
    return events


def bytes_available(events: Sequence[TransferEvent], at_s: float) -> int:
    """Total bytes delivered by time ``at_s`` (mid-payload counts
    proportionally — links deliver bytes, not whole files). Exact at
    event boundaries: a payload counts fully at its ``end_s`` and the
    proportional share is clamped to ``nbytes`` so float rounding never
    over- or under-counts a finished payload."""
    total = 0
    for e in events:
        if at_s >= e.end_s:
            total += e.nbytes
        elif at_s > e.start_s and e.end_s > e.start_s:
            frac = (at_s - e.start_s) / (e.end_s - e.start_s)
            total += min(e.nbytes, int(e.nbytes * frac))
    return total
