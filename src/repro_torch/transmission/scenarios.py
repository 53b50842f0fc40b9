"""Named network scenarios: the catalog benchmarks, examples and tests
all draw from.

Each scenario is a seeded trace factory plus the transport parameters a
:class:`~repro_torch.transmission.session.Session` needs (latency, chunk
size). ``make_trace(seed)`` is deterministic in the seed — the same
seed reproduces the same bandwidth profile, event log and tokens on any
machine — while different seeds give independent draws of the same
scenario family (jitter realizations).

The four canonical entries map to the paper's deployment stories:

==================== ====================================================
``browser-3g``        the paper's user-study regime: a slow cellular
                      link (~0.2 MB/s) with heavy multiplicative jitter
``browser-lte-handoff`` fast LTE that degrades through a cell handoff:
                      ramp down, a dead gap, ramp back up
``edge-stall``        a decent fixed link that suffers a mid-download
                      outage (elevator/tunnel) — the stall scenario
``pod-coldstart``     checkpoint-store -> TPU-pod link: very fast,
                      near-zero latency; stresses the compute side
``flash-crowd``       a solid edge link whose *demand* spikes: N
                      clients join mid-download and the slot-pool
                      engine admits them staggered (see
                      :func:`flash_crowd_arrivals`)
==================== ====================================================

Two *lossy* entries additionally carry a seeded
:class:`~repro_torch.transmission.simulator.FaultTrace` factory
(``make_faults``) — they require the v3 integrity wire and exercise the
quarantine/repair/resume machinery:

==================== ====================================================
``browser-3g-lossy``  the 3G link plus last-mile damage: ~1% bit-flip
                      corruption and occasional mid-chunk disconnects
``edge-flaky``        the edge-stall link on a flaky path: corruption,
                      truncation, duplication, reordering and
                      disconnects all at low rates
==================== ====================================================
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.transmission.simulator import BandwidthTrace, FaultTrace


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    make_trace: Callable[[int], BandwidthTrace]  # seed -> trace
    latency_s: float
    chunk_bytes: int
    # lossy scenarios: seed -> channel fault profile (None = trusted
    # channel, the default for the original catalog entries)
    make_faults: Callable[[int], FaultTrace] | None = None

    @property
    def lossy(self) -> bool:
        return self.make_faults is not None


def _browser_3g(seed: int) -> BandwidthTrace:
    return BandwidthTrace.jittered(
        0.2e6, 0.5, seed=seed, interval_s=0.5, n_intervals=256,
        name=f"browser-3g@{seed}")


def _browser_lte_handoff(seed: int) -> BandwidthTrace:
    """LTE plateau -> handoff dip -> dead gap -> recovery. The plateau
    rates get a small seeded jitter so distinct seeds are distinct
    traces of the same family."""
    rng = np.random.default_rng(seed)
    lte = 2.5e6 * (1.0 + 0.1 * (2.0 * rng.random() - 1.0))
    recovered = 1.2e6 * (1.0 + 0.1 * (2.0 * rng.random() - 1.0))
    segs = [(1.5, lte)]
    segs += BandwidthTrace.ramp(lte, 0.15e6, 1.0, steps=5).segments
    segs += [(0.8, 0.0)]  # the handoff gap
    segs += BandwidthTrace.ramp(0.15e6, recovered, 0.5, steps=4).segments
    segs += [(1.0, recovered)]
    return BandwidthTrace(segs, name=f"browser-lte-handoff@{seed}")


def _edge_stall(seed: int) -> BandwidthTrace:
    # The outage starts 0.35 s in so even the reduced smoke models
    # (~0.7 MB at ~1 MB/s) are still mid-download when the link dies —
    # the scenario must actually exercise the stall path at every scale.
    base = BandwidthTrace.jittered(
        1.0e6, 0.15, seed=seed, interval_s=1.0, n_intervals=128)
    out = base.with_outage(0.35, 1.5)
    return BandwidthTrace(out.segments, name=f"edge-stall@{seed}")


def _pod_coldstart(seed: int) -> BandwidthTrace:
    del seed  # the storage fabric doesn't jitter at this granularity
    return BandwidthTrace.constant(200e6, name="pod-coldstart")


def _flash_crowd(seed: int) -> BandwidthTrace:
    """The link itself is a decent lightly-jittered edge connection —
    the scenario's stress is the *request* side (staggered admissions
    into the slot pool), not the byte clock."""
    return BandwidthTrace.jittered(
        1.5e6, 0.1, seed=seed, interval_s=0.5, n_intervals=128,
        name=f"flash-crowd@{seed}")


def _browser_3g_faults(seed: int) -> FaultTrace:
    """Last-mile cellular damage: ~1% of chunks take a bit flip, an
    occasional chunk loses its connection mid-flight."""
    return FaultTrace(seed=seed, p_corrupt=0.01, p_disconnect=0.002,
                      flips_per_corruption=1)


def _edge_flaky_faults(seed: int) -> FaultTrace:
    """Every fault kind at a low rate — the kitchen-sink reliability
    profile (desync recovery included via truncation/duplication)."""
    return FaultTrace(seed=seed, p_corrupt=0.01, p_truncate=0.004,
                      p_duplicate=0.004, p_reorder=0.004,
                      p_disconnect=0.002)


def flash_crowd_arrivals(seed: int, n_clients: int,
                         span_s: float) -> list[float]:
    """Deterministic staggered arrival offsets for a flash crowd:
    ``n_clients`` requests land within ``span_s`` seconds of the cold
    start, sorted, seed-reproducible. The first client arrives at 0 so
    the pool always cold-starts with work."""
    rng = np.random.default_rng(seed)
    offs = np.sort(rng.uniform(0.0, span_s, size=n_clients))
    offs[0] = 0.0
    return [float(o) for o in offs]


SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="browser-3g",
            description="slow cellular link with heavy jitter "
                        "(paper user-study regime)",
            make_trace=_browser_3g,
            latency_s=0.08,
            chunk_bytes=16 * 1024,
        ),
        Scenario(
            name="browser-lte-handoff",
            description="fast LTE degrading through a cell handoff: "
                        "ramp down, dead gap, recovery",
            make_trace=_browser_lte_handoff,
            latency_s=0.05,
            chunk_bytes=32 * 1024,
        ),
        Scenario(
            name="edge-stall",
            description="1 MB/s edge link that dies for 1.5 s, "
                        "0.35 s into the download",
            make_trace=_edge_stall,
            latency_s=0.02,
            chunk_bytes=32 * 1024,
        ),
        Scenario(
            name="pod-coldstart",
            description="checkpoint-store to pod: 200 MB/s, "
                        "near-zero latency",
            make_trace=_pod_coldstart,
            latency_s=0.005,
            chunk_bytes=1024 * 1024,
        ),
        Scenario(
            name="flash-crowd",
            description="1.5 MB/s edge link; N clients join "
                        "mid-download and share one slot pool",
            make_trace=_flash_crowd,
            latency_s=0.03,
            chunk_bytes=32 * 1024,
        ),
        Scenario(
            name="browser-3g-lossy",
            description="the browser-3g link with ~1% chunk corruption "
                        "and rare mid-chunk disconnects (needs wire v3)",
            make_trace=_browser_3g,
            latency_s=0.08,
            chunk_bytes=16 * 1024,
            make_faults=_browser_3g_faults,
        ),
        Scenario(
            name="edge-flaky",
            description="the edge-stall link on a flaky path: "
                        "corruption, truncation, duplication, "
                        "reordering and disconnects (needs wire v3)",
            make_trace=_edge_stall,
            latency_s=0.02,
            chunk_bytes=32 * 1024,
            make_faults=_edge_flaky_faults,
        ),
    )
}


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {list_scenarios()}"
        ) from None
