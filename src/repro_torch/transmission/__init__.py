"""Transmission substrate: bandwidth traces and simulation, the Fig.-4
concurrent transmission/inference scheduler, the progressive client,
named network scenarios, and the deterministic co-simulation Session."""
from repro_torch.transmission.simulator import (
    BandwidthTrace,
    ChunkDelivery,
    FaultInjector,
    FaultTrace,
    Link,
    TransferEvent,
    as_trace,
    simulate_transfer,
)
from repro_torch.transmission.scheduler import (
    StageCost,
    Timeline,
    overhead_pct,
    progressive_timeline,
    singleton_timeline,
)
from repro_torch.transmission.client import ProgressiveClient
from repro_torch.transmission.scenarios import (SCENARIOS, Scenario,
                                          flash_crowd_arrivals, get_scenario,
                                          list_scenarios)
from repro_torch.transmission.session import (FaultPolicy, Session, SessionEvent,
                                        SessionResult, TransportError)

__all__ = [
    "BandwidthTrace",
    "ChunkDelivery",
    "FaultInjector",
    "FaultPolicy",
    "FaultTrace",
    "Link",
    "TransportError",
    "TransferEvent",
    "as_trace",
    "simulate_transfer",
    "StageCost",
    "Timeline",
    "overhead_pct",
    "progressive_timeline",
    "singleton_timeline",
    "ProgressiveClient",
    "SCENARIOS",
    "Scenario",
    "flash_crowd_arrivals",
    "get_scenario",
    "list_scenarios",
    "Session",
    "SessionEvent",
    "SessionResult",
]
