"""Transmission: the progressive client that turns wire bytes into a
device-resident PlaneStore. The byte-clock simulator, scheduler,
scenarios and ``Session`` are still to be ported (ROADMAP A7)."""
from repro_torch.transmission.client import ProgressiveClient

__all__ = ["ProgressiveClient"]
