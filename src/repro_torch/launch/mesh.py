"""The serving mesh: a grid of ``torch.device``s in one process.

Counterpart of ``make_serving_mesh``, ``data_axes`` and ``model_axis`` in
``src/repro/launch/mesh.py``. The reference is single-controller: one
process drives every device of a ``("data", "model")`` mesh, and sharded
serving gathers but never reduces across it (``launch/sharding.py``).
The port keeps that shape without ``torch.distributed``: a mesh is a
grid of devices, and a gather is a copy to the home device and a
``torch.cat``.

``devices=None`` takes ``cuda:0 .. cuda:n-1`` and raises when the
machine has fewer cards; it never places two shards on one card by
itself. A caller who wants logical shards of one device passes the grid
explicitly (``devices=[torch.device("cuda", 0)] * n``, or ``["cpu"] * n``,
the counterpart of XLA's forced host devices): that checks placement,
ingest and arithmetic, but not the time of copies between cards.

The reference's training and dry-run meshes (``make_production_mesh``,
``make_debug_mesh``) and its TPU roofline constants are not ported here
(ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``("data", "model")`` grid of devices: ``devices[i][j]`` is data
    row i, model shard j. ``devices[0][0]`` is the home device, where
    activations, caches and sampling live."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def model_devices(self) -> tuple[torch.device, ...]:
        """The devices of the model axis in data row 0, in shard order."""
        return self.devices[0]

    def describe(self) -> str:
        cards = sorted({str(d) for row in self.devices for d in row})
        return (f"{self.shape['model']} model shards x {self.shape['data']} data rows on "
                f"{len(cards)} device(s) {cards}")


def canonical_device(device) -> torch.device:
    """``device`` resolved (``cuda`` without a card raises), with a card's
    index filled in, so that ``cuda`` and ``cuda:0`` compare equal."""
    d = resolve_device(device)
    return torch.device("cuda", d.index or 0) if d.type == "cuda" else d


def make_serving_mesh(n_model: int, *, n_data: int = 1,
                      devices: Sequence | None = None) -> Mesh:
    """A serving mesh of ``n_data`` rows of ``n_model`` shards.
    ``devices``: ``n_data * n_model`` devices in row-major order (may
    repeat a device: logical shards); default ``cuda:0 ..``, one card a
    shard, raising if there are fewer."""
    if n_model < 1 or n_data < 1:
        raise ValueError(f"mesh shape ({n_data}, {n_model}) must be positive")
    n = n_model * n_data
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a ({n_data}, {n_model}) serving mesh needs {n} CUDA devices, this "
                f"machine has {have}; pass devices= to place logical shards on fewer")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [canonical_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a ({n_data}, {n_model}) mesh takes {n} devices, got {len(devs)}")
    return Mesh(tuple(tuple(devs[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def check_serving_mesh(mesh: Mesh) -> None:
    """Raise for a mesh sharded serving does not take yet: replica rows
    (``data`` > 1)."""
    if mesh.shape["data"] != 1:
        raise NotImplementedError("a serving mesh with data rows > 1 (replicas) is still "
                                  "to be ported (ROADMAP A13)")


def home_device(mesh: Mesh, device) -> torch.device:
    """The device an entry point on a serving mesh (:func:`check_serving_mesh`)
    runs on: the mesh's home device, which ``device`` must name."""
    check_serving_mesh(mesh)
    if canonical_device(device) != mesh.home:
        raise ValueError(f"device {device} is not the mesh's home device {mesh.home}")
    return mesh.home


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes that shard the batch."""
    return ("data",)


def model_axis(mesh: Mesh) -> str:
    return "model"
