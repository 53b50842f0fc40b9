"""Bit division and bit concatenation (paper eqs. 3 and 4).

Counterpart of ``src/repro/core/bitplanes.py``. Eq. (3) fetches plane m
of widths ``b`` from a k-bit quantized integer:

    p<k, m> = ((q << c_{m-1}) & (2^k - 1)) >> (k - b_m)

with ``c_{m-1}`` the cumulative width of the planes before m. Eq. (4)
reassembles whatever prefix of planes has been received:

    q'<k> = OR_m ( p<k, m> << (k - c_m) )

PyTorch has no ``<<`` for uint16/uint32 on the CPU, so the arithmetic
runs in int64 and casts back to the container dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.quantize import QuantizedTensor, container_dtype


def validate_widths(bits: int, widths: Sequence[int]) -> tuple[int, ...]:
    widths = tuple(int(w) for w in widths)
    if any(w < 1 for w in widths):
        raise ValueError(f"plane widths must be >= 1, got {widths}")
    if sum(widths) != bits:
        raise ValueError(f"plane widths {widths} must sum to bits={bits}")
    return widths


def cumulative(widths: Sequence[int]) -> tuple[int, ...]:
    out, acc = [], 0
    for w in widths:
        acc += w
        out.append(acc)
    return tuple(out)


def split_plane(q: torch.Tensor, bits: int, widths: Sequence[int], m: int) -> torch.Tensor:
    """Eq. (3): extract plane m (1-indexed, MSB planes first)."""
    widths = validate_widths(bits, widths)
    if not (1 <= m <= len(widths)):
        raise ValueError(f"m={m} outside [1, {len(widths)}]")
    cum = (0,) + cumulative(widths)
    before = cum[m - 1]
    w = widths[m - 1]
    shifted = (q.to(torch.int64) << before) & (2 ** bits - 1)
    return (shifted >> (bits - w)).to(container_dtype(w))


def split(qt: QuantizedTensor, widths: Sequence[int]) -> list[torch.Tensor]:
    """All planes of a quantized tensor, MSB-first."""
    widths = validate_widths(qt.bits, widths)
    return [split_plane(qt.q, qt.bits, widths, m + 1) for m in range(len(widths))]


def concat(planes: Sequence[torch.Tensor], bits: int, widths: Sequence[int]) -> torch.Tensor:
    """Eq. (4): OR together a received prefix of planes (1..n planes);
    the unreceived low bits are zero."""
    widths = validate_widths(bits, widths)
    if not (1 <= len(planes) <= len(widths)):
        raise ValueError(f"got {len(planes)} planes for {len(widths)} widths")
    cum = cumulative(widths)
    acc = torch.zeros(planes[0].shape, dtype=torch.int64, device=planes[0].device)
    for m, p in enumerate(planes, start=1):
        acc = acc | (p.to(torch.int64) << (bits - cum[m - 1]))
    return acc.to(container_dtype(bits))


@dataclasses.dataclass(frozen=True)
class PlaneSchedule:
    """Static description of a bit-division: k bits into widths b."""

    bits: int
    widths: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "widths", validate_widths(self.bits, self.widths))

    @property
    def n_planes(self) -> int:
        return len(self.widths)

    @property
    def cumulative_bits(self) -> tuple[int, ...]:
        return cumulative(self.widths)


# The paper's default: a 16-bit model sent as eight 2-bit planes.
PAPER_DEFAULT = PlaneSchedule(bits=16, widths=(2,) * 8)
