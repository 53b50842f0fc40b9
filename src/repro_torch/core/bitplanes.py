"""Bit division and bit concatenation (paper eqs. 3 and 4).

Counterpart of ``src/repro/core/bitplanes.py``. Eq. (3) fetches plane m
of widths ``b`` from a k-bit quantized integer:

    p<k, m> = ((q << c_{m-1}) & (2^k - 1)) >> (k - b_m)

with ``c_{m-1}`` the cumulative width of the planes before m. Eq. (4)
reassembles whatever prefix of planes has been received:

    q'<k> = OR_m ( p<k, m> << (k - c_m) )

Both run through the kernel entry points (``kernels/ops``): eq. (3) is
``plane_extract``, which writes each plane straight into its container
dtype, and eq. (4) is ``plane_or``. A CUDA tensor launches the CUDA
kernels, a CPU tensor takes their plain versions.

Planes travel densely bit-packed (:func:`pack_bits`, :func:`unpack_bits`),
with the reference's byte layout. PyTorch has no ``<<`` for uint16/uint32
on the CPU, so the packing arithmetic runs in int32 (int64 for 32-bit
planes) on the tensor's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.quantize import QuantizedTensor, container_dtype
from repro_torch.kernels import ops


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
    w = widths[m - 1]
    return ops.plane_extract(q, bits=bits, before=cum[m - 1], width=w,
                             out_dtype=container_dtype(w))


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
    acc = torch.zeros(planes[0].shape, dtype=container_dtype(bits),
                      device=planes[0].device)
    for m, p in enumerate(planes, start=1):
        acc = ops.plane_or(acc, p, shift=bits - cum[m - 1])
    return acc


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

    def payload_bytes(self, n_elements: int, upto: int | None = None) -> int:
        """Dense-packed payload size of planes [1..upto]."""
        upto = self.n_planes if upto is None else upto
        return sum(math.ceil(n_elements * w / 8) for w in self.widths[:upto])


# The paper's default: a 16-bit model sent as eight 2-bit planes.
PAPER_DEFAULT = PlaneSchedule(bits=16, widths=(2,) * 8)


# ---------------------------------------------------------------------------
# Dense bit-packing: planes travel packed (w bits per element), which keeps
# the wire the size of the singleton quantized model.
# ---------------------------------------------------------------------------

def _bit_group(width: int) -> tuple[int, int]:
    """Smallest group of values whose packed bits land on a byte
    boundary: lcm(width, 8) bits = (values per group, bytes per group)."""
    L = width * 8 // math.gcd(width, 8)
    return L // width, L // 8


def _wide(width: int) -> torch.dtype:
    """Signed arithmetic dtype that holds every value of a width-bit plane."""
    return torch.int32 if width < 32 else torch.int64


def pack_bits(plane: torch.Tensor, width: int) -> torch.Tensor:
    """Pack a width-bit plane into a dense uint8 byte stream (big-endian
    bit order), on the plane's device; the reference's bytes.

    Byte-granular: values are grouped so a group's bits fill whole bytes
    (lcm(width, 8) bits), and each output byte is assembled from the
    values overlapping it. Peak intermediates are O(n)."""
    wide = _wide(width)
    flat = plane.reshape(-1).to(wide)
    n = flat.shape[0]
    gv, gb = _bit_group(width)
    pad = (-n) % gv
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    vals = flat.reshape(-1, gv)
    out = torch.empty((vals.shape[0], gb), dtype=torch.uint8, device=plane.device)
    for b in range(gb):
        lo_bit, hi_bit = 8 * b, 8 * b + 8
        acc = torch.zeros((vals.shape[0],), dtype=wide, device=plane.device)
        for i in range(gv):
            v_lo, v_hi = i * width, (i + 1) * width
            o_lo, o_hi = max(lo_bit, v_lo), min(hi_bit, v_hi)
            if o_lo >= o_hi:
                continue
            piece = (vals[:, i] >> (v_hi - o_hi)) & (2 ** (o_hi - o_lo) - 1)
            acc = acc | (piece << (hi_bit - o_hi))
        out[:, b] = acc
    return out.reshape(-1)[: -(-n * width // 8)]


def unpack_bits(packed: torch.Tensor, width: int, n_elements: int, *,
                dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Inverse of :func:`pack_bits` on packed's device: values in
    [0, 2^w) as ``dtype`` (the reference returns uint32). A payload too
    short for ``n_elements`` values raises; extra trailing bytes are
    ignored."""
    need = -(-n_elements * width // 8)
    if packed.shape[0] < need:
        raise ValueError(
            f"packed payload has {packed.shape[0]} bytes, need {need} "
            f"for {n_elements} width-{width} values")
    wide = _wide(width)
    gv, gb = _bit_group(width)
    groups = -(-n_elements // gv)
    by = packed[:need].to(wide)
    pad = groups * gb - need
    if pad:
        by = torch.cat([by, by.new_zeros(pad)])
    bys = by.reshape(groups, gb)
    out = torch.empty((groups, gv), dtype=dtype, device=packed.device)
    for i in range(gv):
        v_lo, v_hi = i * width, (i + 1) * width
        acc = torch.zeros((groups,), dtype=wide, device=packed.device)
        for b in range(gb):
            lo_bit, hi_bit = 8 * b, 8 * b + 8
            o_lo, o_hi = max(lo_bit, v_lo), min(hi_bit, v_hi)
            if o_lo >= o_hi:
                continue
            piece = (bys[:, b] >> (hi_bit - o_hi)) & (2 ** (o_hi - o_lo) - 1)
            acc = acc | (piece << (v_hi - o_hi))
        out[:, i] = acc
    return out.reshape(-1)[:n_elements]
