"""Bit-plane accumulate (eq. 4) over a flat accumulator buffer.

Replaces ``src/repro/kernels/bitplane.py`` ``plane_or_segments`` (the
Pallas ``_or_segments_kernel``) with the CUDA kernel in
``csrc/plane_or.cu``. One launch upgrades every tensor of one container
dtype: ``acc`` and ``plane`` are 1-D buffers in which each tensor owns a
block-aligned segment, and ``shifts`` holds the left shift of each
``block`` of elements.

Bound on the H100: device-memory bytes, as the kernel reads acc and plane
once and writes the result once (a uint16 model of n weights moves 6n
bytes). The kernel reads and writes 16 bytes per thread so each warp
moves whole cache lines, and it writes a new buffer: the accumulator it
reads stays valid for views taken before the upgrade.

A tensor on the CPU takes the plain version (``ref.plane_or_segments_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import plane_or_segments_ref

UINT_DTYPES = (torch.uint8, torch.uint16, torch.uint32)

# Launches of the CUDA kernel; the CPU path does not count.
launches = 0


def plane_or_segments(acc: torch.Tensor, plane: torch.Tensor, shifts: torch.Tensor,
                      *, block: int = 1024) -> torch.Tensor:
    """``out = acc | (plane << shifts[i // block])``, out of place.

    acc and plane: 1-D, the same uint8/16/32 dtype and length, a multiple
    of ``block``; shifts: int32, one per block."""
    global launches
    if acc.ndim != 1 or plane.ndim != 1:
        raise ValueError("plane_or_segments operates on flat 1-D buffers")
    if block % 128:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    n = acc.shape[0]
    if n % block:
        raise ValueError(f"buffer length {n} not a multiple of block {block}")
    if plane.shape[0] != n:
        raise ValueError(f"plane length {plane.shape[0]} != acc length {n}")
    if shifts.shape != (n // block,):
        raise ValueError(f"shift table has shape {tuple(shifts.shape)}, expected "
                         f"({n // block},) (one per block)")
    if acc.dtype not in UINT_DTYPES or plane.dtype != acc.dtype:
        raise TypeError(f"acc and plane must share a uint8/16/32 dtype, got "
                        f"{acc.dtype} and {plane.dtype}")
    if acc.device.type == "cpu":
        return plane_or_segments_ref(acc, plane, shifts, block)
    if acc.device.type != "cuda" or plane.device != acc.device \
            or shifts.device != acc.device:
        raise ValueError(f"acc, plane and shifts must lie on one CUDA device, got "
                         f"{acc.device}, {plane.device}, {shifts.device}")
    if shifts.dtype != torch.int32:
        raise TypeError(f"shifts must be int32, got {shifts.dtype}")
    if not (acc.is_contiguous() and plane.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("acc, plane and shifts must be contiguous")
    out = torch.empty_like(acc)
    fn = build.library("plane_or").plane_or_segments
    code = fn(acc.data_ptr(), plane.data_ptr(), shifts.data_ptr(), out.data_ptr(),
              n, block, acc.element_size(), build.stream_handle(acc.device))
    build.check(code, "plane_or_segments")
    launches += 1
    return out
