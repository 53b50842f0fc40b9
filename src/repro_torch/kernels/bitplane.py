"""Bit-plane accumulate (eq. 4) and bit division (eq. 3).

Replaces the three Pallas kernels of ``src/repro/kernels/bitplane.py``
with CUDA kernels:

* ``plane_or_segments`` (``_or_segments_kernel``, ``csrc/plane_or.cu``):
  one launch upgrades every tensor of one container dtype. ``acc`` and
  ``plane`` are 1-D buffers in which each tensor owns a block-aligned
  segment, and ``shifts`` holds the left shift of each ``block`` of
  elements.
* ``plane_or`` (``_or_kernel``, ``csrc/plane_or.cu``): the same OR on
  one tensor of any shape with one shift; acc and plane may have
  different uint dtypes.
* ``plane_extract`` (``_extract_kernel``, ``csrc/plane_extract.cu``):
  one plane of a quantized tensor, written in any uint dtype.

Bound on the H100: device-memory bytes, as each kernel reads its
operands once and writes the result once (a uint16 model of n weights
moves 6n bytes an upgrade). Each thread moves whole words of up to 16
bytes, so each warp moves whole cache lines, and the ORs write a new
buffer: the accumulator they read stays valid for views taken before the
upgrade.

A tensor on the CPU takes the plain version (``ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import plane_extract_ref, plane_or_ref, plane_or_segments_ref

UINT_DTYPES = (torch.uint8, torch.uint16, torch.uint32)

# Launches of each CUDA kernel; the CPU path does not count.
launches = 0                   # plane_or_segments
plane_or_launches = 0
plane_extract_launches = 0


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


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: operands must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")


def plane_or(acc: torch.Tensor, plane: torch.Tensor, *, shift: int) -> torch.Tensor:
    """``out = acc | (plane << shift)`` elementwise, out of place, in acc's
    dtype. acc: uint8/16/32 of any shape; plane: any uint8/16/32 tensor of
    the same shape (widened to 32 bits before the shift); 0 <= shift < 32."""
    global plane_or_launches
    if acc.shape != plane.shape:
        raise ValueError(f"plane shape {tuple(plane.shape)} != acc shape "
                         f"{tuple(acc.shape)}")
    if acc.dtype not in UINT_DTYPES or plane.dtype not in UINT_DTYPES:
        raise TypeError(f"acc and plane must be uint8/16/32, got {acc.dtype} and "
                        f"{plane.dtype}")
    shift = int(shift)
    if not 0 <= shift < 32:
        raise ValueError(f"shift must lie in [0, 32), got {shift}")
    if acc.device.type == "cpu" and plane.device.type == "cpu":
        return plane_or_ref(acc, plane, shift)
    _check_cuda("plane_or", acc, plane)
    out = torch.empty_like(acc)
    fn = build.library("plane_or").plane_or
    code = fn(acc.data_ptr(), plane.data_ptr(), out.data_ptr(), acc.numel(), shift,
              acc.element_size(), plane.element_size(), build.stream_handle(acc.device))
    build.check(code, "plane_or")
    plane_or_launches += 1
    return out


def plane_extract(q: torch.Tensor, *, bits: int, before: int, width: int,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Eq. (3): ``((q << before) & (2^bits - 1)) >> (bits - width)``
    elementwise, the ``width``-bit plane starting ``before`` bits below the
    top of ``bits``-bit values, in ``out_dtype`` (default: q's dtype, as
    the TPU kernel writes). q: uint8/16/32 of any shape."""
    global plane_extract_launches
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if q.dtype not in UINT_DTYPES or out_dtype not in UINT_DTYPES:
        raise TypeError(f"q and out_dtype must be uint8/16/32, got {q.dtype} and "
                        f"{out_dtype}")
    bits, before, width = int(bits), int(before), int(width)
    if not (width >= 1 and before >= 0 and before + width <= bits <= 32):
        raise ValueError(f"need 1 <= width, 0 <= before and before + width <= bits "
                         f"<= 32, got bits={bits}, before={before}, width={width}")
    if width > 8 * torch.empty((), dtype=out_dtype).element_size():
        raise ValueError(f"a {width}-bit plane does not fit {out_dtype}")
    if q.device.type == "cpu":
        return plane_extract_ref(q, bits, before, width, out_dtype)
    _check_cuda("plane_extract", q)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    fn = build.library("plane_extract").plane_extract
    code = fn(q.data_ptr(), out.data_ptr(), q.numel(), bits, before, width,
              q.element_size(), out.element_size(), build.stream_handle(q.device))
    build.check(code, "plane_extract")
    plane_extract_launches += 1
    return out
