"""The model's entry points to the kernels.

Counterpart of ``src/repro/kernels/ops.py``. ``LAUNCH_COUNTS`` tallies
calls at the call site under the reference's names, whichever path the
call takes; each kernel module's own ``launches`` counts only the CUDA
launches. A tensor on the CPU takes the plain version, a CUDA tensor the
hand-written kernel.
"""
from __future__ import annotations

import collections

from repro_torch.kernels import bitplane as _bp
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dequant_matmul as _dqm

# Calls per entry point. Diagnostic only: reset freely, never read on a
# hot path.
LAUNCH_COUNTS: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _count(name: str) -> None:
    LAUNCH_COUNTS[name] += 1


def dequant_matmul(x, q, scale, offset):
    """y = x @ (scale * q + offset); scale and offset are one-element
    float32 tensors on x's device, read by the kernel where it runs."""
    _count("dequant_matmul")
    return _dqm.dequant_matmul(x, q, scale, offset)


def plane_or_segments(acc, plane, shifts, *, block: int = 1024):
    _count("plane_or_segments")
    return _bp.plane_or_segments(acc, plane, shifts, block=block)


def decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Ragged batched decode attention: q (B, H, hd); k/v in the native
    (B, Kh, S, hd) cache layout; k_pos (B, S); q_pos (B,). Returns q's
    dtype."""
    _count("decode_attention")
    return _da.flash_decode(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
