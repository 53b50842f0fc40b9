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
from repro_torch.kernels import verify_attention as _va

# Calls per entry point. Diagnostic only: reset freely, never read on a
# hot path.
LAUNCH_COUNTS: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _count(name: str) -> None:
    LAUNCH_COUNTS[name] += 1


def dequant_matmul(x, q, scale, offset, keep=None, *, bits=None, rows="any"):
    """y = x @ (scale * q + offset); scale and offset are one-element
    float32 tensors on x's device, read by the kernel where it runs, as
    is ``keep``, a truncated view's plane mask (the top ``keep`` of
    ``bits`` bits of q). ``rows="decode"`` keeps every M on the route
    whose rows do not depend on M."""
    _count("dequant_matmul")
    return _dqm.dequant_matmul(x, q, scale, offset, keep, bits=bits, rows=rows)


def plane_or(acc, plane, *, shift):
    _count("plane_or")
    return _bp.plane_or(acc, plane, shift=shift)


def plane_or_segments(acc, plane, shifts, *, block: int = 1024):
    _count("plane_or_segments")
    return _bp.plane_or_segments(acc, plane, shifts, block=block)


def plane_extract(q, *, bits, before, width, out_dtype=None):
    """Eq. (3) on the server side; ``out_dtype`` defaults to q's dtype, as
    the reference's kernel writes."""
    _count("plane_extract")
    return _bp.plane_extract(q, bits=bits, before=before, width=width, out_dtype=out_dtype)


def decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Ragged batched decode attention: q (B, H, hd); k/v in the native
    (B, Kh, S, hd) cache layout; k_pos (B, S); q_pos (B,). Returns q's
    dtype."""
    _count("decode_attention")
    return _da.flash_decode(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def flash_verify(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Ragged attention of T query rows per slot: q (B, T, H, hd); k/v in
    the native (B, Kh, S, hd) cache layout; k_pos (B, S); q_pos (B, T)
    per-row positions (negative = masked row)."""
    _count("flash_verify")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def verify_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """The model's speculative-verify attention: T = k+1 draft rows per
    slot at positions pos + t, one pass over the cache. Each row equals
    a decode step at its position, bit for bit."""
    _count("verify_attention")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def prefill_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """The model's chunked-prefill attention: a (B, chunk) block of prompt
    rows per slot, q_pos holding each slot's chunk offsets (-1 for free
    and decoding slots and past a short final chunk). The same kernel as
    :func:`verify_attention`; the two names keep the call sites apart in
    ``LAUNCH_COUNTS``."""
    _count("prefill_attention")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
