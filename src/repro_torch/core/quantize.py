"""Floor-quantization and dequantization (paper eqs. 2 and 5).

Counterpart of ``src/repro/core/quantize.py``. Eq. (2) floors rather
than rounds, which is what makes bit-plane prefixes exact: the first m
planes of a floor-quantized value are the floor-quantization of that
value at m bits. Eq. (5) adds half an LSB of the *received* precision,
so the reconstruction is unbiased at every stage.

Every float32 operation here is the reference's, in the reference's
order, so ``q``, ``lo`` and ``hi`` come out bit-identical to it for the
same input on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# ε of eq. (2): keeps the scaled value strictly below 2^k.
_EPS_REL = 1e-6
_EPS_ABS = 1e-12


def container_dtype(k: int) -> torch.dtype:
    if k <= 8:
        return torch.uint8
    if k <= 16:
        return torch.uint16
    if k <= 32:
        return torch.uint32
    raise ValueError(f"k={k} exceeds 32-bit container")


@dataclasses.dataclass
class QuantizedTensor:
    """A k-bit floor-quantized tensor plus its dequantization range.

    ``q`` holds unsigned integers in [0, 2^k); ``lo``/``hi`` are the
    per-tensor min/max (float32), ``bits`` the width k.

    As a live parameter leaf of quantized-resident serving, ``q`` is a
    view into the PlaneStore's flat accumulator and ``scale``/``offset``
    carry the eq.-(5) affine (:func:`dequant_affine`) as float32 tensors
    of shape ``q.shape[:-2] + (1, 1)`` on q's device, with
    ``received_bits`` (int32, same shape) beside them. An upgrade changes
    their values; the kernels read them from device memory."""

    q: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    bits: int
    orig_dtype: Any = torch.float32
    scale: torch.Tensor | None = None
    offset: torch.Tensor | None = None
    received_bits: torch.Tensor | None = None

    @property
    def T(self) -> "QuantizedTensor":
        """Transposed view (2-D only): ``q`` transposes as a view, the
        per-tensor affine is invariant. Lets ``x @ embed.T`` (tied
        unembedding) ride the same dequant-matmul dispatch without a
        copy of the table."""
        if self.q.ndim != 2:
            raise ValueError(f"T needs a 2-D tensor, got shape {tuple(self.q.shape)}")
        return dataclasses.replace(self, q=self.q.T)


def _range_eps(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    span = hi - lo
    return span * _EPS_REL + _EPS_ABS


def quantize(x: torch.Tensor, bits: int) -> QuantizedTensor:
    """Eq. (2): q<k> = floor(2^k * (x - min) / (max - min + eps))."""
    if not (1 <= bits <= 32):
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    xf = x.to(torch.float32)
    lo = xf.min()
    hi = xf.max()
    span = hi - lo + _range_eps(lo, hi)
    scaled = (xf - lo) / span
    q = torch.floor(scaled * float(2 ** bits))   # exact, as jnp.ldexp
    # numerical edge can land exactly on 2^k; clamp into range
    q = torch.clamp(q, 0, 2.0 ** bits - 1)
    return QuantizedTensor(q=q.to(container_dtype(bits)), lo=lo, hi=hi,
                           bits=bits, orig_dtype=x.dtype)


def affine_span(lo, hi) -> torch.Tensor:
    """The eq.-(5) ε-widened range ``hi - lo + ε``: the quantity both
    ``scale`` and ``offset`` are proportional to."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return hi - lo + _range_eps(lo, hi)


def dequant_affine(lo, hi, bits: int, received_bits: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (5) as an affine map ``w = scale * q + offset``: the one place
    the slope and intercept are computed. ``received_bits`` is the
    effective precision m of the planes received so far; with m == 0 the
    offset is the centre of the range. Returns float32 tensors shaped like
    ``lo``/``hi``."""
    k = bits
    m = k if received_bits is None else received_bits
    if not (0 <= m <= k):
        raise ValueError(f"received_bits={m} outside [0, {k}]")
    lo = torch.as_tensor(lo, dtype=torch.float32)
    span = affine_span(lo, hi)
    scale = span * (0.5 ** k)
    if m > 0:
        offset = lo + span * (0.5 ** (m + 1))
    else:
        offset = lo + span * 0.5
    return scale, offset


def dequantize(qt: QuantizedTensor, received_bits: int | None = None) -> torch.Tensor:
    """Eq. (5): ``scale * q + offset`` in float32, cast to the original
    dtype; the same two float32 operations the fused kernel applies."""
    scale, offset = dequant_affine(qt.lo, qt.hi, qt.bits, received_bits)
    val = qt.q.to(torch.float32) * scale.to(qt.q.device) + offset.to(qt.q.device)
    return val.to(qt.orig_dtype)
