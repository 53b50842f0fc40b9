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
from typing import Any, Mapping, Sequence

import torch

from repro_torch.kernels.ref import mask_q

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
    their values; the kernels read them from device memory.

    ``keep_bits`` (int32, same shape, on the device) is the deferred
    plane mask of a truncated-precision view (:meth:`truncate`):
    consumers keep only the top ``keep_bits`` bits of ``q``, inside the
    consuming kernel, so ``q`` stays the full view's tensor and no masked
    copy exists. None means no mask. Because the width lives in device
    memory, switching between a draft and a target view, or moving the
    draft's width, changes no launch argument."""

    q: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    bits: int
    orig_dtype: Any = torch.float32
    scale: torch.Tensor | None = None
    offset: torch.Tensor | None = None
    received_bits: torch.Tensor | None = None
    keep_bits: torch.Tensor | None = None

    @property
    def T(self) -> "QuantizedTensor":
        """Transposed view (2-D only): ``q`` transposes as a view, the
        per-tensor affine is invariant. Lets ``x @ embed.T`` (tied
        unembedding) ride the same dequant-matmul dispatch without a
        copy of the table."""
        if self.q.ndim != 2:
            raise ValueError(f"T needs a 2-D tensor, got shape {tuple(self.q.shape)}")
        return dataclasses.replace(self, q=self.q.T)

    def truncate(self, b: int) -> "QuantizedTensor":
        """Truncated-precision view: behave as if only the first planes
        totalling ``b`` bits had been received, without copying ``q``.

        The view shares this tensor's ``q`` (the same tensor object) and
        carries the truncation as a deferred mask (``keep_bits``) and an
        eq.-(5) offset recomputed at ``min(b, received)`` bits; the scale
        (``span * 2^-bits``) does not change, since q stays in its k-bit
        container. The floor-quantization prefix property makes the
        masked value equal to quantizing the source at ``b`` bits. Device
        ops only: no host sync."""
        if not (0 <= b <= self.bits):
            raise ValueError(f"b={b} outside [0, {self.bits}]")
        shape = (tuple(self.scale.shape) if self.scale is not None
                 else tuple(self.q.shape[:-2]) + (1, 1) if self.q.ndim >= 2 else ())
        if self.received_bits is not None:
            recv = torch.clamp(self.received_bits.to(torch.int32), max=b)
        else:
            recv = torch.full(shape, b, dtype=torch.int32, device=self.q.device)
        lo32 = torch.as_tensor(self.lo, dtype=torch.float32).to(self.q.device)
        hi32 = torch.as_tensor(self.hi, dtype=torch.float32).to(self.q.device)
        span = affine_span(lo32, hi32)
        # half an LSB at recv bits, 2^-(recv+1), built as an exact power of
        # two from its exponent bits (recv <= 32 keeps it normal); the
        # offset then takes dequant_affine's two float32 operations, and
        # recv == 0 the centre of the range
        half_lsb = ((126 - recv) << 23).view(torch.float32)
        offset = torch.where(recv > 0, lo32 + span * half_lsb, lo32 + span * 0.5)
        scale = (self.scale if self.scale is not None
                 else torch.broadcast_to(span * (0.5 ** self.bits), shape))
        recv = torch.broadcast_to(recv, shape).contiguous()
        return dataclasses.replace(self, scale=scale,
                                   offset=torch.broadcast_to(offset, shape).contiguous(),
                                   received_bits=recv, keep_bits=recv)


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


# -- batched eq. (5): the resident="fp" upgrade ---------------------------
#
# An upgrade of a float-resident engine re-dequantizes every tensor the
# stage touched. The reference batches that into O(1) dispatches and, so
# that its bytes equal the eager :func:`dequantize`, keeps the multiply
# and the add in separate executables (XLA:CPU would contract them into
# an FMA). Here each is its own eager operation, so nothing can fuse
# them: the product rounds to float32 before the add, as in
# :func:`dequantize`, on the CPU and on the card.


def dequant_constants(los: Sequence, his: Sequence, bits_seq: Sequence[int]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stacked per-tensor eq.-(5) constants ``(lo, span, scale)``, which
    do not depend on the bits received: computed once per store and
    reused at every upgrade. The expressions and their order are
    :func:`dequant_affine`'s. They live on the host (one read of each
    range from the card, once)."""
    def host(xs):
        return torch.stack([torch.as_tensor(x).detach().cpu().to(torch.float32).reshape(())
                            for x in xs])

    lo, hi = host(los), host(his)
    span = hi - lo + _range_eps(lo, hi)
    c = torch.tensor([0.5 ** k for k in bits_seq], dtype=torch.float32)
    return lo, span, span * c


def dequant_offsets(constants: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                    bits_seq: Sequence[int], received_seq: Sequence[int | None]
                    ) -> torch.Tensor:
    """Stacked per-tensor eq.-(5) offsets at the given received
    precisions: the only affine term an upgrade changes."""
    lo, span, _ = constants
    cs = []
    for k, m in zip(bits_seq, received_seq):
        m = k if m is None else m
        if not (0 <= m <= k):
            raise ValueError(f"received_bits={m} outside [0, {k}]")
        cs.append(0.5 ** (m + 1) if m > 0 else 0.5)
    return lo + span * torch.tensor(cs, dtype=torch.float32)


def _affine(q: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
            dtype) -> torch.Tensor:
    """``(q * scale) + offset`` in float32 as two operations, cast to
    ``dtype``. ``scale`` and ``offset`` are 0-d float32 tensors on the
    host; they enter as Python floats (exact: float32 values), so no
    copy to the card waits for the work queued there."""
    val = q.to(torch.float32)
    val.mul_(float(scale))
    val.add_(float(offset))
    return val.to(dtype)


def dequantize_batch(qts: Sequence[QuantizedTensor],
                     received: Sequence[int | None] | None = None, *,
                     constants: tuple | None = None) -> list[torch.Tensor]:
    """Eq. (5) for many tensors, byte-identical per tensor to
    :func:`dequantize`. ``constants`` takes a cached
    :func:`dequant_constants` result (lo, hi and bits never change after
    quantization)."""
    if not qts:
        return []
    if received is None:
        received = [None] * len(qts)
    bits_seq = [qt.bits for qt in qts]
    if constants is None:
        constants = dequant_constants([qt.lo for qt in qts], [qt.hi for qt in qts],
                                      bits_seq)
    offs = dequant_offsets(constants, bits_seq, received)
    return [_affine(qt.q, constants[2][i], offs[i], qt.orig_dtype)
            for i, qt in enumerate(qts)]


def dequantize_buffers(buffers: Mapping[str, torch.Tensor],
                       specs: Sequence[tuple[str, int, int, tuple]],
                       bits_seq: Sequence[int], received: Sequence[int | None],
                       dtypes: Sequence, *, constants: tuple) -> list[torch.Tensor]:
    """:func:`dequantize_batch` over flat spans of shared container
    buffers (the PlaneStore layout): each ``specs`` entry is
    ``(container_dtype_name, offset, size, shape)``; the spans are views,
    so nothing waits for a plane OR still in flight on the card."""
    if not specs:
        return []
    offs = dequant_offsets(constants, bits_seq, received)
    out = []
    for i, (dt, off, size, shape) in enumerate(specs):
        q = buffers[dt][off:off + size].reshape(shape)
        out.append(_affine(q, constants[2][i], offs[i], dtypes[i]))
    return out


def truncate(qt: QuantizedTensor, m: int) -> QuantizedTensor:
    """Keep only the m most significant bits of q (what a receiver holds
    after the first planes totalling m bits): the oracle the truncated
    views are held to (``(q >> s) << s``, ``kernels.ref.mask_q``)."""
    if not (0 <= m <= qt.bits):
        raise ValueError(f"m={m} outside [0, {qt.bits}]")
    return dataclasses.replace(qt, q=mask_q(qt.q, m, qt.bits))
