"""Plain PyTorch versions of the hand-written kernels.

Each function is the definition of its kernel in plain tensor ops: the
kernel wrappers run it for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the CUDA kernels against it. Counterpart of
``src/repro/kernels/ref.py``.

PyTorch has no ``<<`` for uint16/uint32 on the CPU, so the shifts widen
to int32 (uint8/16 containers) or int64 (uint32) and cast back to the
container dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def plane_or_ref(acc: torch.Tensor, plane: torch.Tensor, shift) -> torch.Tensor:
    """Eq. (4): ``acc | (plane << shift)`` in acc's container dtype.
    ``shift`` is an int or an integer tensor broadcastable against acc;
    plane may be any uint dtype. Shifts wrap, as the reference's uint32
    shift does: only the low bits that fit acc's dtype are kept."""
    wide = torch.int32 if acc.element_size() <= 2 else torch.int64
    if isinstance(shift, torch.Tensor):
        shift = shift.to(wide)
    out = acc.to(wide) | (plane.to(wide) << shift)
    return out.to(acc.dtype)


def plane_extract_ref(q: torch.Tensor, bits: int, before: int, width: int,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Eq. (3): ``((q << before) & (2^bits - 1)) >> (bits - width)``, the
    ``width``-bit plane that starts ``before`` bits below the top of a
    ``bits``-bit value, in ``out_dtype`` (default: q's dtype). The shift
    wraps as the reference's uint32 shift does; the mask keeps the low
    ``bits`` bits, so int32 holds every value when ``bits`` < 32."""
    wide = torch.int32 if bits < 32 else torch.int64
    plane = ((q.to(wide) << before) & (2 ** bits - 1)) >> (bits - width)
    return plane.to(q.dtype if out_dtype is None else out_dtype)


def plane_or_segments_ref(acc: torch.Tensor, plane: torch.Tensor,
                          shifts: torch.Tensor, block: int) -> torch.Tensor:
    """Eq. (4) over a flat buffer with one shift per ``block`` elements."""
    return plane_or_ref(acc, plane, shifts.repeat_interleave(block))


def dequant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor) -> torch.Tensor:
    """y = x @ (scale * q + offset). x: (M, K) float; q: (K, N) uint;
    scale and offset are float32 with one element each. Returns float32."""
    w = q.to(torch.float32) * scale.to(torch.float32).reshape(()) \
        + offset.to(torch.float32).reshape(())
    return x.to(torch.float32) @ w


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Ragged batched single-token GQA decode attention.

    q: (B, H, hd); k/v: (B, Kh, S, hd); k_pos: (B, S) int32 cache
    positions (negative = empty); q_pos: (B,) int32 query positions
    (negative = free slot: every key is masked). Returns float32
    (B, H, hd). q is scaled by hd**-0.5 here."""
    B, H, hd = q.shape
    Kh = k.shape[1]
    G = H // Kh
    qf = q.reshape(B, Kh, G, hd).to(torch.float32) * (hd ** -0.5)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.to(torch.float32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = q_pos.reshape(B, 1)
    valid = (k_pos >= 0) & (k_pos <= qp)
    if window:
        valid = valid & (k_pos > qp - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.to(torch.float32))
    return o.reshape(B, H, hd)


def flash_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Ragged batched attention of T query rows per slot.

    q: (B, T, H, hd); k/v: (B, Kh, S, hd); k_pos: (B, S); q_pos: (B, T)
    int32 per-row query positions (negative = masked row). Returns
    float32 (B, T, H, hd).

    A loop of :func:`flash_decode_ref` over the T rows on purpose: each
    row is then exactly a decode step at that row's position, which is
    what makes chunked prefill and speculative verify equal to
    sequential decode row for row."""
    rows = [flash_decode_ref(q[:, t], k, v, k_pos, q_pos[:, t], window=window,
                             softcap=softcap) for t in range(q.shape[1])]
    return torch.stack(rows, dim=1)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                      window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Chunked-prefill attention: :func:`flash_verify_ref`'s operands and
    computation, with q_pos rows holding each slot's chunk offsets
    (slot b's row t is prompt position off_b + t, -1 past a short final
    chunk and for free or decoding slots)."""
    return flash_verify_ref(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
