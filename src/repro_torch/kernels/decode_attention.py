"""Ragged batched flash decode-attention (one new token per slot).

Replaces ``src/repro/kernels/decode_attention.py`` ``flash_decode`` (the
Pallas ``_kernel``) with the CUDA kernel in ``csrc/decode_attention.cu``.
The cache arrives in the native ``(B, Kh, S, hd)`` layout the model keeps
it in, so the wrapper neither transposes nor pads.

Bound on the H100: device-memory bytes. Decode reads all of K and V once
per token while the arithmetic is a rank-1 sliver per key. The kernel
runs one block per (slot, kv-head), reads every cache row once with
coalesced loads and keeps the online-softmax state in registers. With
B*Kh blocks it fills at most B*Kh of the 132 SMs; splitting S across
blocks is left for later.

q is scaled by hd**-0.5 inside (callers pass it unscaled), masked scores
are -1e30 and the denominator is guarded by 1e-30, so a free slot
(``q_pos < 0``) comes out finite, as in the reference.

A tensor on the CPU takes the plain version (``ref.flash_decode_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GMAX, HD_MAX = 8, 256

# Launches of the CUDA kernel; the CPU path does not count.
launches = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_pos: torch.Tensor, q_pos: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, hd); k/v (B, Kh, S, hd); k_pos (B, S) int32; q_pos (B,)
    int32. Returns (B, H, hd) in q's dtype."""
    global launches
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, hd = q.shape
    _, Kh, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    if k_pos.shape != (B, S) or q_pos.shape != (B,):
        raise ValueError(f"k_pos {tuple(k_pos.shape)} / q_pos {tuple(q_pos.shape)} "
                         f"do not match B={B}, S={S}")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, k_pos, q_pos, window=window,
                                softcap=softcap).to(q.dtype)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, k_pos, q_pos)):
        raise ValueError("q, k, v, k_pos and q_pos must lie on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("k_pos and q_pos must be int32")
    if H // Kh > GMAX or hd > HD_MAX:
        raise ValueError(f"kernel takes at most {GMAX} query heads per kv head and "
                         f"hd <= {HD_MAX}, got {H // Kh} and {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and q_pos.is_contiguous()):
        raise ValueError("q, k, v and q_pos must be contiguous")
    out = torch.empty_like(q)
    fn = build.library("decode_attention").flash_decode
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
              k_pos.stride(0), k_pos.stride(1), q_pos.data_ptr(), out.data_ptr(),
              B, H, Kh, S, hd, int(window), float(softcap), float(hd ** -0.5),
              DTYPES[q.dtype], build.stream_handle(dev))
    build.check(code, "flash_decode")
    launches += 1
    return out
