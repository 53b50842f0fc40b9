"""Ragged batched flash verify-attention: T query tokens per slot.

Replaces ``src/repro/kernels/verify_attention.py`` ``flash_verify`` (the
Pallas ``_kernel``) with the CUDA kernel in ``csrc/verify_attention.cu``.
It serves the speculative verify block (``ops.verify_attention``) and the
chunked-prefill block of the slot pool (``ops.prefill_attention``): each
row carries its own position, and a negative position masks the row.

Bound on the H100: device-memory bytes. Each block reads its (slot,
kv-head) cache row once for a tile of up to 8 query rows, in 32-key
chunks that a copy warp stages through a ring in shared memory; a lane
of a compute warp scores one key against every row of the tile. q is
read and the output written in their (B, T, H, hd) layout through
strides, with no transpose or padding on the host. The kernel body is
the decode kernel's (``csrc/attention_rows.cuh``): a row's arithmetic
depends only on S, hd and the dtype, so every row is bit-identical to a
``flash_decode`` launch at that row's query and position.

A tensor on the CPU takes the plain version (``ref.flash_verify_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DTYPES, HD_MAX
from repro_torch.kernels.ref import flash_verify_ref

# Launches of the CUDA kernel; the CPU path does not count.
launches = 0


def flash_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_pos: torch.Tensor, q_pos: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B, T, H, hd); k/v (B, Kh, S, hd); k_pos (B, S) int32; q_pos
    (B, T) int32. Returns (B, T, H, hd) in q's dtype."""
    global launches
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, T, H, hd = q.shape
    _, Kh, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k.shape)}")
    if k_pos.shape != (B, S) or q_pos.shape != (B, T):
        raise ValueError(f"k_pos {tuple(k_pos.shape)} / q_pos {tuple(q_pos.shape)} "
                         f"do not match B={B}, T={T}, S={S}")
    if q.device.type == "cpu":
        return flash_verify_ref(q, k, v, k_pos, q_pos, window=window,
                                softcap=softcap).to(q.dtype)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, k_pos, q_pos)):
        raise ValueError("q, k, v, k_pos and q_pos must lie on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("k_pos and q_pos must be int32")
    if hd > HD_MAX:
        raise ValueError(f"kernel takes hd <= {HD_MAX}, got {hd}")
    if q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError("q's heads must be contiguous (strides (..., hd, 1))")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous")
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    fn = build.library("verify_attention").flash_verify
    code = fn(q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(),
              k_pos.data_ptr(), k_pos.stride(0), k_pos.stride(1), q_pos.data_ptr(),
              q_pos.stride(0), q_pos.stride(1), out.data_ptr(), B, T, H, Kh, S, hd,
              int(window), float(softcap), float(hd ** -0.5), DTYPES[q.dtype],
              build.stream_handle(dev))
    build.check(code, "flash_verify")
    launches += 1
    return out
