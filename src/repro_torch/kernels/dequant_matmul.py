"""Fused dequantize-matmul: ``y = x @ (scale * q + offset)``.

Replaces ``src/repro/kernels/dequant_matmul.py`` ``dequant_matmul`` (the
Pallas ``_kernel``) with the CUDA kernels in ``csrc/dequant_matmul.cu``.
The weights stay in device memory as the receiver's uint accumulators and
eq. (5) is applied in registers on the way into the product, so no float
weight buffer exists.

Bound on the H100: at decode M is the batch (1-16) and the product does
2M operations per weight element, far below the card's ratio of
operations to bytes, so the time is the bytes of q over the memory rate.
The kernels read every element of q once with 8- or 16-byte loads and
cut K into chunks when the column tiles alone cannot fill the 132 SMs;
the chunks' partial sums are added in a fixed order. The tied
unembedding passes ``embed.T``, a transposed view whose K axis is
contiguous: it goes to a warp-per-column kernel that reads the view in
place, never a ``.contiguous()`` copy.

Rounding: the kernels form each weight as two separately rounded float32
operations, ``q * scale`` then ``+ offset`` (no fused multiply-add), as
the plain version does; only the order of the float32 sum over K differs,
so the two agree to a tolerance, not bit for bit.

A tensor on the CPU takes the plain version (``ref.dequant_matmul_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dequant_matmul_ref

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_DTYPES = (torch.uint8, torch.uint16, torch.uint32)
MT = 4          # rows of x per block of the column kernel (csrc MT)

# Launches of the CUDA kernel; the CPU path does not count.
launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_splits(M: int, K: int, N: int, q_bytes: int, sms: int) -> int:
    """Chunks of K for the column kernel: enough blocks for two per SM,
    with at least 64 rows of K per chunk."""
    cols = 32 * (8 if q_bytes == 1 else 16 // q_bytes)
    blocks = -(-N // cols) * -(-M // MT)
    want = -(-2 * sms // blocks)
    return max(1, min(want, K // 64))


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float32 or bfloat16; q: (K, N) uint8/16/32, any strides;
    scale, offset: float32 with one element each. Returns float32 (M, N)."""
    global launches
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(q.shape)} do not chain")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"q must be uint8/16/32, got {q.dtype}")
    if scale.numel() != 1 or offset.numel() != 1:
        raise ValueError("scale and offset must hold one element each")
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale, offset)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (q, scale, offset)):
        raise ValueError(f"x, q, scale and offset must lie on one CUDA device, got "
                         f"{x.device}, {q.device}, {scale.device}, {offset.device}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale and offset must be float32")
    M, K = x.shape
    N = q.shape[1]
    x = x.contiguous()   # (M, K) activations: a no-op on the model's path
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if q.stride(0) == 1 and K > 1:
        ksplit, part = 1, out           # K-contiguous view: no K chunks
    else:
        ksplit = k_splits(M, K, N, q.element_size(), _sm_count(dev.index or 0))
        k_chunk = -(-K // ksplit)
        ksplit = -(-K // k_chunk)
        part = (torch.empty((ksplit, M, N), dtype=torch.float32, device=dev)
                if ksplit > 1 else out)
    fn = build.library("dequant_matmul").dequant_matmul
    code = fn(x.data_ptr(), X_DTYPES[x.dtype], q.data_ptr(), q.element_size(),
              q.stride(0), q.stride(1), scale.data_ptr(), offset.data_ptr(),
              part.data_ptr(), out.data_ptr(), M, K, N, ksplit,
              build.stream_handle(dev))
    build.check(code, "dequant_matmul")
    launches += 1
    return out
