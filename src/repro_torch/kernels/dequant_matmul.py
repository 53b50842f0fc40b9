"""Fused dequantize-matmul: ``y = x @ (scale * q + offset)``.

Replaces ``src/repro/kernels/dequant_matmul.py`` ``dequant_matmul`` (the
Pallas ``_kernel``) with two hand-written CUDA kernels, chosen by the
number of rows M of x. The weights stay in device memory as the
receiver's uint accumulators and eq. (5) is applied on the way into the
product, so no float weight buffer exists. Both read q in place in the
model's two layouts: (K, N) slices of the stacked layer weights and the
tied unembedding's ``embed.T``, a transposed view whose K axis is
contiguous (never a ``.contiguous()`` copy).

- ``gemv`` (``csrc/dequant_matmul.cu``), below ``MMA_MIN_M`` rows (16)
  of (K, N) q, and for uint32 containers: decoding at M = 1-8 does 2M
  operations per weight element and is bound by the bytes of q; float32
  FMAs on the CUDA cores, a split-K column kernel for (K, N) and a
  warp-per-column kernel for the K-contiguous view. Each weight is
  formed as two separately rounded float32 operations, ``q * scale``
  then ``+ offset``, as the plain version does.
- ``mma`` (``csrc/dequant_matmul_mma.cu``) from ``MMA_MIN_M`` rows of
  (K, N) q, and at every M on the K-contiguous ``embed.T``, for uint8/16
  containers: the pool's chunk tick (M = 64), the prefill (M = 256) and
  the unembedding. The centred accumulator
  ``q - c`` is split into bf16-exact byte planes, x into one (bfloat16)
  or three (float32) bf16 terms, and the products run on the tensor
  cores with float32 accumulation; the source note gives the rounding
  and why q is centred.

Each route cuts K into chunks by M, K, N and the SM count (the
tensor-core kernel in its C launcher) and adds their partial sums in a
fixed order, so a launch is deterministic; but a row's result depends
on M (the route and the chunking), so a row is not bit-equal to the same
row computed in a launch of another M.

A tensor on the CPU takes the plain version (``ref.dequant_matmul_ref``);
a CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dequant_matmul_ref

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_DTYPES = (torch.uint8, torch.uint16, torch.uint32)
MT = 4          # rows of x per block of the GEMV column kernel (csrc MT)
# Rows from which the tensor-core kernel runs on uint8/16 (K, N) q with N
# contiguous, set by timing both kernels on the H100 at M = 1-256
# (PERF.md). Below it, and for uint32 q, the GEMV kernel runs. On the
# K-contiguous view (embed.T) the tensor-core kernel runs at every M: the
# warp-per-column GEMV is no faster there from M = 1 on.
MMA_MIN_M = 16

# Launches of the CUDA kernels, in all and by route; the CPU path does
# not count.
launches = 0
launches_by_route = {"gemv": 0, "mma": 0}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(M: int, q_dtype: torch.dtype, k_contiguous: bool = False) -> str:
    """The kernel a CUDA launch of M rows takes over a ``q_dtype``
    container, K-contiguous (``embed.T``) or not."""
    if q_dtype == torch.uint32:
        return "gemv"
    return "mma" if k_contiguous or M >= MMA_MIN_M else "gemv"


def k_splits(M: int, K: int, N: int, q_bytes: int, sms: int) -> int:
    """Chunks of K for the GEMV column kernel: enough blocks for two per
    SM, with at least 64 rows of K per chunk."""
    cols = 32 * (8 if q_bytes == 1 else 16 // q_bytes)
    blocks = -(-N // cols) * -(-M // MT)
    want = -(-2 * sms // blocks)
    return max(1, min(want, K // 64))


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float32 or bfloat16; q: (K, N) uint8/16/32, any strides;
    scale, offset: float32 with one element each. Returns float32 (M, N),
    from the route :func:`route` picks by M on a CUDA tensor."""
    _check_shapes(x, q, scale, offset)
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale, offset)
    if route(x.shape[0], q.dtype, _k_contiguous(q)) == "mma":
        return _launch_mma(x, q, scale, offset)
    return _launch_gemv(x, q, scale, offset)


def _check_shapes(x, q, scale, offset) -> None:
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(q.shape)} do not chain")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"q must be uint8/16/32, got {q.dtype}")
    if scale.numel() != 1 or offset.numel() != 1:
        raise ValueError("scale and offset must hold one element each")


def _k_contiguous(q: torch.Tensor) -> bool:
    return q.stride(0) == 1 and q.shape[0] > 1


def _operands(x, q, scale, offset):
    """The checks and arguments both CUDA launches share: contiguous x
    (the caller holds it until the launch is queued), the float32 output,
    the kernels' leading arguments and the SM count."""
    _check_shapes(x, q, scale, offset)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (q, scale, offset)):
        raise ValueError(f"x, q, scale and offset must lie on one CUDA device, got "
                         f"{x.device}, {q.device}, {scale.device}, {offset.device}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale and offset must be float32")
    x = x.contiguous()   # (M, K) activations: a no-op on the model's path
    out = torch.empty((x.shape[0], q.shape[1]), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), X_DTYPES[x.dtype], q.data_ptr(), q.element_size(), q.stride(0),
            q.stride(1), scale.data_ptr(), offset.data_ptr())
    return x, out, args, _sm_count(dev.index or 0)


def _counted(kind: str, code: int, out: torch.Tensor) -> torch.Tensor:
    global launches
    build.check(code, f"dequant_matmul ({kind})")
    launches += 1
    launches_by_route[kind] += 1
    return out


def _launch_gemv(x, q, scale, offset) -> torch.Tensor:
    """The CUDA-core kernel at any M (the tests and the card's timing
    call it directly to hold both routes at every M)."""
    x, out, args, sms = _operands(x, q, scale, offset)
    (M, K), N = x.shape, q.shape[1]
    if _k_contiguous(q):
        ksplit = 1                  # the warp-per-column kernel: no K chunks
    else:
        ksplit = k_splits(M, K, N, q.element_size(), sms)
        ksplit = -(-K // -(-K // ksplit))
    part = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
            if ksplit > 1 else out)
    code = build.library("dequant_matmul").dequant_matmul(
        *args, part.data_ptr(), out.data_ptr(), M, K, N, ksplit, build.stream_handle(x.device))
    return _counted("gemv", code, out)


def _launch_mma(x, q, scale, offset) -> torch.Tensor:
    """The tensor-core kernel at any M, for uint8/16 q."""
    if q.dtype == torch.uint32:
        raise ValueError("no tensor-core kernel for uint32 q")
    x, out, args, sms = _operands(x, q, scale, offset)
    (M, K), N = x.shape, q.shape[1]
    code = build.library("dequant_matmul_mma").dequant_matmul_mma(
        *args, out.data_ptr(), M, K, N, sms, build.stream_handle(x.device))
    return _counted("mma", code, out)
