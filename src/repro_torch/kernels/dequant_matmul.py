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
  of uint8/16 q, and for uint32 containers at any M: decoding at M = 1-8
  does 2M operations per weight element and is bound by the bytes of q.
  Its one-pass kernels stage every row of x in one block, so q crosses
  device memory once a launch, and fix the chunks of K by K, N and the
  layout (:func:`gemv_k_chunk`), adding them in chunk order inside one
  thread block cluster; q is centred on the accumulator value whose
  weight is nearest 0 and the affine applied once a column. A row's
  result is therefore the same at every M, bit for bit. uint32 q, and q
  whose strides or alignment rule out 8-value vector loads, take PR 12's
  general kernels (:func:`one_pass` says which; ``launches_by_gemv_kernel``
  counts each).
- ``mma`` (``csrc/dequant_matmul_mma.cu``) from ``MMA_MIN_M`` rows of
  uint8/16 q, on both layouts: the pool's chunk tick (M = 64) and the
  prefill (M = 256). The centred accumulator
  ``q - c`` is split into bf16-exact byte planes, x into one (bfloat16)
  or three (float32) bf16 terms, and the products run on the tensor
  cores with float32 accumulation; the source note gives the rounding
  and why q is centred. It cuts K by M, K, N and the SM count (in its C
  launcher), so its rows depend on M.

Both routes add their chunks of K in a fixed order, so a launch is
deterministic. Below ``MMA_MIN_M`` a row's result does not depend on M;
from there on it does (the route switch and the tensor-core chunking),
so a row is not bit-equal to the same row launched at M < 16.
``rows="decode"`` sends a launch to the GEMV route at any M, whose rows
never depend on M: ``Model.decode_step`` and ``Model.verify_step`` use
it, so that each verify row equals the decode step of its token bit for
bit.

Both routes also choose their chunks of K by N. ``n_split`` (default:
q's own N) is the N that rule reads: a shard of a weight split on N
(``ops.sharded_dequant_matmul``, the reference's ``kernels/ops.py:76``)
passes the whole weight's N, so its columns are summed over K in the
unsharded launch's order and come out bit-equal to it. With the default
every launch's arithmetic is what it was without the argument.

A truncated-precision view (``QuantizedTensor.truncate``) passes its
plane mask as an operand: ``keep``, a one-element int32 tensor on the
device, with the leaf's width ``bits``. Each kernel reads it once a
block and ANDs q with the mask ``~0 << (bits - keep)`` before it centres
q, so ``y = x @ (scale * ((q >> s) << s) + offset)`` with ``s = bits -
keep``, and no masked copy of q exists. Without ``keep``, or with
``keep == bits``, the kernels' arithmetic is the unmasked one, bit for
bit.

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
# Rows from which the tensor-core kernel runs on uint8/16 q, on both
# layouts, set by timing both kernels on the H100 at M = 1-256 (PERF.md).
# Below it, and for uint32 q, the GEMV kernel runs.
MMA_MIN_M = 16
# The one-pass GEMV kernels' chunks of K (csrc/dequant_matmul.cu): 32
# columns a (K, N) block, about GEMV_BLOCKS blocks a launch with at most
# GEMV_CLUSTER chunks (one thread block cluster: the H100 holds enough
# clusters of 2 at once, too few of 4) unless K needs more, chunks of a
# multiple of 512 rows up to 4096 ((K, N) q) or 2048 (K-contiguous q), at
# most GEMV_MAX_CHUNKS (the largest portable cluster: K up to 32,768, or
# 16,384 K-contiguous; every K up to 16,384 needs at most 4 chunks).
GEMV_COLS, GEMV_BLOCKS, GEMV_CLUSTER = 32, 128, 2
GEMV_MAX_CHUNK = {False: 4096, True: 2048}
GEMV_MAX_CHUNKS = 8

# ``rows`` of :func:`dequant_matmul`: the route by M, or GEMV at every M.
ROWS = ("any", "decode")

# Launches of the CUDA kernels, in all and by route, and the GEMV route's
# by kernel; the CPU path does not count.
launches = 0
launches_by_route = {"gemv": 0, "mma": 0}
launches_by_gemv_kernel = {"one_pass": 0, "general": 0}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(M: int, q_dtype: torch.dtype) -> str:
    """The kernel a CUDA launch of M rows takes over a ``q_dtype``
    container, in either layout."""
    if q_dtype == torch.uint32:
        return "gemv"
    return "mma" if M >= MMA_MIN_M else "gemv"


def gemv_k_chunk(K: int, N: int, k_contiguous: bool) -> int | None:
    """Rows of K a block of the one-pass GEMV kernels sums (see
    ``GEMV_COLS``): a function of K, N and the layout only, so a row's
    sum order never depends on M. None where K needs more than
    ``GEMV_MAX_CHUNKS`` chunks."""
    want = 1
    if not k_contiguous:
        want = max(1, min(GEMV_CLUSTER, GEMV_BLOCKS // -(-N // GEMV_COLS), K // 512))
    want = max(want, -(-K // GEMV_MAX_CHUNK[k_contiguous]))
    if want > GEMV_MAX_CHUNKS:
        return None
    rows = -(-K // want)
    return -(-rows // 512) * 512


def one_pass(q: torch.Tensor, n_split: int | None = None) -> bool:
    """Whether the GEMV route runs q through its one-pass kernels: uint8/16
    q read with 8-value vector loads (N contiguous with N and the row
    stride multiples of 8, or K contiguous with K and the column stride
    multiples of 8; aligned to 8 values) and K within its chunks (chosen
    for ``n_split`` columns, default N). Not a function of M."""
    if q.dtype not in (torch.uint8, torch.uint16) or q.data_ptr() % (8 * q.element_size()):
        return False
    (K, N), kc = q.shape, _k_contiguous(q)
    if kc:
        vec = K % 8 == 0 and q.stride(1) % 8 == 0
    else:
        vec = q.stride(1) == 1 and N % 8 == 0 and q.stride(0) % 8 == 0
    return vec and gemv_k_chunk(K, N if n_split is None else n_split, kc) is not None


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, keep: torch.Tensor | None = None, *,
                   bits: int | None = None, rows: str = "any",
                   n_split: int | None = None) -> torch.Tensor:
    """x: (M, K) float32 or bfloat16; q: (K, N) uint8/16/32, any strides;
    scale, offset: float32 with one element each; ``keep``: None or an
    int32 with one element, the top bits of ``bits`` (default: q's
    container width) that q keeps. Returns float32 (M, N). On a CUDA
    tensor ``rows="any"`` takes the route :func:`route` picks by M,
    ``rows="decode"`` the GEMV route at every M; ``n_split`` (>= N,
    default N) is the N both routes cut K for."""
    bits = _check_shapes(x, q, scale, offset, keep, bits, n_split)
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale, offset, keep, bits=bits)
    if rows == "any" and route(x.shape[0], q.dtype) == "mma":
        return _launch_mma(x, q, scale, offset, keep, bits=bits, n_split=n_split)
    return _launch_gemv(x, q, scale, offset, keep, bits=bits, n_split=n_split)


def _check_shapes(x, q, scale, offset, keep=None, bits=None, n_split=None) -> int:
    """The operands' checks on every device; returns the width ``bits``."""
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(q.shape)} do not chain")
    if n_split is not None and n_split < q.shape[1]:
        raise ValueError(f"n_split={n_split} is below q's {q.shape[1]} columns")
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"q must be uint8/16/32, got {q.dtype}")
    if scale.numel() != 1 or offset.numel() != 1:
        raise ValueError("scale and offset must hold one element each")
    width = 8 * q.element_size()
    bits = width if bits is None else int(bits)
    if not 1 <= bits <= width:
        raise ValueError(f"bits={bits} outside [1, {width}] for {q.dtype}")
    if keep is not None and (keep.numel() != 1 or keep.dtype != torch.int32):
        raise ValueError("keep must be an int32 with one element")
    return bits


def _k_contiguous(q: torch.Tensor) -> bool:
    return q.stride(0) == 1 and q.shape[0] > 1


def _operands(x, q, scale, offset, keep, bits, n_split):
    """The checks and arguments both CUDA launches share: contiguous x
    (the caller holds it until the launch is queued), the float32 output,
    the kernels' leading arguments (``keep`` as a null pointer when
    absent) and the SM count."""
    bits = _check_shapes(x, q, scale, offset, keep, bits, n_split)
    dev = x.device
    tensors = (q, scale, offset) + (() if keep is None else (keep,))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"x, q, scale, offset and keep must lie on one CUDA device, got "
                         f"{x.device}, {[str(t.device) for t in tensors]}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale and offset must be float32")
    x = x.contiguous()   # (M, K) activations: a no-op on the model's path
    out = torch.empty((x.shape[0], q.shape[1]), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), X_DTYPES[x.dtype], q.data_ptr(), q.element_size(), q.stride(0),
            q.stride(1), scale.data_ptr(), offset.data_ptr(),
            None if keep is None else keep.data_ptr(), bits)
    return x, out, args, _sm_count(dev.index or 0)


def _counted(kind: str, code: int, out: torch.Tensor) -> torch.Tensor:
    global launches
    build.check(code, f"dequant_matmul ({kind})")
    launches += 1
    launches_by_route[kind] += 1
    return out


def _launch_gemv(x, q, scale, offset, keep=None, *, bits=None,
                 n_split: int | None = None) -> torch.Tensor:
    """The CUDA-core kernels at any M (the tests and the card's timing
    call it directly to hold both routes at every M)."""
    x, out, args, _ = _operands(x, q, scale, offset, keep, bits, n_split)
    (M, K), N = x.shape, q.shape[1]
    n_split = N if n_split is None else n_split
    lib, stream = build.library("dequant_matmul"), build.stream_handle(x.device)
    if one_pass(q, n_split):
        kc = _k_contiguous(q)
        code = lib.dequant_matmul_gemv(*args, out.data_ptr(), M, K, N, int(kc),
                                       gemv_k_chunk(K, n_split, kc), stream)
        kernel = "one_pass"
    else:
        code = lib.dequant_matmul_general(*args, out.data_ptr(), M, K, N, stream)
        kernel = "general"
    _counted("gemv", code, out)
    launches_by_gemv_kernel[kernel] += 1
    return out


def _launch_mma(x, q, scale, offset, keep=None, *, bits=None,
                n_split: int | None = None) -> torch.Tensor:
    """The tensor-core kernel at any M, for uint8/16 q."""
    if q.dtype == torch.uint32:
        raise ValueError("no tensor-core kernel for uint32 q")
    x, out, args, sms = _operands(x, q, scale, offset, keep, bits, n_split)
    (M, K), N = x.shape, q.shape[1]
    code = build.library("dequant_matmul_mma").dequant_matmul_mma(
        *args, out.data_ptr(), M, K, N, N if n_split is None else n_split, sms,
        build.stream_handle(x.device))
    return _counted("mma", code, out)
