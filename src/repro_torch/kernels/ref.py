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


_SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16, torch.uint32: torch.int32}


def plane_or_ref(acc: torch.Tensor, plane: torch.Tensor, shift) -> torch.Tensor:
    """Eq. (4): ``acc | (plane << shift)`` in acc's container dtype.
    ``shift`` is an int or an integer tensor broadcastable against acc;
    plane may be any uint dtype. Shifts wrap, as the reference's uint32
    shift does: only the low bits that fit acc's dtype are kept. A plane
    no wider than acc is shifted in acc's width through signed views (a
    signed shift wraps as an unsigned one does; a shift past the width
    keeps nothing), a wider one in int32 or int64."""
    if plane.element_size() <= acc.element_size():
        width, signed = 8 * acc.element_size(), _SIGNED[acc.dtype]
        p = plane.view(signed) if plane.element_size() == acc.element_size() \
            else plane.to(signed)
        if isinstance(shift, torch.Tensor):
            shift = shift.to(acc.device)
            p = torch.where(shift < width, p << torch.clamp(shift, max=width - 1).to(signed), 0)
        elif shift < width:
            p = p << shift
        else:
            return acc.clone()
        return (acc.view(signed) | p).view(acc.dtype)
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
    return plane_or_ref(acc.reshape(-1, block), plane.reshape(-1, block),
                        shifts[:, None]).reshape(-1)


def mask_q(q: torch.Tensor, keep, bits: int | None = None) -> torch.Tensor:
    """A truncated view's deferred plane mask: ``(q >> s) << s`` with
    ``s = bits - keep``, in q's container dtype; ``bits`` defaults to
    the container's width and ``keep`` (an int or an integer tensor
    broadcastable against q) None means no mask. The shift widens to
    int32 (int64 for uint32), so a shift by the full width gives 0, as
    XLA's does."""
    if keep is None:
        return q
    bits = 8 * q.element_size() if bits is None else bits
    wide = torch.int32 if q.element_size() <= 2 else torch.int64
    if isinstance(keep, torch.Tensor):
        keep = keep.to(device=q.device, dtype=wide)
    shift = bits - keep
    return ((q.to(wide) >> shift) << shift).to(q.dtype)


def dequant_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       offset: torch.Tensor, keep=None, *, bits: int | None = None
                       ) -> torch.Tensor:
    """y = x @ (scale * mask(q) + offset). x: (M, K) float; q: (K, N) uint;
    scale and offset are float32 with one element each; ``keep`` masks q
    to its top ``keep`` of ``bits`` bits (:func:`mask_q`). Returns
    float32."""
    q = mask_q(q, None if keep is None else keep.reshape(()), bits)
    # the affine in place on the one float32 copy: the same roundings as
    # out of place, without two more weight-sized temporaries
    w = q.to(torch.float32, copy=True)
    w.mul_(scale.to(torch.float32).reshape(())).add_(offset.to(torch.float32).reshape(()))
    return x.to(torch.float32) @ w


def sharded_dequant_matmul_ref(x: torch.Tensor, shards, scales, offsets, keeps=None, *,
                               bits: int | None = None) -> torch.Tensor:
    """The plain version of ``ops.sharded_dequant_matmul``: q split on N
    into ``shards`` ((K, N_j) each), one :func:`dequant_matmul_ref` a
    shard on x with that shard's scale, offset and keep (equal values on
    every shard: the whole weight's affine and mask), and the outputs
    concatenated along N on x's device."""
    keeps = [None] * len(shards) if keeps is None else keeps
    return torch.cat([dequant_matmul_ref(x.to(q.device), q, s, o, k, bits=bits).to(x.device)
                      for q, s, o, k in zip(shards, scales, offsets, keeps)], dim=1)


def dequant_matmul_split_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             offset: torch.Tensor, *, depth: int = 16) -> torch.Tensor:
    """The tensor-core route's arithmetic (``csrc/dequant_matmul_mma.cu``)
    emulated on the CPU, for the tests: q centred on c, the accumulator
    value whose weight is nearest 0, and split into bf16-exact byte planes
    (``q - c = 256*h + l``; uint8 keeps ``q - c``); float32 x split into
    three bf16 terms, bfloat16 x kept; products exact, sums in float32 in
    ``depth``-deep steps (an mma's K); then
    ``y = scale * (256*A_h + A_l) + (offset + scale*c) * sum_k x``.
    uint8/16 q only, as the kernel."""
    s = scale.to(torch.float32).reshape(())
    o = offset.to(torch.float32).reshape(())
    top = 255 if q.element_size() == 1 else 65535
    cf = torch.clamp(torch.round(-o / s), 0, top)
    d = (s.double() * cf.double() + o.double()).float()      # one fused multiply-add
    c, v = int(cf), q.to(torch.int64)
    planes = ([v - c] if q.element_size() == 1
              else [(v >> 8) - (c >> 8), (v & 255) - (c & 255)])
    xf = x.to(torch.float32)
    terms = [xf]
    if x.dtype == torch.float32:
        terms = []
        for _ in range(3):
            t = xf.to(torch.bfloat16).to(torch.float32)
            terms.append(t)
            xf = xf - t
    sums = []
    for p in planes:
        pd = p.double()
        acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32)
        for k0 in range(0, x.shape[1], depth):
            step = sum(t[:, k0:k0 + depth].double() @ pd[k0:k0 + depth] for t in terms)
            acc = acc + step.float()
        sums.append(acc)
    a = sums[0] if len(sums) == 1 else (256.0 * sums[0].double() + sums[1].double()).float()
    bias = (d * x.to(torch.float32).sum(dim=1, keepdim=True)).float()
    return (s.double() * a.double() + bias.double()).float()


def dequant_matmul_gemv_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                            offset: torch.Tensor, keep=None, *, bits: int | None = None,
                            n_split: int | None = None) -> torch.Tensor:
    """The GEMV route's one-pass arithmetic (``csrc/dequant_matmul.cu``)
    emulated on the CPU, for the tests: q centred on c (as the tensor-core
    route), ``q - c`` exact; K cut into the kernel's chunks
    (``dequant_matmul.gemv_k_chunk``); in a chunk each thread's rows added
    in K order by fused multiply-adds (taken in float64 and rounded once
    to float32: the products are exact there), then (K, N) q's rows of a
    warp by an xor butterfly and the 8 warps in order, K-contiguous q's 32
    lanes by a butterfly; the chunks in order; the row sums of x in the
    kernel's units and order; then
    ``y = fma(scale, A, (offset + scale*c) * sum_k x)``. uint8/16 q only;
    ``keep`` masks q first (:func:`mask_q`), as the kernel does before it
    centres q. Rows are independent of M, as the kernel's; the chunks are
    chosen for ``n_split`` columns (default N), as the kernel's."""
    from repro_torch.kernels.dequant_matmul import GEMV_COLS, gemv_k_chunk

    s = scale.to(torch.float32).reshape(())
    o = offset.to(torch.float32).reshape(())
    top = 255 if q.element_size() == 1 else 65535
    cf = torch.clamp(torch.round(-o / s), 0, top)
    d = (s.double() * cf.double() + o.double()).float()      # one fused multiply-add
    (M, K), N = x.shape, q.shape[1]
    kc = q.stride(0) == 1 and K > 1
    q = mask_q(q, None if keep is None else keep.reshape(()), bits)   # kc: q's own layout
    chunk = gemv_k_chunk(K, N if n_split is None else n_split, kc)
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, -(-K // chunk) * chunk - K))
    wq = torch.nn.functional.pad((q.to(torch.int64) - int(cf)).to(torch.float32),
                                 (0, 0, 0, xf.shape[1] - K))

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    def butterfly(v, masks):   # lanes on the last axis; lane l adds lane l ^ o
        idx = torch.arange(v.shape[-1])
        for m in masks:
            v = v + v[..., idx ^ m]
        return v[..., 0]

    def in_order(v):           # v[:, 0] + v[:, 1] + ... in float32
        total = v[:, 0]
        for i in range(1, v.shape[1]):
            total = total + v[:, i]
        return total

    acc_total = sx_total = None
    for k0 in range(0, xf.shape[1], chunk):
        xc, wc = xf[:, k0:k0 + chunk], wq[k0:k0 + chunk]
        # row sums: thread t adds units t, t + 256, ... of 8 values in order
        units = xc.reshape(M, chunk // 8, 8)
        units = torch.nn.functional.pad(units, (0, 0, 0, -(-chunk // 2048) * 256 - chunk // 8))
        units = units.reshape(M, -1, 256, 8)
        sx = torch.zeros((M, 256), dtype=torch.float32)
        for i in range(units.shape[1]):
            for j in range(8):
                sx = sx + units[:, i, :, j]
        sx = in_order(butterfly(sx.reshape(M, 8, 32), (16, 8, 4, 2, 1)))
        if kc:   # lane l: values 8 l .. 8 l + 7 of every 256
            xs, ws = xc.reshape(M, -1, 32, 8), wc.reshape(-1, 32, 8, N)
            acc = torch.zeros((M, 32, N), dtype=torch.float32)
            for t in range(xs.shape[1]):
                for j in range(8):
                    acc = fma(xs[:, t, :, j, None], ws[None, t, :, j], acc)
            part = butterfly(acc.transpose(1, 2), (16, 8, 4, 2, 1))
        else:    # row r = rpw w + l // (GEMV_COLS / 8) of every 8 rpw
            rpw = 256 // GEMV_COLS
            xs, ws = xc.reshape(M, -1, 8 * rpw), wc.reshape(-1, 8 * rpw, N)
            acc = torch.zeros((M, 8 * rpw, N), dtype=torch.float32)
            for step in range(xs.shape[1]):
                acc = fma(xs[:, step, :, None], ws[None, step], acc)
            masks = [1 << i for i in range(rpw.bit_length() - 1)]
            part = in_order(butterfly(acc.reshape(M, 8, rpw, N).transpose(2, 3), masks))
        acc_total = part if acc_total is None else acc_total + part
        sx_total = sx if sx_total is None else sx_total + sx
    return fma(s, acc_total, (d * sx_total)[:, None])


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
