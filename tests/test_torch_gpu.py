"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (sm_90a) and skips
without one. Run on the card with:

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: ``plane_or_segments``, ``plane_or`` and ``plane_extract``
exact; ``dequant_matmul`` within 1e-4 of the output's largest magnitude
on both routes (on both, q is centred and the products are exact or
rounded once, and the float32 sums over K round: see the source notes),
and every row of a GEMV launch below 16 rows ``torch.equal`` to the
same row launched alone;
``flash_decode`` and ``flash_verify`` within 2e-5 (float32) or 2**-7
(bfloat16 output rounding) of the output's largest magnitude; every ``flash_verify`` row exactly equal to a ``flash_decode``
launch for that row. Self-speculation: ``dequant_matmul`` with the plane
mask ``keep`` within the same 1e-4 of the plain version on the masked q,
bit-equal to the unmasked launch at a full-width keep; with
``rows="decode"`` every row at M = 5-72 equal to the row launched alone;
the norms' rows independent of their count; a verify step's logits and
caches equal to sequential decode steps, and speculative tokens equal to
plain greedy decoding, exactly. Mixture of experts: B2 at the router
(N = 8) and the expert slots, ``expert_dense`` on per-expert slot views
with per-expert masks within the same 1e-4, MoE verify rows equal to
decode steps exactly, and (sharded serving) a bank on 2 and 4 logical
shards equal to the unsharded bank exactly. Training: a train step's
loss and every leaf's gradient on the card within 1e-4 (relative to the
CPU's loss and to the leaf's largest |g|) of the CPU's on the same
float32 parameters and batch; the optimizer's update on the same
gradients within 1e-6; a progressive checkpoint saved on the card (B6)
byte-identical to the CPU's, and loaded through the client on the card
(B1 a stage) to ``quantize(leaf).q`` at stage 8.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import (bitplane, decode_attention, dequant_matmul, ref,
                                 verify_attention)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32])
@pytest.mark.parametrize("offset", [0, 3], ids=["aligned", "unaligned"])
def test_plane_or_segments_exact(dev, dtype, offset):
    """``unaligned`` passes views that start 3 elements into their
    buffers, which takes the kernel's element-wise path."""
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1024 * 9
    top = 2 ** (8 * torch.empty((), dtype=dtype).element_size() - 4)
    acc = torch.randint(0, top, (n + offset,), generator=g, device=dev).to(dtype)[offset:]
    plane = torch.randint(0, 4, (n + offset,), generator=g, device=dev).to(dtype)[offset:]
    shifts = torch.randint(0, 4, (n // 1024,), generator=g, device=dev, dtype=torch.int32)
    before = acc.clone()
    out = bitplane.plane_or_segments(acc, plane, shifts)
    assert torch.equal(out, ref.plane_or_segments_ref(acc, plane, shifts, 1024))
    assert torch.equal(acc, before)          # out of place


def _dqmm_operands(dev, M, K, N, qdtype, layout, xdtype, seed, xkind="randn"):
    """x (M, K) of ``xkind``: ``randn``, ``silu`` (SiLU of 2 randn) or
    ``relu3`` (relu(randn) + 3), the last two of large positive mean; q
    (K, N) of uniform ``qdtype`` values as ``kn`` (N contiguous),
    ``transposed`` (the view of an (N, K) table, as ``embed.T``) or
    ``strided`` (every other column)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = 256 if qdtype == torch.uint8 else 65536
    x = torch.randn((M, K), generator=g, device=dev)
    if xkind == "silu":
        x = torch.nn.functional.silu(2 * x)
    elif xkind == "relu3":
        x = torch.relu(x) + 3
    x = x.to(xdtype)
    if layout == "transposed":
        q = torch.randint(0, hi, (N, K), generator=g, device=dev).to(qdtype).T
    elif layout == "strided":
        q = torch.randint(0, hi, (K, 2 * N), generator=g, device=dev).to(qdtype)[:, ::2]
    else:
        q = torch.randint(0, hi, (K, N), generator=g, device=dev).to(qdtype)
    scale = torch.tensor([[3.0 / hi]], device=dev)
    offset = torch.tensor([[-1.4]], device=dev)
    return x, q, scale, offset


def _assert_dqmm_close(y, x, q, scale, offset):
    want = ref.dequant_matmul_ref(x, q, scale, offset)
    err = (y - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-6


# M = 16, 17, 64 and 256 take the tensor-core route (uint8/16 q); the rest
# and every uint32 q the GEMV route
@pytest.mark.parametrize("M,K,N", [(1, 64, 96), (4, 2048, 2048), (16, 300, 130),
                                   (256, 512, 512), (5, 8192, 64)]
                         + [(m, k, n) for m in (16, 17, 64, 256) for k in (300, 2048, 8192)
                            for n in (130, 2048)])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16, torch.uint32])
@pytest.mark.parametrize("layout", ["kn", "transposed", "strided"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul(dev, M, K, N, qdtype, layout, xdtype):
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, qdtype, layout, xdtype, M + K + N)
    _assert_dqmm_close(dequant_matmul.dequant_matmul(x, q, scale, offset), x, q, scale, offset)


@pytest.mark.parametrize("M,K,N", [(16, 8192, 2048), (64, 2048, 8192), (64, 8192, 2048),
                                   (256, 8192, 2048), (64, 2048, 50304)])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("layout", ["kn", "transposed"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xkind", ["silu", "relu3"])
def test_dequant_matmul_positive_mean(dev, M, K, N, qdtype, layout, xdtype, xkind):
    """Activations of large positive mean, where an uncentred split of q
    would cancel: the tensor-core route stays within 1e-4 of max |y|."""
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, qdtype, layout, xdtype, M + K, xkind)
    before = dequant_matmul.launches_by_route["mma"]
    y = dequant_matmul.dequant_matmul(x, q, scale, offset)
    assert dequant_matmul.launches_by_route["mma"] == before + 1
    _assert_dqmm_close(y, x, q, scale, offset)


@pytest.mark.parametrize("M", [1, 4, 8, 16, 64, 256])
@pytest.mark.parametrize("kernel", ["gemv", "mma"])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("layout", ["kn", "transposed", "strided"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_each_route(dev, M, kernel, qdtype, layout, xdtype):
    """Both kernels at every M the paths run, whichever route M picks."""
    x, q, scale, offset = _dqmm_operands(dev, M, 2048, 2048, qdtype, layout, xdtype, M,
                                         "relu3")
    launch = {"gemv": dequant_matmul._launch_gemv, "mma": dequant_matmul._launch_mma}[kernel]
    before = dict(dequant_matmul.launches_by_route)
    y = launch(x, q, scale, offset)
    assert dequant_matmul.launches_by_route[kernel] == before[kernel] + 1
    _assert_dqmm_close(y, x, q, scale, offset)


@pytest.mark.parametrize("kernel", ["gemv", "mma"])
@pytest.mark.parametrize("M", [4, 64])
def test_dequant_matmul_noncontiguous_x(dev, kernel, M):
    """x as a transposed view: the wrapper's contiguous copy lives until
    the kernel is queued, on either route."""
    x, q, scale, offset = _dqmm_operands(dev, M, 2048, 2048, torch.uint16, "kn",
                                         torch.float32, M)
    xt = x.T.contiguous().T
    assert not xt.is_contiguous()
    launch = {"gemv": dequant_matmul._launch_gemv, "mma": dequant_matmul._launch_mma}[kernel]
    _assert_dqmm_close(launch(xt, q, scale, offset), x, q, scale, offset)


def test_dequant_matmul_route_by_rows(dev):
    """M = 64 (the chunk tick) launches the tensor-core kernel, M = 4
    (decode) the GEMV kernel on both layouts, the K-contiguous view (the
    unembedding) at M = 1 too, and on the one-pass kernels; uint32 q the
    GEMV kernel at any M, on the general kernels; each launch counts once
    in all, once for its route and, on the GEMV route, once for its
    kernel."""
    for M, qdtype, layout, kind, gemv_kernel in [
            (64, torch.uint16, "kn", "mma", None),
            (64, torch.uint16, "transposed", "mma", None),
            (4, torch.uint16, "kn", "gemv", "one_pass"),
            (4, torch.uint16, "transposed", "gemv", "one_pass"),
            (1, torch.uint16, "transposed", "gemv", "one_pass"),
            (4, torch.uint16, "strided", "gemv", "general"),
            (64, torch.uint32, "kn", "gemv", "general")]:
        x, q, scale, offset = _dqmm_operands(dev, M, 512, 256, qdtype, layout, torch.bfloat16,
                                             1)
        assert dequant_matmul.route(M, qdtype) == kind
        before, by = dequant_matmul.launches, dict(dequant_matmul.launches_by_route)
        by_kernel = dict(dequant_matmul.launches_by_gemv_kernel)
        dequant_matmul.dequant_matmul(x, q, scale, offset)
        assert dequant_matmul.launches == before + 1
        assert dequant_matmul.launches_by_route == {**by, kind: by[kind] + 1}
        want = by_kernel if gemv_kernel is None else {
            **by_kernel, gemv_kernel: by_kernel[gemv_kernel] + 1}
        assert dequant_matmul.launches_by_gemv_kernel == want
    with pytest.raises(ValueError):
        dequant_matmul._launch_mma(x, q, scale, offset)


@pytest.mark.parametrize("K,N,layout", [(2048, 2048, "kn"), (8192, 2048, "kn"),
                                        (2048, 8192, "kn"), (2048, 4096, "transposed"),
                                        (8192, 512, "transposed"), (2100, 136, "kn"),
                                        (2104, 136, "transposed")])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_row_independent_of_M(dev, K, N, layout, qdtype, xdtype):
    """Below 16 rows the GEMV route's one-pass kernels fix the chunks of
    K and their order by K, N and the layout alone: every row of an M-row
    launch (M = 2-15) is ``torch.equal`` to that row launched alone, and
    a second launch repeats the first bit for bit."""
    x, q, scale, offset = _dqmm_operands(dev, 15, K, N, qdtype, layout, xdtype, K + N, "relu3")
    assert dequant_matmul.one_pass(q)
    alone = torch.cat([dequant_matmul.dequant_matmul(x[i:i + 1], q, scale, offset)
                       for i in range(15)])
    _assert_dqmm_close(alone, x, q, scale, offset)
    for M in range(2, 16):
        assert dequant_matmul.route(M, qdtype) == "gemv"
        y = dequant_matmul.dequant_matmul(x[:M], q, scale, offset)
        assert torch.equal(y, alone[:M]), M
        assert torch.equal(dequant_matmul.dequant_matmul(x[:M], q, scale, offset), y), M


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("K,N,layout", [(2048, 512, "kn"), (8192, 256, "kn"), (2100, 136, "kn"),
                                        (2048, 96, "transposed"), (4096, 72, "transposed"),
                                        (24576, 256, "kn"), (12288, 64, "transposed")])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
def test_dequant_matmul_gemv_equals_its_emulation(dev, M, K, N, layout, qdtype):
    """The one-pass kernels' sums are ``ref.dequant_matmul_gemv_ref``'s, bit
    for bit, with bfloat16 x (every product and fused multiply-add of the
    emulation is exact in float64 there): the chunks, the thread's K
    order, the butterflies and the warp and chunk order are the kernel's."""
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, qdtype, layout, torch.bfloat16, K + N,
                                         "relu3")
    y = dequant_matmul._launch_gemv(x, q, scale, offset)
    want = ref.dequant_matmul_gemv_ref(x.cpu(), q.cpu(), scale.cpu(), offset.cpu())
    assert torch.equal(y.cpu(), want)


# The one-pass kernels' edges: K not a multiple of its chunk (2100: chunks
# of 768), N not a multiple of a block's columns (136, 130), K below one
# chunk (72), K cut into the most chunks (16384: 8), the whole embed.T
# (N = 50304), and M past 16 (groups of 16 rows, one pass each)
@pytest.mark.parametrize("M,K,N,layout", [(4, 2100, 2048, "kn"), (8, 2048, 136, "kn"),
                                          (3, 72, 520, "kn"), (8, 16384, 64, "kn"),
                                          (5, 2104, 130, "transposed"),
                                          (8, 72, 520, "transposed"),
                                          (4, 2048, 50304, "transposed"),
                                          (8, 2048, 50304, "transposed"),
                                          (40, 2048, 2048, "kn"), (17, 2048, 200, "transposed")])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_one_pass_edges(dev, M, K, N, layout, qdtype, xdtype):
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, qdtype, layout, xdtype, M + K + N)
    assert dequant_matmul.one_pass(q)
    before = dequant_matmul.launches_by_gemv_kernel["one_pass"]
    y = dequant_matmul._launch_gemv(x, q, scale, offset)
    assert dequant_matmul.launches_by_gemv_kernel["one_pass"] == before + 1
    _assert_dqmm_close(y, x, q, scale, offset)


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("K,N,layout", [(2048, 2048, "kn"), (8192, 2048, "kn"),
                                        (2048, 8192, "kn"), (2048, 50304, "transposed")])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xkind", ["silu", "relu3"])
def test_dequant_matmul_gemv_positive_mean(dev, M, K, N, layout, qdtype, xdtype, xkind):
    """Activations of large positive mean at decode M on the GEMV route:
    q centred, the one-pass kernels stay within 1e-4 of max |y|."""
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, qdtype, layout, xdtype, M + K, xkind)
    before = dequant_matmul.launches_by_gemv_kernel["one_pass"]
    y = dequant_matmul.dequant_matmul(x, q, scale, offset)
    assert dequant_matmul.launches_by_gemv_kernel["one_pass"] == before + 1
    _assert_dqmm_close(y, x, q, scale, offset)


@pytest.mark.parametrize("M,K,N,layout", [(64, 8192, 2048, "kn"), (256, 2048, 2048, "kn"),
                                          (64, 2048, 50304, "transposed"),
                                          (4, 8192, 2048, "kn")])
def test_dequant_matmul_is_deterministic(dev, M, K, N, layout):
    """Two launches on the same operands are bit-identical: the K chunks'
    partial sums are added in a fixed order, without atomics."""
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, torch.uint16, layout, torch.float32, 7)
    a = dequant_matmul.dequant_matmul(x, q, scale, offset)
    b = dequant_matmul.dequant_matmul(x, q, scale, offset)
    assert torch.equal(a, b)


# Shapes at the edges of the attention body's design (csrc/attention_rows.cuh):
# S around one 32-key chunk (31, 32, 33) and one key (1); around 8 chunks,
# one a warp (255, 256, 257: a ninth goes back to warp 0); around the
# largest cache that stays resident in the bfloat16 ring at hd = 128 (416,
# 417: 13 chunks fit); and a cache that cycles through the ring (float32
# and bfloat16 at hd = 256, S = 1000). Their B = EDGE_B slots include one
# whose keys are all masked (k_pos = -1 throughout).
EDGE_B = 5
EDGE_S_HD = [(31, 128), (32, 128), (33, 128), (1, 128), (255, 64), (256, 64), (257, 64),
             (416, 128), (417, 128), (1000, 256)]
# the dense variants' heads: minitron-4b's 24 on 8 KV heads (G = 3) and
# starcoder2-15b's 48 on 4 (G = 12), hd 128, at the single stream's
# decode (B = 4), the pool's chunk (T = 8) and verify at k = 4 (T = 5);
# zamba2-7b's shared block, 32 heads on 32 (G = 1) at hd 112, whose rows
# (224 bytes in bfloat16) are not whole 128-byte lines: the copy warp
# stages them, not the tensor memory accelerator
NEW_ARCH_DECODE = [(4, 24, 8, 112, 128), (4, 48, 4, 112, 128), (8, 48, 4, 160, 128),
                   (4, 32, 32, 112, 112), (8, 32, 32, 160, 112)]
NEW_ARCH_VERIFY = [(8, 8, 24, 8, 160, 128), (8, 8, 48, 4, 160, 128), (4, 5, 24, 8, 112, 128),
                   (4, 5, 48, 4, 112, 128),
                   (8, 8, 32, 32, 160, 112), (4, 5, 32, 32, 112, 112)]


def _mask_edge_slot(k_pos):
    """In the edge shapes' batches, slot 2's keys are all masked."""
    if k_pos.shape[0] == EDGE_B:
        k_pos[2] = -1


@pytest.mark.parametrize("B,H,Kh,S,hd", [(4, 16, 16, 112, 128), (3, 8, 2, 50, 64),
                                         (2, 8, 1, 300, 256), (1, 4, 4, 7, 32),
                                         (2, 24, 2, 70, 16)] + NEW_ARCH_DECODE
                         + [(EDGE_B, 16, 16, S, hd) for S, hd in EDGE_S_HD])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode(dev, B, H, Kh, S, hd, window, softcap, dtype):
    g = torch.Generator(device=dev).manual_seed(B * S + hd)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    k_pos[0, S // 2:] = -1
    _mask_edge_slot(k_pos)
    q_pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    q_pos[-1] = -1 if B > 1 else S // 3
    out = decode_attention.flash_decode(q, k, v, k_pos, q_pos, window=window,
                                        softcap=softcap)
    want = ref.flash_decode_ref(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
    assert torch.isfinite(out).all()
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def test_wrappers_count_cuda_launches(dev):
    before = (bitplane.launches, dequant_matmul.launches, decode_attention.launches)
    acc = torch.zeros(1024, dtype=torch.uint16, device=dev)
    bitplane.plane_or_segments(acc, acc, torch.zeros(1, dtype=torch.int32, device=dev))
    dequant_matmul.dequant_matmul(torch.ones(2, 8, device=dev), acc[:32].view(8, 4),
                                  torch.ones(1, 1, device=dev), torch.ones(1, 1, device=dev))
    kv = torch.zeros(1, 1, 4, 8, device=dev)
    decode_attention.flash_decode(torch.zeros(1, 1, 8, device=dev), kv, kv,
                                  torch.arange(4, dtype=torch.int32, device=dev)[None],
                                  torch.tensor([3], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert (bitplane.launches, dequant_matmul.launches,
            decode_attention.launches) == tuple(b + 1 for b in before)


UINTS = (torch.uint8, torch.uint16, torch.uint32)


def _uint(g, dev, n, dtype, offset=0):
    """n random values of ``dtype`` starting ``offset`` elements into a
    buffer (an offset view takes the kernels' element-wise path)."""
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 2 ** bits, (n + offset,), generator=g, device=dev,
                        dtype=torch.int64)
    return raw.to(dtype)[offset:]


@pytest.mark.parametrize("acc_dtype", UINTS)
@pytest.mark.parametrize("plane_dtype", UINTS)
@pytest.mark.parametrize("n,offset", [(1_048_576, 0), (1961, 0), (5, 0), (4099, 3)],
                         ids=["aligned", "tail", "tiny", "unaligned"])
def test_plane_or_exact(dev, acc_dtype, plane_dtype, n, offset):
    g = torch.Generator(device=dev).manual_seed(n + offset)
    acc = _uint(g, dev, n, acc_dtype, offset)
    plane = _uint(g, dev, n, plane_dtype, offset)
    before = acc.clone()
    for shift in (0, 2, 14, 31):
        out = bitplane.plane_or(acc, plane, shift=shift)
        assert out.dtype == acc_dtype
        assert torch.equal(out, ref.plane_or_ref(acc, plane, shift))
    assert torch.equal(acc, before)          # out of place


@pytest.mark.parametrize("q_dtype", UINTS)
@pytest.mark.parametrize("out_dtype", UINTS)
@pytest.mark.parametrize("n,offset", [(1_048_576, 0), (1961, 0), (5, 0), (4099, 3)],
                         ids=["aligned", "tail", "tiny", "unaligned"])
def test_plane_extract_exact(dev, q_dtype, out_dtype, n, offset):
    g = torch.Generator(device=dev).manual_seed(n + offset + 1)
    q = _uint(g, dev, n, q_dtype, offset)
    bits = 8 * q.element_size()
    out_bits = 8 * torch.empty((), dtype=out_dtype).element_size()
    for before, width in ((0, 2), (bits - 2, 2), (1, min(bits - 1, out_bits)), (0, 1)):
        got = bitplane.plane_extract(q, bits=bits, before=before, width=width,
                                     out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, ref.plane_extract_ref(q, bits, before, width, out_dtype))


def test_bitplane_kernels_count_cuda_launches_and_reject_mixed_devices(dev):
    before = (bitplane.plane_or_launches, bitplane.plane_extract_launches)
    q = torch.arange(100, dtype=torch.int32, device=dev).to(torch.uint16)
    plane = bitplane.plane_extract(q, bits=16, before=14, width=2, out_dtype=torch.uint8)
    bitplane.plane_or(q, plane, shift=0)
    torch.cuda.synchronize()
    assert (bitplane.plane_or_launches, bitplane.plane_extract_launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):
        bitplane.plane_or(q, plane.cpu(), shift=0)
    with pytest.raises(ValueError):
        bitplane.plane_extract(q[::2], bits=16, before=0, width=2)


def test_split_and_concat_on_the_card(dev):
    """``bitplanes.split`` (eq. 3) and ``concat`` (eq. 4) of a CUDA tensor
    launch ``plane_extract`` and ``plane_or`` once a plane, and a full
    prefix of planes restores q."""
    from repro_torch.core import bitplanes
    from repro_torch.core.quantize import quantize

    qt = quantize(torch.randn((37, 301), generator=torch.Generator(device=dev).manual_seed(5),
                              device=dev), 16)
    widths = (4, 4, 8)
    before = (bitplane.plane_or_launches, bitplane.plane_extract_launches)
    planes = bitplanes.split(qt, widths)
    assert [p.dtype for p in planes] == [torch.uint8] * 3
    assert torch.equal(bitplanes.concat(planes, 16, widths), qt.q)
    top8 = ((qt.q.to(torch.int32) >> 8) << 8).to(torch.uint16)
    assert torch.equal(bitplanes.concat(planes[:2], 16, widths), top8)
    torch.cuda.synchronize()
    assert (bitplane.plane_or_launches, bitplane.plane_extract_launches) == \
        (before[0] + 5, before[1] + 3)


def test_mixed_devices_raise(dev):
    with pytest.raises(ValueError):
        bitplane.plane_or_segments(torch.zeros(1024, dtype=torch.uint16, device=dev),
                                   torch.zeros(1024, dtype=torch.uint16),
                                   torch.zeros(1, dtype=torch.int32, device=dev))


def _verify_operands(dev, B, T, H, Kh, S, hd, dtype, seed):
    """Slot 0 ends at the cache end; slot 1 (if any) is ragged, with empty
    cache entries past S // 2 and its last rows masked as past a short
    final chunk; the last slot (if B > 2) is free."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    q_pos = (torch.arange(T, dtype=torch.int32, device=dev) + (S - T)).repeat(B, 1)
    if B > 1:
        k_pos[1, S // 2:] = -1
        q_pos[1] = torch.arange(T, dtype=torch.int32, device=dev) + S // 4
        q_pos[1, max(1, T - 2):] = -1
    if B > 2:
        q_pos[-1] = -1
    _mask_edge_slot(k_pos)
    return q, k, v, k_pos, q_pos


# the edge shapes at the path's heads (8 rows a tile) and with GQA; and 5
# or 6 chunks (S = 150, 180, 190), whose last chunks warps 4-7 share by
# rows, at 2, 4 and 8 rows a tile
EDGE_VERIFY = ([(EDGE_B, 8, 16, 16, S, hd) for S, hd in EDGE_S_HD]
               + [(EDGE_B, 3, 8, 2, S, 64) for S in (1, 32, 33, 257)]
               + [(EDGE_B, 2, 16, 16, 150, 128), (EDGE_B, 4, 16, 16, 180, 128),
                  (EDGE_B, 8, 16, 16, 190, 128), (EDGE_B, 2, 8, 2, 150, 64)])


@pytest.mark.parametrize("B,T,H,Kh,S,hd", [(8, 8, 16, 16, 160, 128), (3, 5, 8, 2, 50, 64),
                                           (2, 8, 16, 2, 300, 256), (3, 1, 4, 4, 7, 32),
                                           (3, 3, 24, 2, 33, 16)] + EDGE_VERIFY
                         + NEW_ARCH_VERIFY)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_verify(dev, B, T, H, Kh, S, hd, window, softcap, dtype):
    """(3, 3, 24, 2, ...) has G = 12 query heads per kv head: a slot's 36
    rows span five tiles, each tile mixing tokens."""
    q, k, v, k_pos, q_pos = _verify_operands(dev, B, T, H, Kh, S, hd, dtype, B * S + hd)
    out = verify_attention.flash_verify(q, k, v, k_pos, q_pos, window=window,
                                        softcap=softcap)
    want = ref.flash_verify_ref(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
    assert out.shape == q.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,T,H,Kh,S,hd", [(8, 8, 16, 16, 160, 128), (3, 5, 8, 2, 50, 64),
                                           (3, 3, 24, 2, 33, 16)] + EDGE_VERIFY
                         + NEW_ARCH_VERIFY)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 25.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_verify_rows_equal_flash_decode(dev, B, T, H, Kh, S, hd, window, softcap,
                                              dtype):
    """Bit for bit: each verify row is a decode step at its position."""
    q, k, v, k_pos, q_pos = _verify_operands(dev, B, T, H, Kh, S, hd, dtype, S + T)
    out = verify_attention.flash_verify(q, k, v, k_pos, q_pos, window=window,
                                        softcap=softcap)
    for t in range(T):
        row = decode_attention.flash_decode(q[:, t].contiguous(), k, v, k_pos,
                                            q_pos[:, t].contiguous(), window=window,
                                            softcap=softcap)
        assert torch.equal(out[:, t], row), f"row {t}"


@pytest.mark.parametrize("kernel", ["decode", "verify"])
@pytest.mark.parametrize("S,hd", [(160, 128), (417, 128), (1000, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_row_independent_of_batch(dev, kernel, S, hd, dtype):
    """One slot's output is the same bits launched alone (B = 1) and as
    slot 3 of 8 (other slots ragged, masked and free), and a second launch
    of the same operands repeats the first bit for bit."""
    T = 1 if kernel == "decode" else 8
    q, k, v, k_pos, q_pos = _verify_operands(dev, 8, T, 16, 16, S, hd, dtype, S + hd)
    q_pos[3] = torch.arange(T, dtype=torch.int32, device=dev) + S // 2
    k_pos[3, S - 3:] = -1

    def run(*ops):
        if kernel == "decode":
            qq, kk, vv, kp, qp = ops
            return decode_attention.flash_decode(qq[:, 0].contiguous(), kk, vv, kp,
                                                 qp[:, 0].contiguous())[:, None]
        return verify_attention.flash_verify(*ops)

    batch = run(q, k, v, k_pos, q_pos)
    alone = run(*(t[3:4].contiguous() for t in (q, k, v, k_pos, q_pos)))
    assert torch.equal(batch[3:4], alone)
    assert torch.equal(run(q, k, v, k_pos, q_pos), batch)


@pytest.mark.parametrize("B,H,Kh,hd", [(4, 32, 16, 128), (3, 8, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_on_wrapped_ring(dev, B, H, Kh, hd, dtype):
    """B3 and B4 over a sliding-window ring (window 24, 5 slots of margin:
    gemma3-27b's G = 2 at hd 128, and a G = 4 shape), each slot's k_pos
    from ``ring_positions`` at its own head: wrapped three times, twice, not
    at all, and a free slot. Decode at the head and a verify block of the
    last 5 positions within the stated tolerance of the plain versions;
    every verify row equal (torch.equal) to a decode launch at its position,
    over the block's k_pos and over the k_pos that a decode step at that
    position sees (the slots past it hold positions outside the window)."""
    from repro_torch.models.attention import ring_positions

    window, T = 24, 5
    ring = window + T
    g = torch.Generator(device=dev).manual_seed(hd + B)
    k = torch.randn((B, Kh, ring, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Kh, ring, hd), generator=g, device=dev).to(dtype)
    heads = torch.tensor([3 * ring + 7, 2 * ring + 1, 12, -1][:B - 1] + [-1],
                         dtype=torch.int32, device=dev)
    k_pos = ring_positions(ring, heads)
    assert int(k_pos.min()) < 0 and int(k_pos[0].min()) > 2 * ring
    q_pos = torch.where(heads[:, None] >= 0,
                        heads[:, None] - (T - 1) + torch.arange(T, dtype=torch.int32,
                                                                device=dev), -1)
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    dec = decode_attention.flash_decode(q[:, -1].contiguous(), k, v, k_pos, heads,
                                        window=window)
    want = ref.flash_decode_ref(q[:, -1], k, v, k_pos, heads, window=window)
    assert (dec.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    out = verify_attention.flash_verify(q, k, v, k_pos, q_pos, window=window)
    want = ref.flash_verify_ref(q, k, v, k_pos, q_pos, window=window)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    for t in range(T):
        qt, pt = q[:, t].contiguous(), q_pos[:, t].contiguous()
        for kp in (k_pos, ring_positions(ring, pt)):
            row = decode_attention.flash_decode(qt, k, v, kp, pt, window=window)
            assert torch.equal(out[:, t], row), f"row {t}"


def test_flash_verify_reads_q_through_strides(dev):
    """A q whose token axis is not the outer one (a transposed view) gives
    the same result as its contiguous copy."""
    q, k, v, k_pos, q_pos = _verify_operands(dev, 3, 4, 8, 2, 40, 32, torch.float32, 7)
    qt = q.transpose(0, 1).contiguous().transpose(0, 1)
    assert not qt.is_contiguous()
    assert torch.equal(verify_attention.flash_verify(qt, k, v, k_pos, q_pos),
                       verify_attention.flash_verify(q, k, v, k_pos, q_pos))


def test_flash_verify_counts_cuda_launches(dev):
    before = verify_attention.launches
    q, k, v, k_pos, q_pos = _verify_operands(dev, 2, 3, 4, 2, 16, 8, torch.float32, 1)
    verify_attention.flash_verify(q, k, v, k_pos, q_pos)
    torch.cuda.synchronize()
    assert verify_attention.launches == before + 1


def test_flash_verify_mixed_devices_raise(dev):
    q, k, v, k_pos, q_pos = _verify_operands(dev, 2, 3, 4, 2, 16, 8, torch.float32, 1)
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q, k.cpu(), v, k_pos, q_pos)
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q, k, v, k_pos, q_pos.cpu())


# the paths that telemetry records from run once with the registry off,
# once on: what it records is host values, so neither waits for the device
TELEMETRY = pytest.mark.parametrize("telemetry", [False, True], ids=["off", "telemetry"])


@TELEMETRY
def test_pool_step_and_upgrade_never_sync(dev, telemetry):
    """On the card, ``step()`` (prefill ticks included) and a double-
    buffered upgrade run under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises on any operation that waits for the device."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=64, d_ff=128, vocab=128,
                                        n_heads=2, n_kv=2)
    model = build_model(cfg)
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev))
    pool = SlotPoolEngine(model, prog, n_slots=3, max_len=32, resident="quantized",
                          dispatch_window=2, prefill_chunk=4, device=dev)
    pool.receive_stage()
    rng = np.random.default_rng(0)
    for rid in range(5):
        pool.submit(PoolRequest(rid=rid, prompt=rng.integers(0, 128, 3 + 2 * rid),
                                max_new_tokens=6))
    torch.cuda.synchronize()
    obs.reset()
    with obs.telemetry(telemetry):
        while any(not s.free for s in pool.slots) or pool.queue:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(pool.dispatch_window):
                    if any(not s.free for s in pool.slots):
                        pool.step()
                pool.upgrade_if_available()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            pool.flush()
            pool._admit_from_queue()
        ups = obs.get_registry().get("engine_upgrades_total")
        assert (ups is not None) == telemetry
    assert pool.completed == set(range(5))
    assert all(len(v) == 6 for v in pool.outputs.values())
    assert pool.stage == prog.n_stages and pool._tick_count > 0


def _recurrent_pool(dev, name, **over):
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import SlotPoolEngine

    cfg = get_config(name).reduced(d_model=64, vocab=128, **over)
    model = build_model(dataclasses.replace(cfg, dtype=torch.bfloat16))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev))
    return SlotPoolEngine(model, prog, n_slots=3, max_len=40, resident="quantized",
                          dispatch_window=2, prefill_chunk=4, device=dev)


def test_recurrent_pool_step_and_tick_never_sync(dev):
    """A zamba2-shaped pool (13 layers: mamba2 blocks and the shared
    attention block, bfloat16): admissions into used slots (each zeroes
    the slot's recurrent state), chunk ticks stepping the recurrences
    token by token with masked rows, decode steps and double-buffered
    upgrades run under ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.serving.engine import PoolRequest

    pool = _recurrent_pool(dev, "zamba2-7b", n_layers=13)
    pool.receive_stage()
    rng = np.random.default_rng(0)
    for rid in range(5):
        pool.queue.append(PoolRequest(rid=rid, prompt=rng.integers(0, 128, 3 + 3 * rid),
                                      max_new_tokens=6))
    torch.cuda.synchronize()
    while any(not s.free for s in pool.slots) or pool.queue:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pool._admit_from_queue()
            for _ in range(pool.dispatch_window):
                if any(not s.free for s in pool.slots):
                    pool.step()
            pool.upgrade_if_available()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pool.flush()
    assert pool.completed == set(range(5))
    assert all(len(v) == 6 for v in pool.outputs.values())
    assert pool.stage == pool.prog.n_stages and pool._tick_count > 0


def test_reset_recurrent_slot_no_host_read(dev):
    """``_reset_recurrent_slot`` zeroes one slot's rows of every recurrent
    leaf in place under ``set_sync_debug_mode("error")``: no host read."""
    pool = _recurrent_pool(dev, "xlstm-125m", n_layers=4)
    leaves = [leaf for part, key in pool._recurrent_keys
              for leaf in pool.caches[part][key].values()]
    for i, leaf in enumerate(leaves):
        leaf.fill_(float(i + 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pool._reset_recurrent_slot(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for i, leaf in enumerate(leaves):
        assert not leaf[:, 2].any() and bool((leaf[:, :2] == i + 1).all())


@TELEMETRY
def test_client_feed_and_catch_up_upgrade_never_sync(dev, telemetry):
    """On the card, a v3 client fed one stage's bytes (verify, upload,
    unpack, OR) and the wire-fed server's catch-up upgrade run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the device. The store then equals the
    in-memory receiver's."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=64, d_ff=128, vocab=128,
                                        n_heads=2, n_kv=2)
    model = build_model(cfg)
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev))
    blob = wire.encode(prog, integrity=True)
    meta, hdr = wire.decode_header(blob)
    ends = np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()
    client = ProgressiveClient(device=dev)
    srv = ProgressiveServer(model, prog, max_len=16, resident="quantized", device=dev,
                            receiver=WireStoreReceiver(client, prog))
    client.feed(blob[:ends[1]])
    srv.receive_stage()
    srv.start({"tokens": torch.arange(8).reshape(1, 8)})
    torch.cuda.synchronize()
    obs.reset()
    with obs.telemetry(telemetry):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for a in range(ends[1], ends[2], 997):
                client.feed(blob[a:min(a + 997, ends[2])])
            srv.receive_stage()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fed = obs.get_registry().get("client_bytes_fed_total")
        if telemetry:
            assert fed.value() == ends[2] - ends[1]
        else:
            assert fed is None
    assert client.stages_complete == srv.stage == 2
    state = ReceiverState.init(prog, device=dev)
    for s in (1, 2):
        state = state.receive(prog.stage(s))
    assert client.store.fingerprint() == state.store.fingerprint()


# ---------------------------------------------------------------------------
# self-speculation: the plane mask as an operand, verify rows equal to
# decode rows, speculative tokens equal to plain greedy decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["gemv", "mma"])
@pytest.mark.parametrize("M", [4, 20, 64])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("layout", ["kn", "transposed", "strided"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_keep_operand(dev, kernel, M, qdtype, layout, xdtype):
    """Both routes with ``keep`` = 0, 2, 4, 8 and 16 (clamped to q's width)
    against the plain version on the masked q, within 1e-4 of max |y|;
    the full-width keep launch is bit-equal to the launch without keep."""
    x, q, scale, offset = _dqmm_operands(dev, M, 2048, 512, qdtype, layout, xdtype, M + 3,
                                         "relu3")
    launch = {"gemv": dequant_matmul._launch_gemv, "mma": dequant_matmul._launch_mma}[kernel]
    bits = 8 * q.element_size()
    for keep in sorted({min(k, bits) for k in (0, 2, 4, 8, 16)}):
        kt = torch.tensor([[keep]], dtype=torch.int32, device=dev)
        y = launch(x, q, scale, offset, kt)
        want = ref.dequant_matmul_ref(x, q, scale, offset, kt)
        assert torch.equal(want, ref.dequant_matmul_ref(x, ref.mask_q(q, keep), scale, offset))
        err = (y - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6, keep
    full = torch.tensor([[bits]], dtype=torch.int32, device=dev)
    assert torch.equal(launch(x, q, scale, offset, full), launch(x, q, scale, offset))


def test_dequant_matmul_keep_uint32_and_narrow_bits(dev):
    """The general kernels (uint32 q, 20-bit values) and a 12-bit leaf in a
    uint16 container mask by ``bits - keep``, as the plain version."""
    for qdtype, bits in ((torch.uint32, 20), (torch.uint16, 12)):
        g = torch.Generator(device=dev).manual_seed(bits)
        x = torch.randn((5, 1024), generator=g, device=dev)
        q = torch.randint(0, 2 ** bits, (1024, 96), generator=g, device=dev).to(qdtype)
        scale = torch.tensor([[2.0 ** -bits]], device=dev)
        offset = torch.tensor([[-0.5]], device=dev)
        for keep in (0, 4, bits):
            kt = torch.tensor([[keep]], dtype=torch.int32, device=dev)
            for rows in ("any", "decode"):
                y = dequant_matmul.dequant_matmul(x, q, scale, offset, kt, bits=bits, rows=rows)
                want = ref.dequant_matmul_ref(x, q, scale, offset, kt, bits=bits)
                assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-6


@pytest.mark.parametrize("K,N,layout", [(2048, 2048, "kn"), (8192, 2048, "kn"),
                                        (2048, 8192, "kn"), (2048, 4096, "transposed")])
@pytest.mark.parametrize("keep", [None, 4])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_decode_rows_independent_of_M(dev, K, N, layout, keep, xdtype):
    """``rows="decode"`` keeps every M on the GEMV route: at the verify
    shapes M = 5, 20, 32 and 72, masked or not, every row equals (torch.equal)
    that row launched alone, and the launches count on the GEMV route."""
    x, q, scale, offset = _dqmm_operands(dev, 72, K, N, torch.uint16, layout, xdtype, K + N,
                                         "silu")
    kt = None if keep is None else torch.tensor([[keep]], dtype=torch.int32, device=dev)
    alone = torch.cat([dequant_matmul.dequant_matmul(x[i:i + 1], q, scale, offset, kt,
                                                     rows="decode") for i in range(72)])
    for M in (5, 20, 32, 72):
        before = dict(dequant_matmul.launches_by_route)
        y = dequant_matmul.dequant_matmul(x[:M], q, scale, offset, kt, rows="decode")
        assert dequant_matmul.launches_by_route == {**before, "gemv": before["gemv"] + 1}
        assert torch.equal(y, alone[:M]), M
    _assert_dqmm_close(alone, x, ref.mask_q(q, keep), scale, offset)


@pytest.mark.parametrize("norm_type,d_model", [("nonparam_ln", d) for d in (64, 128, 256, 2048)]
                         + [(n, d) for n in ("rmsnorm", "layernorm")
                            for d in (64, 128, 3072, 6144)] + [("rmsnorm", 5376)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_rows_independent_of_count(dev, dtype, d_model, norm_type):
    """The norms' statistics: every row of an M-row ``apply_norm`` (M = 1-80)
    equals (torch.equal) that row normalised alone, at each width the port
    runs: olmo-1b's non-parametric LayerNorm at 2048, minitron-4b's RMSNorm
    at 3072 and starcoder2-15b's affine LayerNorm at 6144 (each also at
    the other's width), and the reduced models' of these tests."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import apply_norm, norm_init

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(d_model=d_model),
                              norm_type=norm_type)
    g = torch.Generator(device=dev).manual_seed(9)
    x = (torch.randn((80, cfg.d_model), generator=g, device=dev) * 3 + 1).to(dtype)
    p = {k: v + 0.3 * torch.randn(v.shape, generator=g, device=dev)
         for k, v in norm_init(cfg, d_model, device=dev).items()}
    alone = torch.cat([apply_norm(cfg, p, x[i:i + 1]) for i in range(80)])
    for M in list(range(1, 17)) + [20, 32, 64, 72, 80]:
        assert torch.equal(apply_norm(cfg, p, x[:M]), alone[:M]), M
        assert torch.equal(apply_norm(cfg, p, x[:M].reshape(1, M, -1))[0], alone[:M]), M


@pytest.mark.parametrize("H,hd", [(32, 128), (16, 128), (4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_norm_rows_independent_of_count(dev, dtype, H, hd):
    """gemma3-27b's per-head RMSNorm of q (32 heads) and k (16), hd 128:
    every token's heads normalised in an M-token launch (M = 1-80, the
    (M, 1, H, hd) of a decode step's slots or (1, M, H, hd) of a verify
    block) equal (torch.equal) the token's heads alone."""
    from repro_torch.models.attention import qk_norm

    g = torch.Generator(device=dev).manual_seed(H + hd)
    x = (torch.randn((80, 1, H, hd), generator=g, device=dev) * 3 + 1).to(dtype)
    scale = 1.0 + 0.3 * torch.randn((hd,), generator=g, device=dev)
    alone = torch.cat([qk_norm(x[i:i + 1], scale) for i in range(80)])
    for M in list(range(1, 17)) + [20, 32, 64, 72, 80]:
        assert torch.equal(qk_norm(x[:M], scale), alone[:M]), M
        assert torch.equal(qk_norm(x[:M].reshape(1, M, H, hd), scale)[0], alone[:M, 0]), M


# the dense variants' weights that no olmo-1b launch has: minitron-4b's
# embed.T (K-contiguous, N = 256,000), starcoder2-15b's untied lm_head
# ((K, N)) and its mlp.wo at K = 24,576 (6 chunks of K, a cluster of 6),
# and the narrow wk of each
NEW_ARCH_WEIGHTS = [(3072, 256000, "transposed"), (6144, 49152, "kn"), (24576, 6144, "kn"),
                    (3072, 1024, "kn"), (6144, 512, "kn"), (9216, 3072, "kn"),
                    # gemma3-27b: embed.T at N = 262,144, mlp.wo at K = 21,504, wk
                    (5376, 262144, "transposed"), (21504, 5376, "kn"), (5376, 2048, "kn")]


@pytest.mark.parametrize("K,N,layout", NEW_ARCH_WEIGHTS)
@pytest.mark.parametrize("keep", [None, 4])
def test_dequant_matmul_at_new_arch_weights(dev, K, N, layout, keep):
    """Both routes within 1e-4 of the plain version at M = 1, 4, 8, 20 and
    64 (bfloat16 x, float32 for the unembeddings), and every row of a
    ``rows="decode"`` launch at M = 20 equal to the row launched alone;
    every shape on the one-pass kernels."""
    xdtype = torch.float32 if N in (256000, 49152) else torch.bfloat16
    x, q, scale, offset = _dqmm_operands(dev, 64, K, N, torch.uint16, layout, xdtype, K + N,
                                         "silu")
    kt = None if keep is None else torch.tensor([[keep]], dtype=torch.int32, device=dev)
    assert dequant_matmul.one_pass(q)
    mq = ref.mask_q(q, kt)
    for M in (1, 4, 8, 20, 64):
        _assert_dqmm_close(dequant_matmul.dequant_matmul(x[:M], q, scale, offset, kt),
                           x[:M], mq, scale, offset)
    alone = torch.cat([dequant_matmul.dequant_matmul(x[i:i + 1], q, scale, offset, kt,
                                                     rows="decode") for i in range(20)])
    assert torch.equal(dequant_matmul.dequant_matmul(x[:20], q, scale, offset, kt,
                                                     rows="decode"), alone)


# mixtral-8x22b's router (N = 8) and expert slots at its published widths
MOE_WEIGHTS = [(6144, 8, "kn"), (6144, 16384, "kn"), (16384, 6144, "kn")]


@pytest.mark.parametrize("K,N,layout", MOE_WEIGHTS)
@pytest.mark.parametrize("keep", [None, 5])
def test_dequant_matmul_at_moe_weights(dev, K, N, layout, keep):
    """As ``test_dequant_matmul_at_new_arch_weights`` at the router and the
    expert slots, M = 1-64 (16: an expert's rows at the pool's decode)."""
    x, q, scale, offset = _dqmm_operands(dev, 64, K, N, torch.uint16, layout, torch.bfloat16,
                                         K + N, "silu")
    kt = None if keep is None else torch.tensor([[keep]], dtype=torch.int32, device=dev)
    assert dequant_matmul.one_pass(q)
    mq = ref.mask_q(q, kt)
    for M in (1, 4, 8, 16, 20, 64):
        for rows in ("any", "decode"):
            _assert_dqmm_close(dequant_matmul.dequant_matmul(x[:M], q, scale, offset, kt,
                                                             rows=rows), x[:M], mq, scale, offset)
    alone = torch.cat([dequant_matmul.dequant_matmul(x[i:i + 1], q, scale, offset, kt,
                                                     rows="decode") for i in range(20)])
    assert torch.equal(dequant_matmul.dequant_matmul(x[:20], q, scale, offset, kt,
                                                     rows="decode"), alone)


def test_expert_dense_on_per_expert_slot_views(dev):
    """``expert_dense`` through B2 on a bank divided per expert: 8 experts
    of (1024, 2048), stage 3 cut mid-way so the slices hold different
    received bits, the 4-bit draft view's per-expert ``keep``. One B2
    launch an expert on its slot of the store's buffer (a view, no copy),
    each within 1e-4 of the plain version on its own masked q and affine,
    at M = 8 and 16 rows an expert, both ``rows``."""
    from repro_torch.core.plane_store import PlaneStore
    from repro_torch.core.policy import ExpertPopularityPolicy
    from repro_torch.core.progressive import divide
    from repro_torch.models.common import expert_dense

    E, d, f = 8, 1024, 2048
    g = torch.Generator(device=dev).manual_seed(5)
    bank = torch.randn((E, d, f), generator=g, device=dev) \
        * torch.arange(1, E + 1, device=dev)[:, None, None]
    prog = divide({"moe": {"we_up": bank}}, ExpertPopularityPolicy(
        n_experts=E, popularity={e: 0.1 * e for e in range(E)}))
    store = PlaneStore.from_model(prog, device=dev)
    for s in range(1, 4):
        items = prog.stage(s)
        store.ingest(items if s < 3 else items[:5])
    assert len(set(store.received)) == 2
    buf = store.buffers["uint16"]
    idxs = store.groups[("moe", "we_up")]
    for bits in (None, 4):
        w = store.quantized_leaves(bits=bits)[("moe", "we_up")]
        assert w.q.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        for C in (1, 2):
            x = torch.randn((8, E, C, d), generator=g, device=dev).to(torch.bfloat16)
            for rows in ("any", "decode"):
                before = dequant_matmul.launches
                y = expert_dense(x, w, dtype=torch.float32, rows=rows)
                assert dequant_matmul.launches - before == E
                for e, i in enumerate(idxs):
                    assert w.q[e].data_ptr() == store.acc(i).data_ptr()
                    kt = None if w.keep_bits is None else w.keep_bits[e]
                    want = ref.dequant_matmul_ref(x[:, e].reshape(-1, d), ref.mask_q(w.q[e], kt),
                                                  w.scale[e], w.offset[e])
                    err = (y[:, e].reshape(-1, f) - want).abs().max().item()
                    assert err <= 1e-4 * want.abs().max().item(), (bits, C, rows, e)


def _moe_model(dev):
    """Reduced mixtral-8x22b in bfloat16 on the card: ``swa_moe`` over a
    window of 16, 4 experts, top-2, drop-free capacity, hd 64, divided
    under the expert policy."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ExpertPopularityPolicy
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model

    model = build_model(get_config("mixtral-8x22b").reduced(
        d_model=256, n_heads=4, n_kv=2, d_ff=512, vocab=512, dtype=torch.bfloat16))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev),
                  ExpertPopularityPolicy(n_experts=4, popularity={1: 0.5, 3: 0.2}))
    return model, prog


@pytest.mark.parametrize("pattern", ["reject_all", "alternate", "accept_all"])
def test_moe_verify_step_equals_decode_steps(dev, pattern):
    """The verify rounds over mixtral's MoE blocks (rings of 16 + 5,
    positions past 40; capacity drop-free, so no verify row loses an
    expert a decode step keeps): every verify row's logits and the caches
    equal sequential decode steps bit for bit, routing included."""
    model, prog = _moe_model(dev)
    _verify_rounds(dev, model, prog, pattern, prompt_len=20, rounds=10)


def test_moe_decode_step_never_syncs(dev):
    """A MoE decode step and an upgrade under
    ``torch.cuda.set_sync_debug_mode("error")``: routing, dispatch and
    combine never read the device from the host."""
    from repro_torch.serving import ProgressiveServer

    model, prog = _moe_model(dev)
    srv = ProgressiveServer(model, prog, max_len=48, resident="quantized", device=dev)
    srv.receive_stage()
    srv.start({"tokens": torch.arange(12).reshape(2, 6)})
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, caches = model.decode_step(srv.params, srv.caches, tok, 6)
        srv.receive_stage()
        logits, caches = model.decode_step(srv.params, caches, tok, 7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("n", [2, 4])
def test_expert_dense_on_sharded_bank(dev, n):
    """``expert_dense`` on a ``ShardedLeaf`` bank, the expert route of a
    ``ShardedPlaneStore`` over n logical shards of the card: mixtral's
    slices (8 experts of 6144 x 16,384), stage 3 cut mid-way so the
    experts hold different received bits, the 4-bit draft view's
    per-expert ``keep``. E B2 launches in all, each expert's on its
    shard's slot, and the result ``torch.equal`` to the unsharded call at
    M = 4 and 8 rows an expert, both ``rows``."""
    from repro_torch.core.plane_store import PlaneStore, ShardedLeaf, ShardedPlaneStore
    from repro_torch.core.policy import ExpertPopularityPolicy
    from repro_torch.core.progressive import divide
    from repro_torch.models.common import expert_dense

    E, d, f = 8, 6144, 16384
    g = torch.Generator(device=dev).manual_seed(6)
    bank = torch.randn((E, d, f), generator=g, device=dev) \
        * torch.arange(1, E + 1, device=dev)[:, None, None]
    prog = divide({"moe": {"we_gate": bank}}, ExpertPopularityPolicy(
        n_experts=E, popularity={e: 0.1 * e for e in range(E)}))
    del bank
    one = PlaneStore.from_model(prog, device=dev)
    sharded = ShardedPlaneStore.from_model(prog, _mesh(dev, n))
    for s in range(1, 4):
        items = prog.stage(s)
        for store in (one, sharded):
            store.ingest(items if s < 3 else items[:5])
    del prog
    key = ("moe", "we_gate")
    for bits in (None, 4):
        w1 = one.quantized_leaves(bits=bits)[key]
        wn = sharded.quantized_leaves(bits=bits)[key]
        assert isinstance(wn, ShardedLeaf) and wn.axis == -3 and len(wn.parts) == n
        assert len(set(w1.received_bits.flatten().tolist())) == (2 if bits is None else 1)
        for C in (1, 2):
            x = torch.randn((4, E, C, d), generator=g, device=dev).to(torch.bfloat16)
            for rows in ("any", "decode"):
                before = dequant_matmul.launches
                y = expert_dense(x, wn, dtype=torch.bfloat16, rows=rows)
                assert dequant_matmul.launches - before == E
                assert torch.equal(y, expert_dense(x, w1, dtype=torch.bfloat16, rows=rows)), \
                    (bits, C, rows)


def test_sharded_moe_decode_step_never_syncs(dev):
    """A MoE decode step on 2 logical shards and an upgrade under
    ``torch.cuda.set_sync_debug_mode("error")``: the shards' experts and
    the split weights read nothing back to the host; the logits equal one
    device's."""
    from repro_torch.serving import ProgressiveServer

    model, prog = _moe_model(dev)
    logits = []
    for mesh in (None, _mesh(dev, 2)):
        srv = ProgressiveServer(model, prog, max_len=48, resident="quantized", mesh=mesh,
                                device=dev)
        srv.receive_stage()
        srv.start({"tokens": torch.arange(12).reshape(2, 6)})
        tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, caches = model.decode_step(srv.params, srv.caches, tok, 6)
            srv.receive_stage()
            out, caches = model.decode_step(srv.params, caches, tok, 7)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        logits.append(out)
    assert bool(torch.isfinite(logits[1]).all()) and torch.equal(logits[0], logits[1])


def _spec_model(dev, seed=0, **over):
    """Reduced olmo-1b in bfloat16 on the card (hd 64), divided."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model

    shape = dict(n_layers=2, d_model=256, n_heads=4, n_kv=4, d_ff=512, vocab=512,
                 dtype=torch.bfloat16)
    shape.update(over)
    model = build_model(get_config("olmo-1b").reduced(**shape))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(seed), device=dev))
    return model, prog


@pytest.mark.parametrize("pattern", ["reject_all", "alternate", "accept_all"])
def test_verify_step_equals_decode_steps(dev, pattern):
    """The card's form of the reference's KV-rollback test: rounds of k
    draft decode steps (draft view, 4 bits) and a T = k + 1 verify on the
    target view, ragged across slots, against sequential ``decode_step``s
    of the same blocks. Each verify row's logits and the whole caches
    equal (torch.equal) the sequential ones after every round."""
    model, prog = _spec_model(dev)
    _verify_rounds(dev, model, prog, pattern, prompt_len=10, rounds=6)


def _gemma_model(dev):
    """Reduced gemma3-27b in bfloat16 on the card: one 5:1 cycle, window
    16, qk-norm, softcap, hd 64, divided."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model

    model = build_model(get_config("gemma3-27b").reduced(
        d_model=256, n_heads=4, n_kv=2, head_dim=64, d_ff=512, vocab=512,
        dtype=torch.bfloat16))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev))
    return model, prog


@pytest.mark.parametrize("pattern", ["reject_all", "alternate", "accept_all"])
def test_windowed_verify_step_equals_decode_steps(dev, pattern):
    """The same rounds over gemma3-27b's rings (window 16, grown by k_max +
    1 = 5 after a 20-token prompt), positions past 40: every ring wraps,
    and verify rows still equal sequential decode steps bit for bit."""
    model, prog = _gemma_model(dev)
    _verify_rounds(dev, model, prog, pattern, prompt_len=20, rounds=10)


def _verify_rounds(dev, model, prog, pattern, *, prompt_len, rounds):
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.models.common import quantized_resident_eligible
    from repro_torch.serving.speculative import SpeculativeEngine

    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
    plain = state.materialize_resident(quantized_resident_eligible)
    target = state.materialize_resident(quantized_resident_eligible,
                                        bits=SpeculativeEngine._FULL_BITS)
    draft = state.materialize_resident(quantized_resident_eligible, bits=4)
    B, P, k_max = 3, prompt_len, 4
    prompt = torch.randint(0, model.cfg.vocab, (B, P), generator=torch.Generator().manual_seed(1))
    logits, caches = model.prefill(plain, {"tokens": prompt.to(dev)})
    spec_c = model.grow_caches(caches, 64, ring_margin=k_max + 1, pos=P)
    seq_c = {part: {k: {n: t.clone() for n, t in c.items()} for k, c in spec_c[part].items()}
             for part in ("cycles", "tail")}
    last = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    for rnd in range(rounds):
        k = 1 + rnd % k_max
        toks, cur = [last], last
        for j in range(k):
            lg, spec_c = model.decode_step(draft, spec_c, cur, pos + j)
            cur = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            toks.append(cur)
        block = torch.cat(toks, dim=1)
        vlog, spec_c = model.verify_step(target, spec_c, block, pos)
        for t in range(k + 1):
            lg, seq_c = model.decode_step(plain, seq_c, block[:, t:t + 1], pos + t)
            assert torch.equal(vlog[:, t], lg), (rnd, t)
        for slot, c in spec_c["cycles"].items():
            for name in ("k", "v"):
                assert torch.equal(c[name], seq_c["cycles"][slot][name]), (rnd, slot)
        acc = {"reject_all": [0] * B, "accept_all": [k] * B,
               "alternate": [k if (rnd + b) % 2 else 0 for b in range(B)]}[pattern]
        acc_t = torch.tensor(acc, device=dev)
        last = torch.gather(torch.argmax(vlog, dim=-1).to(torch.int32), 1, acc_t[:, None])
        pos = pos + acc_t.to(torch.int32) + 1


def test_speculative_tokens_equal_plain_on_the_card(dev):
    """``SpeculativeEngine`` (k = 4 and adaptive) against
    ``ProgressiveServer`` at stages 2, 5 and 8 at batch 3, and
    ``SpeculativeSlotPool`` against ``SlotPoolEngine`` per request at
    stage 8: tokens equal (torch.equal); every verify launch of B2 on the
    GEMV route's one-pass kernels."""
    from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine,
                                     SpecConfig, SpeculativeEngine, SpeculativeSlotPool)

    model, prog = _spec_model(dev)
    prompt = torch.randint(0, model.cfg.vocab, (3, 12), generator=torch.Generator().manual_seed(2))
    for k in (4, None):
        spec = SpeculativeEngine(model, prog, max_len=12 + 24 + 9,
                                 spec=SpecConfig(draft_bits=4, k=k), device=dev)
        plain = ProgressiveServer(model, prog, max_len=12 + 24, resident="quantized", device=dev)
        for s in range(1, prog.n_stages + 1):
            spec.receive_stage()
            plain.receive_stage()
            if s not in (2, 5, 8):
                continue
            spec.start({"tokens": prompt})
            plain.start({"tokens": prompt})
            before = dict(dequant_matmul.launches_by_gemv_kernel)
            res = spec.decode(24)
            assert dequant_matmul.launches_by_gemv_kernel["general"] == before["general"]
            assert torch.equal(res.tokens.to(dev), plain.decode(24).tokens), (k, s)
            assert s == 2 or res.drafted > 0
    rng = np.random.default_rng(3)
    reqs = [(rid, rng.integers(0, model.cfg.vocab, int(rng.integers(4, 30))),
             int(rng.integers(4, 20))) for rid in range(7)]
    outs = []
    for cls, kw in ((SpeculativeSlotPool, {"spec": SpecConfig(draft_bits=4, k=3)}),
                    (SlotPoolEngine, {"resident": "quantized"})):
        pool = cls(model, prog, n_slots=4, max_len=64, prefill_chunk=8, dispatch_window=4,
                   device=dev, **kw)
        for _ in range(prog.n_stages):
            pool.receive_stage()
        for rid, p, budget in reqs:
            pool.submit(PoolRequest(rid=rid, prompt=p, max_new_tokens=budget))
        outs.append(pool.run())
    assert outs[0] == outs[1]


@TELEMETRY
def test_spec_round_and_upgrade_never_sync(dev, telemetry):
    """A speculative round of either engine and an upgrade of both views
    run under ``torch.cuda.set_sync_debug_mode("error")``; only the
    round's one host read (the single stream's, the pool's at flush)
    waits for the device."""
    from repro_torch import obs

    obs.reset()
    with obs.telemetry(telemetry):
        pool = _spec_rounds_without_sync(dev)
        rounds = obs.get_registry().get("spec_rounds_total")
        if telemetry:
            assert rounds.value(engine="SpeculativeSlotPool") == len(pool.accept_log) > 0
        else:
            assert rounds is None
    assert pool.completed == set(range(5)) and all(len(v) == 6 for v in pool.outputs.values())


def _spec_rounds_without_sync(dev):
    """The single stream's rounds around an upgrade, then the pool's
    steps and upgrades, each under ``set_sync_debug_mode("error")``.
    Returns the pool, run to its end."""
    from repro_torch import to_device
    from repro_torch.serving import (PoolRequest, SpecConfig, SpeculativeEngine,
                                     SpeculativeSlotPool)

    model, prog = _spec_model(dev)
    eng = SpeculativeEngine(model, prog, max_len=48, spec=SpecConfig(draft_bits=2, k=3),
                            device=dev)
    for _ in range(3):
        eng.receive_stage()
    eng.start({"tokens": torch.arange(10).reshape(1, 10)})
    pos = to_device(np.array([10], np.int32), eng.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g, acc, nxt, eng.caches = eng._run_round(eng.caches, eng._first_tok, pos, eng.choose_k())
        eng.receive_stage()
        eng._run_round(eng.caches, nxt, pos + acc + 1, eng.choose_k())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert g.shape == (1, 4)
    pool = SpeculativeSlotPool(model, prog, n_slots=3, max_len=40, dispatch_window=2,
                               prefill_chunk=4, spec=SpecConfig(draft_bits=2, k=3), device=dev)
    pool.receive_stage()
    rng = np.random.default_rng(0)
    for rid in range(5):
        pool.submit(PoolRequest(rid=rid, prompt=rng.integers(0, 512, 3 + 2 * rid),
                                max_new_tokens=6))
    torch.cuda.synchronize()
    while any(not s.free for s in pool.slots) or pool.queue:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(pool.dispatch_window):
                if any(not s.free for s in pool.slots):
                    pool.step()
            pool.upgrade_if_available()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pool.flush()
        pool._admit_from_queue()
    return pool


def _pool_model(dev, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model

    cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=256, d_ff=1024, vocab=512,
                                        n_heads=4, n_kv=4)
    model = build_model(cfg)
    return cfg, model, divide(model.init(torch.Generator(device=dev).manual_seed(seed),
                                         device=dev))


def test_pool_slot_alone_equals_busy_pool(dev):
    """The reference's per-slot contract (``tests/test_slot_pool.py``): a
    request's tokens do not depend on the requests beside it. Each of 12
    requests alone in a 1-slot pool (its prefill ticks at M = 8 rows, on
    the GEMV route) against the same request in a busy 8-slot pool (ticks
    at M = 64, the tensor-core route; decode at M = 8 on the GEMV route,
    whose rows do not depend on M)."""
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg, model, prog = _pool_model(dev)
    settings = dict(max_len=96, resident="quantized", dispatch_window=8, prefill_chunk=8,
                    device=dev)
    rng = np.random.default_rng(3)
    requests = [(rid, rng.integers(0, cfg.vocab, int(rng.integers(5, 60))),
                 int(rng.integers(12, 33))) for rid in range(12)]

    def serve(n_slots, reqs):
        pool = SlotPoolEngine(model, prog, n_slots=n_slots, **settings)
        for _ in range(prog.n_stages):
            pool.receive_stage()
        for rid, prompt, budget in reqs:
            pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=budget))
        return pool.run()

    busy = serve(8, requests)
    for req in requests:
        alone = serve(1, [req])
        assert alone[req[0]] == busy[req[0]], f"request {req[0]}"


def test_fp_pool_step_and_upgrade_never_sync(dev):
    """Float residency on the card: after the first stage (which reads
    each tensor's range to the host once), ``step()`` and an upgrade that
    dequantizes every tensor run under ``set_sync_debug_mode("error")``,
    as they do under quantized residency."""
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg, model, prog = _pool_model(dev, seed=1)
    rng = np.random.default_rng(0)
    requests = [(rid, rng.integers(0, cfg.vocab, 3 + 2 * rid)) for rid in range(5)]
    for resident in ("fp", "quantized"):
        pool = SlotPoolEngine(model, prog, n_slots=3, max_len=32, resident=resident,
                              dispatch_window=2, prefill_chunk=4, device=dev)
        pool.receive_stage()
        for rid, prompt in requests:
            pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=6))
        torch.cuda.synchronize()
        while any(not s.free for s in pool.slots) or pool.queue:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(pool.dispatch_window):
                    if any(not s.free for s in pool.slots):
                        pool.step()
                pool.upgrade_if_available()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            pool.flush()
            pool._admit_from_queue()
        assert pool.stage == prog.n_stages and pool.completed == set(range(5))
        assert all(len(v) == 6 for v in pool.outputs.values())
        if resident == "fp":
            rep = pool.resident_report()
            assert rep["quantized_bytes"] == 0 and rep["fp_leaves"] == len(prog.tensors)


def test_quantized_view_matmul_at_vocab_rows(dev):
    """``QuantizedLinearState.matmul`` on a (50304, 2048) weight (the
    full-width embedding as a (K, N) weight: K = 50,304, no multiple of
    512) at M = 1, 4 and 64, at stages 1, 4 and 8, within 1e-4 of the
    largest |y| of ``dequantize`` followed by ``torch.matmul``."""
    from repro_torch.core.progressive import divide
    from repro_torch.core.quantize import dequantize
    from repro_torch.serving import from_progressive

    g = torch.Generator(device=dev).manual_seed(0)
    w = 0.02 * torch.randn((50304, 2048), generator=g, device=dev)
    prog = divide({"embed": w})
    view = from_progressive(prog, 0)
    xs = {M: torch.randn((M, 50304), generator=g, device=dev) for M in (1, 4, 64)}
    for s in range(1, prog.n_stages + 1):
        view.upgrade(prog.tensors[0].planes[s - 1])
        if s not in (1, 4, 8):
            continue
        wq = dequantize(view.store.quantized(0), view.received_bits)
        for M, x in xs.items():
            y = view.matmul(x)
            want = x @ wq
            err = float((y - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (s, M, err)
    assert view.resident_bytes == 50304 * 2048 * 2


def test_acc_view_fresh_across_ingests_on_the_card(dev):
    """``PlaneStore.acc(i)`` on the card: cached between ingests, fresh
    after every full and sparse ingest (each replaces the buffer), and a
    ``copy()`` keeps the views of its own buffers; equal to the same store
    on the CPU."""
    from repro_torch.core.plane_store import PlaneStore
    from repro_torch.core.progressive import divide

    g = torch.Generator(device=dev).manual_seed(1)
    params = {"a": torch.randn((300, 70), generator=g, device=dev),
              "b": torch.randn((9, 1030), generator=g, device=dev)}
    prog = divide(params)
    store = PlaneStore.from_model(prog, device=dev)
    host = PlaneStore.from_model(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        before = [store.acc(i) for i in range(2)]
        assert store.acc(1) is before[1]
        snap = store.copy()
        items = prog.stage(s)
        if s % 2:
            store.ingest(items)
        else:
            for it in items:
                store.ingest([it])
        host.ingest([(i, p.cpu()) for i, p in items])
        for i in range(2):
            assert store.acc(i) is not before[i]
            assert torch.equal(store.acc(i).cpu(), host.acc(i))
            assert torch.equal(snap.acc(i), before[i])
    assert store.fingerprint() == host.fingerprint()


def test_batch1_admission_and_upgrade_never_sync(dev):
    """Batch-1 admission on the card (a bucket-padded prefill, its caches
    written into the slot's rows, the slot's position and logits set),
    the pool's steps and double-buffered upgrades all run under
    ``torch.cuda.set_sync_debug_mode("error")``, with prompt buckets and
    without; each request alone in a 1-slot pool emits the busy pool's
    tokens (its prefill is a batch of one either way, and decode rows do
    not depend on M), at stage 8."""
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg, model, prog = _pool_model(dev, seed=2)
    rng = np.random.default_rng(1)
    requests = [PoolRequest(rid=rid, prompt=rng.integers(0, cfg.vocab, 3 + 5 * rid),
                            max_new_tokens=6) for rid in range(5)]
    for buckets in (True, False):
        pool = SlotPoolEngine(model, prog, n_slots=3, max_len=40, resident="quantized",
                              dispatch_window=1, chunked_prefill=False,
                              prefill_buckets=buckets, device=dev)
        pool.receive_stage()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for req in requests:
                pool.submit(req)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        while any(not s.free for s in pool.slots) or pool.queue:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(pool.dispatch_window):
                    if any(not s.free for s in pool.slots):
                        pool.step()
                pool.upgrade_if_available()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            pool.flush()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pool._admit_from_queue()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert pool.completed == set(range(5)) and pool._tick_count == 0
        assert pool.stage == prog.n_stages
        assert all(len(v) == 6 for v in pool.outputs.values())

    def serve(n_slots, reqs):           # at stage 8 throughout
        pool = SlotPoolEngine(model, prog, n_slots=n_slots, max_len=40,
                              resident="quantized", dispatch_window=2,
                              chunked_prefill=False, device=dev)
        for _ in range(prog.n_stages):
            pool.receive_stage()
        for req in reqs:
            pool.submit(req)
        return pool.run()

    busy = serve(3, requests)
    for req in requests:
        assert serve(1, [req])[req.rid] == busy[req.rid], req.rid


# ---------------------------------------------------------------------------
# B7: sharded_dequant_matmul on logical shards of the card
# ---------------------------------------------------------------------------

def _mesh(dev, n):
    from repro_torch.launch.mesh import make_serving_mesh

    return make_serving_mesh(n, devices=[dev] * n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("K,N,layout", [(2048, 2048, "kn"), (2048, 8192, "kn"),
                                        (8192, 2048, "kn"), (2048, 4096, "transposed")])
@pytest.mark.parametrize("keep", [None, 4])
def test_sharded_dequant_matmul_equals_one_launch(dev, n, K, N, layout, keep):
    """B7 on n contiguous shards of q's columns (sub-store layout; the
    K-contiguous layout as row blocks of a table, transposed) at every M
    and route: ``torch.equal`` to one B2 launch on the whole q, through
    ``ops`` and on each forced route with ``n_split = N``."""
    from repro_torch.kernels import ops

    x_all, q, scale, offset = _dqmm_operands(dev, 256, K, N, torch.uint16, layout,
                                             torch.bfloat16, K + N + n)
    w = N // n
    if layout == "transposed":
        table = q.T
        shards = [table[j * w:(j + 1) * w].T for j in range(n)]
    else:
        shards = [q[:, j * w:(j + 1) * w].contiguous() for j in range(n)]
    kt = None if keep is None else torch.full((1, 1), keep, dtype=torch.int32, device=dev)
    mesh = _mesh(dev, n)
    scales, offsets, keeps = [scale] * n, [offset] * n, None if kt is None else [kt] * n
    for M in (1, 4, 8, 20, 64, 256):
        x = x_all[:M]
        for rows in ("any", "decode"):
            before = ops.sharded_launches
            y = ops.sharded_dequant_matmul(x, shards, scales, offsets, keeps=keeps, bits=16,
                                           rows=rows, mesh=mesh)
            assert ops.sharded_launches == before + 1
            assert torch.equal(y, dequant_matmul.dequant_matmul(x, q, scale, offset, kt,
                                                                bits=16, rows=rows)), (M, rows)
        for launch in (dequant_matmul._launch_gemv, dequant_matmul._launch_mma):
            ys = torch.cat([launch(x, s, scale, offset, kt, bits=16, n_split=N)
                            for s in shards], dim=1)
            assert torch.equal(ys, launch(x, q, scale, offset, kt, bits=16)), (M, launch)
        want = ref.sharded_dequant_matmul_ref(x, shards, scales, offsets, keeps, bits=16)
        assert (y - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-6


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("keep", [None, 4])
def test_sharded_dequant_matmul_narrow_shards_gather(dev, n, keep):
    """mixtral's router (6144, 8) split on its 8 columns: shards of 4 or 2
    columns are too narrow for the one-pass kernels, so B7 joins them and
    launches once (on the one-pass kernel on the GEMV route): one B2
    launch, ``torch.equal`` to one B2 launch on the whole q."""
    from repro_torch.kernels import ops

    K, N = 6144, 8
    x_all, q, scale, offset = _dqmm_operands(dev, 64, K, N, torch.uint16, "kn",
                                             torch.bfloat16, K + N + n)
    w = N // n
    shards = [q[:, j * w:(j + 1) * w].contiguous() for j in range(n)]
    assert dequant_matmul.one_pass(q) and not dequant_matmul.one_pass(shards[0], N)
    kt = None if keep is None else torch.full((1, 1), keep, dtype=torch.int32, device=dev)
    mesh = _mesh(dev, n)
    for M in (1, 4, 8, 20, 64):
        for rows in ("any", "decode"):
            x = x_all[:M]
            before = dequant_matmul.launches
            general = dequant_matmul.launches_by_gemv_kernel["general"]
            y = ops.sharded_dequant_matmul(x, shards, [scale] * n, [offset] * n,
                                           keeps=None if kt is None else [kt] * n, bits=16,
                                           rows=rows, mesh=mesh)
            assert dequant_matmul.launches - before == 1
            assert dequant_matmul.launches_by_gemv_kernel["general"] == general
            assert torch.equal(y, dequant_matmul.dequant_matmul(x, q, scale, offset, kt,
                                                                bits=16, rows=rows)), (M, rows)


@pytest.mark.parametrize("M,K,N,layout", [(4, 2048, 2048, "kn"), (8, 2048, 8192, "kn"),
                                          (64, 8192, 2048, "kn"), (256, 2048, 2048, "kn"),
                                          (4, 2048, 4096, "transposed"),
                                          (64, 2048, 4096, "transposed")])
def test_n_split_default_leaves_b2_unchanged(dev, M, K, N, layout):
    """``n_split`` defaults to N: passing N changes no bit on either route."""
    x, q, scale, offset = _dqmm_operands(dev, M, K, N, torch.uint16, layout, torch.bfloat16, M)
    for launch in (dequant_matmul._launch_gemv, dequant_matmul._launch_mma,
                   dequant_matmul.dequant_matmul):
        assert torch.equal(launch(x, q, scale, offset),
                           launch(x, q, scale, offset, n_split=N)), launch
    with pytest.raises(ValueError, match="n_split"):
        dequant_matmul.dequant_matmul(x, q, scale, offset, n_split=N - 8)


def test_sharded_server_equals_one_device_at_every_stage(dev):
    """A 2-layer server on 2 and 4 logical shards, an upgrade every other
    step: quantized, every logit and token ``torch.equal`` to one
    device's; float residency (cuBLAS on N/n columns may sum in another
    order), logits within 1e-2 of the largest."""
    from repro_torch.serving import ProgressiveServer

    model, prog = _spec_model(dev)
    prompt = torch.randint(0, model.cfg.vocab, (3, 12), generator=torch.Generator().manual_seed(4))
    for resident in ("quantized", "fp"):
        runs = []
        for n in (None, 2, 4):
            srv = ProgressiveServer(model, prog, max_len=12 + 20, resident=resident,
                                    mesh=None if n is None else _mesh(dev, n), device=dev)
            srv.receive_stage()
            srv.start({"tokens": prompt})
            steps = [(None, srv.last_logits.clone())]
            for i in range(20):
                if srv.stage < prog.n_stages and i % 2 == 0:
                    srv.receive_stage()
                tokens = srv.decode(1).tokens
                steps.append((tokens, srv.last_logits.clone()))
            assert srv.stage == 8
            runs.append(steps)
        for steps in runs[1:]:
            for (t0, l0), (t1, l1) in zip(runs[0], steps):
                if resident == "quantized":
                    assert torch.equal(l0, l1) and (t0 is None or torch.equal(t0, t1))
                else:
                    assert (l0 - l1).abs().max().item() <= 1e-2 * l0.abs().max().item()


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-7b"])
def test_sharded_recurrent_serving_equals_one_device(dev, name):
    """A recurrent arch (bfloat16; zamba2-7b at 13 layers, both uses of the
    shared block) on 2 logical shards, its ``conv_w`` and ``r`` gathered
    home: the quantized server, an upgrade every other step, every logit
    and token ``torch.equal`` to one device's; the chunked pool's tokens
    equal."""
    from repro_torch.serving import PoolRequest, ProgressiveServer, SlotPoolEngine

    pool1 = _recurrent_pool(dev, name, **({"n_layers": 13} if name == "zamba2-7b" else {}))
    model, prog = pool1.model, pool1.prog
    prompt = torch.randint(0, 128, (3, 12), generator=torch.Generator().manual_seed(4))
    runs, pools = [], []
    for n in (None, 2):
        mesh = None if n is None else _mesh(dev, n)
        srv = ProgressiveServer(model, prog, max_len=12 + 16, resident="quantized", mesh=mesh,
                                device=dev)
        srv.receive_stage()
        srv.start({"tokens": prompt})
        steps = [(None, srv.last_logits.clone())]
        for i in range(16):
            if srv.stage < prog.n_stages and i % 2 == 0:
                srv.receive_stage()
            steps.append((srv.decode(1).tokens, srv.last_logits.clone()))
        assert srv.stage == 8
        runs.append(steps)
        pool = SlotPoolEngine(model, prog, n_slots=3, max_len=40, resident="quantized",
                              dispatch_window=2, prefill_chunk=4, mesh=mesh, device=dev)
        pool.receive_stage()
        rng = np.random.default_rng(0)
        for rid in range(5):
            pool.submit(PoolRequest(rid=rid, prompt=rng.integers(0, 128, 3 + 3 * rid),
                                    max_new_tokens=6))
        pools.append(pool.run(on_window=lambda _: pool.upgrade_if_available()))
    for (t0, l0), (t1, l1) in zip(*runs):
        assert torch.equal(l0, l1) and (t0 is None or torch.equal(t0, t1))
    assert pools[0] == pools[1] and len(pools[0]) == 5


def test_serving_mesh_needs_cards_unless_told(dev):
    from repro_torch.launch.mesh import home_device, make_serving_mesh

    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_serving_mesh(n)
    mesh = make_serving_mesh(n, devices=[dev] * n)
    assert mesh.shape["model"] == n and mesh.home == torch.device("cuda", 0)
    # an entry point on the mesh runs on its home device, and says so
    assert home_device(mesh, "cuda") == mesh.home
    with pytest.raises(ValueError, match="home device"):
        home_device(mesh, torch.device("cuda", 1))


# ---------------------------------------------------------------------------
# cross caches (ROADMAP A8(e)): every key valid, every row at q_pos = S
# ---------------------------------------------------------------------------

def _cross_operands(dev, B, T, H, Kh, S, hd, dtype, seed):
    """q (B, T, H, hd) over a memory cache (B, Kh, S, hd) as the cross
    blocks read it: ``k_pos = arange(S)`` on every slot, every row at
    ``q_pos = S`` (no key is past a query)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    q_pos = torch.full((B, T), S, dtype=torch.int32, device=dev)
    return q, k, v, k_pos, q_pos


# seamless-m4t-medium's decoder over a 64-token prompt's 16 frames (half a
# 32-key chunk), and llama-3.2-vision-90b's cross layers at its published
# heads over one tile's 1601 image embeddings (not a multiple of 32)
CROSS_SHAPES = [(4, 16, 16, 16, 64), (4, 64, 8, 1601, 128)]


@pytest.mark.parametrize("B,H,Kh,S,hd", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_over_cross_cache(dev, B, H, Kh, S, hd, dtype):
    """B3 (one row a slot) and B4 (T = 5 rows a slot) within the stated
    tolerance of their plain versions, and every B4 row equal to a B3
    launch of that row, bit for bit."""
    q, k, v, k_pos, q_pos = _cross_operands(dev, B, 5, H, Kh, S, hd, dtype, S + hd)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    out = verify_attention.flash_verify(q, k, v, k_pos, q_pos)
    want = ref.flash_verify_ref(q, k, v, k_pos, q_pos)
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    for t in range(5):
        row = decode_attention.flash_decode(q[:, t].contiguous(), k, v, k_pos,
                                            q_pos[:, t].contiguous())
        want_row = ref.flash_decode_ref(q[:, t], k, v, k_pos, q_pos[:, t])
        assert (row.float() - want_row).abs().max().item() <= \
            tol * max(1.0, want_row.abs().max().item())
        assert torch.equal(out[:, t], row), f"row {t}"


@pytest.mark.parametrize("M", [1, 4, 64])
def test_dequant_matmul_at_seamless_unembedding(dev, M):
    """seamless-m4t-medium's tied unembedding: the (256206, 1024) table's
    transposed view, N not a multiple of 8, on the one-pass K-contiguous
    GEMV kernel below 16 rows and the tensor-core kernel at 64, float32
    x, within 1e-4 of the plain version."""
    x, q, scale, offset = _dqmm_operands(dev, M, 1024, 256206, torch.uint16, "transposed",
                                         torch.float32, M)
    assert dequant_matmul.one_pass(q)
    _assert_dqmm_close(dequant_matmul.dequant_matmul(x, q, scale, offset), x, q, scale,
                       offset)


def test_seamless_decode_step_never_syncs(dev):
    """A reduced seamless-m4t-medium (encoder, ``selfcross`` blocks) on the
    card in bfloat16: after the prefill, a decode step (B3 over the self
    and the cross caches), an upgrade and a verify step under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer

    model = build_model(get_config("seamless-m4t-medium").reduced(
        d_model=256, n_heads=4, n_kv=4, d_ff=512, vocab=512, dtype=torch.bfloat16))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(0), device=dev))
    srv = ProgressiveServer(model, prog, max_len=48, resident="quantized", device=dev)
    srv.receive_stage()
    g = torch.Generator(device=dev).manual_seed(1)
    srv.start({"tokens": torch.arange(24).reshape(2, 12),
               "enc_input": torch.randn((2, 3, 256), generator=g, device=dev)})
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    block = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, caches = model.decode_step(srv.params, srv.caches, tok, 12)
        srv.receive_stage()
        logits, caches = model.decode_step(srv.params, caches, tok, 13)
        vlogits, caches = model.verify_step(srv.params, caches, block, 14)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(vlogits).all())


def test_vision_pool_takes_images_on_the_card(dev):
    """A reduced llama-3.2-vision-90b pool (batch-1 admission) on the
    card: images submitted as tensors on the card give the tokens of the
    same images submitted as numpy arrays."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving import PoolRequest, SlotPoolEngine

    model = build_model(get_config("llama-3.2-vision-90b").reduced())
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    gates = params["decoder"]["cycles"]["4_cross"]
    for name in ("gate_attn", "gate_mlp"):
        gates[name].copy_(torch.empty_like(gates[name]).uniform_(0.5, 1.0, generator=g))
    prog = divide(params)
    cfg = model.cfg
    images = torch.randn((2, cfg.vision_tokens, cfg.d_vision), generator=g, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 14)]

    def run(as_numpy: bool) -> dict:
        pool = SlotPoolEngine(model, prog, n_slots=2, max_len=40, resident="quantized",
                              device=dev)
        for _ in range(8):
            pool.receive_stage()
        for rid, prompt in enumerate(prompts):
            image = images[rid].cpu().numpy() if as_numpy else images[rid]
            pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=8,
                                    extras={"vision_embeds": image}))
        assert pool.chunked_prefill is False
        return pool.run()

    assert run(as_numpy=False) == run(as_numpy=True)


# ---------------------------------------------------------------------------
# the paper's CNN (progressivenet-cnn): progressive inference on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,batch", [(16, 64), (224, 8)])
def test_cnn_progressive_inference_against_plain(dev, size, batch):
    """The CNN at its published widths divided on the card (B6) and fed
    through a v3 client (B1 a stage): its planes and wire bytes equal the
    CPU's, the stage-8 accumulators equal ``quantize(leaf).q``, the leaves
    at each stage equal the CPU client's, and the logits on them are
    within 1e-4 of the CPU's largest |logit|. ``cnn_apply`` runs its
    convolutions in IEEE float32 and leaves cuDNN's TF32 switch as it
    found it."""
    from repro_torch.configs.progressivenet_cnn import cnn_apply, cnn_init
    from repro_torch.core import wire
    from repro_torch.core.progressive import divide
    from repro_torch.core.quantize import quantize
    from repro_torch.transmission import ProgressiveClient

    params = cnn_init(torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    before = bitplane.plane_extract_launches
    prog, cpu_prog = divide(params), divide(cpu_params)
    assert bitplane.plane_extract_launches - before == 8 * len(prog.tensors) == 104
    for t, c in zip(prog.tensors, cpu_prog.tensors):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(t.planes, c.planes)), t.path
    blob = wire.encode(prog, integrity=True)
    assert blob == wire.encode(cpu_prog, integrity=True)
    x = torch.from_numpy(np.random.default_rng(size).standard_normal(
        (batch, size, size, 3)).astype(np.float32))
    client, cpu_client = ProgressiveClient(device=dev), ProgressiveClient(device="cpu")
    meta, hdr = wire.decode_header(blob)
    ends = np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()
    tf32 = torch.backends.cudnn.allow_tf32 = True   # the default, which cnn_apply overrides
    client.feed(blob[:ends[0]])
    cpu_client.feed(blob[:ends[0]])
    before = bitplane.launches
    for s in range(1, len(ends)):
        client.feed(blob[ends[s - 1]:ends[s]])
        cpu_client.feed(blob[ends[s - 1]:ends[s]])
        leaves, cpu_leaves = client.materialize(), cpu_client.materialize()
        for k, v in cpu_leaves.items():
            assert torch.equal(leaves[k].cpu(), v), (s, k)
        got, want = cnn_apply(leaves, x.to(dev)), cnn_apply(cpu_leaves, x)
        assert torch.backends.cudnn.allow_tf32 is tf32
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (s, err)
    assert bitplane.launches - before == 8
    for i, t in enumerate(prog.tensors):
        assert torch.equal(client.store._slice_acc(i), quantize(params[t.path[0]], 16).q), t.path


def _train_batch(vocab: int, B: int = 2, S: int = 32) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b", "xlstm-125m"])
def test_train_step_on_card_against_cpu(dev, arch):
    """Reduced float32 archs (dense, MoE, recurrent): the loss and each
    leaf's gradient on the card against the CPU's plain path on the same
    params and batch, then one AdamW update on the CPU's gradients on
    both. The card's float32 matmuls sum in other orders (TF32 off), hence
    the tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat = dict(tree_flatten_with_path(cpu))
    skeleton = tree_skeleton(cpu)
    batch = _train_batch(cfg.vocab)
    trees, losses, grads = {}, {}, {}
    for side in ("cpu", "cuda"):
        trees[side] = tree_unflatten(skeleton,
                                     {p: v.to(side).requires_grad_(True) for p, v in flat.items()})
        loss, _ = model.loss(trees[side], {k: v.to(side) for k, v in batch.items()})
        leaves = [v for _, v in tree_flatten_with_path(trees[side])]
        losses[side] = float(loss.detach())
        grads[side] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-9
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1)
    paths = list(flat)
    for side, tree in trees.items():
        g = tree_unflatten(skeleton, {p: v.to(side) for p, v in zip(paths, grads["cpu"])})
        opt.update(ocfg, g, opt.init(tree), tree)
    for (p, a), (_, b) in zip(tree_flatten_with_path(trees["cuda"]),
                              tree_flatten_with_path(trees["cpu"])):
        a, b = a.detach().cpu(), b.detach()
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()) + 1e-9, p


def test_checkpoint_on_card(dev, tmp_path):
    """Reduced olmo-1b trained two steps on the card, then saved there (B6,
    8 launches a tensor): the files equal a CPU save's of the same params;
    the checkpoint fed to a client on the card (B1, one launch a stage)
    holds ``quantize(leaf).q`` of every tensor at stage 8, and
    ``load_flat`` its leaves."""
    from repro_torch.configs import get_config
    from repro_torch.core import wire
    from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
    from repro_torch.core.quantize import quantize
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import train

    cfg = get_config("olmo-1b").reduced()
    res = train(build_model(cfg), steps=2, device=dev,
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2))
    assert all(np.isfinite(h["loss"]) for h in res.history)
    leaves = dict(tree_flatten_with_path(res.params))
    before = bitplane.plane_extract_launches
    prog = checkpoint.save(res.params, str(tmp_path / "card"))
    assert bitplane.plane_extract_launches - before == 8 * len(prog.tensors) == 8 * len(leaves)
    checkpoint.save(tree_unflatten(tree_skeleton(res.params),
                                   {p: v.detach().cpu() for p, v in leaves.items()}),
                    str(tmp_path / "cpu"))
    for f in ["header.bin"] + [f"stage_{s:02d}.bin" for s in range(1, 9)]:
        assert (tmp_path / "card" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes(), f
    before = bitplane.launches
    client = checkpoint.feed(str(tmp_path / "card"), device=dev)
    assert bitplane.launches - before == 8 and client.stages_complete == 8
    for i, t in enumerate(prog.tensors):
        assert torch.equal(client.store._slice_acc(i), quantize(leaves[t.path].detach(), 16).q)
    flat = checkpoint.load_flat(str(tmp_path / "card"), device=dev)
    want = client.materialize()
    assert sorted(flat) == sorted(wire.path_str(p) for p in leaves)
    assert all(torch.equal(flat[k], want[k]) for k in want)


def _example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``__main__`` block
    does not run)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, argv, kernels", [
    ("quickstart", [], ("plane_extract", "plane_or_segments")),
    ("train_then_transmit", ["--steps", "4"], ("plane_extract", "plane_or_segments")),
    ("progressive_serving", ["--decode-steps", "4"], ("plane_or_segments", "decode_attention")),
    ("progressive_serving", ["--decode-steps", "4", "--resident", "quantized"],
     ("dequant_matmul", "decode_attention")),
    ("progressive_serving", ["--decode-steps", "4", "--speculative"],
     ("dequant_matmul", "flash_verify")),
    ("progressive_serving", ["--decode-steps", "4", "--flash-crowd", "2"],
     ("plane_or_segments", "flash_verify")),
    ("expert_priority_moe", [], ("plane_extract", "plane_or_segments")),
], ids=["quickstart", "train", "serve", "serve-quantized", "serve-speculative",
        "serve-crowd", "moe"])
def test_example_runs_on_the_card(dev, name, argv, kernels, tmp_path, monkeypatch):
    """Each script of ``examples_torch/`` runs to its end on the card at
    small arguments (its ``main`` with ``--device cuda``), launching the
    kernels of its path; quickstart checks its stage-8 leaves against the
    singleton quantized model itself."""
    import tempfile

    def launches() -> dict:
        return {"plane_extract": bitplane.plane_extract_launches,
                "plane_or_segments": bitplane.launches,
                "dequant_matmul": dequant_matmul.launches,
                "decode_attention": decode_attention.launches,
                "flash_verify": verify_attention.launches}

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = launches()
    out = _example(name).main(argv + ["--device", "cuda"])
    after = launches()
    assert all(after[k] > before[k] for k in kernels), (after, before)
    if name == "quickstart":
        assert out["n_stages"] == 8 and len(out["logits"]) == 8
    elif name == "train_then_transmit":
        assert abs(out["accuracy"][8] - out["accuracy"][0]) <= 0.02
    elif name == "progressive_serving":
        assert out["blob_bytes"] > 0 and out["upgrades"]
    else:
        assert out["n_tensors"] == 22 and int(out["counts"].sum()) == 4 * 64 * 2
