"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (sm_90a) and skips
without one. Run on the card with:

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: ``plane_or_segments``, ``plane_or`` and ``plane_extract``
exact; ``dequant_matmul`` within 1e-4 of the output's largest magnitude
on both routes (the GEMV kernel differs from the plain version only in
the order of the float32 sum over K; the tensor-core kernel's products
are exact and its float32 sums round, see its source note);
``flash_decode`` and ``flash_verify`` within 2e-5 (float32) or 2**-7
(bfloat16 output rounding) of the output's largest magnitude; every ``flash_verify`` row exactly equal to a ``flash_decode``
launch for that row.
"""
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


# M = 16, 17, 64 and 256, and the transposed layout at any M, take the
# tensor-core route (uint8/16 q); the rest and every uint32 q the GEMV route
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
    (decode) the GEMV kernel on (K, N) q and the tensor-core kernel on the
    K-contiguous view (the unembedding), at M = 1 too; uint32 q the GEMV
    kernel at any M; each launch counts once in all and once for its
    route."""
    for M, qdtype, layout, kind in [(64, torch.uint16, "kn", "mma"),
                                    (4, torch.uint16, "kn", "gemv"),
                                    (4, torch.uint16, "transposed", "mma"),
                                    (1, torch.uint16, "transposed", "mma"),
                                    (64, torch.uint32, "kn", "gemv")]:
        x, q, scale, offset = _dqmm_operands(dev, M, 512, 256, qdtype, layout, torch.bfloat16,
                                             1)
        before, by = dequant_matmul.launches, dict(dequant_matmul.launches_by_route)
        dequant_matmul.dequant_matmul(x, q, scale, offset)
        assert dequant_matmul.launches == before + 1
        assert dequant_matmul.launches_by_route == {**by, kind: by[kind] + 1}
    with pytest.raises(ValueError):
        dequant_matmul._launch_mma(x, q, scale, offset)


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


@pytest.mark.parametrize("B,H,Kh,S,hd", [(4, 16, 16, 112, 128), (3, 8, 2, 50, 64),
                                         (2, 8, 1, 300, 256), (1, 4, 4, 7, 32),
                                         (2, 24, 2, 70, 16)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode(dev, B, H, Kh, S, hd, window, softcap, dtype):
    g = torch.Generator(device=dev).manual_seed(B * S + hd)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(dtype)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    k_pos[0, S // 2:] = -1
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
    return q, k, v, k_pos, q_pos


@pytest.mark.parametrize("B,T,H,Kh,S,hd", [(8, 8, 16, 16, 160, 128), (3, 5, 8, 2, 50, 64),
                                           (2, 8, 16, 2, 300, 256), (3, 1, 4, 4, 7, 32),
                                           (3, 3, 24, 2, 33, 16)])
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
                                           (3, 3, 24, 2, 33, 16)])
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


def test_pool_step_and_upgrade_never_sync(dev):
    """On the card, ``step()`` (prefill ticks included) and a double-
    buffered upgrade run under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises on any operation that waits for the device."""
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
    assert pool.completed == set(range(5))
    assert all(len(v) == 6 for v in pool.outputs.values())
    assert pool.stage == prog.n_stages and pool._tick_count > 0


def test_client_feed_and_catch_up_upgrade_never_sync(dev):
    """On the card, a v3 client fed one stage's bytes (verify, upload,
    unpack, OR) and the wire-fed server's catch-up upgrade run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the device. The store then equals the
    in-memory receiver's."""
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
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in range(ends[1], ends[2], 997):
            client.feed(blob[a:min(a + 997, ends[2])])
        srv.receive_stage()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert client.stages_complete == srv.stage == 2
    state = ReceiverState.init(prog, device=dev)
    for s in (1, 2):
        state = state.receive(prog.stage(s))
    assert client.store.fingerprint() == state.store.fingerprint()
