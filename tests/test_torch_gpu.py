"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (sm_90a) and skips
without one. Run on the card with:

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: ``plane_or_segments`` exact; ``dequant_matmul`` within 1e-4
of the output's largest magnitude (only the order of the float32 sum
over K differs); ``flash_decode`` within 2e-5 (float32) or 2**-7
(bfloat16 output rounding) of the output's largest magnitude.
"""
import pytest
import torch

from repro_torch.kernels import bitplane, decode_attention, dequant_matmul, ref

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


@pytest.mark.parametrize("M,K,N", [(1, 64, 96), (4, 2048, 2048), (16, 300, 130),
                                   (256, 512, 512), (5, 8192, 64)])
@pytest.mark.parametrize("qdtype", [torch.uint8, torch.uint16, torch.uint32])
@pytest.mark.parametrize("layout", ["kn", "transposed", "strided"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul(dev, M, K, N, qdtype, layout, xdtype):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    hi = 256 if qdtype == torch.uint8 else 65536
    x = torch.randn((M, K), generator=g, device=dev).to(xdtype)
    if layout == "transposed":
        q = torch.randint(0, hi, (N, K), generator=g, device=dev).to(qdtype).T
    elif layout == "strided":
        q = torch.randint(0, hi, (K, 2 * N), generator=g, device=dev).to(qdtype)[:, ::2]
    else:
        q = torch.randint(0, hi, (K, N), generator=g, device=dev).to(qdtype)
    scale = torch.tensor([[3.0 / hi]], device=dev)
    offset = torch.tensor([[-1.4]], device=dev)
    y = dequant_matmul.dequant_matmul(x, q, scale, offset)
    want = ref.dequant_matmul_ref(x, q, scale, offset)
    err = (y - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-6


@pytest.mark.parametrize("B,H,Kh,S,hd", [(4, 16, 16, 112, 128), (3, 8, 2, 50, 64),
                                         (2, 8, 1, 300, 256), (1, 4, 4, 7, 32)])
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


def test_mixed_devices_raise(dev):
    with pytest.raises(ValueError):
        bitplane.plane_or_segments(torch.zeros(1024, dtype=torch.uint16, device=dev),
                                   torch.zeros(1024, dtype=torch.uint16),
                                   torch.zeros(1, dtype=torch.int32, device=dev))
