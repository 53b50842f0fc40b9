"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` takes its plain
PyTorch version; here it is held against the JAX kernel run in
interpret mode, as ``tests/test_kernels.py`` runs it, on the same inputs
made with numpy. The CUDA kernels themselves are held against the same
plain versions on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``).

Tolerances: ``plane_or_segments``, ``plane_or`` and ``plane_extract``
are integer work and must match exactly. ``dequant_matmul`` and ``flash_decode`` are float32 on both
sides and differ only in the order of float32 sums (the Pallas kernel
sweeps K or S in blocks): rtol 2e-5 and atol 2e-4 / 2e-5, as the
reference's own kernel tests allow. The emulation of the tensor-core
route's arithmetic is held to the same tolerance, and to 1e-4 of the
largest output magnitude. ``flash_verify``'s plain version is
held within atol 1e-5 (float32, outputs of magnitude <= 3) against the
JAX plain version and the interpret-mode Pallas kernel, and its rows
exactly against the port's ``flash_decode_ref``. An emulation of the CUDA
attention body's order of arithmetic (chunks of 32 keys, warp = chunk mod
8, the warp-order combine) is held to the same decode and verify
tolerances against the JAX kernels, and its verify rows exactly against
its decode rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitplane import plane_extract as jax_plane_extract
from repro.kernels.bitplane import plane_or as jax_plane_or
from repro.kernels.bitplane import plane_or_segments as jax_plane_or_segments
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.dequant_matmul import dequant_matmul as jax_dequant_matmul
from repro.kernels.ref import flash_verify_ref as jax_flash_verify_ref
from repro.kernels.verify_attention import flash_verify as jax_flash_verify
from repro_torch.core.quantize import dequant_affine, quantize
from repro_torch.kernels import (bitplane, decode_attention, dequant_matmul, ops, ref,
                                 verify_attention)

NP_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}
TORCH_UINT = {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# plane_or_segments: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_plane_or_segments_exact(bits, layout):
    """Random accumulators and planes with one shift per 1024-element
    block. ``sparse`` leaves whole segments with a zero plane (the blocks
    of a shipment that does not touch them), as a compact round does."""
    rng = np.random.default_rng(bits)
    block, n_blocks = 1024, 6
    n = block * n_blocks
    width = 2 if bits <= 16 else 5
    shifts = rng.integers(0, bits - width + 1, n_blocks).astype(np.int32)
    acc = (rng.integers(0, 2 ** (bits - width), n) << width).astype(NP_UINT[bits])
    plane = rng.integers(0, 2 ** width, n).astype(NP_UINT[bits])
    if layout == "sparse":
        plane[block:3 * block] = 0
        plane[5 * block:] = 0
    want = np.asarray(jax_plane_or_segments(jnp.asarray(acc), jnp.asarray(plane),
                                            jnp.asarray(shifts), interpret=True))
    got = bitplane.plane_or_segments(_t(acc), _t(plane), _t(shifts), block=block)
    assert got.dtype == TORCH_UINT[bits]
    np.testing.assert_array_equal(got.numpy(), want)


def test_plane_or_segments_rejects_bad_operands():
    acc = torch.zeros(2048, dtype=torch.uint16)
    with pytest.raises(ValueError):
        bitplane.plane_or_segments(acc, acc[:1024], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitplane.plane_or_segments(acc, acc, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        bitplane.plane_or_segments(acc, acc.to(torch.uint8),
                                   torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# plane_extract and plane_or: exact
# ---------------------------------------------------------------------------

# (bits, widths) per container dtype: the paper's eight 2-bit planes and
# an uneven division of 16 bits, and their 8- and 32-bit counterparts
DIVISIONS = {8: [(8, (2, 2, 2, 2)), (8, (2, 2, 4))],
             16: [(16, (2,) * 8), (16, (4, 4, 8))],
             32: [(20, (5, 5, 5, 5)), (32, (4, 4, 8, 16))]}


def _division_cases():
    return [(c, bits, w) for c, divs in DIVISIONS.items() for bits, w in divs]


@pytest.mark.parametrize("container,bits,widths", _division_cases())
def test_plane_extract_and_plane_or_exact(container, bits, widths):
    """Every plane of a (37, 53) tensor (1,961 elements, no multiple of
    the 1024 block) extracted in q's dtype and in the plane's container
    dtype, then ORed back plane by plane, each step against the JAX
    kernels in interpret mode; the last OR restores q."""
    rng = np.random.default_rng(bits + len(widths))
    q = rng.integers(0, 2 ** bits, (37, 53), dtype=np.uint64).astype(NP_UINT[container])
    acc = np.zeros_like(q)
    jacc = jnp.asarray(acc)
    before = 0
    for w in widths:
        want = np.asarray(jax_plane_extract(jnp.asarray(q), bits=bits, before=before,
                                            width=w, interpret=True))
        got = bitplane.plane_extract(_t(q), bits=bits, before=before, width=w)
        assert got.dtype == TORCH_UINT[container]
        np.testing.assert_array_equal(got.numpy(), want)
        small = bitplane.plane_extract(_t(q), bits=bits, before=before, width=w,
                                       out_dtype=TORCH_UINT[8 if w <= 8 else 16 if w <= 16
                                                            else 32])
        np.testing.assert_array_equal(small.numpy(), want)
        before += w
        jacc = jax_plane_or(jacc, jnp.asarray(want), shift=bits - before, interpret=True)
        acc_t = bitplane.plane_or(_t(acc), small, shift=bits - before)
        assert acc_t.dtype == TORCH_UINT[container]
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(jacc))
        acc = acc_t.numpy()
    np.testing.assert_array_equal(acc, q)


@pytest.mark.parametrize("acc_bits,plane_bits", [(8, 32), (16, 8), (32, 8), (16, 32)])
def test_plane_or_mixed_dtypes_and_wrapping_shift_exact(acc_bits, plane_bits):
    """Planes wider than the accumulator and shifts that push bits past
    its top: only the bits that fit acc's dtype survive, as the
    reference's uint32 shift and cast keep them."""
    rng = np.random.default_rng(acc_bits * plane_bits)
    acc = rng.integers(0, 2 ** acc_bits, 3001, dtype=np.uint64).astype(NP_UINT[acc_bits])
    plane = rng.integers(0, 2 ** plane_bits, 3001, dtype=np.uint64).astype(
        NP_UINT[plane_bits])
    for shift in (0, 3, acc_bits - 1, 31):
        want = np.asarray(jax_plane_or(jnp.asarray(acc), jnp.asarray(plane), shift=shift,
                                       interpret=True))
        got = bitplane.plane_or(_t(acc), _t(plane), shift=shift)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plane_or_and_plane_extract_reject_bad_operands():
    q = torch.zeros(10, dtype=torch.uint16)
    with pytest.raises(ValueError):
        bitplane.plane_or(q, q[:5], shift=0)
    with pytest.raises(ValueError):
        bitplane.plane_or(q, q, shift=32)
    with pytest.raises(TypeError):
        bitplane.plane_or(q, q.to(torch.int32), shift=0)
    with pytest.raises(ValueError):
        bitplane.plane_extract(q, bits=16, before=10, width=8)
    with pytest.raises(ValueError):
        bitplane.plane_extract(q, bits=16, before=0, width=12, out_dtype=torch.uint8)
    with pytest.raises(TypeError):
        bitplane.plane_extract(q.to(torch.int16), bits=16, before=0, width=2)


# ---------------------------------------------------------------------------
# dequant_matmul: float32 tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "embed_T"])
@pytest.mark.parametrize("bits", [8, 16])
def test_dequant_matmul_vs_jax(M, transposed, bits):
    """``transposed`` passes q as the transposed view of a row-major
    (N, K) table, as the tied unembedding passes ``embed.T``."""
    rng = np.random.default_rng(M * 10 + bits + transposed)
    K, N = 96, 80
    x = rng.standard_normal((M, K)).astype(np.float32)
    table = rng.integers(0, 2 ** bits, (N, K) if transposed else (K, N)
                         ).astype(NP_UINT[bits])
    scale = np.float32(2.0 ** -bits * 3.1)
    offset = np.float32(-1.3)
    q_jax = jnp.asarray(table).T if transposed else jnp.asarray(table)
    want = np.asarray(jax_dequant_matmul(jnp.asarray(x), q_jax, scale, offset,
                                         bm=8, bn=32, bk=32, interpret=True))
    q = _t(table).T if transposed else _t(table)
    got = dequant_matmul.dequant_matmul(_t(x), q, torch.tensor([[scale]]),
                                        torch.tensor([[offset]]))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


def _stage_operands(seed, M, K, N, bits, stage, transposed, xkind):
    """Gaussian weights quantized to ``bits`` (the port's ``quantize``),
    the accumulator after the first stage (its top 2 bits) or the last
    (all bits) with the port's eq.-(5) affine for that precision, and x
    of zero (``randn``) or large positive mean (``relu3``: relu(randn) +
    3; ``silu``: SiLU of 2 randn)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((0.02 * rng.standard_normal((K, N))).astype(np.float32))
    qt = quantize(w, bits)
    m = 2 if stage == "first" else bits
    q = (qt.q.to(torch.int64) >> (bits - m) << (bits - m)).to(qt.q.dtype)
    scale, offset = dequant_affine(qt.lo, qt.hi, bits, received_bits=m)
    z = rng.standard_normal((M, K)).astype(np.float32)
    x = {"randn": z, "relu3": np.maximum(z, 0) + 3,
         "silu": 2 * z / (1 + np.exp(-2 * z))}[xkind].astype(np.float32)
    if transposed:   # q as the transposed view of a row-major (N, K) table
        q = q.T.contiguous().T
    return x, q, scale.reshape(1, 1), offset.reshape(1, 1)


@pytest.mark.parametrize("xkind,xdtype", [("randn", torch.float32), ("relu3", torch.float32),
                                          ("silu", torch.bfloat16),
                                          ("relu3", torch.bfloat16)])
@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "embed_T"])
@pytest.mark.parametrize("stage", ["first", "last"])
@pytest.mark.parametrize("bits", [8, 16])
def test_dequant_matmul_split_emulation_vs_jax(bits, stage, transposed, xkind, xdtype):
    """The tensor-core route's arithmetic (q centred and split into bf16
    byte planes, float32 x into three bf16 terms, float32 sums 16 deep),
    emulated by ``ref.dequant_matmul_split_ref``, against the JAX kernel
    in interpret mode at K = 8192 (its default K block of 512), with the
    port's stage-1 and stage-8 affines and activations of zero and of
    large positive mean: within
    the kernel tests' rtol 2e-5 / atol 2e-4, and within 1e-4 of max |y|
    (``chip_smoke.py``'s ``DQMM_RTOL``)."""
    M, K, N = 16, 8192, 80
    x, q, scale, offset = _stage_operands(bits + 100 * transposed, M, K, N, bits, stage,
                                          transposed, xkind)
    xt = torch.from_numpy(x).to(xdtype)
    x_jax = xt.to(torch.float32).numpy()   # the same values, bf16-exact or not
    q_jax = jnp.asarray(q.T.contiguous().numpy()).T if transposed else jnp.asarray(q.numpy())
    want = np.asarray(jax_dequant_matmul(jnp.asarray(x_jax), q_jax, scale.numpy(),
                                         offset.numpy(), bm=16, bn=128, bk=512,
                                         interpret=True))
    got = ref.dequant_matmul_split_ref(xt, q, scale, offset)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "embed_T"])
@pytest.mark.parametrize("stage", ["first", "last"])
@pytest.mark.parametrize("bits", [8, 16])
def test_dequant_matmul_gemv_emulation_vs_jax(bits, stage, transposed):
    """The GEMV route's one-pass arithmetic (q centred, exact products,
    the kernel's fixed chunks of K and its order of sums), emulated by
    ``ref.dequant_matmul_gemv_ref``, against the JAX kernel in interpret
    mode with its default blocks (bk = 512), at K = 2048 and 8192, M = 8,
    with the port's stage-1 and stage-8 affines and activations of zero
    mean (float32) and of large positive mean (bfloat16): within the
    kernel tests' rtol 2e-5 / atol 2e-4 and within 1e-4 of max |y|
    (``chip_smoke.py``'s ``DQMM_RTOL``), both sides being float32 sums of
    the same products in other orders. Rows of M = 1 and 4 launches are
    bit-equal to the M = 8 rows, as on the card."""
    N = 80
    for K, xkind, xdtype in [(2048, "randn", torch.float32), (8192, "relu3", torch.bfloat16)]:
        x, q, scale, offset = _stage_operands(bits + 10 * transposed + K, 8, K, N, bits, stage,
                                              transposed, xkind)
        xt = torch.from_numpy(x).to(xdtype)
        q_jax = (jnp.asarray(q.T.contiguous().numpy()).T if transposed
                 else jnp.asarray(q.numpy()))
        want = np.asarray(jax_dequant_matmul(jnp.asarray(xt.to(torch.float32).numpy()), q_jax,
                                             scale.numpy(), offset.numpy(), interpret=True))
        got = ref.dequant_matmul_gemv_ref(xt, q, scale, offset)
        assert got.dtype == torch.float32 and got.shape == (8, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        for M in (1, 4):
            assert torch.equal(ref.dequant_matmul_gemv_ref(xt[:M], q, scale, offset), got[:M])


def test_dequant_matmul_gemv_chunks_depend_on_K_N_and_layout_only():
    """The one-pass kernels' chunks of K: a multiple of 512 up to 4096
    ((K, N) q) or 2048 (embed.T), at most 8, in clusters of 2 where the
    blocks of 32 (K, N) columns alone do not fill the card; whole K for
    embed.T; ``one_pass`` sends uint32 q and q that 8-value vector loads
    cannot read to the general kernels."""
    chunk = dequant_matmul.gemv_k_chunk
    assert [chunk(K, N, False) for K, N in [(2048, 2048), (8192, 2048), (2048, 8192)]] \
        == [1024, 4096, 2048]
    assert chunk(2048, 50304, True) == 2048 and chunk(8192, 64, True) == 2048
    assert chunk(300, 130, False) == 512 and chunk(16384, 64, False) == 4096
    assert chunk(16385, 64, False) == 3584 and chunk(24576, 6144, False) == 4096
    assert chunk(32769, 64, False) is None and chunk(16392, 64, True) is None
    q = torch.zeros((64, 48), dtype=torch.uint16)
    one_pass = dequant_matmul.one_pass
    assert one_pass(q) and one_pass(torch.zeros((48, 64), dtype=torch.uint8).T)
    assert not one_pass(q.to(torch.uint32)) and not one_pass(q[:, ::2])
    assert not one_pass(q[:, 1:]) and not one_pass(torch.zeros((64, 44), dtype=torch.uint16))


def test_dequant_matmul_cpu_takes_plain_version_and_counts_nothing():
    """On the CPU the wrapper returns the plain version, whatever route M
    would pick on the card, and counts no launch; either CUDA launch
    refuses a CPU tensor; the route is the tensor-core kernel from
    ``MMA_MIN_M`` rows of uint8/16 q, on both layouts, and the GEMV kernel
    below and for uint32 q."""
    rng = np.random.default_rng(5)
    scale, offset = torch.tensor([[3.0 / 65536]]), torch.tensor([[-1.4]])
    before = (dequant_matmul.launches, dict(dequant_matmul.launches_by_route))
    for M in (1, 4, 16, 64):
        x = _t(rng.standard_normal((M, 96)).astype(np.float32))
        q = _t(rng.integers(0, 65536, (96, 40)).astype(np.uint16))
        got = dequant_matmul.dequant_matmul(x, q, scale, offset)
        assert torch.equal(got, ref.dequant_matmul_ref(x, q, scale, offset))
        for launch in (dequant_matmul._launch_gemv, dequant_matmul._launch_mma):
            with pytest.raises(ValueError):
                launch(x, q, scale, offset)
    assert (dequant_matmul.launches, dict(dequant_matmul.launches_by_route)) == before
    lo = dequant_matmul.MMA_MIN_M
    assert dequant_matmul.route(lo, torch.uint16) == "mma"
    assert dequant_matmul.route(64, torch.uint8) == "mma"
    assert dequant_matmul.route(lo - 1, torch.uint16) == "gemv"
    assert dequant_matmul.route(256, torch.uint32) == "gemv"
    assert dequant_matmul.route(1, torch.uint8) == "gemv"


def test_dequant_matmul_rejects_bad_operands():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.uint16)
    one = torch.ones(1, 1)
    with pytest.raises(ValueError):
        dequant_matmul.dequant_matmul(x, torch.zeros(7, 4, dtype=torch.uint16), one, one)
    with pytest.raises(TypeError):
        dequant_matmul.dequant_matmul(x, q.to(torch.int32), one, one)
    with pytest.raises(ValueError):
        dequant_matmul.dequant_matmul(x, q, torch.ones(2), one)


# ---------------------------------------------------------------------------
# flash_decode: float32 tolerance
# ---------------------------------------------------------------------------

def _attention_inputs(seed, B, H, Kh, hd, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Kh, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Kh, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("Kh,window,softcap", [
    (4, 0, 0.0),     # MHA (olmo's G = 1)
    (2, 0, 0.0),     # GQA
    (2, 24, 0.0),    # sliding window
    (1, 0, 30.0),    # MQA + softcap
    (2, 16, 25.0),   # all at once
])
def test_flash_decode_vs_jax(Kh, window, softcap):
    """Ragged slots: one at the end of the cache, one mid-way with empty
    cache slots beyond its prefix, one early, one free (q_pos = -1)."""
    B, H, hd, S = 4, 8, 32, 64
    q, k, v = _attention_inputs(Kh * 100 + window, B, H, Kh, hd, S)
    q_pos = np.array([63, 40, 7, -1], np.int32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos[1, 45:] = -1
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
        jnp.asarray(q_pos), window=window, softcap=softcap, bs=32, interpret=True))
    got = decode_attention.flash_decode(_t(q), _t(k), _t(v), _t(k_pos), _t(q_pos),
                                        window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_decode_all_free_pool_is_finite():
    """Every slot free and every cache entry empty: one call, finite
    output equal to the reference's (the mean of V)."""
    B, H, Kh, hd, S = 3, 4, 2, 32, 64
    q, k, v = _attention_inputs(13, B, H, Kh, hd, S)
    k_pos = np.full((B, S), -1, np.int32)
    q_pos = np.full((B,), -1, np.int32)
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
        jnp.asarray(q_pos), bs=32, interpret=True))
    got = decode_attention.flash_decode(_t(q), _t(k), _t(v), _t(k_pos), _t(q_pos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_decode_rejects_bad_operands():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 2, 16, 8)
    k_pos = torch.zeros(2, 16, dtype=torch.int32)
    q_pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention.flash_decode(q, k, k[:, :, :8], k_pos, q_pos)
    with pytest.raises(ValueError):
        decode_attention.flash_decode(q, k, k, k_pos[:, :8], q_pos)
    with pytest.raises(ValueError):
        decode_attention.flash_decode(torch.zeros(2, 3, 8), k, k, k_pos, q_pos)


# ---------------------------------------------------------------------------
# flash_verify: float32 tolerance against JAX, exact against decode rows
# ---------------------------------------------------------------------------

def _verify_inputs(seed, B, T, H, Kh, hd, S):
    """Slot 0 at the end of the cache, slot 1 ragged (empty cache entries
    past 30, its last rows masked as past a short final chunk), slot 2
    free (every row masked)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Kh, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Kh, S, hd)).astype(np.float32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos[1, 30:] = -1
    q_pos = np.stack([np.arange(S - T, S), np.arange(20, 20 + T),
                      np.full(T, -1)]).astype(np.int32)
    q_pos[1, max(1, T - 2):] = -1
    return q, k, v, k_pos, q_pos


@pytest.mark.parametrize("G,T,window,softcap", [
    (1, 1, 0, 0.0), (1, 5, 0, 0.0), (1, 8, 0, 0.0),     # MHA (olmo's G = 1)
    (2, 1, 0, 0.0), (2, 5, 0, 0.0), (2, 8, 0, 0.0),     # GQA
    (2, 5, 12, 0.0),                                    # sliding window
    (1, 8, 0, 30.0),                                    # softcap
    (2, 8, 12, 25.0),                                   # both
])
def test_flash_verify_vs_jax(G, T, window, softcap):
    """S = 37 is no multiple of the Pallas block, so the JAX kernel pads
    the cache with zero rows; the port's plain version never pads. A
    masked row attends to nothing and comes out as the mean of V over the
    cache it sees (padding included, in the JAX kernel), a value every
    caller discards: against the kernel, only the live rows are held."""
    B, Kh, hd, S = 3, 2, 16, 37
    q, k, v, k_pos, q_pos = _verify_inputs(G * 10 + T, B, T, Kh * G, Kh, hd, S)
    args = [jnp.asarray(a) for a in (q, k, v, k_pos, q_pos)]
    want_ref = np.asarray(jax_flash_verify_ref(*args, window=window, softcap=softcap))
    want_kernel = np.asarray(jax_flash_verify(*args, window=window, softcap=softcap,
                                              bs=16, interpret=True))
    got = ops.flash_verify(*(_t(a) for a in (q, k, v, k_pos, q_pos)), window=window,
                           softcap=softcap)
    assert got.shape == (B, T, Kh * G, hd) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=1e-5)
    live = q_pos >= 0
    np.testing.assert_allclose(got.numpy()[live], want_kernel[live], rtol=0, atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 25.0)])
def test_flash_verify_rows_equal_flash_decode(window, softcap):
    """Each row of the verify plain version is a decode step at that row's
    position, bit for bit: the property chunked prefill and lossless
    speculation rest on."""
    q, k, v, k_pos, q_pos = (_t(a) for a in _verify_inputs(5, 3, 6, 4, 2, 16, 40))
    out = ref.flash_verify_ref(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
    for t in range(q.shape[1]):
        row = ref.flash_decode_ref(q[:, t], k, v, k_pos, q_pos[:, t], window=window,
                                   softcap=softcap)
        assert torch.equal(out[:, t], row), f"row {t}"
    assert torch.equal(ref.flash_prefill_ref(q, k, v, k_pos, q_pos, window=window,
                                             softcap=softcap), out)


def test_flash_verify_rejects_bad_operands():
    q = torch.zeros(2, 3, 4, 8)
    k = torch.zeros(2, 2, 16, 8)
    k_pos = torch.zeros(2, 16, dtype=torch.int32)
    q_pos = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q, k, k[:, :, :8], k_pos, q_pos)
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q, k, k, k_pos, q_pos[:, :2])
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q[:, :, :3], k, k, k_pos, q_pos)
    with pytest.raises(ValueError):
        verify_attention.flash_verify(q[0], k, k, k_pos, q_pos)


# ---------------------------------------------------------------------------
# the CUDA attention body's order of arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

_CHUNK, _WARPS, _NP = 32, 8, 4


def _fma(a, b, c):
    """fmaf to within double rounding: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _exp(x):
    # through float64, so every element rounds alike wherever it lies
    return torch.exp(x.double()).float()


def _emulate_attention_rows(q, k, v, k_pos, q_pos, window=0, softcap=0.0):
    """Each row of ``csrc/attention_rows.cuh`` in its order of arithmetic.

    q (B, T, H, hd), k/v (B, Kh, S, hd) float32, k_pos (B, S), q_pos (B, T).
    Scores: q scaled, dims zero-padded to HDP = 32 * DPL, NP = 4 partial
    fma sums over d % 4 in d order, added as a fixed tree. Keys in chunks
    of 32 (a lane each), chunk c to warp c % 8; per chunk and row one max,
    p = exp(x - m_new), the 32 p added by the xor butterfly, l = fma(l,
    corr, sum), acc = acc * corr, then the 32 keys' fma into acc in cache
    order. The 8 warps' states combine in warp order. Nothing here depends
    on B, T, the heads or other rows."""
    B, T, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    G = H // Kh
    hdp = 32 * next(n for n in (1, 2, 4, 8) if hd <= 32 * n)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    pad = (0, hdp - hd)
    qs = torch.nn.functional.pad(q * scale, pad)                    # (B, T, H, hdp)
    heads = torch.arange(H) // G
    kk = torch.nn.functional.pad(k, pad)[:, heads]                  # (B, H, S, hdp)
    vv = torch.nn.functional.pad(v, pad)[:, heads]
    n_chunks = -(-S // _CHUNK)
    s_pad = n_chunks * _CHUNK - S
    part = torch.zeros((_NP, B, T, H, S))
    for d in range(hdp):
        part[d % _NP] = _fma(qs[..., d, None], kk[:, None, :, :, d], part[d % _NP])
    sc = (part[0] + part[1]) + (part[2] + part[3])
    if softcap:
        sc = (torch.tanh((sc / softcap).double()).float()) * softcap
    kp, qp = k_pos[:, None, None, :], q_pos[:, :, None, None]
    valid = (kp >= 0) & (kp <= qp) & (qp >= 0)
    if window:
        valid &= kp > qp - window
    x = torch.where(valid, sc, torch.tensor(-1e30))
    x = torch.nn.functional.pad(x, (0, s_pad), value=-float("inf"))
    vv = torch.nn.functional.pad(vv, (0, 0, 0, s_pad))
    m = torch.full((_WARPS, B, T, H), -1e30)
    l = torch.zeros((_WARPS, B, T, H))
    acc = torch.zeros((_WARPS, B, T, H, hdp))
    lanes = torch.arange(_CHUNK)
    for c in range(n_chunks):
        w, keys = c % _WARPS, slice(c * _CHUNK, (c + 1) * _CHUNK)
        xc = x[..., keys]
        m_new = torch.maximum(m[w], xc.max(-1).values)
        p = _exp(xc - m_new[..., None])
        corr = _exp(m[w] - m_new)
        ps = p
        for o in (16, 8, 4, 2, 1):
            ps = ps + ps[..., lanes ^ o]
        l[w] = _fma(l[w], corr, ps[..., 0])
        a = acc[w] * corr[..., None]
        for s in range(_CHUNK):
            a = _fma(p[..., s, None], vv[:, None, :, c * _CHUNK + s], a)
        acc[w], m[w] = a, m_new
    mx = m.max(0).values
    den = torch.zeros((B, T, H))
    num = torch.zeros((B, T, H, hdp))
    for w in range(_WARPS):
        cw = _exp(m[w] - mx)
        den = _fma(l[w], cw, den)
        num = _fma(acc[w], cw[..., None], num)
    return (num / torch.clamp(den, min=1e-30)[..., None])[..., :hd]


@pytest.mark.parametrize("S,Kh,window,softcap", [
    (64, 4, 0, 0.0),      # MHA, two whole chunks
    (70, 2, 24, 0.0),     # GQA, a ragged third chunk, sliding window
    (300, 1, 16, 25.0),   # MQA, 10 chunks: warps 0 and 1 take two each
])
def test_attention_rows_emulation_vs_jax_flash_decode(S, Kh, window, softcap):
    """The CUDA body's order of arithmetic, held against the JAX kernel in
    interpret mode at the decode tolerance; every row that attends to a key
    (the JAX kernel pads S with masked keys, which a free row would see)."""
    B, H, hd = 4, 8, 32
    q, k, v = _attention_inputs(S + Kh, B, H, Kh, hd, S)
    q_pos = np.array([S - 1, 40, 7, -1], np.int32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos[1, 45:] = -1
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
        jnp.asarray(q_pos), window=window, softcap=softcap, bs=32, interpret=True))
    got = _emulate_attention_rows(_t(q)[:, None], _t(k), _t(v), _t(k_pos),
                                  _t(q_pos)[:, None], window=window, softcap=softcap)[:, 0]
    assert torch.isfinite(got).all()
    live = q_pos >= 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("G,T,window,softcap", [(1, 8, 0, 0.0), (2, 5, 12, 25.0)])
def test_attention_rows_emulation_vs_jax_flash_verify(G, T, window, softcap):
    """The emulated CUDA body against the JAX plain version and the JAX
    kernel in interpret mode at the verify tolerance (live rows against the
    kernel, as ``test_flash_verify_vs_jax``), and each of its verify rows
    equal, bit for bit, to the emulated decode launch of that row."""
    B, Kh, hd, S = 3, 2, 16, 37
    q, k, v, k_pos, q_pos = _verify_inputs(G * 10 + T, B, T, Kh * G, Kh, hd, S)
    args = [jnp.asarray(a) for a in (q, k, v, k_pos, q_pos)]
    want_ref = np.asarray(jax_flash_verify_ref(*args, window=window, softcap=softcap))
    want_kernel = np.asarray(jax_flash_verify(*args, window=window, softcap=softcap,
                                              bs=16, interpret=True))
    tq, tk, tv, tkp, tqp = (_t(a) for a in (q, k, v, k_pos, q_pos))
    got = _emulate_attention_rows(tq, tk, tv, tkp, tqp, window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=1e-5)
    live = q_pos >= 0
    np.testing.assert_allclose(got.numpy()[live], want_kernel[live], rtol=0, atol=1e-5)
    for t in range(T):
        row = _emulate_attention_rows(tq[:, t:t + 1], tk, tv, tkp, tqp[:, t:t + 1],
                                      window=window, softcap=softcap)
        assert torch.equal(got[:, t:t + 1], row), f"row {t}"


# ---------------------------------------------------------------------------
# the wrapper contract: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """``ops.LAUNCH_COUNTS`` counts every call at the call site; each
    kernel module's own ``launches`` counts CUDA launches only, so a CPU
    call leaves it where it was."""
    before = (bitplane.launches, dequant_matmul.launches, decode_attention.launches)
    ops.reset_launch_counts()
    acc = torch.zeros(1024, dtype=torch.uint16)
    out = ops.plane_or_segments(acc, torch.ones(1024, dtype=torch.uint16),
                                torch.full((1,), 3, dtype=torch.int32))
    assert int(out[0]) == 8
    ops.dequant_matmul(torch.ones(2, 4), torch.zeros(4, 3, dtype=torch.uint8),
                       torch.ones(1, 1), torch.ones(1, 1))
    ops.dequant_matmul(torch.ones(2, 4), torch.zeros(3, 4, dtype=torch.uint8).T,
                       torch.ones(1, 1), torch.ones(1, 1))
    kv = torch.zeros(1, 1, 4, 8)
    ops.decode_attention(torch.zeros(1, 1, 8), kv, kv,
                         torch.arange(4, dtype=torch.int32)[None],
                         torch.tensor([3], dtype=torch.int32))
    assert ops.LAUNCH_COUNTS == {"plane_or_segments": 1, "dequant_matmul": 2,
                                 "decode_attention": 1}
    assert (bitplane.launches, dequant_matmul.launches,
            decode_attention.launches) == before


def test_bitplane_entry_points_count_calls_and_launch_nothing_on_the_cpu():
    before = (bitplane.plane_or_launches, bitplane.plane_extract_launches)
    ops.reset_launch_counts()
    q = torch.tensor([0b1101_0010_0000_0111], dtype=torch.uint16)
    top = ops.plane_extract(q, bits=16, before=0, width=4, out_dtype=torch.uint8)
    assert top.dtype == torch.uint8 and int(top[0]) == 0b1101
    acc = ops.plane_or(torch.zeros(1, dtype=torch.uint16), top, shift=12)
    assert int(acc[0]) == 0b1101 << 12
    assert ops.LAUNCH_COUNTS == {"plane_extract": 1, "plane_or": 1}
    assert (bitplane.plane_or_launches, bitplane.plane_extract_launches) == before


def test_verify_entry_points_count_calls_and_launch_nothing_on_the_cpu():
    """The three names of the verify kernel count under the reference's
    names; a CPU call leaves the kernel's own launch count where it was."""
    before = verify_attention.launches
    ops.reset_launch_counts()
    kv = torch.zeros(1, 1, 4, 8)
    args = (torch.zeros(1, 2, 1, 8), kv, kv, torch.arange(4, dtype=torch.int32)[None],
            torch.tensor([[2, 3]], dtype=torch.int32))
    for fn in (ops.flash_verify, ops.verify_attention, ops.prefill_attention):
        assert fn(*args).shape == (1, 2, 1, 8)
    assert ops.LAUNCH_COUNTS == {"flash_verify": 1, "verify_attention": 1,
                                 "prefill_attention": 1}
    assert verify_attention.launches == before
