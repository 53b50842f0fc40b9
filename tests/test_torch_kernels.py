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
reference's own kernel tests allow. ``flash_verify``'s plain version is
held within atol 1e-5 (float32, outputs of magnitude <= 3) against the
JAX plain version and the interpret-mode Pallas kernel, and its rows
exactly against the port's ``flash_decode_ref``.
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
