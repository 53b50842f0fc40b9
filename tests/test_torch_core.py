"""The port's core numerics against the JAX package, held exactly.

Quantized values, lo/hi, planes, ``divide``'s tensor order and keys, the
flat accumulators and ``PlaneStore.fingerprint()`` CRCs must be
bit-identical to the reference's for the same inputs, after every stage
and for sparse shipments too. So must the float32 bytes of eager
dequantization and of the quantized views' scale and offset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bitplanes as jbp
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.plane_store import next_plane_shift as jax_next_plane_shift
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import ReceiverState as JReceiverState
from repro.core.progressive import divide as jax_divide
from repro.core.quantize import dequantize as jax_dequantize
from repro.core.quantize import quantize as jax_quantize
from repro.core.wire import path_str
from repro.models.model import build_model as jax_build_model
from repro_torch.core import bitplanes
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.plane_store import next_plane_shift
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import ReceiverState, divide
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.interop import params_from_numpy

# One schedule per container dtype (uint8, uint16, uint32).
SCHEDULES = {
    "uint8": ((8, (2, 2, 2, 2))),
    "uint16": ((16, (2,) * 8)),
    "uint32": ((20, (5, 5, 5, 5))),
}


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config("olmo-1b").reduced(n_layers=2, d_model=64, d_ff=128,
                                            vocab=128, n_heads=2, n_kv=2)
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("bits", [4, 8, 16, 20])
@pytest.mark.parametrize("kind", ["normal", "wide", "constant"])
def test_quantize_exact(bits, kind):
    rng = np.random.default_rng(bits)
    x = {"normal": rng.standard_normal((37, 53)),
         "wide": rng.standard_normal((5, 11, 7)) * 1e3 + 17.0,
         "constant": np.full((8, 8), 0.25)}[kind].astype(np.float32)
    want = jax_quantize(jnp.asarray(x), bits)
    got = quantize(torch.from_numpy(x), bits)
    assert str(got.q.dtype).endswith(str(want.q.dtype))
    np.testing.assert_array_equal(_as_np(got.q), np.asarray(want.q))
    assert _as_np(got.lo).tobytes() == np.asarray(want.lo).tobytes()
    assert _as_np(got.hi).tobytes() == np.asarray(want.hi).tobytes()
    for m in (0, bits // 2, bits):
        assert _as_np(dequantize(got, m)).tobytes() == \
            np.asarray(jax_dequantize(want, m)).tobytes()


@pytest.mark.parametrize("widths", [(2,) * 8, (1, 3, 12), (8, 8), (16,)])
def test_split_plane_and_concat_exact(widths):
    x = np.random.default_rng(len(widths)).standard_normal((41, 29)).astype(np.float32)
    jq = jax_quantize(jnp.asarray(x), 16)
    q = quantize(torch.from_numpy(x), 16)
    planes = []
    for m in range(1, len(widths) + 1):
        want = np.asarray(jbp.split_plane(jq.q, 16, widths, m))
        got = bitplanes.split_plane(q.q, 16, widths, m)
        assert str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_array_equal(_as_np(got), want)
        planes.append(got)
        np.testing.assert_array_equal(
            _as_np(bitplanes.concat(planes, 16, widths)),
            np.asarray(jbp.concat([jnp.asarray(_as_np(p)) for p in planes], 16, widths)))
    np.testing.assert_array_equal(_as_np(bitplanes.concat(planes, 16, widths)),
                                  _as_np(q.q))


def test_divide_tensor_order_keys_and_planes_exact(jax_params):
    jprog = jax_divide(jax_params)
    prog = divide(params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu"))
    assert [path_str(t.path) for t in jprog.tensors] == \
        ["/".join(t.path) for t in prog.tensors]
    assert prog.n_stages == jprog.n_stages == 8
    for jt, t in zip(jprog.tensors, prog.tensors):
        assert t.shape == jt.shape
        assert _as_np(t.lo).tobytes() == np.asarray(jt.lo).tobytes()
        assert _as_np(t.hi).tobytes() == np.asarray(jt.hi).tobytes()
        for jp, p in zip(jt.planes, t.planes):
            np.testing.assert_array_equal(_as_np(p), np.asarray(jp))
    for s in range(1, 9):
        assert [i for i, _ in prog.stage(s)] == [i for i, _ in jprog.stage(s)]


@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_store_accumulators_and_fingerprint_every_stage(jax_params, container):
    """Full-stage upgrades: after every stage the flat buffers, their CRCs
    and the quantized views' float32 affine equal the reference's."""
    bits, widths = SCHEDULES[container]
    jprog = jax_divide(jax_params, JUniformPolicy(schedule=JSchedule(bits, widths)))
    prog = divide(params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu"),
                  UniformPolicy(schedule=PlaneSchedule(bits, widths)))
    jst = JReceiverState.init(jprog)
    st = ReceiverState.init(prog, device="cpu")
    assert st.store.fingerprint() == jst.store.fingerprint()
    for s in range(1, prog.n_stages + 1):
        jst = jst.receive(jprog.stage(s))
        st = st.receive(prog.stage(s))
        assert st.store.fingerprint() == jst.store.fingerprint(), f"stage {s}"
        for dt, buf in st.store.buffers.items():
            np.testing.assert_array_equal(_as_np(buf), np.asarray(jst.store.buffers[dt]))
        jleaves = jst.store.quantized_leaves()
        leaves = st.store.quantized_leaves()
        # no leaf eligible: every leaf dequantized to float at its precision
        jfloat = jst.store.quantized_leaves(eligible=lambda key: False)
        floats = st.store.quantized_leaves(eligible=lambda key: False)
        for jt, t in zip(jprog.tensors, prog.tensors):
            jl, l = jleaves[jt.path], leaves[t.path]
            for name in ("scale", "offset", "received_bits", "lo", "hi"):
                assert _as_np(getattr(l, name)).tobytes() == \
                    np.asarray(getattr(jl, name)).tobytes(), (t.path, name, s)
            assert _as_np(floats[t.path]).tobytes() == \
                np.asarray(jfloat[jt.path]).tobytes(), (t.path, s)
        for i, slot in enumerate(st.store.slots):
            if st.store.received[i] < slot.schedule.n_planes:
                assert next_plane_shift(slot.schedule, st.store.received[i]) == \
                    jax_next_plane_shift(jst.store.slots[i].schedule,
                                         jst.store.received[i])


def test_store_sparse_shipments_exact(jax_params):
    """Shipments that touch only some tensors (the gather/scatter path),
    including two planes of one tensor in one shipment (two rounds)."""
    jprog = jax_divide(jax_params)
    prog = divide(params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu"))
    jst = JReceiverState.init(jprog).store
    st = ReceiverState.init(prog, device="cpu").store
    shipments = [[0, 3], [7], [0, 0, 5], [1, 2, 4, 6], [3, 7, 7]]
    sent = [0] * len(prog.tensors)
    for ship in shipments:
        items = []
        for i in ship:
            items.append((i, sent[i]))
            sent[i] += 1
        jst.ingest([(i, jprog.tensors[i].planes[m]) for i, m in items])
        st.ingest([(i, prog.tensors[i].planes[m]) for i, m in items])
        assert st.received == jst.received
        assert st.fingerprint() == jst.fingerprint(), ship
    old = st.copy()
    crc = old.fingerprint()
    st.ingest([(5, prog.tensors[5].planes[sent[5]])])
    assert old.fingerprint() == crc   # ingest never writes into a shared buffer
    with pytest.raises(ValueError):
        st.ingest([(0, prog.tensors[4].planes[0])])   # wrong element count
