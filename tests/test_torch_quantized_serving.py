"""The single-tensor quantized view (``serving/quantized.py``) against the
JAX package's, on the CPU.

The reference's five cases (``tests/test_quantized_serving.py``) on the
same (96, 64) weight and the same numpy-seeded activations, plus the store
API the view rests on. Held:

* byte paths exactly: the view's accumulator, ``received_bits``,
  ``resident_bytes``, the store's fingerprint and
  ``quantization_error_bound`` equal the reference's at every stage;
* ``matmul`` (``ops.dequant_matmul``'s plain version on the CPU) within
  the reference test's tolerance of ``x @ materialize()`` and within 1e-4
  of the largest output of the JAX view's ``matmul``;
* ``PlaneStore.acc(i)`` is fresh after every ingest and after ``copy()``;
  ``from_model(indices=)`` builds a store of those tensors alone, and
  ``from_progressive`` resolves a shared store's slot by key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plane_store import PlaneStore as JPlaneStore
from repro.core.progressive import ReceiverState as JReceiverState
from repro.core.progressive import divide as jax_divide
from repro.core.quantize import quantization_error_bound as jax_error_bound
from repro.core.quantize import quantize as jax_quantize
from repro.serving.quantized import from_progressive as jax_from_progressive
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.progressive import ReceiverState, divide
from repro_torch.core.quantize import quantization_error_bound, quantize
from repro_torch.serving import QuantizedLinearState, from_progressive

RTOL, ATOL = 3e-5, 3e-4      # the reference test's, against x @ materialize()
DQMM_RTOL = 1e-4             # B2's: of the largest |y|


@pytest.fixture(scope="module")
def setup():
    w = np.array(jax.random.normal(jax.random.PRNGKey(0), (96, 64)) * 2.0)
    x = np.random.default_rng(1).standard_normal((8, 96)).astype(np.float32)
    return (w, x, jax_divide({"w": jnp.asarray(w)}),
            divide({"w": torch.from_numpy(w)}))


def _bytes(t) -> bytes:
    return (t.detach().contiguous().numpy().tobytes() if isinstance(t, torch.Tensor)
            else np.asarray(t).tobytes())


def test_upgrade_path_matches_materialized(setup):
    w, x, jprog, prog = setup
    jstate = jax_from_progressive(jprog, 0)
    state = from_progressive(prog, 0)
    ref = ReceiverState.init(prog, device="cpu")
    assert state.store.device.type == "cpu" and state.received_bits == 0
    for s in range(1, prog.n_stages + 1):
        jstate = jstate.upgrade(jprog.tensors[0].planes[s - 1])
        state = state.upgrade(prog.tensors[0].planes[s - 1])
        ref = ref.receive(prog.stage(s))
        assert _bytes(state.acc) == _bytes(jstate.acc), f"stage {s}"
        assert state.received_bits == jstate.received_bits == 2 * s
        assert state.store.fingerprint() == jstate.store.fingerprint()
        got = state.matmul(torch.from_numpy(x))
        want = x @ ref.materialize()["w"].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"stage {s}")
        jgot = np.asarray(jstate.matmul(jnp.asarray(x), bm=8, bn=32, bk=32))
        assert np.abs(got.numpy() - jgot).max() <= DQMM_RTOL * np.abs(jgot).max()


def test_final_stage_error_within_quant_bound(setup):
    w, _, jprog, prog = setup
    state = from_progressive(prog, planes_upto=prog.n_stages, tensor_idx=0)
    w_rec = state.matmul(torch.eye(96))
    bound = quantization_error_bound(quantize(torch.from_numpy(w), 16))
    assert _bytes(bound) == _bytes(jax_error_bound(jax_quantize(jnp.asarray(w), 16)))
    for m in (2, 8):
        assert _bytes(quantization_error_bound(quantize(torch.from_numpy(w), 16), m)) == \
            _bytes(jax_error_bound(jax_quantize(jnp.asarray(w), 16), m))
    err = float((w_rec - torch.from_numpy(w)).abs().max())
    assert err <= float(bound) + 1e-4
    assert err <= float(w.max() - w.min()) / 2 ** 16 + 1e-4     # the reference's bound


def test_resident_bytes_stay_constant(setup):
    w, _, jprog, prog = setup
    st0 = from_progressive(prog, 0, planes_upto=1)
    st1 = st0.upgrade(prog.tensors[0].planes[1])
    assert st0.resident_bytes == st1.resident_bytes == w.size * 2      # uint16
    assert st1.resident_bytes == jax_from_progressive(jprog, 0, planes_upto=2).resident_bytes


def test_upgrade_is_in_place_on_the_shared_store(setup):
    _, _, jprog, prog = setup
    st = from_progressive(prog, 0, planes_upto=1)
    store = st.store
    st2 = st.upgrade(prog.tensors[0].planes[1])
    assert st2.store is store and store.received[0] == 2 and st2.received_bits == 4
    jst = jax_from_progressive(jprog, 0, planes_upto=1).upgrade(jprog.tensors[0].planes[1])
    assert store.fingerprint() == jst.store.fingerprint()


def test_too_many_upgrades_raise(setup):
    _, _, _, prog = setup
    st = from_progressive(prog, 0, planes_upto=prog.n_stages)
    with pytest.raises(ValueError):
        st.upgrade(prog.tensors[0].planes[0])
    with pytest.raises(ValueError, match="2-D"):
        QuantizedLinearState(store=PlaneStore.from_model(
            divide({"b": torch.ones(5)}), device="cpu"))


def test_acc_fresh_after_ingest_and_copy():
    """``acc(i)`` is cached until the next ingest replaces the buffer: it
    never reads the bits of an older buffer, on a full-stage or a sparse
    shipment, and a ``copy()`` keeps its own views."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((40, 24)).astype(np.float32),
              "b": rng.standard_normal((7, 9)).astype(np.float32)}
    prog = divide({k: torch.from_numpy(v) for k, v in params.items()})
    jprog = jax_divide({k: jnp.asarray(v) for k, v in params.items()})
    store, jstore = PlaneStore.from_model(prog, device="cpu"), JPlaneStore.from_model(jprog)
    for s in range(1, prog.n_stages + 1):
        before = [store.acc(i) for i in range(store.n_tensors)]
        assert all(store.acc(i) is before[i] for i in range(store.n_tensors))   # cached
        snap = store.copy()
        if s % 2:
            store.ingest(prog.stage(s))                     # full stage
            jstore.ingest(jprog.stage(s))
        else:
            for i, plane in prog.stage(s):                  # sparse, a tensor at a time
                store.ingest([(i, plane)])
                jstore.ingest([(i, jprog.tensors[i].planes[s - 1])])
        for i in range(store.n_tensors):
            assert torch.equal(store.acc(i), store._slice_acc(i))
            assert _bytes(store.acc(i)) == _bytes(jstore.acc(i))
            # the snapshot still reads the stage before
            assert torch.equal(snap.acc(i), before[i])
        assert store.fingerprint() == jstore.fingerprint()
        assert not torch.equal(store.acc(0), before[0])


def test_subset_store_and_shared_lookup(setup):
    """``from_model(indices=)`` allocates only those tensors, and
    ``from_progressive`` on a shared store resolves the slot by key: the
    view's upgrade is the shared store's ingest."""
    rng = np.random.default_rng(3)
    arrays = {"a": rng.standard_normal((16, 8)).astype(np.float32),
              "m": rng.standard_normal((32, 24)).astype(np.float32),
              "z": rng.standard_normal((3,)).astype(np.float32)}
    prog = divide({k: torch.from_numpy(v) for k, v in arrays.items()})
    jprog = jax_divide({k: jnp.asarray(v) for k, v in arrays.items()})
    sub = PlaneStore.from_model(prog, indices=[1], device="cpu")
    jsub = JPlaneStore.from_model(jprog, indices=[1])
    assert [s.key for s in sub.slots] == [("m",)] and sub.resident_bytes() == \
        jsub.resident_bytes()
    assert (sub.slots[0].slice_axis, sub.slots[0].slice_idx) == (None, 0)
    view = from_progressive(prog, 1, planes_upto=3, store=sub)
    assert view.idx == 0 and view.received == 3
    shared = ReceiverState.init(prog, device="cpu").store
    view = from_progressive(prog, 1, planes_upto=2, store=shared)
    assert view.idx == 1 and shared.received == [0, 2, 0]
    jshared = JReceiverState.init(jprog).store
    jax_from_progressive(jprog, 1, planes_upto=2, store=jshared)
    assert shared.fingerprint() == jshared.fingerprint()
    with pytest.raises(ValueError, match="no slot"):
        from_progressive(prog, 0, store=sub)
