"""Mixture-of-experts blocks, per-expert sliced tensors and the expert
policies (ROADMAP A8(c)) against the JAX package, on the CPU.

mixtral-8x22b (``swa_moe``: windowed attention, window 16) and dbrx-132b
(``moe``: full attention, rope base 5e5) as ``reduced()`` gives them: 2
layers, 4 experts, top-2, drop-free ``capacity_factor`` 4.0, d_model 64,
d_ff 128, vocab 256, float32, the same weights in both packages (the JAX
init through numpy). Held:

* ``moe_apply`` at the published cf = 1.25 with 8 experts (tokens dropped)
  and at the drop-free 4.0: ``y`` within ``Y_ATOL``, ``balance_loss``
  within ``AUX_RTOL`` and ``dropped_frac`` equal; ``expert_dense`` on a
  float and on a quantized bank within ``Y_ATOL``;
* a division under ``ExpertPopularityPolicy``: planes, (lo, hi), slices
  and stage order exact, wire v1-v3 blobs byte-identical, accumulators and
  ``fingerprint()`` equal at stages 1, 4 and 8 (in memory and wire-fed),
  per-expert ``scale`` and truncated views as the reference's own tests
  hold them, and the quantized leaves' expert slots views of the store's
  buffer; ``LayerPriorityPolicy(score=embeddings_first_score)``'s stage
  order; a depth equal to ``n_experts``, where the layer axis is the one
  sliced, as in the reference; a sliced leaf that one strided view cannot
  express raises;
* calibration of a sliced division: ``weight_sse_schedule``,
  ``measure_plane_gains`` and ``greedy_schedule`` identical;
* serving: ``ProgressiveServer`` in both residencies (logits within
  ``LOGIT_ATOL`` and greedy tokens identical at stages 1, 4 and 8),
  ``SlotPoolEngine`` chunked and, for dbrx, batch-1 with bucket padding
  (upgrades mid-stream), ``SpeculativeEngine``: tokens identical to the
  reference's. A forward that asks for no auxiliaries gives the same
  outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as jcal
from repro.core import wire as jwire
from repro.core.plane_store import PlaneStore as JPlaneStore
from repro.core.policy import ExpertPopularityPolicy as JExpertPolicy
from repro.core.policy import LayerPriorityPolicy as JLayerPolicy
from repro.core.policy import embeddings_first_score as jax_score
from repro.core.progressive import ReceiverState as JReceiverState
from repro.core.progressive import divide as jax_divide
from repro.core.quantize import QuantizedTensor as JQuantizedTensor
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.serving.speculative import SpeculativeEngine as JSpecEngine
from repro.transmission import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import calibrate as cal
from repro_torch.core import wire
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.policy import (DivisionPolicy, ExpertPopularityPolicy,
                                     LayerPriorityPolicy, TensorPlan, embeddings_first_score)
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.core.quantize import QuantizedTensor, dequantize, quantize
from repro_torch.interop import params_from_numpy
from repro_torch.models import common, moe, transformer
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine)
from repro_torch.transmission import ProgressiveClient

SIZE = dict(d_model=64, d_ff=128, vocab=256)
# float32 on both sides, the sums over d (64) and f (128) in other orders:
# far below 2e-5 of outputs of order 1-10
Y_ATOL = 2e-5
LOGIT_ATOL = 2e-5       # as tests/test_torch_serving.py
# the balance loss is E * sum(mean(probs) * routed share), two float32
# reductions whose order differs: a few float32 ulps
AUX_RTOL = 1e-6
PROMPT, STEPS, MAX_LEN = 20, 24, 64
POPULARITY = {2: 0.6, 0: 0.3, 3: 0.1}     # expert 1 never routed: last


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(want, got, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(want), _np(got), rtol=0, atol=atol)


def _weights(model, seed=0):
    """numpy weights in the tree layout of ``model.init``: each matrix and
    expert bank at the init's scale, the norms' scales around 1 (so that
    each changes the logits)."""
    rng = np.random.default_rng(seed)
    shapes = tree_flatten_with_path(model.init(torch.Generator(), device="meta"))
    out: dict = {}
    for path, t in shapes:
        shape = tuple(t.shape)
        if path[-1] == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * (0.02 if path == ("embed",) else
                                              (2.0 / (shape[-2] + shape[-1])) ** 0.5)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def _build(name: str, **over):
    """Both models over the same numpy weights, both divided under the
    expert policy."""
    jcfg = jax_get_config(name).reduced(**SIZE, **over)
    cfg = get_config(name).reduced(**SIZE, **over)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    weights = _weights(model)
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, device="cpu")
    jpol = JExpertPolicy(popularity=POPULARITY, n_experts=cfg.n_experts)
    pol = ExpertPopularityPolicy(popularity=POPULARITY, n_experts=cfg.n_experts)
    return dict(cfg=cfg, jmodel=jmodel, model=model, jparams=jparams, params=params,
                jprog=jax_divide(jparams, jpol), prog=divide(params, pol))


@pytest.fixture(scope="module")
def mixtral():
    return _build("mixtral-8x22b")


@pytest.fixture(scope="module")
def dbrx():
    return _build("dbrx-132b")


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SIZE["vocab"], shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixtral-8x22b", "dbrx-132b"])
def test_configs_equal_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    for over in ({}, SIZE, dict(n_layers=4)):
        red, jred = cfg.reduced(**over), jcfg.reduced(**over)
        assert {f: getattr(red, f) for f in fields} == {f: getattr(jred, f) for f in fields}
    red = cfg.reduced()
    assert (red.n_experts, red.top_k, red.capacity_factor) == (4, 2, 4.0)
    assert cfg.capacity_factor == 1.25 and not cfg.tie_embeddings
    ours = build_model(cfg.reduced(**SIZE)).init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(jax_build_model(jcfg.reduced(**SIZE)).init, jax.random.PRNGKey(0))
    flat = {tuple(p.key for p in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {p: tuple(t.shape) for p, t in tree_flatten_with_path(ours)} == flat
    slot = f"0_{cfg.cycle[0]}"
    assert flat[("decoder", "cycles", slot, "moe", "we_down")] == (2, 4, 128, 64)
    assert flat[("decoder", "cycles", slot, "moe", "router")] == (2, 64, 4)


# ---------------------------------------------------------------------------
# moe_apply and expert_dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_experts,cf,T", [(8, 1.25, 32), (4, 4.0, 32), (4, 4.0, 1)],
                         ids=["drop_prone", "drop_free", "decode"])
def test_moe_apply_equals_reference(n_experts, cf, T):
    over = dict(n_experts=n_experts, capacity_factor=cf, **SIZE)
    jcfg = jax_get_config("mixtral-8x22b").reduced(**over)
    cfg = get_config("mixtral-8x22b").reduced(**over)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jcfg, jax.random.PRNGKey(1)))
    # skew the router (a trained model's experts are not equally popular)
    p["router"] = p["router"] * np.linspace(2.0, 0.2, n_experts, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal((3, T, SIZE["d_model"])).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, params_from_numpy(p, device="cpu"), torch.from_numpy(x))
    assert moe.capacity(cfg, T) == jmoe.capacity(jcfg, T)
    _close(jy, y, Y_ATOL)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(aux["balance_loss"]), float(jaux["balance_loss"]),
                               rtol=AUX_RTOL)
    assert (float(aux["dropped_frac"]) > 0) == (cf < n_experts / cfg.top_k), aux


def test_moe_apply_without_aux_same_outputs():
    """``with_aux=False`` (what a forward without ``aux=`` asks for) gives
    the same ``y`` and no auxiliaries; a model's prefill with and without
    ``aux=`` gives the same logits."""
    cfg = get_config("mixtral-8x22b").reduced(**SIZE)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    p = params["decoder"]["cycles"]["0_swa_moe"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 9, SIZE["d_model"]))
                         .astype(np.float32))
    y, aux = moe.moe_apply(cfg, p, x)
    y2, aux2 = moe.moe_apply(cfg, p, x, with_aux=False)
    assert aux2 is None and set(aux) == {"balance_loss", "dropped_frac"}
    assert torch.equal(y, y2)
    batch = {"tokens": torch.from_numpy(_prompt(3, (2, 12)))}
    acc = transformer.zero_aux()
    got, _ = model.prefill(params, batch, aux=acc)
    want, _ = model.prefill(params, batch)
    assert torch.equal(got, want) and float(acc["balance_loss"]) > 0


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities: top-k takes the lower expert index, as
    ``jax.lax.top_k``, and the buffer rows count token-major."""
    cfg = get_config("mixtral-8x22b").reduced(capacity_factor=1.0)
    logits = torch.tensor([[[0.5, 1.0, 1.0, 1.0], [2.0, 2.0, 0.0, 2.0],
                            [1.0, 1.0, 1.0, 1.0]]])
    gate, expert, pos, keep, _, _ = moe.route(cfg, logits, C=2)
    jvals, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1), 2)
    assert expert.tolist() == np.asarray(jidx).tolist() == [[[1, 2], [0, 1], [0, 1]]]
    assert pos.tolist() == [[[0, 0], [0, 1], [1, 2]]]
    assert keep.tolist() == [[[True, True], [True, True], [True, False]]]
    assert float(gate[0, 2, 1]) == 0.0


@pytest.mark.parametrize("quantized", [False, True])
def test_expert_dense_equals_reference(quantized):
    """A (3, 16, 24) bank, each expert of its own scale; x (2, 3, 5, 16).
    Quantized: the bank divided per expert at 8 bits, 6 of 8 bits
    received, through each package's quantized leaf."""
    rng = np.random.default_rng(4)
    bank = (rng.standard_normal((3, 16, 24)) * np.arange(1, 4)[:, None, None]).astype(np.float32)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    if not quantized:
        jw, w = jnp.asarray(bank), torch.from_numpy(bank)
    else:
        sched = PlaneSchedule(bits=8, widths=(2, 2, 2, 2))
        jprog = jax_divide({"we_up": jnp.asarray(bank)},
                           JExpertPolicy(schedule=sched, n_experts=3))
        prog = divide({"we_up": torch.from_numpy(bank)},
                      ExpertPopularityPolicy(schedule=sched, n_experts=3))
        jstore, store = JPlaneStore.from_model(jprog), PlaneStore.from_model(prog, device="cpu")
        for s in range(1, 4):
            jstore.ingest(jprog.stage(s))
            store.ingest(prog.stage(s))
        jw = jstore.quantized_leaves()[jprog.tensors[0].path]
        w = store.quantized_leaves()[("we_up",)]
        assert isinstance(w, QuantizedTensor) and isinstance(jw, JQuantizedTensor)
        for name in ("q", "scale", "offset", "received_bits"):
            assert np.array_equal(_np(getattr(w, name)), np.asarray(getattr(jw, name))), name
    want = jcommon.expert_dense(jnp.asarray(x), jw, dtype=jnp.float32)
    got = common.expert_dense(torch.from_numpy(x), w, dtype=torch.float32)
    assert got.shape == (2, 3, 5, 24)
    _close(want, got, Y_ATOL)


# ---------------------------------------------------------------------------
# sliced division: bytes, accumulators, views
# ---------------------------------------------------------------------------

def test_sliced_division_equals_reference(mixtral):
    """Every tensor's path, shape, range, slice fields, priority and planes,
    and every stage's order, equal the reference's; hot experts' planes
    come before cold ones' within a stage, after the other tensors."""
    jprog, prog = mixtral["jprog"], mixtral["prog"]
    assert len(prog.tensors) == len(jprog.tensors)
    for t, jt in zip(prog.tensors, jprog.tensors):
        assert t.path == tuple(p.key for p in jt.path)
        assert (t.shape, t.slice_axis, t.slice_idx, t.n_slices) == \
            (jt.shape, jt.slice_axis, jt.slice_idx, jt.n_slices)
        assert t.plan.priority == jt.plan.priority
        assert float(t.lo) == float(jt.lo) and float(t.hi) == float(jt.hi)
        for a, b in zip(t.planes, jt.planes):
            assert np.array_equal(_np(a), np.asarray(b))
    sliced = [t for t in prog.tensors if t.slice_axis is not None]
    assert len(sliced) == 3 * 4 and all(t.slice_axis == 1 and t.shape[0] == 2 for t in sliced)
    for s in range(1, prog.n_stages + 1):
        assert [i for i, _ in prog.stage(s)] == [i for i, _ in jprog.stage(s)]
    order = [prog.tensors[i].slice_idx for i, _ in prog.stage(1)
             if prog.tensors[i].slice_axis is not None]
    assert order == [2] * 3 + [0] * 3 + [3] * 3 + [1] * 3
    assert prog.tensors[prog.stage(1)[0][0]].slice_axis is None


def _stage_ends(blob):
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


def _buffers(store):
    return {k: _np(v).tobytes() for k, v in store.buffers.items()}


def test_sliced_wire_accumulators_fingerprints(mixtral):
    """v1, v2 (a schedule and entropy coding) and v3 blobs byte-identical;
    the v3 stream fed in ragged chunks to a client of each package beside
    in-memory receivers: accumulators and ``fingerprint()`` equal at
    stages 1, 4 and 8, and the wire-fed store's leaves equal the
    in-memory store's."""
    jprog, prog = mixtral["jprog"], mixtral["prog"]
    sched = cal.uniform_schedule(prog)
    jsched = jcal.uniform_schedule(jprog)
    assert wire.encode(prog) == jwire.encode(jprog)
    assert wire.encode(prog, schedule=sched, entropy_coded=True) == \
        jwire.encode(jprog, schedule=jsched, entropy_coded=True)
    blob = wire.encode(prog, integrity=True)
    assert blob == jwire.encode(jprog, integrity=True)
    meta, _ = wire.decode_header(blob)
    assert sum(t["slice_axis"] is not None for t in meta["tensors"]) == 12
    ends = _stage_ends(blob)
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    st, jst = ReceiverState.init(prog, device="cpu"), JReceiverState.init(jprog)
    rng = np.random.default_rng(5)
    pos = 0
    for s in range(1, prog.n_stages + 1):
        while pos < ends[s]:
            n = min(ends[s] - pos, int(np.exp(rng.uniform(0.0, np.log(1 << 17)))))
            client.feed(blob[pos:pos + n])
            jclient.feed(blob[pos:pos + n])
            pos += n
        st, jst = st.receive(prog.stage(s)), jst.receive(jprog.stage(s))
        if s not in (1, 4, 8):
            continue
        assert client.store.fingerprint() == jclient.store.fingerprint() \
            == st.store.fingerprint() == jst.store.fingerprint(), f"stage {s}"
        assert _buffers(client.store) == _buffers(st.store) == _buffers(jst.store)
        wleaves = client.materialize()
        for path, leaf in tree_flatten_with_path(st.materialize()):
            assert torch.equal(wleaves["/".join(path)], leaf), path
        jflat = {tuple(p.key for p in path): v for path, v in
                 jax.tree_util.tree_flatten_with_path(jst.materialize())[0]}
        for path, leaf in tree_flatten_with_path(st.materialize()):
            assert np.array_equal(np.asarray(jflat[path]), _np(leaf)), path


def test_sliced_quantized_leaf(mixtral):
    """The reference's ``test_sliced_expert_bank_quantized_leaf`` and
    ``test_truncated_view_sliced_expert_bank`` on the port, plus: the
    stacked bank is a view of the store's buffer (no second uint buffer),
    its expert slots are the slots' accumulators, and its metadata equal
    the reference's, at full precision and mid-stream."""
    E, d, f = 3, 8, 16
    w = (np.random.default_rng(3).standard_normal((E, d, f))
         * np.arange(1, E + 1)[:, None, None]).astype(np.float32)
    sched = PlaneSchedule(bits=8, widths=(2, 2, 2, 2))
    prog = divide({"we_gate": torch.from_numpy(w)},
                  ExpertPopularityPolicy(schedule=sched, n_experts=E))
    store = PlaneStore.from_model(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        store.ingest(prog.stage(s))
    qt = store.quantized_leaves()[("we_gate",)]
    assert qt.q.shape == (E, d, f) and qt.scale.shape == (E, 1, 1)
    assert len(set(_np(qt.scale).ravel().tolist())) == E
    want = store.materialize_leaves()[("we_gate",)]
    got = qt.q.to(torch.float32) * qt.scale + qt.offset
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-7)
    assert _np(qt.received_bits).ravel().tolist() == [8] * E
    leaf = store.quantized_leaves(bits=4)[("we_gate",)]
    assert leaf.q is qt.q
    got = common.masked_q(leaf).to(torch.float32) * leaf.scale + leaf.offset
    for e in range(E):
        np.testing.assert_array_equal(_np(got[e]), _np(dequantize(quantize(
            torch.from_numpy(w[e]), 4))), err_msg=f"expert {e}")
    assert _np(leaf.keep_bits).ravel().tolist() == [4] * E

    # the live model's banks: views of the flat buffer, slot by slot,
    # with the reference's metadata, mid-stream and at stage 8
    jprog, prog = mixtral["jprog"], mixtral["prog"]
    store, jstore = PlaneStore.from_model(prog, device="cpu"), JPlaneStore.from_model(jprog)
    for s in range(1, prog.n_stages + 1):
        items = prog.stage(s)
        n = len(items) if s != 3 else len(items) - 5      # stage 3 cut mid-way
        store.ingest(items[:n])
        jstore.ingest(jprog.stage(s)[:n])
        if s not in (3, 8):
            continue
        leaves, jleaves = store.quantized_leaves(), jstore.quantized_leaves()
        tleaves = store.quantized_leaves(bits=4)
        jt = jstore.quantized_leaves(bits=4)
        for key, qt in leaves.items():
            if not isinstance(qt, QuantizedTensor):
                continue
            jq = next(v for k, v in jleaves.items() if tuple(p.key for p in k) == key)
            for name in ("q", "scale", "offset", "received_bits", "lo", "hi"):
                assert np.array_equal(_np(getattr(qt, name)), np.asarray(getattr(jq, name))), \
                    (s, key, name)
            jtq = next(v for k, v in jt.items() if tuple(p.key for p in k) == key)
            for name in ("offset", "keep_bits", "received_bits"):
                assert np.array_equal(_np(getattr(tleaves[key], name)),
                                      np.asarray(getattr(jtq, name))), (s, key, name)
        bank = leaves[("decoder", "cycles", "0_swa_moe", "moe", "we_up")]
        buf = store.buffers["uint16"]
        assert bank.q.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        idxs = store.groups[("decoder", "cycles", "0_swa_moe", "moe", "we_up")]
        for e, i in enumerate(idxs):
            assert bank.q[:, e].data_ptr() == store.acc(i).data_ptr()
            assert torch.equal(bank.q[:, e], store.acc(i))
        if s == 3:
            assert len(set(_np(bank.received_bits).ravel().tolist())) == 2


def test_layer_priority_stage_order(mixtral):
    """``LayerPriorityPolicy(score=embeddings_first_score)``: the scores and
    every stage's order equal the reference's; embed and lm_head first."""
    prog = divide(mixtral["params"], LayerPriorityPolicy(score=embeddings_first_score))
    jprog = jax_divide(mixtral["jparams"], JLayerPolicy(score=jax_score))
    for p in ("embed", "lm_head", "final_norm/scale", "decoder/cycles/0_swa_moe/attn/wq",
              "a/12_b/3"):
        assert embeddings_first_score(p) == jax_score(p)
    for t, jt in zip(prog.tensors, jprog.tensors):
        assert t.plan.priority == jt.plan.priority
    for s in (1, 8):
        assert [i for i, _ in prog.stage(s)] == [i for i, _ in jprog.stage(s)]
    first = [prog.tensors[i].path for i, _ in prog.stage(1)[:3]]
    assert set(first) == {("embed",), ("lm_head",), ("final_norm", "scale")}


def test_depth_equal_to_experts_slices_the_layer_axis():
    """dbrx reduced to 2 experts at its 2 layers: banks are (2, 2, d, f), so
    the first axis of size n_experts is the layer axis and each slice is a
    layer, as in the reference. At the division: bytes, fingerprints and
    the restacked float leaves equal; the quantized banks' scale varies
    along the layers, and their prefill agrees with the float leaves'."""
    arch = _build("dbrx-132b", n_experts=2)
    jprog, prog = arch["jprog"], arch["prog"]
    sliced = [t for t in prog.tensors if t.slice_axis is not None]
    assert len(sliced) == 3 * 2 and all(t.slice_axis == 0 and t.shape[0] == 2 for t in sliced)
    assert wire.encode(prog, integrity=True) == jwire.encode(jprog, integrity=True)
    st, jst = ReceiverState.init(prog, device="cpu"), JReceiverState.init(jprog)
    for s in range(1, prog.n_stages + 1):
        st, jst = st.receive(prog.stage(s)), jst.receive(jprog.stage(s))
    assert st.store.fingerprint() == jst.store.fingerprint()
    jflat = {tuple(p.key for p in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jst.materialize())[0]}
    leaves = st.materialize()
    for path, leaf in tree_flatten_with_path(leaves):
        assert np.array_equal(np.asarray(jflat[path]), _np(leaf)), path
    params = st.materialize_resident()
    bank = params["decoder"]["cycles"]["0_moe"]["moe"]["we_gate"]
    assert bank.scale.shape == (2, 2, 1, 1) and len(set(_np(bank.scale[:, 0]).ravel())) == 2
    batch = {"tokens": torch.from_numpy(_prompt(11, (2, 12)))}
    want, _ = arch["model"].prefill(leaves, batch)
    got, _ = arch["model"].prefill(params, batch)
    _close(want, got)


@dataclasses.dataclass(frozen=True)
class _SlicePolicy(DivisionPolicy):
    """Slices every leaf along ``axis``; with ``mixed``, slice 0 at 6 bits
    and the rest at 8."""
    axis: int
    mixed: bool

    def slice_spec(self, path, shape):
        return self.axis

    def plan(self, path, shape, dtype, slice_idx=None):
        bits = 6 if self.mixed and slice_idx == 0 else 8
        return TensorPlan(schedule=PlaneSchedule(bits=bits, widths=(bits - 4, 2, 2)))

    @property
    def n_stages(self):
        return 3


@pytest.mark.parametrize("axis,mixed", [(0, True), (1, False)],
                         ids=["slices_of_two_widths", "slices_along_a_matrix_dim"])
def test_unstridable_sliced_leaf_raises(axis, mixed):
    """A sliced leaf that one strided view of one width cannot express
    raises rather than becoming a copy or a float leaf; its float leaf
    still restacks."""
    w = np.random.default_rng(8).standard_normal((3, 8, 16)).astype(np.float32)
    prog = divide({"we_up": torch.from_numpy(w)}, _SlicePolicy(axis=axis, mixed=mixed))
    store = PlaneStore.from_model(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        store.ingest(prog.stage(s))
    assert store.materialize_leaves()[("we_up",)].shape == (3, 8, 16)
    with pytest.raises(ValueError, match="sliced leaf"):
        store.quantized_leaves()


def test_sliced_calibration_equals_reference():
    """A tree with a sliced bank beside an unsliced weight: the float64
    weight-SSE schedule, the marginal gains and the greedy schedule under a
    weighted MSE loss equal the reference's."""
    rng = np.random.default_rng(7)
    tree = {"moe": {"we_gate": (rng.standard_normal((3, 8, 16))
                                * np.arange(1, 4)[:, None, None]).astype(np.float32)},
            "wq": rng.standard_normal((16, 8)).astype(np.float32)}
    jprog = jax_divide(jax.tree.map(jnp.asarray, tree), JExpertPolicy(n_experts=3))
    prog = divide(params_from_numpy(tree, device="cpu"), ExpertPopularityPolicy(n_experts=3))
    assert len(prog.tensors) == 4

    def same(got, want):
        assert got.units == tuple(want.units) and got.checkpoints == tuple(want.checkpoints)

    same(cal.weight_sse_schedule(prog), jcal.weight_sse_schedule(jprog))
    store = PlaneStore.from_model(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        store.ingest(prog.stage(s))
    refs = {tuple(k): np.asarray(v, np.float64) for k, v in store.materialize_leaves().items()}

    def loss(leaves):
        total = 0.0
        for k, v in leaves.items():
            k = tuple(getattr(p, "key", p) for p in k)     # either package's key
            total += (3.0 if "moe" in k else 1.0) * float(np.mean(
                (np.asarray(v, np.float64) - refs[k]) ** 2))
        return total

    assert cal.measure_plane_gains(prog, loss) == jcal.measure_plane_gains(jprog, loss)
    same(cal.greedy_schedule(prog, loss), jcal.greedy_schedule(jprog, loss))
    assert cal._truncated_leaf(store, store.groups[("moe", "we_gate")], 4).shape == (3, 8, 16)


# ---------------------------------------------------------------------------
# serving against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral", "dbrx"])
@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_server_logits_and_tokens_every_stage(arch, resident, request):
    """At stages 1, 4 and 8 from a fresh start: the prefill's logits, then
    12 greedy steps (mixtral's rings of 16 wrap); logits within
    ``LOGIT_ATOL`` and tokens identical. (The pools below take their
    upgrades mid-stream.)"""
    a = request.getfixturevalue(arch)
    tokens = _prompt(1, (2, PROMPT))
    jsrv = JServer(a["jmodel"], a["jprog"], max_len=MAX_LEN, resident=resident)
    srv = ProgressiveServer(a["model"], a["prog"], max_len=MAX_LEN, resident=resident,
                            device="cpu")
    for s in range(1, 9):
        jsrv.receive_stage()
        srv.receive_stage()
        if s not in (1, 4, 8):
            continue
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        _close(jsrv.last_logits, srv.last_logits)
        jres, res = jsrv.decode(12), srv.decode(12)
        np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens), f"stage {s}")
        _close(jsrv.last_logits, srv.last_logits)
    rep, jrep = srv.resident_report(), jsrv.resident_report()
    assert rep == jrep
    if resident == "quantized":
        # the accumulators' bytes and the norms' float bytes, nothing else
        slots = srv.state.store.slots
        weights = [s for s in slots if common.quantized_resident_eligible(s.key)]
        assert rep["quantized_bytes"] == sum(s.size * s.container.itemsize for s in weights)
        assert rep["fp_bytes"] == sum(4 * s.size for s in slots if s not in weights) > 0


def _requests(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, SIZE["vocab"], L).astype(np.int32), int(rng.integers(10, 16)))
            for rid, L in enumerate(lengths)]


def _pool_run(pool, req_cls, reqs):
    pool.receive_stage()
    for rid, prompt, budget in reqs:
        pool.submit(req_cls(rid=rid, prompt=prompt, max_new_tokens=budget))
    return pool.run(on_window=lambda _: pool.upgrade_if_available())


@pytest.mark.parametrize("arch,chunked", [("mixtral", True), ("dbrx", True), ("dbrx", False)],
                         ids=["mixtral_chunked", "dbrx_chunked", "dbrx_batch1_buckets"])
def test_pool_tokens_equal_reference(arch, chunked, request):
    """Four requests on three slots (prompts 9-26), an upgrade a window.
    dbrx's batch-1 admission pads each prompt to its bucket, whose length
    sets the prefill's capacity, as in the reference."""
    a = request.getfixturevalue(arch)
    reqs = _requests(4, [12, 26, 9, 20])
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_window=4, prefill_chunk=8,
              chunked_prefill=chunked, resident="quantized")
    jpool = JSlotPool(a["jmodel"], a["jprog"], **kw)
    pool = SlotPoolEngine(a["model"], a["prog"], device="cpu", **kw)
    jout = _pool_run(jpool, JPoolRequest, reqs)
    out = _pool_run(pool, PoolRequest, reqs)
    assert pool.prefill_buckets == jpool.prefill_buckets == (arch == "dbrx")
    assert out == {rid: list(map(int, t)) for rid, t in jout.items()}
    assert pool.stage_log == jpool.stage_log and pool.admit_stage == jpool.admit_stage
    assert pool.upgrades == jpool.upgrades and pool.stage > 2


def test_speculative_engine_equals_reference(mixtral):
    """k = 4 (rings of 16 + 5), draft 4 bits, at stages 1, 4 and 8: tokens
    and rounds equal the JAX engine's, tokens the port's plain server's
    (drop-free capacity)."""
    model, prog = mixtral["model"], mixtral["prog"]
    tokens = _prompt(6, (2, PROMPT))
    max_len = PROMPT + STEPS + 5
    jeng = JSpecEngine(mixtral["jmodel"], mixtral["jprog"], max_len=max_len,
                       spec=JSpecConfig(draft_bits=4, k=4, k_max=4))
    eng = SpeculativeEngine(model, prog, max_len=max_len,
                            spec=SpecConfig(draft_bits=4, k=4, k_max=4), device="cpu")
    plain = ProgressiveServer(model, prog, max_len=max_len, resident="quantized", device="cpu")
    drafted = 0
    for s in range(1, prog.n_stages + 1):
        for e in (jeng, eng, plain):
            e.receive_stage()
        if s not in (1, 4, 8):
            continue
        for e in (jeng, eng, plain):
            e.start({"tokens": tokens})
        plain.caches = model.grow_caches(plain.caches, max_len, ring_margin=5, pos=PROMPT)
        jres, res = jeng.decode(STEPS), eng.decode(STEPS)
        np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens), f"stage {s}")
        assert [(r["k"], r["accepted"]) for r in res.accept_rounds] == \
            [(r["k"], r["accepted"]) for r in jres.accept_rounds]
        assert torch.equal(res.tokens, plain.decode(STEPS).tokens), f"stage {s}"
        drafted += res.drafted
    assert drafted > 0 and eng.resident_report()["extra_draft_bytes"] == 0
