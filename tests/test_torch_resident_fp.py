"""Float residency (``resident="fp"``) in the port against the JAX package,
on the CPU.

Reduced olmo-1b (2 layers, d_model 64), the same weights in both packages
(the JAX init, converted through numpy). Held, byte for byte:

* ``dequantize_batch`` and ``dequantize_buffers`` against the
  reference's (and against the eager ``dequantize``), for uint8, uint16
  and uint32 containers and float32 and bfloat16 leaves;
* ``ReceiverState.materialize`` after every stage, the leaf cache
  recomputing only the tensors an ingest touched;
* ``ProgressiveClient.materialize()`` mid-stage on v1 and v3 streams (a
  damaged unit holds back what follows it), and
  ``WireStoreReceiver.materialize()``;
* ``transmit_reconstruct``;

and the engines: float-resident greedy tokens equal the JAX package's
float-resident tokens and the port's quantized-resident tokens, at every
stage and with upgrades mid-decode, single stream and slot pool;
``resident_report`` equals the reference's.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import ReceiverState as JReceiverState
from repro.core.progressive import divide as jax_divide
from repro.core.progressive import transmit_reconstruct as jax_transmit_reconstruct
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro.serving.engine import WireStoreReceiver as JWireStoreReceiver
from repro.transmission import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import (ReceiverState, divide, transmit_reconstruct,
                                          tree_flatten_with_path)
from repro_torch.core.quantize import (dequant_constants, dequantize, dequantize_batch,
                                       dequantize_buffers, quantize)
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import (PoolRequest, ProgressiveServer, SlotPoolEngine,
                                        WireStoreReceiver)
from repro_torch.transmission import ProgressiveClient

jq = importlib.import_module("repro.core.quantize")  # the package re-exports a function of that name
REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
LOGIT_ATOL = 2e-5
SCHEDULES = {"uint8": (8, (2, 2, 2, 2)), "uint16": (16, (2,) * 8),
             "uint32": (20, (5, 5, 5, 5))}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, model, jparams, params


def _progs(models, container="uint16"):
    _, _, jparams, params = models
    bits, widths = SCHEDULES[container]
    return (jax_divide(jparams, JUniformPolicy(schedule=JSchedule(bits, widths))),
            divide(params, UniformPolicy(schedule=PlaneSchedule(bits, widths))))


def _raw(x) -> tuple:
    """(dtype name, shape, bytes) of a JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (str(x.dtype).rsplit(".", 1)[-1], tuple(x.shape),
                x.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _same_leaves(got: dict, want: dict) -> None:
    assert sorted(map(str, got)) == sorted(map(str, want))
    for k in got:
        assert _raw(got[k]) == _raw(want[k]), k


def _flat(tree) -> dict:
    return dict(tree_flatten_with_path(tree))


def _jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# batched eq. (5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("container", sorted(SCHEDULES))
@pytest.mark.parametrize("dtype", sorted(TORCH_DTYPES))
def test_dequantize_batch_and_buffers_byte_equal(container, dtype):
    bits = SCHEDULES[container][0]
    rng = np.random.default_rng(bits)
    xs = [(rng.standard_normal(shape) * s + m).astype(np.float32)
          for shape, s, m in (((7, 33), 0.02, 0.0), ((64,), 3.0, -1.0), ((5, 4, 9), 1e-3, 2.0))]
    jqts = [jq.quantize(jnp.asarray(x, dtype), bits) for x in xs]
    qts = [quantize(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), bits) for x in xs]
    for jqt, qt in zip(jqts, qts):
        assert _raw(qt.q) == _raw(jqt.q)
    received = [None, 0, bits // 2]
    out = dequantize_batch(qts, received)
    for got, want, qt, m in zip(out, jq.dequantize_batch(jqts, received), qts, received):
        assert _raw(got) == _raw(want)
        assert _raw(got) == _raw(dequantize(qt, m))
    # the same values as spans of one flat container buffer
    flat = np.concatenate([np.asarray(jqt.q).reshape(-1) for jqt in jqts])
    specs, off = [], 0
    for x in xs:
        specs.append((container, off, x.size, x.shape))
        off += x.size
    args = ([bits] * 3, received)
    want = jq.dequantize_buffers(
        {container: jnp.asarray(flat)}, specs, *args, [dtype] * 3,
        constants=jq.dequant_constants([t.lo for t in jqts], [t.hi for t in jqts], [bits] * 3))
    got = dequantize_buffers(
        {container: torch.from_numpy(flat)}, specs, *args, [TORCH_DTYPES[dtype]] * 3,
        constants=dequant_constants([t.lo for t in qts], [t.hi for t in qts], [bits] * 3))
    assert [_raw(g) for g in got] == [_raw(w) for w in want]


# ---------------------------------------------------------------------------
# store, receivers, client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_materialize_after_every_stage_byte_equal(models, container):
    jprog, prog = _progs(models, container)
    jst, st = JReceiverState.init(jprog), ReceiverState.init(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        jst, st = jst.receive(jprog.stage(s)), st.receive(prog.stage(s))
        _same_leaves(_flat(st.materialize()), _jflat(jst.materialize()))
        assert not st.store.dirty_keys()


def test_leaf_cache_recomputes_only_touched_tensors(models):
    _, prog = _progs(models)
    st = ReceiverState.init(prog, device="cpu").receive(prog.stage(1))
    store = st.store
    first = store.materialize_leaves()
    assert store.materialize_leaves() == first      # the same tensors, nothing recomputed
    idx, plane = prog.stage(2)[0]
    store.ingest([(idx, plane)])
    key = store.slots[idx].key
    assert store.dirty_keys() == {key}
    again = store.materialize_leaves()
    for k, leaf in again.items():
        assert (leaf is first[k]) == (k != key), k
    assert not torch.equal(again[key], first[key])
    # quantized views of the same store leave the float leaves alone
    store.quantized_leaves()
    assert store.materialize_leaves()[key] is again[key]


def _stream_ends(blob: bytes) -> list[int]:
    meta, hdr = wire.decode_header(blob)
    ends = [hdr]
    for n in wire.layout_from_header(meta, hdr).stage_bytes:
        ends.append(ends[-1] + n)
    return ends


@pytest.mark.parametrize("stream", ["v1", "v3", "v3_damaged"])
def test_client_materialize_mid_stage_byte_equal(models, stream):
    jprog, prog = _progs(models)
    integrity = stream != "v1"
    blob = wire.encode(prog, integrity=integrity)
    assert blob == jwire.encode(jprog, integrity=integrity)
    ends = _stream_ends(blob)
    cut = (ends[3] + ends[4]) // 2          # the middle of stage 3
    data = bytearray(blob)
    if stream == "v3_damaged":
        meta, hdr = wire.decode_header(blob)
        layout = wire.layout_from_header(meta, hdr)
        offs = layout.unit_offsets()
        seq = next(i for i, o in enumerate(offs) if ends[3] < o < cut - 64)
        data[offs[seq] + 20] ^= 0xFF
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    for c in (client, jclient):
        c.feed(bytes(data[:cut]))
    assert client.stages_complete == jclient.stages_complete == 3
    _same_leaves(client.materialize(), jclient.materialize())
    assert client.store.fingerprint() == jclient.store.fingerprint()
    # the receivers read the store as it stands, without a flush
    _same_leaves(_flat(WireStoreReceiver(client, prog).materialize()),
                 _jflat(JWireStoreReceiver(jclient, jprog).materialize()))
    for c in (client, jclient):
        c.feed(bytes(data[cut:]))
        if stream == "v3_damaged":
            assert c.nacks
            (s, _), = c.nacks.items()
            c.feed_repair(s, blob[offs[s]:offs[s] + (offs[s + 1] - offs[s])])
    assert client.complete and client.stages_complete == prog.n_stages
    _same_leaves(client.materialize(), jclient.materialize())
    assert client.store.fingerprint() == jclient.store.fingerprint()
    want = ReceiverState.init(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        want = want.receive(prog.stage(s))
    assert client.store.fingerprint() == want.store.fingerprint()


@pytest.mark.parametrize("upto", [1, 5, None])
def test_transmit_reconstruct_byte_equal(models, upto):
    _, _, jparams, params = models
    _same_leaves(_flat(transmit_reconstruct(params, upto_stage=upto, device="cpu")),
                 _jflat(jax_transmit_reconstruct(jparams, upto_stage=upto)))


# ---------------------------------------------------------------------------
# float-resident engines
# ---------------------------------------------------------------------------

def _tokens(n=2, length=8, seed=1):
    return np.random.default_rng(seed).integers(0, REDUCED["vocab"], (n, length)
                                                ).astype(np.int32)


@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_fp_server_tokens_equal_reference_and_quantized(models, container):
    """Upgrades land between decode steps; the float-resident server's
    tokens, upgrades and per-step stages equal the JAX float-resident
    server's and the port's quantized-resident server's."""
    jmodel, model = models[:2]
    jprog, prog = _progs(models, container)
    steps = 2 * len(SCHEDULES[container][1]) + 2
    arrivals = set(range(2, steps - 2, 2))
    tokens = _tokens()
    jsrv = JServer(jmodel, jprog, max_len=8 + steps)
    srv = ProgressiveServer(model, prog, max_len=8 + steps, device="cpu")
    qsrv = ProgressiveServer(model, prog, max_len=8 + steps, resident="quantized",
                             device="cpu")
    assert srv.resident == "fp"
    results = []
    for eng, batch in ((jsrv, {"tokens": jnp.asarray(tokens)}), (srv, {"tokens": tokens}),
                       (qsrv, {"tokens": tokens})):
        eng.receive_stage()
        eng.start(batch)
        results.append(eng.decode(steps, stage_arrival=lambda i: i in arrivals))
    jres, res, qres = results
    assert res.upgrades == jres.upgrades == qres.upgrades
    assert res.stage_at_step == jres.stage_at_step == qres.stage_at_step
    assert res.stage_at_step[-1] == prog.n_stages
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert torch.equal(res.tokens, qres.tokens)
    np.testing.assert_allclose(np.asarray(jsrv.last_logits), srv.last_logits.numpy(),
                               rtol=0, atol=LOGIT_ATOL)
    rep = srv.resident_report()
    assert rep == jsrv.resident_report()
    assert rep["quantized_bytes"] == 0 and rep["fp_bytes"] > 0


def test_fp_tokens_equal_quantized_at_every_stage(models):
    """From a fresh start at each stage, float and quantized residency
    give the same greedy tokens, and the float logits stay within the
    JAX float-resident server's."""
    jmodel, model = models[:2]
    jprog, prog = _progs(models)
    tokens = _tokens(3, 6, seed=4)
    jsrv = JServer(jmodel, jprog, max_len=16)
    srv = ProgressiveServer(model, prog, max_len=16, device="cpu")
    qsrv = ProgressiveServer(model, prog, max_len=16, resident="quantized", device="cpu")
    for s in range(1, prog.n_stages + 1):
        for eng in (jsrv, srv, qsrv):
            eng.receive_stage()
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        qsrv.start({"tokens": tokens})
        np.testing.assert_allclose(np.asarray(jsrv.last_logits), srv.last_logits.numpy(),
                                   rtol=0, atol=LOGIT_ATOL)
        a, b = srv.decode(6), qsrv.decode(6)
        assert torch.equal(a.tokens, b.tokens), f"stage {s}"
        np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(jsrv.decode(6).tokens))


def test_fp_pool_equals_reference_and_quantized_pool(models):
    jmodel, model = models[:2]
    jprog, prog = _progs(models, "uint8")
    settings = dict(n_slots=3, max_len=24, dispatch_window=2, prefill_chunk=4)
    rng = np.random.default_rng(0)
    requests = [(rid, rng.integers(0, REDUCED["vocab"], int(rng.integers(2, 12))
                                   ).astype(np.int32), int(rng.integers(3, 9)))
                for rid in range(5)]
    pools = [JSlotPool(jmodel, jprog, **settings),
             SlotPoolEngine(model, prog, device="cpu", **settings),
             SlotPoolEngine(model, prog, device="cpu", resident="quantized", **settings)]
    outs = []
    for pool, cls in zip(pools, (JPoolRequest, PoolRequest, PoolRequest)):
        pool.receive_stage()
        for rid, prompt, budget in requests:
            pool.submit(cls(rid=rid, prompt=prompt, max_new_tokens=budget))
        outs.append(pool.run(on_window=lambda _, p=pool: p.upgrade_if_available()))
    jpool, pool, qpool = pools
    assert outs[1] == outs[0] == outs[2]
    assert pool.stage_log == jpool.stage_log == qpool.stage_log
    assert pool.upgrades == jpool.upgrades and pool.stage == prog.n_stages
    assert pool.resident_report() == jpool.resident_report()
