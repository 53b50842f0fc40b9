"""The port's self-speculative decoding against the JAX package's, on the
CPU.

Reduced olmo-1b (2 layers, d_model 64, 4 heads, 2 KV heads, d_ff 128,
vocab 256), float32, the same seeded numpy weights in both packages (in
the reference's tree layout; the port's through
``interop.params_from_numpy``), prompts made with numpy. Held:

* ``truncate``, ``QuantizedTensor.truncate`` and
  ``PlaneStore.quantized_leaves(bits=)``: masked q, ``received_bits``
  and ``keep_bits`` equal, and scale and offset equal to the float32
  byte, for uint8, uint16 and uint32 containers at every even width,
  also beyond the received bits; the view cache drops a key's views
  when an ingest touches it; a view shares its full view's ``q``;
* ``dense`` and ``embed_lookup`` over a truncated view within atol 1e-5
  of the reference's (float32; only the order of float32 sums differs),
  and the B2 wrapper's plain path with ``keep`` equal to the plain
  version on the masked q;
* ``SpeculationController``: the same (k, draft bits, rate) after every
  step of one seeded sequence of ``update``/``on_upgrade``;
* ``SpeculativeEngine`` (k = 4, and adaptive) at every stage: tokens and
  the per-round ``(k, accepted)`` equal the JAX engine's and the tokens
  the port's plain server's; with stages landing between rounds, the
  tokens equal a plain server replayed at the run's per-token stages,
  and an engine fed from wire bytes equals the pull-mode engine;
* ``SpeculativeSlotPool``: per-request tokens, stage logs and rounds
  equal the JAX pool's, with all stages received first and with an
  upgrade every window;
* the headroom checks and the refusal of recurrent blocks raise as the
  reference's do; the parts left for later raise
  ``NotImplementedError`` naming their ROADMAP item; the draft adds no
  resident bytes.

The tests run torch on one thread: the shapes are tiny, and several
threads a process only contend with the other test processes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.plane_store import PlaneStore as JPlaneStore
from repro.core.policy import SpeculationController as JController
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import divide as jax_divide
from repro.core.quantize import quantize as jax_quantize
from repro.core.quantize import truncate as jax_truncate
from repro.models import common as jcommon
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.serving.speculative import SpeculativeEngine as JSpecEngine
from repro.serving.speculative import SpeculativeSlotPool as JSpecPool
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.policy import SpeculationController, UniformPolicy
from repro_torch.core.progressive import divide
from repro_torch.core.quantize import quantize, truncate
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import common
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SpecConfig,
                                 SpeculativeEngine, SpeculativeSlotPool)

REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
SCHEDULES = {"uint8": (8, (2, 2, 2, 2)), "uint16": (16, (2,) * 8),
             "uint32": (20, (5, 5, 5, 5))}
# dense over a truncated view: float32 on both sides, the sums in
# another order
DENSE_ATOL = 1e-5
PROMPT, STEPS = 8, 10
MAX_LEN = PROMPT + STEPS + 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    # seeded numpy weights in the reference's tree layout (its init's
    # shapes, scaled as its dense init scales them)
    rng = np.random.default_rng(0)
    weights = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * (2.0 / sum(a.shape[-2:])) ** 0.5
                   ).astype(np.float32),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    params = params_from_numpy(weights, device="cpu")
    return jmodel, model, jax_divide(jax.tree.map(jnp.asarray, weights)), divide(params)


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, REDUCED["vocab"], shape).astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rounds(log):
    return [(r["k"], r["accepted"]) for r in log]


# ---------------------------------------------------------------------------
# truncated views
# ---------------------------------------------------------------------------

def _stores(container, stages=None):
    """A (24, 40) weight divided under the container's schedule into the
    JAX and the port stores, ``stages`` of them received (default all)."""
    bits, widths = SCHEDULES[container]
    stages = len(widths) if stages is None else stages
    w = (np.random.default_rng(1).standard_normal((24, 40)) * 2.0).astype(np.float32)
    jprog = jax_divide({"wq": jnp.asarray(w)},
                       JUniformPolicy(schedule=JSchedule(bits, widths)))
    prog = divide({"wq": torch.from_numpy(w)},
                  UniformPolicy(schedule=PlaneSchedule(bits, widths)))
    jstore, store = JPlaneStore.from_model(jprog), PlaneStore.from_model(prog, device="cpu")
    for s in range(1, stages + 1):
        jstore.ingest(jprog.stage(s))
        store.ingest(prog.stage(s))
    return w, bits, jstore, store, jprog.tensors[0].path, prog.tensors[0].path


def _assert_same_view(jleaf, leaf, what):
    np.testing.assert_array_equal(_np(common.masked_q(leaf)),
                                  np.asarray(jcommon.masked_q(jleaf)), err_msg=what)
    for name in ("received_bits", "keep_bits"):
        np.testing.assert_array_equal(_np(getattr(leaf, name)).reshape(-1),
                                      np.asarray(getattr(jleaf, name)).reshape(-1),
                                      err_msg=f"{what} {name}")
    for name in ("scale", "offset"):   # equal to the float32 byte
        got = _np(getattr(leaf, name)).astype(np.float32).reshape(-1).view(np.uint32)
        want = np.asarray(getattr(jleaf, name), np.float32).reshape(-1).view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")


@pytest.mark.parametrize("container", sorted(SCHEDULES))
@pytest.mark.parametrize("stages", [1, None], ids=["beyond_received", "all_received"])
def test_truncated_views_equal_reference(container, stages):
    """``quantized_leaves(bits=b)`` and ``QuantizedTensor.truncate(b)`` at
    every even b up to the width, on a store holding all planes or only
    the first: equal to the reference's views; the view shares q; at
    full reception the masked q is the oracle ``truncate``'s."""
    w, bits, jstore, store, jkey, key = _stores(container, stages)
    full = store.quantized_leaves()[key]
    for b in range(0, bits + 1, 2):
        leaf = store.quantized_leaves(bits=b)[key]
        assert leaf.q is full.q and leaf.q.data_ptr() == full.q.data_ptr()
        _assert_same_view(jstore.quantized_leaves(bits=b)[jkey], leaf, f"{container} b={b}")
        _assert_same_view(jstore.quantized_leaves()[jkey].truncate(b), full.truncate(b),
                          f"{container} truncate({b})")
        if stages is None:
            want = truncate(quantize(torch.from_numpy(w), bits), b).q
            assert torch.equal(common.masked_q(leaf), want)
            np.testing.assert_array_equal(
                _np(want), np.asarray(jax_truncate(jax_quantize(jnp.asarray(w), bits), b).q))
    with pytest.raises(ValueError, match="outside"):
        full.truncate(bits + 1)


def test_truncated_view_cache_dropped_by_ingest():
    _, _, _, store, _, key = _stores("uint8", 1)
    a = store.quantized_leaves(bits=2)[key]
    assert store.quantized_leaves(bits=2)[key] is a          # cached
    assert store.quantized_leaves(bits=4)[key] is not a
    snap = store.copy()
    store.ingest([(0, torch.zeros((24, 40), dtype=torch.uint8))])
    b = store.quantized_leaves(bits=2)[key]
    assert b is not a                                        # dropped by the ingest
    assert snap.quantized_leaves(bits=2)[key] is a           # a copy keeps its own


def test_dense_and_embed_lookup_with_truncated_views(models):
    """The model's dispatch over draft views of layer 0's wq and of the
    embedding: ``dense`` hands the mask to the kernel wrapper (its plain
    path on the CPU), ``embed_lookup`` masks the gathered rows."""
    jmodel, model, jprog, prog = models
    jstore, store = JPlaneStore.from_model(jprog), PlaneStore.from_model(prog, device="cpu")
    for s in range(1, 9):
        jstore.ingest(jprog.stage(s))
        store.ingest(prog.stage(s))
    x = np.random.default_rng(2).standard_normal((5, REDUCED["d_model"])).astype(np.float32)
    tokens = _prompt(3, (2, 6))
    for b in (0, 4, 16):
        jl, pl = jstore.quantized_leaves(bits=b), store.quantized_leaves(bits=b)
        jw = [v for k, v in jl.items() if "wq" in str(k)][0]
        pw = [v for k, v in pl.items() if "wq" in str(k)][0]
        jw0 = dataclasses.replace(jw, q=jw.q[0], lo=jw.lo[0], hi=jw.hi[0], scale=jw.scale[0],
                                  offset=jw.offset[0], received_bits=jw.received_bits[0],
                                  keep_bits=jw.keep_bits[0])
        pw0 = dataclasses.replace(pw, q=pw.q[0], lo=pw.lo[0], hi=pw.hi[0],
                                  scale=pw.scale[0], offset=pw.offset[0],
                                  received_bits=pw.received_bits[0], keep_bits=pw.keep_bits[0])
        want = np.asarray(jcommon.dense(jnp.asarray(x), jw0, dtype=jnp.float32))
        got = common.dense(torch.from_numpy(x), pw0, dtype=torch.float32)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=DENSE_ATOL, err_msg=f"b={b}")
        je = [v for k, v in jl.items() if "embed" in str(k)][0]
        pe = [v for k, v in pl.items() if "embed" in str(k)][0]
        np.testing.assert_allclose(
            _np(common.embed_lookup(pe, torch.from_numpy(tokens))),
            np.asarray(jcommon.embed_lookup(je, jnp.asarray(tokens))),
            rtol=0, atol=DENSE_ATOL, err_msg=f"embed b={b}")


@pytest.mark.parametrize("qdtype,bits", [(torch.uint8, 8), (torch.uint16, 16),
                                         (torch.uint16, 12), (torch.uint32, 20)])
def test_dequant_matmul_keep_is_the_masked_q(qdtype, bits):
    """The B2 wrapper's plain path and the one-pass emulation with the
    ``keep`` operand equal the same functions on the masked q, bit for
    bit; keep == bits and keep=None agree."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 512), generator=g)
    q = torch.randint(0, 2 ** bits, (512, 24), generator=g).to(qdtype)
    scale, offset = torch.tensor([[2.0 ** -bits]]), torch.tensor([[-0.4]])
    for keep in range(0, bits + 1, 2):
        kt = torch.tensor([[keep]], dtype=torch.int32)
        qm = ref.mask_q(q, keep, bits)
        got = ops.dequant_matmul(x, q, scale, offset, kt, bits=bits, rows="decode")
        assert torch.equal(got, ref.dequant_matmul_ref(x, qm, scale, offset)), keep
        if qdtype != torch.uint32:
            assert torch.equal(ref.dequant_matmul_gemv_ref(x, q.T.contiguous().T, scale,
                                                           offset, kt, bits=bits),
                               ref.dequant_matmul_gemv_ref(x, qm.T.contiguous().T, scale,
                                                           offset))
    full = torch.tensor([[bits]], dtype=torch.int32)
    assert torch.equal(ops.dequant_matmul(x, q, scale, offset, full, bits=bits),
                       ops.dequant_matmul(x, q, scale, offset))
    with pytest.raises(ValueError, match="rows"):
        ops.dequant_matmul(x, q, scale, offset, rows="prefill")


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def test_controller_decisions_equal_reference():
    rng = np.random.default_rng(7)
    for kw in ({}, {"draft_bits": 2, "k_max": 6, "k_init": 3}):
        jc, pc = JController(**kw), SpeculationController(**kw)
        for _ in range(300):
            op = rng.integers(0, 6)
            if op == 0:
                jc.on_upgrade(), pc.on_upgrade()
            else:
                proposed = int(rng.integers(0, 9))
                accepted = int(rng.integers(0, proposed + 1))
                if op == 1:
                    accepted = 0
                jc.update(accepted, proposed), pc.update(accepted, proposed)
            bits = int(rng.integers(0, 17))
            assert (pc.k, pc.draft_bits, pc.rate, pc.choose_k(bits)) == \
                (jc.k, jc.draft_bits, jc.rate, jc.choose_k(bits))


# ---------------------------------------------------------------------------
# the engines against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, None], ids=["k4", "adaptive"])
def test_engine_equals_reference_and_plain_at_every_stage(models, k):
    jmodel, model, jprog, prog = models
    tokens = _prompt(1, (2, PROMPT))
    jeng = JSpecEngine(jmodel, jprog, max_len=MAX_LEN, spec=JSpecConfig(draft_bits=4, k=k))
    eng = SpeculativeEngine(model, prog, max_len=MAX_LEN, spec=SpecConfig(draft_bits=4, k=k),
                            device="cpu")
    plain = ProgressiveServer(model, prog, max_len=MAX_LEN, resident="quantized",
                              device="cpu")
    drafted = 0
    for s in range(1, prog.n_stages + 1):
        for e in (jeng, eng, plain):
            e.receive_stage()
            e.start({"tokens": tokens})
        jres, res = jeng.decode(STEPS), eng.decode(STEPS)
        np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens),
                                      err_msg=f"stage {s}")
        assert _rounds(res.accept_rounds) == _rounds(jres.accept_rounds), f"stage {s}"
        assert res.stage_log == jres.stage_log
        assert (res.drafted, res.accepted) == (jres.drafted, jres.accepted)
        assert torch.equal(res.tokens, plain.decode(STEPS).tokens), f"stage {s}"
        drafted += res.drafted
    assert drafted > 0 and eng.controller.rate == jeng.controller.rate


def _stage_replay(model, prog, prompt, stage_log):
    """Plain greedy tokens of a batch-1 ``ProgressiveServer`` replayed at a
    speculative run's per-token stage log: token j's value is computed at
    stage_log[j], and its K/V is written by the step that computes token
    j + 1, at stage_log[j + 1] (the reference's ``_stage_replay``)."""
    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stage_log),
                            resident="quantized", device="cpu")
    while srv.stage < stage_log[0]:
        srv.receive_stage()
    srv.start({"tokens": prompt})
    out = [int(torch.argmax(srv.last_logits, dim=-1)[0])]
    pos = prompt.shape[1]
    for stage in stage_log[1:]:
        while srv.stage < stage:
            srv.receive_stage()
        logits, srv.caches = model.decode_step(srv.params, srv.caches,
                                               torch.tensor([[out[-1]]]), pos)
        pos += 1
        out.append(int(torch.argmax(logits, dim=-1)[0]))
    return out


def test_engine_midstream_upgrades_equal_stage_replay(models):
    """Stages landing between rounds at batch 1: the tokens equal a plain
    server replayed at the run's per-token stage log."""
    _, model, _, prog = models
    tokens = _prompt(2, (1, PROMPT))
    eng = SpeculativeEngine(model, prog, max_len=MAX_LEN + 4,
                            spec=SpecConfig(draft_bits=4, k=3), device="cpu")
    eng.receive_stage()
    eng.start({"tokens": tokens})
    res = eng.decode(STEPS + 4, stage_arrival=lambda i: True)
    assert len(res.upgrades) >= 2 and eng.stage == 1 + len(res.upgrades)
    assert res.tokens[0].tolist() == _stage_replay(model, prog, tokens, res.stage_log[0])


def test_engine_over_wire_bytes_equals_pull_mode(models):
    """``SpeculativeEngine(receiver=WireStoreReceiver(...))`` fed the v3
    stream one stage between rounds: the same tokens, stage log and rounds
    as the pull-mode engine with the same arrivals."""
    from repro_torch.core import wire
    from repro_torch.serving import WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    _, model, _, prog = models
    blob = wire.encode(prog, integrity=True)
    meta, hdr = wire.decode_header(blob)
    ends = np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()
    client = ProgressiveClient(device="cpu")
    spec = SpecConfig(draft_bits=4, k=3)
    wired = SpeculativeEngine(model, prog, max_len=MAX_LEN + 4, spec=spec, device="cpu",
                              receiver=WireStoreReceiver(client, prog))
    pull = SpeculativeEngine(model, prog, max_len=MAX_LEN + 4, spec=spec, device="cpu")
    client.feed(blob[:ends[1]])
    tokens = _prompt(5, (2, PROMPT))
    for e in (wired, pull):
        e.receive_stage()
        e.start({"tokens": tokens})

    def arrive(done):
        client.feed(blob[ends[client.stages_complete]:ends[client.stages_complete + 1]])
        return True

    got = wired.decode(STEPS + 4, stage_arrival=arrive)
    want = pull.decode(STEPS + 4, stage_arrival=lambda done: True)
    assert torch.equal(got.tokens, want.tokens)
    assert got.stage_log == want.stage_log and got.upgrades == want.upgrades
    assert _rounds(got.accept_rounds) == _rounds(want.accept_rounds)
    assert wired.resident_report()["extra_draft_bytes"] == 0


@pytest.mark.parametrize("upgrades", [False, True], ids=["stage8", "midflight"])
def test_pool_equals_reference(models, upgrades):
    jmodel, model, jprog, prog = models
    rng = np.random.default_rng(4)
    reqs = [(rid, rng.integers(0, REDUCED["vocab"], int(rng.integers(3, 11))).astype(np.int32),
             int(rng.integers(2, 9))) for rid in range(5)]
    kw = dict(n_slots=3, max_len=24, dispatch_window=2, prefill_chunk=4)
    jpool = JSpecPool(jmodel, jprog, spec=JSpecConfig(draft_bits=4, k=3), **kw)
    pool = SpeculativeSlotPool(model, prog, spec=SpecConfig(draft_bits=4, k=3), device="cpu",
                               **kw)
    outs = []
    for p, req_cls in ((jpool, JPoolRequest), (pool, PoolRequest)):
        for _ in range(1 if upgrades else prog.n_stages):
            p.receive_stage()
        for rid, prompt, budget in reqs:
            p.submit(req_cls(rid=rid, prompt=prompt, max_new_tokens=budget))
        on_window = (lambda _, p=p: p.upgrade_if_available()) if upgrades else None
        outs.append(p.run(on_window=on_window))
    jout, out = outs
    assert out == {rid: list(map(int, t)) for rid, t in jout.items()}
    assert pool.stage_log == jpool.stage_log
    assert pool.admit_stage == jpool.admit_stage
    assert _rounds(pool.accept_log) == _rounds(jpool.accept_log)
    assert pool.completed == set(range(len(reqs)))
    assert all(len(out[rid]) == budget for rid, _, budget in reqs)
    assert pool.stage == (jpool.stage if upgrades else 8) and (pool.stage > 2 or not upgrades)


# ---------------------------------------------------------------------------
# refusals, audits
# ---------------------------------------------------------------------------

def test_headroom_and_recurrent_checks_raise(models, monkeypatch):
    _, model, _, prog = models
    spec = SpecConfig(draft_bits=4, k=3, k_max=3)
    with pytest.raises(ValueError, match="k_max"):
        SpeculativeEngine(model, prog, max_len=spec.k_max + 1, spec=spec, device="cpu")
    with pytest.raises(ValueError, match="k_max"):
        SpeculativeSlotPool(model, prog, n_slots=2, max_len=spec.k_max + 1, spec=spec,
                            device="cpu")
    SpeculativeEngine(model, prog, max_len=spec.k_max + 2, spec=spec, device="cpu")
    eng = SpeculativeEngine(model, prog, max_len=12, spec=spec, device="cpu")
    eng.receive_stage()
    with pytest.raises(ValueError, match="headroom"):
        eng.start({"tokens": np.zeros((1, 9), np.int32)})
    eng.start({"tokens": np.zeros((1, 8), np.int32)})
    with pytest.raises(ValueError, match="max_len"):
        eng.decode(3)
    eng.decode(2)
    with pytest.raises(RuntimeError, match="one-shot"):
        eng.decode(1)
    pool = SpeculativeSlotPool(model, prog, n_slots=2, max_len=16, spec=spec, device="cpu")
    pool.receive_stage()
    with pytest.raises(ValueError, match="verify headroom"):
        pool.submit(PoolRequest(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=6))
    pool.submit(PoolRequest(rid=1, prompt=np.zeros(8, np.int32), max_new_tokens=5))
    with pytest.raises(ValueError, match="k must be"):
        SpecConfig(k=-1)
    recurrent = build_model(dataclasses.replace(model.cfg, cycle=("mamba2",)))
    with pytest.raises(NotImplementedError, match="rollback"):
        SpeculativeEngine(recurrent, prog, max_len=24, spec=spec, device="cpu")
    # a windowed model's rings grow by the largest verify block
    swa = build_model(dataclasses.replace(model.cfg, cycle=("swa",), window=8))
    assert SpeculativeEngine(swa, prog, max_len=24, spec=spec,
                             device="cpu")._ring_margin == spec.k_max + 1
    # the parts left for later name their ROADMAP item
    with pytest.raises(NotImplementedError, match="A13"):   # replica rows
        SpeculativeEngine(model, prog, max_len=24, spec=spec, device="cpu",
                          mesh=make_serving_mesh(2, n_data=2, devices=["cpu"] * 4))
    # batch-1 admission (A9's rest) admits: the prefill's argmax is the
    # first token, emitted at admission; a budget of 1 ends there
    bpool = SpeculativeSlotPool(model, prog, n_slots=2, max_len=24, spec=spec,
                                chunked_prefill=False, device="cpu")
    bpool.receive_stage()
    bpool.submit(PoolRequest(rid=0, prompt=np.zeros(8, np.int32), max_new_tokens=5))
    bpool.submit(PoolRequest(rid=1, prompt=np.ones(3, np.int32), max_new_tokens=1))
    assert not bpool.chunked_prefill and bpool._tick_count == 0
    assert len(bpool.outputs[0]) == len(bpool.outputs[1]) == 1
    assert bpool.slots[1].free and bpool.slots[0].dispatched == 1
    out = bpool.run()
    assert len(out[0]) == 5 and len(out[1]) == 1 and bpool.completed == {0, 1}
    # telemetry is ported (tests/test_torch_telemetry.py): an engine serves
    # with REPRO_TELEMETRY set, and with the registry on it records each round
    monkeypatch.setenv("REPRO_TELEMETRY", "1")
    eng = SpeculativeEngine(model, prog, max_len=24, spec=spec, device="cpu")
    for _ in range(prog.n_stages):
        eng.receive_stage()
    eng.start({"tokens": np.zeros((1, 8), np.int32)})
    with obs.telemetry(True):
        res = eng.decode(4)
        assert obs.get_registry().get("spec_rounds_total").value(
            engine="SpeculativeEngine") == res.rounds > 0


def test_draft_adds_no_resident_bytes(models):
    _, model, _, prog = models
    eng = SpeculativeEngine(model, prog, max_len=24, spec=SpecConfig(draft_bits=4, k=2),
                            device="cpu")
    plain = ProgressiveServer(model, prog, max_len=24, resident="quantized", device="cpu")
    for _ in range(prog.n_stages):
        eng.receive_stage()
        plain.receive_stage()
    rep = eng.resident_report()
    assert rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] == 0
    assert rep["quantized_bytes"] == plain.resident_report()["quantized_bytes"]
    assert set(rep["effective_bits"].values()) == {4, 16}
    for k in ("embed",):
        t, d = eng.params[k], eng.draft_params[k]
        assert d.q.data_ptr() == t.q.data_ptr()
    td = eng.params["decoder"]["cycles"]["0_attn"]
    dd = eng.draft_params["decoder"]["cycles"]["0_attn"]
    for group in ("attn", "mlp"):
        for name in td[group]:
            assert td[group][name].q is dd[group][name].q
            assert int(dd[group][name].keep_bits.max()) == 4
            assert int(td[group][name].keep_bits.max()) == 16
