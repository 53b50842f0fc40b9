"""Sliding windows (ROADMAP A8(b)) against the JAX package, on the CPU.

gemma3-27b reduced: 6 layers (one 5:1 cycle, ``swa`` x 5 then
``global``), d_model 64, 4 heads on 2 KV heads (G = 2, head_dim 32),
d_ff 128, vocab 256, window 16 (the reference's ``reduced``), ``qk_norm``,
logit softcap 30, the global layer's rope base 100x; float32, the same
weights in both packages (the JAX init through numpy, with the ``q_norm``,
``k_norm``, ``norm2`` and ``final_norm`` scales redrawn from a numpy seed
so that each changes the logits). Positions run past 40, so every ring
of 16 slots wraps at least twice. Held:

* the config and the ring helpers (``ring_positions``,
  ``make_ring_cache`` with S < W and S > W, ``grow_ring_cache``) equal the
  reference's exactly;
* v3 wire bytes, accumulators and ``fingerprint()`` exactly;
* prefill and teacher-forced decode logits past position 40 within
  ``LOGIT_ATOL`` at stages 1, 4 and 8 in both residencies, and the rings'
  contents;
* a verify block (T = 5, ring margin 5) and prefill chunks over a
  wrapped ring, logits and rings;
* greedy tokens identical: the single stream, the pool (chunked and
  batch-1 admission, buckets off), ``SpeculativeEngine`` and
  ``SpeculativeSlotPool`` at k = 4, and the speculative tokens equal to the
  port's plain tokens;
* the tail on ``reduced(n_layers=8)`` (two ``swa`` blocks after the
  cycle): parameters, bytes, logits and tokens;
* the refusals: a bucket-padded windowed prefill, ``ring < window + T``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.progressive import divide as jax_divide
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import PoolRequest as JPoolRequest
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import SlotPoolEngine as JSlotPool
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.serving.speculative import SpeculativeEngine as JSpecEngine
from repro.serving.speculative import SpeculativeSlotPool as JSpecPool
from repro.transmission import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine, SpeculativeSlotPool)
from repro_torch.transmission import ProgressiveClient

NAME = "gemma3-27b"
SIZE = dict(d_model=64, d_ff=128, vocab=256)
LOGIT_ATOL = 2e-5       # as tests/test_torch_serving.py: float32, sums in other orders
PROMPT = 20             # longer than the window: the prefill keeps its last 16
FORCED = 22             # teacher-forced decode to position 41
MAX_LEN = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(n_layers: int):
    """Both models over the same weights, and both divided models."""
    jcfg = jax_get_config(NAME).reduced(n_layers=n_layers, **SIZE)
    cfg = get_config(NAME).reduced(n_layers=n_layers, **SIZE)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    weights = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    dec = weights["decoder"]
    blocks = list(dec["cycles"].values()) + list(dec["tail"].values())
    scales = [b["attn"] for b in blocks] + [b["norm2"] for b in blocks] + [weights["final_norm"]]
    for tree in scales:
        for k, v in tree.items():
            if k in ("q_norm", "k_norm", "scale"):
                tree[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, device="cpu")
    return dict(jmodel=jmodel, model=model, jprog=jax_divide(jparams), prog=divide(params),
                weights=weights)


@pytest.fixture(scope="module")
def gemma():
    return _build(6)


@pytest.fixture(scope="module")
def tail():
    return _build(8)


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(0, SIZE["vocab"], shape).astype(np.int32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(want, got, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(want), _np(got), rtol=0, atol=atol)


def _close_trees(jtree, tree):
    flat = dict(tree_flatten_with_path(tree))
    jflat = {tuple(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert sorted(flat) == sorted(jflat)
    for k, v in flat.items():
        _close(jflat[k], v)


# ---------------------------------------------------------------------------
# config, ring helpers, parameters
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    cfg, jcfg = get_config(NAME), jax_get_config(NAME)
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab) \
        == (62, 5376, 32, 16, 128, 21504, 262144)
    assert cfg.cycle == ("swa",) * 5 + ("global",) and cfg.window == 1024
    assert cfg.qk_norm and cfg.logit_softcap == 30.0 and cfg.act == "gelu"
    assert cfg.tail == jcfg.tail == ("swa", "swa") and cfg.n_cycles == 10
    for n in (6, 8):
        red, jred = cfg.reduced(n_layers=n), jcfg.reduced(n_layers=n)
        assert {f: getattr(red, f) for f in fields} == {f: getattr(jred, f) for f in fields}
        assert red.window == 16 and red.tail == jred.tail


def test_ring_helpers_equal_reference():
    """``ring_positions`` at scalar and per-slot positions (free slots
    included), ``make_ring_cache`` with a prompt shorter and longer than
    the window, and ``grow_ring_cache`` of a wrapped ring, stacked too."""
    for ring in (5, 16, 21):
        for p in range(-2, 50):
            got = attn.ring_positions(ring, torch.tensor(p, dtype=torch.int32))
            assert np.array_equal(_np(got), np.asarray(jattn.ring_positions(ring, p)))
        pos = np.array([-1, 0, 3, 17, 44], np.int32)
        got = attn.ring_positions(ring, torch.from_numpy(pos))
        assert got.dtype == torch.int32 and got.shape == (5, ring)
        assert np.array_equal(_np(got), np.asarray(jattn.ring_positions(ring, jnp.asarray(pos))))
    rng = np.random.default_rng(1)
    for S in (5, 16, 37):
        k, v = (rng.standard_normal((2, S, 3, 8)).astype(np.float32) for _ in range(2))
        rk, rv = attn.make_ring_cache(torch.from_numpy(k), torch.from_numpy(v), 16)
        jk, jv = jattn.make_ring_cache(jnp.asarray(k), jnp.asarray(v), 16)
        assert np.array_equal(_np(rk), np.asarray(jk)) and np.array_equal(_np(rv), np.asarray(jv))
        for lead in ((), (3,)):
            c = {n: rng.standard_normal(lead + (2, 3, 16, 8)).astype(np.float32)
                 for n in ("k", "v")}
            for new, pos in ((21, S), (16 + 8, 41), (12, S)):
                got = attn.grow_ring_cache({n: torch.from_numpy(a) for n, a in c.items()},
                                           new, pos)
                want = jattn.grow_ring_cache({n: jnp.asarray(a) for n, a in c.items()},
                                             new, pos)
                for n in ("k", "v"):
                    assert np.array_equal(_np(got[n]), np.asarray(want[n])), (S, lead, new)


def test_param_trees_equal_reference():
    """The same leaves, shapes and dtypes as the JAX init, ``q_norm`` and
    ``k_norm`` included, and the tail's unstacked blocks."""
    for n in (6, 8):
        cfg = get_config(NAME).reduced(n_layers=n, **SIZE)
        ours = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        jmodel = jax_build_model(jax_get_config(NAME).reduced(n_layers=n, **SIZE))
        jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        flat = {tuple(p.key for p in path): tuple(leaf.shape) for path, leaf in
                jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        assert {p: tuple(t.shape) for p, t in tree_flatten_with_path(ours)} == flat
        assert ("decoder", "cycles", "0_swa", "attn", "q_norm") in flat
        assert (("decoder", "tail", "1_swa", "attn", "k_norm") in flat) == (n == 8)


# ---------------------------------------------------------------------------
# bytes, accumulators, fingerprints
# ---------------------------------------------------------------------------

def _stage_ends(blob):
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


def _buffers(store):
    return {k: _np(v).tobytes() for k, v in store.buffers.items()}


def test_wire_accumulators_fingerprints_every_stage(tail):
    """The 8-layer model: its cycle's stacked leaves and the tail's
    unstacked ones, ``q_norm``/``k_norm`` among them."""
    arch = tail
    jprog, prog = arch["jprog"], arch["prog"]
    blob = wire.encode(prog, integrity=True)
    assert blob == jwire.encode(jprog, integrity=True)
    ends = _stage_ends(blob)
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    st = ReceiverState.init(prog, device="cpu")
    rng = np.random.default_rng(5)
    pos = 0
    for s in range(1, prog.n_stages + 1):
        while pos < ends[s]:
            n = min(ends[s] - pos, int(np.exp(rng.uniform(0.0, np.log(1 << 16)))))
            client.feed(blob[pos:pos + n])
            jclient.feed(blob[pos:pos + n])
            pos += n
        st = st.receive(prog.stage(s))
        assert client.store.fingerprint() == jclient.store.fingerprint() \
            == st.store.fingerprint(), f"stage {s}"
        assert _buffers(client.store) == _buffers(jclient.store) == _buffers(st.store)


# ---------------------------------------------------------------------------
# logits and rings against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_logits_and_rings_every_stage(gemma, resident):
    """At stages 1, 4 and 8: the prefill of a prompt longer than the
    window, then teacher-forced decode to position 41 (each ring wraps
    twice); the logits and the caches (rings and the global layer's)."""
    jmodel, model = gemma["jmodel"], gemma["model"]
    tokens = _prompt(1, (2, PROMPT))
    forced = _prompt(2, (2, FORCED))
    jsrv = JServer(jmodel, gemma["jprog"], max_len=MAX_LEN, resident=resident)
    srv = ProgressiveServer(model, gemma["prog"], max_len=MAX_LEN, resident=resident,
                            device="cpu")
    for s in range(1, gemma["prog"].n_stages + 1):
        jsrv.receive_stage()
        srv.receive_stage()
        if s not in (1, 4, 8):
            continue
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        _close(jsrv.last_logits, srv.last_logits)
        assert srv.caches["cycles"]["0_swa"]["k"].shape[-2] == 16
        assert srv.caches["cycles"]["5_global"]["k"].shape[-2] == MAX_LEN
        jcaches, caches = jsrv.caches, srv.caches
        for t in range(FORCED):
            tok = forced[:, t:t + 1]
            jl, jcaches = jsrv._decode(jsrv.params, jcaches, jnp.asarray(tok),
                                       jnp.int32(jsrv.pos + t))
            lg, caches = model.decode_step(srv.params, caches, torch.from_numpy(tok),
                                           srv.pos + t)
            _close(jl, lg)
            assert np.array_equal(np.argmax(np.asarray(jl), -1), _np(lg.argmax(-1)))
        _close_trees(jcaches, caches)
        assert srv.resident_report() == jsrv.resident_report(), f"stage {s}"


def _served_params(arch, resident="quantized"):
    jsrv = JServer(arch["jmodel"], arch["jprog"], max_len=MAX_LEN, resident=resident)
    srv = ProgressiveServer(arch["model"], arch["prog"], max_len=MAX_LEN, resident=resident,
                            device="cpu")
    for _ in range(arch["prog"].n_stages):
        jsrv.receive_stage()
        srv.receive_stage()
    return jsrv.params, srv.params


def test_verify_and_prefill_chunks_over_wrapped_rings(gemma):
    """Stage 8, quantized: a verify block (T = 5) on rings grown by 5 slots
    after a prefill and 17 decode steps (positions to 41), each slot at its
    own base; then a pool's rings (margin 8) filled by prefill chunks of 8
    to position 40, ragged across slots. Logits and caches equal the
    reference's; a verify row's logits equal a decode step's at its
    position."""
    jmodel, model = gemma["jmodel"], gemma["model"]
    jp, p = _served_params(gemma)
    jm = types.SimpleNamespace(**{k: jax.jit(getattr(jmodel, k)) for k in (
        "prefill", "decode_step", "verify_step", "prefill_chunk")},
        grow_caches=jmodel.grow_caches, init_caches=jmodel.init_caches)
    jmodel = jm
    tokens = _prompt(4, (2, PROMPT))
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens)})
    lg, c = model.prefill(p, {"tokens": torch.from_numpy(tokens)})
    _close(jl, lg)
    jc = jmodel.grow_caches(jc, MAX_LEN, ring_margin=5, pos=PROMPT)
    c = model.grow_caches(c, MAX_LEN, ring_margin=5, pos=PROMPT)
    assert c["cycles"]["0_swa"]["k"].shape[-2] == 21
    _close_trees(jc, c)
    forced = _prompt(5, (2, 17))
    for t in range(17):
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(forced[:, t:t + 1]),
                                    jnp.int32(PROMPT + t))
        lg, c = model.decode_step(p, c, torch.from_numpy(forced[:, t:t + 1]), PROMPT + t)
    block = _prompt(6, (2, 5))
    base = np.array([PROMPT + 17, PROMPT + 12], np.int32)
    jl, jc = jmodel.verify_step(jp, jc, jnp.asarray(block), jnp.asarray(base))
    before = {k: v.clone() for k, v in c["cycles"]["0_swa"].items()}
    lg, c = model.verify_step(p, c, torch.from_numpy(block), torch.from_numpy(base))
    _close(jl, lg)
    _close_trees(jc, c)
    # slot 1's rows at 32-36 overwrote positions 11-15 (ring 21), no
    # position still inside a row's window
    assert not torch.equal(before["k"], c["cycles"]["0_swa"]["k"])
    # with too small a ring, a multi-row block raises
    small = model.init_caches(2, MAX_LEN, ring_margin=4, device="cpu")
    with pytest.raises(ValueError, match="window \\+ T"):
        model.verify_step(p, small, torch.from_numpy(block), torch.from_numpy(base))

    # prefill chunks into pooled rings: slot 0 from 0 to 40, slot 1 from 0
    # to 33, then masked; a free third slot throughout
    jc = jmodel.init_caches(3, MAX_LEN, ring_margin=8)
    c = model.init_caches(3, MAX_LEN, ring_margin=8, device="cpu")
    prompts = _prompt(7, (3, 41))
    for off in range(0, 41, 8):
        tok_pos = np.full((3, 8), -1, np.int32)
        toks = np.zeros((3, 8), np.int32)
        for slot, L in ((0, 41), (1, 34)):
            n = max(0, min(8, L - off))
            tok_pos[slot, :n] = np.arange(off, off + n)
            toks[slot, :n] = prompts[slot, off:off + n]
        jl, jc = jmodel.prefill_chunk(jp, jc, jnp.asarray(toks), jnp.asarray(tok_pos))
        lg, c = model.prefill_chunk(p, c, torch.from_numpy(toks), torch.from_numpy(tok_pos))
        live = tok_pos >= 0
        _close(np.asarray(jl)[live], lg[torch.from_numpy(live)])
    _close_trees(jc, c)
    small = model.init_caches(3, MAX_LEN, ring_margin=7, device="cpu")
    with pytest.raises(ValueError, match="ring_margin"):
        model.prefill_chunk(p, small, torch.from_numpy(toks), torch.from_numpy(tok_pos))


def test_bucketed_windowed_prefill_raises(gemma):
    model = gemma["model"]
    _, p = _served_params(gemma)
    with pytest.raises(NotImplementedError, match="ring"):
        model.prefill(p, {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                      np.asarray([5], np.int32))
    cfg = model.cfg
    h = torch.zeros((1, 8, cfg.d_model))
    lp = layer(p["decoder"]["cycles"]["0_swa"]["attn"], 0)
    with pytest.raises(NotImplementedError, match="ring layout"):
        attn.self_attention(cfg, lp, h, mode="prefill", cache=None,
                            pos=torch.tensor([5]), window=cfg.window)
    pool = SlotPoolEngine(model, gemma["prog"], n_slots=2, max_len=MAX_LEN,
                          chunked_prefill=False, device="cpu")
    assert not pool.prefill_buckets and pool._ring_margin == 0
    pool = SlotPoolEngine(model, gemma["prog"], n_slots=2, max_len=MAX_LEN, prefill_chunk=8,
                          device="cpu")
    assert pool._ring_margin == 8 and pool.caches["cycles"]["1_swa"]["k"].shape[-2] == 24


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engines
# ---------------------------------------------------------------------------

def _decode_run(eng, tokens, steps, arrivals):
    eng.receive_stage()
    eng.start({"tokens": tokens})
    return eng.decode(steps, stage_arrival=lambda i: i in arrivals)


def test_greedy_tokens_with_midstream_upgrades(gemma):
    """Quantized residency, stages 2-8 landing between decode steps to
    position 43; tokens, stage logs and the last logits equal."""
    arch = gemma
    steps = 24
    arrivals = set(range(2, 16, 2))
    tokens = _prompt(3, (2, PROMPT))
    jsrv = JServer(arch["jmodel"], arch["jprog"], max_len=PROMPT + steps, resident="quantized")
    srv = ProgressiveServer(arch["model"], arch["prog"], max_len=PROMPT + steps,
                            resident="quantized", device="cpu")
    jres = _decode_run(jsrv, jnp.asarray(tokens), steps, arrivals)
    res = _decode_run(srv, tokens, steps, arrivals)
    assert res.upgrades == jres.upgrades and res.stage_at_step == jres.stage_at_step
    assert res.stage_at_step[-1] == 8
    np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens))
    _close(jsrv.last_logits, srv.last_logits)


def _requests(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, SIZE["vocab"], L).astype(np.int32), int(rng.integers(18, 26)))
            for rid, L in enumerate(lengths)]


def _pool_run(pool, req_cls, reqs, upgrades=True, stages=1):
    for _ in range(stages):
        pool.receive_stage()
    for rid, prompt, budget in reqs:
        pool.submit(req_cls(rid=rid, prompt=prompt, max_new_tokens=budget))
    return pool.run(on_window=(lambda _: pool.upgrade_if_available()) if upgrades else None)


@pytest.mark.parametrize("chunked,margin", [(True, 0), (False, 0), (False, 5)],
                         ids=["chunked", "batch1", "batch1_margin"])
def test_pool_tokens_equal_reference(gemma, chunked, margin):
    """Five requests on three slots, prompts 12-26 (some over the window),
    budgets so that positions pass 40, an upgrade a window; batch-1
    admission without buckets (a windowed arch turns them off). With a
    ring margin, batch-1 admission repacks each prefill's ring of 16
    slots into the pool's 21; the margin changes no token, so the JAX
    pool runs without one."""
    reqs = _requests(4, [12, 26, 20, 26, 12])
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_window=4, prefill_chunk=8,
              chunked_prefill=chunked, resident="quantized")
    jpool = JSlotPool(gemma["jmodel"], gemma["jprog"], **kw)
    pool = SlotPoolEngine(gemma["model"], gemma["prog"], ring_margin=margin, device="cpu",
                          **kw)
    jout = _pool_run(jpool, JPoolRequest, reqs)
    out = _pool_run(pool, PoolRequest, reqs)
    assert not pool.prefill_buckets and not jpool.prefill_buckets
    want = 8 if chunked else margin
    assert pool._ring_margin == want and jpool._ring_margin == (8 if chunked else 0)
    assert pool.caches["cycles"]["1_swa"]["k"].shape[-2] == gemma["model"].cfg.window + want
    assert out == {rid: list(map(int, t)) for rid, t in jout.items()}
    assert pool.stage_log == jpool.stage_log and pool.admit_stage == jpool.admit_stage
    assert pool.upgrades == jpool.upgrades and pool.stage > 2


def test_speculative_engine_equals_reference_and_plain(gemma):
    """k = 4 (k_max 4: rings of 16 + 5), draft 4 bits, at stages 1, 4 and 8
    from a fresh start, 24 tokens from a prompt of 20: tokens and rounds
    equal the JAX engine's, tokens the port's plain server's."""
    jmodel, model, prog = gemma["jmodel"], gemma["model"], gemma["prog"]
    tokens = _prompt(6, (2, PROMPT))
    steps = 24
    max_len = PROMPT + steps + 5
    jeng = JSpecEngine(jmodel, gemma["jprog"], max_len=max_len,
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
        assert eng.caches["cycles"]["2_swa"]["k"].shape[-2] == 21
        jres, res = jeng.decode(steps), eng.decode(steps)
        np.testing.assert_array_equal(_np(res.tokens), np.asarray(jres.tokens),
                                      err_msg=f"stage {s}")
        assert [(r["k"], r["accepted"]) for r in res.accept_rounds] == \
            [(r["k"], r["accepted"]) for r in jres.accept_rounds]
        assert torch.equal(res.tokens, plain.decode(steps).tokens), f"stage {s}"
        drafted += res.drafted
    assert drafted > 0


def test_speculative_pool_equals_reference(gemma):
    """``SpeculativeSlotPool`` at k = 4 from stage 1 with upgrades a window,
    chunked admission: rings of 16 + 8 slots (the chunk's margin, above
    k_max + 1 = 5)."""
    reqs = _requests(9, [20, 12, 26, 20])
    kw = dict(n_slots=3, max_len=MAX_LEN, dispatch_window=2, prefill_chunk=8)
    spec = dict(draft_bits=4, k=4, k_max=4)
    jpool = JSpecPool(gemma["jmodel"], gemma["jprog"], spec=JSpecConfig(**spec), **kw)
    pool = SpeculativeSlotPool(gemma["model"], gemma["prog"], spec=SpecConfig(**spec),
                               device="cpu", **kw)
    jout = _pool_run(jpool, JPoolRequest, reqs)
    out = _pool_run(pool, PoolRequest, reqs)
    assert pool._ring_margin == jpool._ring_margin == 8
    assert out == {rid: list(map(int, t)) for rid, t in jout.items()}
    assert pool.stage_log == jpool.stage_log and pool.admit_stage == jpool.admit_stage
    assert [(r["k"], r["accepted"]) for r in pool.accept_log] == \
        [(r["k"], r["accepted"]) for r in jpool.accept_log]
    assert all(len(out[rid]) == budget for rid, _, budget in reqs)


def test_tail_logits_every_stage(tail):
    """The 8-layer model (cycle, then ``swa`` x 2 unstacked): prefill and
    teacher-forced decode logits to position 41 and the tail's rings at
    stages 1, 4 and 8, quantized, and the greedy tokens those logits
    give."""
    jmodel, model = tail["jmodel"], tail["model"]
    tokens = _prompt(8, (2, PROMPT))
    forced = _prompt(9, (2, FORCED))
    jsrv = JServer(jmodel, tail["jprog"], max_len=MAX_LEN, resident="quantized")
    srv = ProgressiveServer(model, tail["prog"], max_len=MAX_LEN, resident="quantized",
                            device="cpu")
    for s in range(1, 9):
        jsrv.receive_stage()
        srv.receive_stage()
        if s not in (1, 4, 8):
            continue
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        _close(jsrv.last_logits, srv.last_logits)
        assert sorted(srv.caches["tail"]) == ["0_swa", "1_swa"]
        assert srv.caches["tail"]["1_swa"]["k"].shape == (2, 2, 16, 32)
        jcaches, caches = jsrv.caches, srv.caches
        for t in range(FORCED):
            tok = forced[:, t:t + 1]
            jl, jcaches = jsrv._decode(jsrv.params, jcaches, jnp.asarray(tok),
                                       jnp.int32(jsrv.pos + t))
            lg, caches = model.decode_step(srv.params, caches, torch.from_numpy(tok),
                                           srv.pos + t)
            _close(jl, lg)
            assert np.array_equal(np.argmax(np.asarray(jl), -1), _np(lg.argmax(-1)))
        _close_trees(jcaches, caches)
